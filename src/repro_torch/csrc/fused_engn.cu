// Fused feature extraction + RER aggregate on Hopper (paper Fig. 8).
//
// Replaces the Pallas kernel src/repro/kernels/fused_engn/fused_engn.py::
// fused_extract_aggregate (_fused_kernel):
//
//   Y[br_k*T : +T, hc] += A_k @ (X[bc_k*T : +T] @ W[:, hc])
//
// over dst-sorted dense tiles; P = X W for the current source tile lives
// only in shared memory, never in device memory.
//
// Bound on the H100: operations, at the widths the slice runs (F = 1433
// on cora): P costs 2*T*F*Hc per tile and chunk.  As in the reference,
// P is recomputed for every tile (nnzb times, not q times), which is the
// price of keeping it off device memory.  Design:
//   * one CTA per (dst interval, 16-wide output chunk) walks its tile
//     span and owns its (T x 16) output block: no atomics;
//   * phase 1 computes P = X[bc] @ W[:, hc] with a K-loop over F in
//     16-wide slabs (F is ragged: 1433, 64) into a T x 16 shared array;
//   * phase 2 streams A_k in 256 x 16 slabs (a T=256 tile is 256 KB,
//     above the 227 KB a CTA may use) against the resident P;
//   * in both phases each slab is loaded into registers one stage ahead
//     of its use, so its loads overlap the previous stage's arithmetic;
//   * the narrow 16-wide chunk keeps q * ceil(H/16) CTAs in flight
//     without recomputing any product across CTAs; H = 7 is masked;
//   * fp32 FMA on the CUDA cores, as the reference contracts in f32.
// T may be at most 256 (the CTA's rows); the wrapper checks it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // max T: rows per CTA
constexpr int kHc = 16;     // output columns per CTA
constexpr int kBk = 16;     // reduction depth per shared-memory stage
constexpr int kSlabLoads = kRows * kBk / kThreads;  // 16

// A kRows x kBk slab of a row-major (rows x cols, leading dim ld) matrix
// starting at column c0, zero outside it, into registers.
__device__ __forceinline__ void load_slab(float (&r)[kSlabLoads],
                                          const float* __restrict__ src,
                                          int rows, int cols, int ld, int c0,
                                          int tid) {
#pragma unroll
  for (int l = 0; l < kSlabLoads; ++l) {
    const int e = tid + l * kThreads;
    const int row = e / kBk, col = c0 + e % kBk;
    r[l] = (row < rows && col < cols) ? src[(size_t)row * ld + col] : 0.f;
  }
}

__device__ __forceinline__ void store_slab(float (&s)[kRows][kBk + 1],
                                           const float (&r)[kSlabLoads],
                                           int tid) {
#pragma unroll
  for (int l = 0; l < kSlabLoads; ++l) {
    const int e = tid + l * kThreads;
    s[e / kBk][e % kBk] = r[l];
  }
}

// thread (tx, ty) = (tid % 4, tid / 4) owns rows ty + 64 i, cols tx + 4 j.
// Each slab's global loads go to registers one stage ahead, so they are
// in flight while the previous stage computes out of shared memory.
__global__ void __launch_bounds__(kThreads)
fused_engn_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ block_col,
                  const int* __restrict__ tile_ptr,
                  const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int t, int f, int h,
                  int n_hchunks) {
  __shared__ float stage_s[kRows][kBk + 1];  // X slab, then A slab
  __shared__ float w_s[kBk][kHc];
  __shared__ float p_s[kRows][kHc];
  const int tid = threadIdx.x;
  const int tx = tid & 3, ty = tid >> 2;
  const int dst = blockIdx.x / n_hchunks;
  const int h0 = (blockIdx.x % n_hchunks) * kHc;
  // W slab: one element per thread
  const int wr = tid / kHc, wc = h0 + tid % kHc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float reg[kSlabLoads];
  const int k_lo = tile_ptr[dst], k_hi = tile_ptr[dst + 1];
  for (int k = k_lo; k < k_hi; ++k) {
    // phase 1: P = X[bc] @ W[:, h0:h0+kHc]
    const float* xs = x + (size_t)block_col[k] * t * f;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
    load_slab(reg, xs, t, f, f, 0, tid);
    float rw = (wr < f && wc < h) ? w[(size_t)wr * h + wc] : 0.f;
    for (int f0 = 0; f0 < f; f0 += kBk) {
      store_slab(stage_s, reg, tid);
      w_s[wr][tid % kHc] = rw;
      __syncthreads();
      if (f0 + kBk < f) {
        load_slab(reg, xs, t, f, f, f0 + kBk, tid);
        rw = (f0 + kBk + wr < f && wc < h)
                 ? w[(size_t)(f0 + kBk + wr) * h + wc] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kBk; ++kk) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = stage_s[ty + 64 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = w_s[kk][tx + 4 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = fmaf(xv[i], wv[j], p[i][j]);
      }
      __syncthreads();
    }
    // rows >= t hold zeros (their X loads were masked)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[ty + 64 * i][tx + 4 * j] = p[i][j];

    // phase 2: Y += A_k @ P
    const float* a = blocks + (size_t)k * t * t;
    load_slab(reg, a, t, t, t, 0, tid);
    for (int u0 = 0; u0 < t; u0 += kBk) {
      store_slab(stage_s, reg, tid);
      __syncthreads();  // also publishes p_s on the first slab
      if (u0 + kBk < t) load_slab(reg, a, t, t, t, u0 + kBk, tid);
#pragma unroll
      for (int kk = 0; kk < kBk; ++kk) {
        float av[4], pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = stage_s[ty + 64 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = p_s[u0 + kk][tx + 4 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], pv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 64 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h0 + tx + 4 * j;
      if (col < h) y[((size_t)dst * t + row) * h + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int fused_engn_launch(const void* blocks, const void* block_col,
                                 const void* tile_ptr, const void* x,
                                 const void* w, void* y, int q, int t, int f,
                                 int h, void* stream) {
  if (q == 0 || t == 0 || h == 0) return (int)cudaGetLastError();
  if (t > kRows) return (int)cudaErrorInvalidValue;
  const int n_hchunks = (h + kHc - 1) / kHc;
  const dim3 grid((unsigned)q * n_hchunks);
  fused_engn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(block_col),
      static_cast<const int*>(tile_ptr), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<float*>(y), t, f, h,
      n_hchunks);
  return (int)cudaGetLastError();
}

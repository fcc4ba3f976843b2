// RER-SpMM on Hopper: the aggregate over dense T x T tiles.
//
// Replaces the Pallas kernel src/repro/kernels/rer_spmm/rer_spmm.py::rer_spmm
// (_spmm_kernel_sum, _spmm_kernel_max):
//
//   Y[br_k*T : +T] (+)= A_k @ X[bc_k*T : +T]     over dst-sorted tiles k
//   max: Y[r, f] = max over A[r, u] != 0 of A[r, u] * X[u, f], -inf -> 0.
//
// Bound on the H100: bytes.  The tiles are mostly structural zeros, so
// the useful work is 2*nnz*F operations against 4*T^2 bytes per tile;
// the kernel streams every tile once per feature chunk and spends its
// time on those loads.  Design:
//   * one CTA per (dst interval, 64-row slab, 16-wide feature chunk);
//     it walks its interval's tile span [tile_ptr[i], tile_ptr[i+1]) and
//     owns its output block, so it needs no atomics and no zero-fill;
//     the 64-row slab cuts the hub interval's span (the critical path
//     after the degree sort) into four CTAs;
//   * the feature chunk is the fastest grid index, so the CTAs that read
//     the same tiles run side by side and share them through L2;
//   * a T=256 fp32 tile is 256 KB, more than a CTA's 227 KB of shared
//     memory: A is streamed in 64 x 32 slabs, X in 32 x 16, each slab
//     loaded into registers one stage ahead of its use;
//   * fp32 FMA on the CUDA cores (the reference contracts in f32; Hopper
//     tensor cores have no IEEE fp32 mode);
//   * ragged F and T are masked at the edge: X is never padded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // output rows per CTA
constexpr int kFc = 16;     // output features per CTA
constexpr int kBk = 32;     // source columns per shared-memory stage
constexpr int kRowStride = kThreads / kFc;           // 16
constexpr int kRowsPerThread = kRows / kRowStride;   // 4
constexpr int kALoads = kRows * kBk / kThreads;      // 8
constexpr int kXLoads = kBk * kFc / kThreads;        // 2

// thread (tx, ty) = (tid % 16, tid / 16) owns column tx, rows ty + 16 i.
// The CTA's stages (tile k, source columns u0..u0+31) run back to back;
// each stage's global loads go to registers one stage ahead, so they are
// in flight while the previous stage computes out of shared memory.
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
rer_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ block_col,
                const int* __restrict__ tile_ptr,
                const float* __restrict__ x, float* __restrict__ y,
                int t, int f, int n_fchunks) {
  __shared__ float a_s[kRows][kBk + 1];
  __shared__ float x_s[kBk][kFc];
  const int tid = threadIdx.x;
  const int tx = tid % kFc, ty = tid / kFc;
  const int dst = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int r0 = blockIdx.y * kRows;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = kMax ? -INFINITY : 0.f;

  const int k_lo = tile_ptr[dst];
  const int n_u = (t + kBk - 1) / kBk;
  const int n_stages = (tile_ptr[dst + 1] - k_lo) * n_u;
  float ra[kALoads], rx[kXLoads];
  auto load = [&](int s) {
    const int k = k_lo + s / n_u, u0 = (s % n_u) * kBk;
    const float* a = blocks + (size_t)k * t * t;
    const float* xs = x + (size_t)block_col[k] * t * f;
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int e = tid + l * kThreads;
      const int gr = r0 + e / kBk, gc = u0 + e % kBk;
      ra[l] = (gr < t && gc < t) ? a[(size_t)gr * t + gc] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kXLoads; ++l) {
      const int e = tid + l * kThreads;
      const int gr = u0 + e / kFc, gc = f0 + e % kFc;
      rx[l] = (gr < t && gc < f) ? xs[(size_t)gr * f + gc] : 0.f;
    }
  };

  if (n_stages > 0) load(0);
  for (int s = 0; s < n_stages; ++s) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int e = tid + l * kThreads;
      a_s[e / kBk][e % kBk] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kXLoads; ++l) {
      const int e = tid + l * kThreads;
      x_s[e / kFc][e % kFc] = rx[l];
    }
    __syncthreads();
    if (s + 1 < n_stages) load(s + 1);
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      const float xv = x_s[kk][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float av = a_s[ty + kRowStride * i][kk];
        if (kMax) {
          if (av != 0.f) acc[i] = fmaxf(acc[i], av * xv);
        } else {
          acc[i] = fmaf(av, xv, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  const int col = f0 + tx;
  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + kRowStride * i;
    if (row >= t) continue;
    float v = acc[i];
    if (kMax && v == -INFINITY) v = 0.f;
    y[((size_t)dst * t + row) * f + col] = v;
  }
}

}  // namespace

extern "C" int rer_spmm_launch(const void* blocks, const void* block_col,
                               const void* tile_ptr, const void* x, void* y,
                               int q, int t, int f, int op_max,
                               void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  dim3 grid((unsigned)q * n_fchunks, (t + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const int* bc = static_cast<const int*>(block_col);
  const int* tp = static_cast<const int*>(tile_ptr);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  if (op_max)
    rer_spmm_kernel<true><<<grid, kThreads, 0, s>>>(b, bc, tp, xx, yy, t, f,
                                                    n_fchunks);
  else
    rer_spmm_kernel<false><<<grid, kThreads, 0, s>>>(b, bc, tp, xx, yy, t, f,
                                                     n_fchunks);
  return (int)cudaGetLastError();
}

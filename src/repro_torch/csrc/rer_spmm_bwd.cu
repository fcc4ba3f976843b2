// The max backward of RER-SpMM on Hopper, over dense T x T tiles.
//
// Backward of the max variant of the Pallas kernel
// src/repro/kernels/rer_spmm/rer_spmm.py::rer_spmm (_spmm_kernel_max),
// which the reference differentiates through its XLA twin
// blocked_spmm_xla: a max over the sources u of each tile (jnp.max), then
// a max over the tiles of each destination interval (segment_max).  Each
// level splits its cotangent evenly over its tied winners, so with y the
// forward output and, for destination row r and feature f,
//
//   c_k[r, f] = #{u : A_k[r, u] != 0 and A_k[r, u] * x[u, f] == y[r, f]}
//   n[r, f]   = #{k : c_k[r, f] > 0}
//
// the source u of tile k receives A_k[r, u] * g[r, f] / (c_k n) from
// every such winner.  A row with no candidate (y finished from -inf to 0)
// has no u with A != 0 and sends nothing.  The products are recomputed
// bitwise as the forward kernel computed them (one fp32 multiply), so
// the ties are found exactly.
//
// Two kernels, no atomics:
//   1. over the forward carrier, one CTA per (dst interval, 64-row slab,
//      16-wide feature chunk), as the forward: walk the interval's tile
//      span counting c_k per tile into the scratch W (nnzb, T, F) and
//      n in registers, then walk the span again to turn W into
//      g / (c_k n) (0 where the tile holds no winner);
//   2. over the transposed carrier (tiles A_k^T, dst-sorted by the
//      forward's source interval, `tile_of` naming each one's forward
//      tile, -1 for pads), one CTA per (source interval, 64-row slab,
//      16-wide chunk): dX[u, f] = sum over tiles and r of A^T[u, r] W[r, f]
//      where A^T[u, r] x[u, f] == y[r, f].  Each CTA owns its dX block.
//
// Bound on the H100: bytes, as the forward: pass 1 streams the tiles
// twice as often as the forward's one walk would need (count, then
// weight only re-reads W), pass 2 streams the transposed tiles once per
// feature chunk plus W and y slabs.  Simple first: one shared-memory
// stage at a time, no prefetch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows per CTA
constexpr int kFc = 16;     // features per CTA
constexpr int kBk = 32;     // tile columns per shared-memory stage
constexpr int kRowStride = kThreads / kFc;           // 16
constexpr int kRowsPerThread = kRows / kRowStride;   // 4

// pass 1: c_k per tile into w, n in registers, then w = g / (c_k n)
__global__ void __launch_bounds__(kThreads)
max_count_kernel(const float* __restrict__ blocks,
                 const int* __restrict__ block_col,
                 const int* __restrict__ tile_ptr,
                 const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ g, float* __restrict__ w,
                 int t, int f, int n_fchunks) {
  __shared__ float a_s[kRows][kBk + 1];
  __shared__ float x_s[kBk][kFc];
  const int tid = threadIdx.x;
  const int tx = tid % kFc, ty = tid / kFc;
  const int dst = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int r0 = blockIdx.y * kRows;
  const int col = f0 + tx;

  float yv[kRowsPerThread];
  int cnt[kRowsPerThread], ntie[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + kRowStride * i;
    // NaN matches no product: rows and columns past the edge count nothing
    yv[i] = (row < t && col < f) ? y[((size_t)dst * t + row) * f + col]
                                 : __int_as_float(0x7fc00000);
    cnt[i] = 0;
    ntie[i] = 0;
  }

  const int k_lo = tile_ptr[dst], k_hi = tile_ptr[dst + 1];
  for (int k = k_lo; k < k_hi; ++k) {
    const float* a = blocks + (size_t)k * t * t;
    const float* xs = x + (size_t)block_col[k] * t * f;
    for (int u0 = 0; u0 < t; u0 += kBk) {
      for (int e = tid; e < kRows * kBk; e += kThreads) {
        const int gr = r0 + e / kBk, gc = u0 + e % kBk;
        a_s[e / kBk][e % kBk] = (gr < t && gc < t) ? a[(size_t)gr * t + gc]
                                                   : 0.f;
      }
      for (int e = tid; e < kBk * kFc; e += kThreads) {
        const int gr = u0 + e / kFc, gc = f0 + e % kFc;
        x_s[e / kFc][e % kFc] = (gr < t && gc < f) ? xs[(size_t)gr * f + gc]
                                                   : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBk; ++kk) {
        const float xv = x_s[kk][tx];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float av = a_s[ty + kRowStride * i][kk];
          if (av != 0.f && av * xv == yv[i]) ++cnt[i];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = r0 + ty + kRowStride * i;
      if (row < t && col < f)
        w[((size_t)k * t + row) * f + col] = (float)cnt[i];
      ntie[i] += cnt[i] > 0;
      cnt[i] = 0;
    }
  }

  // each thread re-reads only what it wrote itself: no barrier needed
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + kRowStride * i;
    if (row >= t || col >= f) continue;
    const float gv = g[((size_t)dst * t + row) * f + col];
    for (int k = k_lo; k < k_hi; ++k) {
      float* wp = w + ((size_t)k * t + row) * f + col;
      const float c = *wp;
      *wp = c > 0.f ? gv / (c * (float)ntie[i]) : 0.f;
    }
  }
}

// pass 2: dX over the transposed tiles
__global__ void __launch_bounds__(kThreads)
max_grad_kernel(const float* __restrict__ blocks_t,
                const int* __restrict__ tile_of,
                const int* __restrict__ block_col_t,
                const int* __restrict__ tile_ptr_t,
                const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ w, float* __restrict__ dx,
                int t, int f, int n_fchunks) {
  __shared__ float a_s[kRows][kBk + 1];
  __shared__ float w_s[kBk][kFc];
  __shared__ float y_s[kBk][kFc];
  const int tid = threadIdx.x;
  const int tx = tid % kFc, ty = tid / kFc;
  const int src = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int r0 = blockIdx.y * kRows;
  const int col = f0 + tx;

  float xv[kRowsPerThread], acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + kRowStride * i;
    xv[i] = (row < t && col < f) ? x[((size_t)src * t + row) * f + col] : 0.f;
    acc[i] = 0.f;
  }

  const int k_lo = tile_ptr_t[src], k_hi = tile_ptr_t[src + 1];
  for (int k = k_lo; k < k_hi; ++k) {
    const int kf = tile_of[k];
    if (kf < 0) continue;                      // a pad tile: all zero
    const float* a = blocks_t + (size_t)k * t * t;
    const float* wk = w + (size_t)kf * t * f;
    const float* yk = y + (size_t)block_col_t[k] * t * f;
    for (int r_0 = 0; r_0 < t; r_0 += kBk) {
      for (int e = tid; e < kRows * kBk; e += kThreads) {
        const int gr = r0 + e / kBk, gc = r_0 + e % kBk;
        a_s[e / kBk][e % kBk] = (gr < t && gc < t) ? a[(size_t)gr * t + gc]
                                                   : 0.f;
      }
      for (int e = tid; e < kBk * kFc; e += kThreads) {
        const int gr = r_0 + e / kFc, gc = f0 + e % kFc;
        const bool ok = gr < t && gc < f;
        w_s[e / kFc][e % kFc] = ok ? wk[(size_t)gr * f + gc] : 0.f;
        y_s[e / kFc][e % kFc] = ok ? yk[(size_t)gr * f + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBk; ++kk) {
        const float wv = w_s[kk][tx], yy = y_s[kk][tx];
        if (wv == 0.f) continue;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float av = a_s[ty + kRowStride * i][kk];
          if (av != 0.f && av * xv[i] == yy) acc[i] = fmaf(av, wv, acc[i]);
        }
      }
      __syncthreads();
    }
  }

  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + ty + kRowStride * i;
    if (row < t) dx[((size_t)src * t + row) * f + col] = acc[i];
  }
}

}  // namespace

extern "C" int rer_spmm_max_bwd_launch(
    const void* blocks, const void* block_col, const void* tile_ptr,
    const void* blocks_t, const void* tile_of, const void* block_col_t,
    const void* tile_ptr_t, const void* x, const void* y, const void* g,
    void* w, void* dx, int q, int t, int f, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  const dim3 grid((unsigned)q * n_fchunks, (t + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  max_count_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(block_col),
      static_cast<const int*>(tile_ptr), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(g),
      static_cast<float*>(w), t, f, n_fchunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_grad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(blocks_t), static_cast<const int*>(tile_of),
      static_cast<const int*>(block_col_t),
      static_cast<const int*>(tile_ptr_t), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<float*>(dx), t, f, n_fchunks);
  return (int)cudaGetLastError();
}

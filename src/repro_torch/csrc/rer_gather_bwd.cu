// The max backward of RER-Gather on Hopper, over packed edge tiles.
//
// Backward of the max variant of the Pallas kernel
// src/repro/kernels/rer_gather/rer_gather.py::rer_gather
// (_gather_kernel_max).  The reference differentiates the packed max
// through packed_flat_xla, one segment_max over every merged entry of a
// destination row, which splits the cotangent evenly over all tied
// entries of the row.  The card runs the forward as one launch per pow2
// bucket group and merges the groups by maximum; its backward gives the
// flat gradient all the same: with y the merged forward output,
//
//   cnt[d, f] = #{entries (d, s, v) of every group : v != 0 and
//                 v * x[s, f] == y[d, f]}
//   dX[s, f] += v * g[d, f] / cnt[d, f]   for each such entry.
//
// A row with no entry (y finished from -inf to 0) counts nothing and
// sends nothing.  The product v * x is one fp32 multiply, bitwise the
// forward kernel's, so the ties are found exactly.
//
// Two launchers, each one launch per bucket group:
//   * rer_gather_max_count_launch over the forward groups: one CTA per
//     (dst interval, 32-wide feature chunk), as the forward, counts the
//     winners in a T x 32 shared int accumulator (integer atomics, exact
//     in any order) and adds it into cnt; each CTA owns its block and
//     the launches run in stream order;
//   * rer_gather_max_grad_launch over the groups of the transposed store
//     (entries (u, r, v) of tiles A_k^T, dst-sorted by the forward's
//     source interval): one CTA per (source interval, 32-wide chunk)
//     adds v * g / cnt of the winners into a T x 32 shared float
//     accumulator (atomics: the order varies, so the partial agrees with
//     the plain version to fp32 rounding) and writes its dX block.
//
// Bound on the H100: bytes, as the forward: 12 B per entry plus the
// referenced x, y, g and cnt rows.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFc = 32;  // features per CTA: one per lane

__global__ void __launch_bounds__(kThreads)
max_count_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const float* __restrict__ vals,
                 const int* __restrict__ block_col,
                 const int* __restrict__ tile_ptr,
                 const float* __restrict__ x, const float* __restrict__ y,
                 int* __restrict__ cnt, int s, int t, int f, int n_fchunks) {
  extern __shared__ int cnt_s[];  // t x kFc
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int dst = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int fcol = f0 + lane;
  const bool live = fcol < f;

  for (int e = tid; e < t * kFc; e += kThreads) cnt_s[e] = 0;
  __syncthreads();

  const float* yd = y + (size_t)dst * t * f;
  const int k_lo = tile_ptr[dst], k_hi = tile_ptr[dst + 1];
  for (int k = k_lo; k < k_hi; ++k) {
    const float* xs = x + (size_t)block_col[k] * t * f;
    const size_t base = (size_t)k * s;
    for (int e0 = warp * 32; e0 < s; e0 += kWarps * 32) {
      const int e = e0 + lane;
      int r = 0, c = 0;
      float v = 0.f;
      if (e < s) {
        r = rows[base + e];
        c = cols[base + e];
        v = vals[base + e];
      }
      if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float vj = __shfl_sync(0xffffffffu, v, j);
        const int rj = __shfl_sync(0xffffffffu, r, j);
        const int cj = __shfl_sync(0xffffffffu, c, j);
        if (vj == 0.f || !live) continue;
        if (vj * xs[(size_t)cj * f + fcol] == yd[(size_t)rj * f + fcol])
          atomicAdd(&cnt_s[rj * kFc + lane], 1);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < t * kFc; e += kThreads) {
    const int row = e / kFc, col = f0 + e % kFc;
    if (col < f) cnt[((size_t)dst * t + row) * f + col] += cnt_s[e];
  }
}

__global__ void __launch_bounds__(kThreads)
max_grad_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const int* __restrict__ block_col,
                const int* __restrict__ tile_ptr,
                const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, const int* __restrict__ cnt,
                float* __restrict__ dx, int s, int t, int f, int n_fchunks) {
  extern __shared__ float acc_s[];  // t x kFc
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int src = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int fcol = f0 + lane;
  const bool live = fcol < f;

  for (int e = tid; e < t * kFc; e += kThreads) acc_s[e] = 0.f;
  __syncthreads();

  const float* xs = x + (size_t)src * t * f;
  const int k_lo = tile_ptr[src], k_hi = tile_ptr[src + 1];
  for (int k = k_lo; k < k_hi; ++k) {
    const size_t dbase = (size_t)block_col[k] * t * f;
    const size_t base = (size_t)k * s;
    for (int e0 = warp * 32; e0 < s; e0 += kWarps * 32) {
      const int e = e0 + lane;
      int u = 0, r = 0;
      float v = 0.f;
      if (e < s) {
        u = rows[base + e];
        r = cols[base + e];
        v = vals[base + e];
      }
      if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float vj = __shfl_sync(0xffffffffu, v, j);
        const int uj = __shfl_sync(0xffffffffu, u, j);
        const int rj = __shfl_sync(0xffffffffu, r, j);
        if (vj == 0.f || !live) continue;
        const size_t d = dbase + (size_t)rj * f + fcol;
        if (vj * xs[(size_t)uj * f + fcol] == y[d])
          atomicAdd(&acc_s[uj * kFc + lane], vj * (g[d] / (float)cnt[d]));
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < t * kFc; e += kThreads) {
    const int row = e / kFc, col = f0 + e % kFc;
    if (col < f) dx[((size_t)src * t + row) * f + col] = acc_s[e];
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

extern "C" int rer_gather_max_count_launch(
    const void* rows, const void* cols, const void* vals,
    const void* block_col, const void* tile_ptr, const void* x, const void* y,
    void* cnt, int q, int s, int t, int f, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  const size_t smem = (size_t)t * kFc * sizeof(int);
  const int err = set_smem((const void*)max_count_kernel, smem);
  if (err) return err;
  max_count_kernel<<<(unsigned)q * n_fchunks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(block_col),
      static_cast<const int*>(tile_ptr), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<int*>(cnt), s, t, f,
      n_fchunks);
  return (int)cudaGetLastError();
}

extern "C" int rer_gather_max_grad_launch(
    const void* rows, const void* cols, const void* vals,
    const void* block_col, const void* tile_ptr, const void* x, const void* y,
    const void* g, const void* cnt, void* dx, int q, int s, int t, int f,
    void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  const size_t smem = (size_t)t * kFc * sizeof(float);
  const int err = set_smem((const void*)max_grad_kernel, smem);
  if (err) return err;
  max_grad_kernel<<<(unsigned)q * n_fchunks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(block_col),
      static_cast<const int*>(tile_ptr), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(g),
      static_cast<const int*>(cnt), static_cast<float*>(dx), s, t, f,
      n_fchunks);
  return (int)cudaGetLastError();
}

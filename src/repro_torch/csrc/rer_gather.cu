// RER-Gather on Hopper: the aggregate over packed edge tiles.
//
// Replaces the Pallas kernel src/repro/kernels/rer_gather/rer_gather.py::
// rer_gather (_gather_kernel_sum, _gather_kernel_max):
//
//   per packed tile k, for its S entries (row, col, val):
//     Y[br_k*T + row] (+)= val * X[bc_k*T + col]
//   pad entries are (0, 0, 0.0); max skips val == 0 and, unless
//   `finish`, keeps -inf in uncovered rows so partials merge by maximum.
//
// Bound on the H100: bytes.  Each entry costs 12 B of (row, col, val)
// and one F-wide row of X; the work is 2 operations per entry and
// feature.  Design:
//   * the reference's one-hot MXU gather is a TPU workaround: here each
//     warp loads 32 entries with one coalesced read, broadcasts them
//     with __shfl_sync, and each lane reads its feature of the referenced
//     X row directly, so only the rows the entries name are read;
//   * one CTA per (dst interval, 32-wide feature chunk) walks its
//     interval's tile span and keeps a T x 32 accumulator in shared
//     memory; it owns its output block, so global memory sees no atomics;
//   * the eight warps of a CTA share that accumulator: sum adds with
//     shared-memory float atomics (the order of the adds varies from run
//     to run, so sums agree with the plain version to fp32 rounding, not
//     bitwise); max uses a compare-and-swap float max, exact in any order;
//   * entries with val == 0 (pads, and a merged weight of 0) are skipped,
//     which is exact for sum and is the max convention;
//   * buckets reach S = 16384, so the entries are walked in chunks.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFc = 32;  // features per CTA: one per lane

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  int* ia = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(ia);
  // values only grow, so a stale read is never above the true value
  while (__int_as_float(old) < v) {
    const int assumed = old;
    old = atomicCAS(ia, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
rer_gather_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const int* __restrict__ block_col,
                  const int* __restrict__ tile_ptr,
                  const float* __restrict__ x, float* __restrict__ y,
                  int s, int t, int f, int n_fchunks, int finish) {
  extern __shared__ float acc_s[];  // t x kFc
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int dst = blockIdx.x / n_fchunks;
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int fcol = f0 + lane;
  const bool live = fcol < f;

  for (int e = tid; e < t * kFc; e += kThreads)
    acc_s[e] = kMax ? -INFINITY : 0.f;
  __syncthreads();

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
        const float m = vj * xs[(size_t)cj * f + fcol];
        if (kMax)
          atomic_max_float(&acc_s[rj * kFc + lane], m);
        else
          atomicAdd(&acc_s[rj * kFc + lane], m);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < t * kFc; e += kThreads) {
    const int row = e / kFc, col = f0 + e % kFc;
    if (col >= f) continue;
    float v = acc_s[e];
    if (kMax && finish && v == -INFINITY) v = 0.f;
    y[((size_t)dst * t + row) * f + col] = v;
  }
}

}  // namespace

extern "C" int rer_gather_launch(const void* rows, const void* cols,
                                 const void* vals, const void* block_col,
                                 const void* tile_ptr, const void* x, void* y,
                                 int q, int s, int t, int f, int op_max,
                                 int finish, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  const size_t smem = (size_t)t * kFc * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rr = static_cast<const int*>(rows);
  const int* cc = static_cast<const int*>(cols);
  const float* vv = static_cast<const float*>(vals);
  const int* bc = static_cast<const int*>(block_col);
  const int* tp = static_cast<const int*>(tile_ptr);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  const dim3 grid((unsigned)q * n_fchunks);
  if (op_max) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(rer_gather_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    rer_gather_kernel<true><<<grid, kThreads, smem, st>>>(
        rr, cc, vv, bc, tp, xx, yy, s, t, f, n_fchunks, finish);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(rer_gather_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    rer_gather_kernel<false><<<grid, kThreads, smem, st>>>(
        rr, cc, vv, bc, tp, xx, yy, s, t, f, n_fchunks, finish);
  }
  return (int)cudaGetLastError();
}

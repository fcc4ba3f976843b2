// Fused linear + activation on Hopper: Y = act(X @ W + b).
//
// Replaces the Pallas kernel
// src/repro/kernels/feature_update/feature_update.py::fused_linear_act_kernel
// (the feature-extraction / update stage with its XPE epilogue fused):
// act is relu, sigmoid or tanh, anything else the identity, applied with
// the bias on the output tile once its K loop is done, so the
// pre-activation never goes back to device memory.
//
// Bound on the H100: operations at the update stage's shapes (pubmed:
// N = 19,717 rows, K = 500..564, H = 64 is 2 N K H = 1.3-1.4 GFLOP against
// 40-45 MB, about 30 operations per byte, over the CUDA cores' balance
// point of 20).  Design: a tiled fp32 GEMM on the CUDA cores (the
// reference contracts in f32 and Hopper's tensor cores have no IEEE fp32
// mode), no library GEMM:
//   * one CTA of 256 threads per 64 x 64 output tile, a K loop in steps
//     of 16 through shared memory (X tile stored k-major, so the inner
//     loop reads it as a broadcast);
//   * each thread owns a 4 x 4 block of outputs, rows ty + 16 i and
//     columns tx + 16 j, so the epilogue's stores are coalesced;
//   * ragged N, K and H are masked at the edge: nothing is padded (the
//     reference's wrapper pads to its tile sizes instead).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBm = 64, kBn = 64, kBk = 16;
constexpr int kT = 16;                 // threads along each output side
constexpr int kPer = kBm / kT;         // 4 outputs per thread per side

template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if (kAct == 1) return fmaxf(v, 0.f);
  if (kAct == 2) return 1.f / (1.f + expf(-v));
  if (kAct == 3) return tanhf(v);
  return v;
}

template <int kAct>
__global__ void __launch_bounds__(kThreads)
linear_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int n, int k, int h) {
  __shared__ float x_s[kBk][kBm + 4];
  __shared__ float w_s[kBk][kBn];
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const int row0 = blockIdx.y * kBm, col0 = blockIdx.x * kBn;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBk) {
#pragma unroll
    for (int l = 0; l < kBm * kBk / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kBk, kk = e % kBk;
      const int gr = row0 + r, gk = k0 + kk;
      x_s[kk][r] = (gr < n && gk < k) ? x[(size_t)gr * k + gk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kBk * kBn / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / kBn, c = e % kBn;
      const int gk = k0 + kk, gc = col0 + c;
      w_s[kk][c] = (gk < k && gc < h) ? w[(size_t)gk * h + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBk; ++kk) {
      float a[kPer], bb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = x_s[kk][ty + kT * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) bb[j] = w_s[kk][tx + kT * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + kT * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + kT * j;
      if (c < h) y[(size_t)r * h + c] = activate<kAct>(acc[i][j] + b[c]);
    }
  }
}

}  // namespace

extern "C" int feature_update_launch(const void* x, const void* w,
                                     const void* b, void* y, int n, int k,
                                     int h, int act, void* stream) {
  if (n == 0 || h == 0) return (int)cudaGetLastError();
  const dim3 grid((h + kBn - 1) / kBn, (n + kBm - 1) / kBm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  const float* bb = static_cast<const float*>(b);
  float* yy = static_cast<float*>(y);
  switch (act) {
    case 1:
      linear_act_kernel<1><<<grid, kThreads, 0, s>>>(xx, ww, bb, yy, n, k, h);
      break;
    case 2:
      linear_act_kernel<2><<<grid, kThreads, 0, s>>>(xx, ww, bb, yy, n, k, h);
      break;
    case 3:
      linear_act_kernel<3><<<grid, kThreads, 0, s>>>(xx, ww, bb, yy, n, k, h);
      break;
    default:
      linear_act_kernel<0><<<grid, kThreads, 0, s>>>(xx, ww, bb, yy, n, k, h);
  }
  return (int)cudaGetLastError();
}

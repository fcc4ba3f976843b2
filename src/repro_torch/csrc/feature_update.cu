// Fused linear + activation on Hopper: Y = act(X @ W + b).
//
// Replaces the Pallas kernel
// src/repro/kernels/feature_update/feature_update.py::fused_linear_act_kernel
// (the feature-extraction / update stage with its XPE epilogue fused):
// act is relu, sigmoid or tanh, anything else the identity, applied with
// the bias in registers on the finished output tile, so the
// pre-activation never goes back to device memory.
//
// Bound on the H100: operations at the update stage's shapes (pubmed:
// N = 19,717 rows, K = 500..564, H = 64 is 2 N K H = 1.3-1.4 GFLOP against
// 40-45 MB, about 30 operations per byte, over the CUDA cores' balance
// point of 20).  A CUDA-core SGEMM (the reference contracts in f32 and
// Hopper's tensor cores have no IEEE fp32 mode), no library GEMM, built
// for the tall, narrow update stage:
//   * one CTA of 256 threads per BM x 64 output tile, BM = 32 RM; each
//     thread owns RM contiguous rows x 8 columns (two runs of 4, at c and
//     c + 32) in registers.  Per 4-deep k step a thread reads RM float4
//     of X (4 k values of a row) and 8 float4 of W (LDS.128 each) for
//     32 RM FMAs;
//   * RM is chosen at launch from N and the SM count so that the
//     busiest SM computes the fewest rows (pubmed: RM = 5, 124 tiles of
//     160 rows, one per SM, against 309 tiles of 64 rows before);
//   * X and W stream through a ring of three 64-deep k stages (172 KB of
//     shared memory at RM = 5) filled by cp.async (16-byte copies when K
//     and H are multiples of 4 and the pointers 16-byte aligned, 4-byte
//     copies otherwise), so the next stages' copies are in flight during
//     this stage's FMAs (on an NVIDIA H100 80GB HBM3 at 700 W, 64-deep
//     stages measured 8% faster than 32-deep ones, and four or five
//     32-deep stages no faster than three); the ragged k tail, rows past
//     N and columns past H are zero-filled by the copy (src-size 0),
//     never read from device memory;
//   * each output is one fmaf chain over k in order, bias added after;
//   * X stays row-major in shared memory (no transpose on the store); a
//     row's 16-byte chunks are XOR-swizzled by the owning thread row, so
//     the four rows a warp reads at once sit in four bank groups;
//   * the epilogue stores each row's 8 columns as two float4: a warp
//     writes four rows' 128-byte runs per store, whole sectors, so the
//     stores are coalesced without a pass through shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCn = 8;                 // output columns per thread
constexpr int kBn = 64;                // output columns per CTA
constexpr int kTx = kBn / kCn;         // threads along H
constexpr int kTy = 32;                // thread rows along N
constexpr int kThreads = kTx * kTy;
constexpr int kBk = 64;                // k per stage
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return 1.f / (1.f + expf(-v));
  if (act == 3) return tanhf(v);
  return v;
}

// Float offset of X's element (r, k) in a stage: rows of kBk floats,
// 16-byte chunk k / 4 swizzled by the thread row that reads the row.
template <int RM>
__device__ __forceinline__ int x_at(int r, int k) {
  return r * kBk + 4 * ((k >> 2) ^ ((r / RM) & 7)) + (k & 3);
}

// Copies of one k stage: X rows row0.. of the tile and W rows k0.. of
// columns col0.., zero past N, K and H.
template <int RM, bool kVec>
__device__ __forceinline__ void load_stage(float* xs, float* ws,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int n, int k, int h, int row0,
                                           int col0, int k0, int tid) {
  constexpr int kBm = RM * kTy;
  if (kVec) {
    for (int i = tid; i < kBm * (kBk / 4); i += kThreads) {
      const int r = i / (kBk / 4), kk = 4 * (i % (kBk / 4));
      const bool in = row0 + r < n && k0 + kk < k;
      cp_async16(xs + x_at<RM>(r, kk),
                 in ? x + (size_t)(row0 + r) * k + k0 + kk : x, in);
    }
    for (int i = tid; i < kBk * (kBn / 4); i += kThreads) {
      const int r = i / (kBn / 4), c = 4 * (i % (kBn / 4));
      const bool in = k0 + r < k && col0 + c < h;
      cp_async16(ws + r * kBn + c, in ? w + (size_t)(k0 + r) * h + col0 + c
                                      : w, in);
    }
  } else {
    for (int i = tid; i < kBm * kBk; i += kThreads) {
      const int r = i / kBk, kk = i % kBk;
      const bool in = row0 + r < n && k0 + kk < k;
      cp_async4(xs + x_at<RM>(r, kk),
                in ? x + (size_t)(row0 + r) * k + k0 + kk : x, in);
    }
    for (int i = tid; i < kBk * kBn; i += kThreads) {
      const int r = i / kBn, c = i % kBn;
      const bool in = k0 + r < k && col0 + c < h;
      cp_async4(ws + r * kBn + c, in ? w + (size_t)(k0 + r) * h + col0 + c
                                     : w, in);
    }
  }
}

template <int RM, bool kVec>
__global__ void __launch_bounds__(kThreads)
linear_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y, int n,
                  int k, int h, int act) {
  constexpr int kBm = RM * kTy;
  extern __shared__ __align__(16) float smem[];
  float* xs0 = smem;                              // kStages x kBm x kBk
  float* ws0 = smem + kStages * kBm * kBk;        // kStages x kBk x kBn
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int row0 = blockIdx.x * kBm, col0 = blockIdx.y * kBn;
  const int n_k = (k + kBk - 1) / kBk;

  // each output is one fmaf chain over k = 0 .. K-1, bias added after
  float acc[RM][kCn];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kCn; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage<RM, kVec>(xs0 + s * kBm * kBk, ws0 + s * kBk * kBn, x, w, n,
                           k, h, row0, col0, s * kBk, tid);
    cp_commit();
  }

  const int swz = ty & 7;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    // the slot read at kt - 1 is free once every thread passed the sync
    const int pre = kt + kStages - 1;
    if (pre < n_k) {
      const int slot = pre % kStages;
      load_stage<RM, kVec>(xs0 + slot * kBm * kBk, ws0 + slot * kBk * kBn,
                           x, w, n, k, h, row0, col0, pre * kBk, tid);
    }
    cp_commit();
    const int slot = kt % kStages;
    const float* xs = xs0 + slot * kBm * kBk + (ty * RM) * kBk;
    const float* ws = ws0 + slot * kBk * kBn + tx * 4;
#pragma unroll
    for (int kc = 0; kc < kBk / 4; ++kc) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + i * kBk +
                                                4 * (kc ^ swz));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // columns tx * 4 + 32 q + (0..3): a warp's float4 reads of a W
        // row fall in distinct bank groups
        float bv[kCn];
#pragma unroll
        for (int q = 0; q < kCn / 4; ++q) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              ws + (4 * kc + j) * kBn + 32 * q);
          bv[4 * q] = b4.x;
          bv[4 * q + 1] = b4.y;
          bv[4 * q + 2] = b4.z;
          bv[4 * q + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = j == 0 ? a[i].x : j == 1 ? a[i].y
                         : j == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int c = 0; c < kCn; ++c) acc[i][c] = fmaf(av, bv[c], acc[i][c]);
        }
      }
    }
  }
  cp_wait<0>();

  // columns col0 + tx * 4 + 32 q + (0..3)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty * RM + i;
    if (r >= n) break;
    float* yr = y + (size_t)r * h;
#pragma unroll
    for (int q = 0; q < kCn / 4; ++q) {
      const int c = col0 + tx * 4 + 32 * q;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = activate(acc[i][4 * q + j] + (c + j < h ? b[c + j] : 0.f),
                        act);
      if (kVec) {
        if (c < h)
          *reinterpret_cast<float4*>(yr + c) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < h) yr[c + j] = v[j];
      }
    }
  }
}

template <int RM, bool kVec>
void launch(const float* x, const float* w, const float* b, float* y, int n,
            int k, int h, int act, cudaStream_t st) {
  constexpr int kBm = RM * kTy;
  const size_t smem = sizeof(float) * kStages * (kBm * kBk + kBk * kBn);
  static bool smem_set = false;
  if (!smem_set) {
    cudaFuncSetAttribute(linear_act_kernel<RM, kVec>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_set = true;
  }
  const dim3 grid((unsigned)((n + kBm - 1) / kBm),
                  (unsigned)((h + kBn - 1) / kBn));
  linear_act_kernel<RM, kVec><<<grid, kThreads, smem, st>>>(x, w, b, y, n, k,
                                                            h, act);
}

template <bool kVec>
void dispatch(int rm, const float* x, const float* w, const float* b,
              float* y, int n, int k, int h, int act, cudaStream_t st) {
  switch (rm) {
    case 2:
      launch<2, kVec>(x, w, b, y, n, k, h, act, st);
      break;
    case 4:
      launch<4, kVec>(x, w, b, y, n, k, h, act, st);
      break;
    default:
      launch<5, kVec>(x, w, b, y, n, k, h, act, st);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Rows per thread: the fewest rows on the busiest SM, ceil(tiles / SMs)
// tiles of 32 RM rows each; a tie takes the larger tile (W read fewer
// times).
int rows_per_thread(int n, int col_tiles) {
  const int sms = sm_count();
  const int choices[] = {2, 4, 5};
  int best = 2;
  long long best_rows = -1;
  for (int rm : choices) {
    const long long tiles = (long long)((n + rm * kTy - 1) / (rm * kTy)) *
                            col_tiles;
    const long long rows = (tiles + sms - 1) / sms * rm * kTy;
    if (best_rows < 0 || rows <= best_rows) {
      best = rm;
      best_rows = rows;
    }
  }
  return best;
}

}  // namespace

extern "C" int feature_update_launch(const void* x, const void* w,
                                     const void* b, void* y, int n, int k,
                                     int h, int act, void* stream) {
  if (n == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  const float* bb = static_cast<const float*>(b);
  float* yy = static_cast<float*>(y);
  const bool vec = k % 4 == 0 && h % 4 == 0 && (size_t)xx % 16 == 0 &&
                   (size_t)ww % 16 == 0 && (size_t)yy % 16 == 0;
  const int rm = rows_per_thread(n, (h + kBn - 1) / kBn);
  if (vec)
    dispatch<true>(rm, xx, ww, bb, yy, n, k, h, act, st);
  else
    dispatch<false>(rm, xx, ww, bb, yy, n, k, h, act, st);
  return (int)cudaGetLastError();
}

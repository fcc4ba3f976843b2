// R-GCN's typed projection over the (src, relation) pairs that send, on
// Hopper:  Y[p] = X[pair_src[p]] @ W[rel(p)]  for every pair p, with its
// two gradients  dW[r] = X[pair_src_r]^T dY_r  and  dX += dY_r W_r^T
// scattered to pair_src.
//
// Replaces no TPU kernel: the reference projects every vertex under every
// relation with one XLA einsum, (N, F) x (R, F, H) -> (N, R*H), in
// src/repro/core/models.py::RGCNLayer.src_payload, and its typed flat
// entries then read one H-wide slice each.  On a large typed
// graph few (src, relation) pairs send (AM: 8,053,434 of N R =
// 443.4 M, 1.8%), so the port projects only those, once each, and the
// aggregate gathers Y[gpair[e]] per entry.
//
// Bound on the H100: bytes.  Each pair reads its X row once (AM layer 1:
// 8.05 M rows of 267 fp32 = 8.6 GB, 2.6 ms at 3.35 TB/s) for F H fused
// multiply-adds (43 GFLOP, 0.64 ms at 67 TFLOP/s); W_r is a few KB and
// stays on chip.  fp32 throughout, each output one fmaf chain.
//
// The pairs are sorted by relation, then by source; the host cuts each
// relation's run into blocks (rel, start, end) of at most kRows pairs
// (the projection and dX) or any length (dW), so a CTA works inside one
// relation and stages only its W_r.
//   * project: one CTA of 128 threads per block of <= 128 pairs and
//     H-chunk of HC outputs (HC in {4, 8, 12, 16}).  X is gathered in
//     32-feature stages, a warp copying one pair's 128-byte run of a row
//     per instruction (cp.async, zero-filled past F), two stages in
//     flight; the W_r stage (32 x HC) sits beside it.  Thread t then
//     owns pair t: each k is one shared load of its row (stride 33: no
//     bank conflict) and HC/4 broadcast float4 loads of W.
//   * grad_w: one CTA per (block, 512-feature slice, H-chunk), all HC
//     outputs in registers; for F of 128 or more thread t owns features
//     t + 128 j (j < 4) of its slice, 16 pairs a stage, and for a narrower
//     F (AM layer 2: F = 10) feature t % F and every (128 / F)-th pair
//     of a stage of up to 128 pairs.  The stages' X slice rows and dY
//     rows come by cp.async, two stages in flight; each thread's partial
//     of dW_r is added to device memory with one atomic per element.  The
//     host cuts dW's blocks at 2,048 pairs, so the atomics are few (AM
//     layer 1: 3,990 CTAs of 2,670 each).
//   * grad_x: one CTA per (block of <= 128 pairs, H-chunk, 256-feature
//     slice); the block's dY rows and W_r's slice in shared memory (W
//     rows at an odd stride), then the (pair, feature) items in order,
//     each an fmaf chain over the H-chunk and one atomic add into dX.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 128;          // pairs of a project / grad_x block
constexpr int kK = 32;              // features of a project stage
constexpr int kXs = kK + 1;         // row stride of a project X stage
constexpr int kWStage = 16;         // pairs of a grad_w stage
constexpr int kWSlice = 4 * kThreads;   // features of a grad_w CTA
constexpr int kFc = 256;            // features of a grad_x CTA

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

// One project stage: features k0.. of the block's X rows (src < 0: a row
// past the block, zero-filled) and of W_r's columns h0.. .
template <int HC>
__device__ __forceinline__ void project_stage(
    float* xs, float* ws, const int* s_src, const float* __restrict__ x,
    const float* __restrict__ wr, int f, int h, int h0, int k0, int t) {
  const int lane = t & 31;
  for (int i = t >> 5; i < kRows; i += kThreads / 32) {
    const int src = s_src[i];
    const bool in = src >= 0 && k0 + lane < f;
    cp_async4(xs + i * kXs + lane, in ? x + (size_t)src * f + k0 + lane : x,
              in);
  }
  for (int i = t; i < kK * HC; i += kThreads) {
    const int kk = i / HC, c = i % HC;
    const bool in = k0 + kk < f && h0 + c < h;
    cp_async4(ws + i, in ? wr + (size_t)(k0 + kk) * h + h0 + c : wr, in);
  }
}

template <int HC>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ pair_src,
               const int* __restrict__ blocks, float* __restrict__ y, int f,
               int h) {
  __shared__ float xs[2][kRows * kXs];
  __shared__ __align__(16) float ws[2][kK * HC];
  __shared__ int s_src[kRows];
  const int t = threadIdx.x;
  const int rel = blocks[3 * blockIdx.x], p0 = blocks[3 * blockIdx.x + 1];
  const int np = blocks[3 * blockIdx.x + 2] - p0;
  const int h0 = blockIdx.y * HC;
  const float* wr = w + (size_t)rel * f * h;
  s_src[t] = t < np ? pair_src[p0 + t] : -1;
  __syncthreads();

  float acc[HC];
#pragma unroll
  for (int c = 0; c < HC; ++c) acc[c] = 0.f;
  const int n_k = (f + kK - 1) / kK;
  project_stage<HC>(xs[0], ws[0], s_src, x, wr, f, h, h0, 0, t);
  cp_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    // the slot filled here was last read in kt - 1, before its closing
    // barrier
    if (kt + 1 < n_k)
      project_stage<HC>(xs[(kt + 1) & 1], ws[(kt + 1) & 1], s_src, x, wr, f,
                        h, h0, (kt + 1) * kK, t);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* xr = xs[kt & 1] + t * kXs;
    const float* wv = ws[kt & 1];
    const int kn = min(kK, f - kt * kK);     // the stage's real features
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      const float xv = xr[kk];
#pragma unroll
      for (int c = 0; c < HC / 4; ++c) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wv + kk * HC + 4 * c);
        acc[4 * c] = fmaf(xv, w4.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(xv, w4.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(xv, w4.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(xv, w4.w, acc[4 * c + 3]);
      }
    }
    __syncthreads();
  }
  if (t < np) {
    float* yr = y + (size_t)(p0 + t) * h + h0;
#pragma unroll
    for (int c = 0; c < HC; ++c)
      if (h0 + c < h) yr[c] = acc[c];
  }
}

// Pairs of a grad_w stage: kWStage where threads own whole features (F of
// 128 or more; a narrower last slice leaves threads idle), else (kNarrow:
// F < 128, each feature shared by 128 / F threads, each taking a share of
// the stage's pairs) as many as kWStage rows of 128 features hold, up to
// kRows.
template <bool kNarrow>
__host__ __device__ __forceinline__ int grad_w_rows(int fs) {
  if (!kNarrow) return kWStage;
  const int rows = kWStage * kThreads / ((fs + 3) & ~3);
  return rows < kRows ? rows : kRows;
}

// One grad_w stage: pairs p.. (up to `rows`, none at or past p1), their X
// rows at features f0 .. f0 + fs and their dY rows at columns h0.. .
template <int HC, bool kNarrow>
__device__ __forceinline__ void grad_w_stage(
    float* xs, float* dys, const float* __restrict__ x,
    const float* __restrict__ dy, const int* __restrict__ pair_src, int p,
    int p1, int rows, int f, int h, int f0, int fs, int fsp, int h0, int t) {
  if (!kNarrow) {
    for (int i = 0; i < kWStage; ++i) {
      const bool row = p + i < p1;
      const int src = row ? __ldg(pair_src + p + i) : 0;
      for (int kk = t; kk < fs; kk += kThreads)
        cp_async4(xs + i * fsp + kk,
                  row ? x + (size_t)src * f + f0 + kk : x, row);
    }
  } else {
    // narrow rows: the (row, feature) items in order, a row's run apiece
    for (int idx = t; idx < rows * fs; idx += kThreads) {
      const int i = idx / fs, kk = idx - i * fs;
      const bool row = p + i < p1;
      const int src = row ? __ldg(pair_src + p + i) : 0;
      cp_async4(xs + i * fsp + kk,
                row ? x + (size_t)src * f + f0 + kk : x, row);
    }
  }
  for (int i = t; i < rows * HC; i += kThreads) {
    const int r = i / HC, c = i % HC;
    const bool in = p + r < p1 && h0 + c < h;
    cp_async4(dys + i, in ? dy + (size_t)(p + r) * h + h0 + c : dy, in);
  }
}

// One pair's outer product into a thread's accumulators: its features
// k0 + kThreads j (j < J) of the X row `xr` times the HC columns of `dr`.
template <int HC, int J>
__device__ __forceinline__ void grad_w_row(
    float (&acc)[kWSlice / kThreads][HC], const float* xr, const float* dr,
    int k0, int fs) {
  float d[HC];
#pragma unroll
  for (int c = 0; c < HC / 4; ++c) {
    const float4 d4 = *reinterpret_cast<const float4*>(dr + 4 * c);
    d[4 * c] = d4.x;
    d[4 * c + 1] = d4.y;
    d[4 * c + 2] = d4.z;
    d[4 * c + 3] = d4.w;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = k0 + kThreads * j;
    if (k < fs) {
      const float xv = xr[k];
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[j][c] = fmaf(xv, d[c], acc[j][c]);
    }
  }
}

template <int HC, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
grad_w_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ pair_src,
              const int* __restrict__ blocks, float* __restrict__ dw, int f,
              int h) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kJ = kNarrow ? 1 : kWSlice / kThreads;
  const int t = threadIdx.x;
  const int rel = blocks[3 * blockIdx.x], p0 = blocks[3 * blockIdx.x + 1];
  const int p1 = blocks[3 * blockIdx.x + 2];
  const int f0 = blockIdx.y * kWSlice;
  const int fs = min(kWSlice, f - f0);
  const int fsp = (fs + 3) & ~3;
  const int h0 = blockIdx.z * HC;
  const int rows = grad_w_rows<kNarrow>(fs);
  // wide: thread t owns features t + kThreads j and every pair; narrow:
  // feature t % fs and the pairs grp, grp + groups, ...
  const int groups = kNarrow ? kThreads / fs : 1;
  const int grp = kNarrow ? t / fs : 0;
  const int k0 = t - grp * fs;
  float* xs0 = smem;                           // 2 x rows x fsp
  float* dys0 = smem + 2 * rows * fsp;         // 2 x rows x HC

  float acc[kWSlice / kThreads][HC];
#pragma unroll
  for (int j = 0; j < kWSlice / kThreads; ++j)
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[j][c] = 0.f;
  const int n_st = (p1 - p0 + rows - 1) / rows;
  grad_w_stage<HC, kNarrow>(xs0, dys0, x, dy, pair_src, p0, p1, rows, f, h,
                            f0, fs, fsp, h0, t);
  cp_commit();
  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st)
      grad_w_stage<HC, kNarrow>(xs0 + ((s + 1) & 1) * rows * fsp,
                                dys0 + ((s + 1) & 1) * rows * HC, x, dy,
                                pair_src, p0 + (s + 1) * rows, p1, rows, f,
                                h, f0, fs, fsp, h0, t);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* xb = xs0 + (s & 1) * rows * fsp;
    const float* db = dys0 + (s & 1) * rows * HC;
    if (!kNarrow) {
#pragma unroll 4
      for (int i = 0; i < kWStage; ++i)
        grad_w_row<HC, kJ>(acc, xb + i * fsp, db + i * HC, k0, fs);
    } else if (grp < groups) {
      for (int i = grp; i < rows; i += groups)
        grad_w_row<HC, kJ>(acc, xb + i * fsp, db + i * HC, k0, fs);
    }
    __syncthreads();
  }
  if (grp >= groups) return;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int k = k0 + kThreads * j;
    if (k >= fs) break;
    float* out = dw + ((size_t)rel * f + f0 + k) * h + h0;
#pragma unroll
    for (int c = 0; c < HC; ++c)
      if (h0 + c < h) atomicAdd(out + c, acc[j][c]);
  }
}

template <int HC>
__global__ void __launch_bounds__(kThreads)
grad_x_kernel(const float* __restrict__ dy, const float* __restrict__ w,
              const int* __restrict__ pair_src,
              const int* __restrict__ blocks, float* __restrict__ dx, int f,
              int h) {
  __shared__ float dys[kRows * HC];
  __shared__ float ws[kFc * (HC + 1)];
  __shared__ int s_src[kRows];
  const int t = threadIdx.x;
  const int rel = blocks[3 * blockIdx.x], p0 = blocks[3 * blockIdx.x + 1];
  const int np = blocks[3 * blockIdx.x + 2] - p0;
  const int h0 = blockIdx.y * HC;
  const int f0 = blockIdx.z * kFc;
  const int fc = min(kFc, f - f0);
  const float* wr = w + (size_t)rel * f * h;
  s_src[t] = t < np ? pair_src[p0 + t] : 0;
  for (int i = t; i < kRows * HC; i += kThreads) {
    const int r = i / HC, c = i % HC;
    dys[i] = r < np && h0 + c < h ? dy[(size_t)(p0 + r) * h + h0 + c] : 0.f;
  }
  for (int i = t; i < fc * HC; i += kThreads) {
    const int k = i / HC, c = i % HC;
    ws[k * (HC + 1) + c] =
        h0 + c < h ? wr[(size_t)(f0 + k) * h + h0 + c] : 0.f;
  }
  __syncthreads();
  for (int i = t; i < np * fc; i += kThreads) {
    const int r = i / fc, k = i % fc;
    const float* d = dys + r * HC;
    const float* wk = ws + k * (HC + 1);
    float g = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) g = fmaf(d[c], wk[c], g);
    atomicAdd(dx + (size_t)s_src[r] * f + f0 + k, g);
  }
}

// The H-chunk: the fewest of 4, 8, 12 or 16 columns that holds H, else 16.
int chunk_of(int h) { return h <= 4 ? 4 : h <= 8 ? 8 : h <= 12 ? 12 : 16; }

// A launch's stages: F of 128 or more takes kWStage rows of the widest
// slice, a narrow F (one slice) grad_w_rows<true> of its width.
size_t grad_w_smem(int f, int hc) {
  const int fs = f < kWSlice ? f : kWSlice;
  const int rows = f < kThreads ? grad_w_rows<true>(fs) : kWStage;
  return sizeof(float) * 2 * rows * (((fs + 3) & ~3) + hc);
}

template <int HC>
void project(const float* x, const float* w, const int* src, const int* blk,
             int nblk, float* y, int f, int h, cudaStream_t st) {
  const dim3 grid((unsigned)nblk, (unsigned)((h + HC - 1) / HC));
  project_kernel<HC><<<grid, kThreads, 0, st>>>(x, w, src, blk, y, f, h);
}

template <int HC, bool kNarrow>
void grad_w_as(const float* x, const float* dy, const int* src,
               const int* blk, int nblk, float* dw, int f, int h,
               cudaStream_t st) {
  const size_t smem = grad_w_smem(f, HC);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(grad_w_kernel<HC, kNarrow>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((unsigned)nblk, (unsigned)((f + kWSlice - 1) / kWSlice),
                  (unsigned)((h + HC - 1) / HC));
  grad_w_kernel<HC, kNarrow><<<grid, kThreads, smem, st>>>(x, dy, src, blk,
                                                           dw, f, h);
}

template <int HC>
void grad_w(const float* x, const float* dy, const int* src, const int* blk,
            int nblk, float* dw, int f, int h, cudaStream_t st) {
  if (f < kThreads)
    grad_w_as<HC, true>(x, dy, src, blk, nblk, dw, f, h, st);
  else
    grad_w_as<HC, false>(x, dy, src, blk, nblk, dw, f, h, st);
}

template <int HC>
void grad_x(const float* dy, const float* w, const int* src, const int* blk,
            int nblk, float* dx, int f, int h, cudaStream_t st) {
  const dim3 grid((unsigned)nblk, (unsigned)((h + HC - 1) / HC),
                  (unsigned)((f + kFc - 1) / kFc));
  grad_x_kernel<HC><<<grid, kThreads, 0, st>>>(dy, w, src, blk, dx, f, h);
}

}  // namespace

// y (P, H) = x[pair_src] @ w[rel], blocks (nblk, 3) of <= 128 pairs.
extern "C" int typed_pairs_project_launch(const void* x, const void* w,
                                          const void* pair_src,
                                          const void* blocks, int nblk,
                                          void* y, int f, int h,
                                          void* stream) {
  if (nblk == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  const int* ss = static_cast<const int*>(pair_src);
  const int* bb = static_cast<const int*>(blocks);
  float* yy = static_cast<float*>(y);
  switch (chunk_of(h)) {
    case 4: project<4>(xx, ww, ss, bb, nblk, yy, f, h, st); break;
    case 8: project<8>(xx, ww, ss, bb, nblk, yy, f, h, st); break;
    case 12: project<12>(xx, ww, ss, bb, nblk, yy, f, h, st); break;
    default: project<16>(xx, ww, ss, bb, nblk, yy, f, h, st);
  }
  return (int)cudaGetLastError();
}

// dw (R, F, H) += x[pair_src]^T dy per relation; dw zeroed by the caller.
extern "C" int typed_pairs_grad_w_launch(const void* x, const void* dy,
                                         const void* pair_src,
                                         const void* blocks, int nblk,
                                         void* dw, int f, int h,
                                         void* stream) {
  if (nblk == 0 || h == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  const float* dd = static_cast<const float*>(dy);
  const int* ss = static_cast<const int*>(pair_src);
  const int* bb = static_cast<const int*>(blocks);
  float* ww = static_cast<float*>(dw);
  switch (chunk_of(h)) {
    case 4: grad_w<4>(xx, dd, ss, bb, nblk, ww, f, h, st); break;
    case 8: grad_w<8>(xx, dd, ss, bb, nblk, ww, f, h, st); break;
    case 12: grad_w<12>(xx, dd, ss, bb, nblk, ww, f, h, st); break;
    default: grad_w<16>(xx, dd, ss, bb, nblk, ww, f, h, st);
  }
  return (int)cudaGetLastError();
}

// dx (N, F) += dy W_rel^T at pair_src; blocks of <= 128 pairs, dx zeroed
// by the caller.
extern "C" int typed_pairs_grad_x_launch(const void* dy, const void* w,
                                         const void* pair_src,
                                         const void* blocks, int nblk,
                                         void* dx, int f, int h,
                                         void* stream) {
  if (nblk == 0 || h == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dd = static_cast<const float*>(dy);
  const float* ww = static_cast<const float*>(w);
  const int* ss = static_cast<const int*>(pair_src);
  const int* bb = static_cast<const int*>(blocks);
  float* xx = static_cast<float*>(dx);
  switch (chunk_of(h)) {
    case 4: grad_x<4>(dd, ww, ss, bb, nblk, xx, f, h, st); break;
    case 8: grad_x<8>(dd, ww, ss, bb, nblk, xx, f, h, st); break;
    case 12: grad_x<12>(dd, ww, ss, bb, nblk, xx, f, h, st); break;
    default: grad_x<16>(dd, ww, ss, bb, nblk, xx, f, h, st);
  }
  return (int)cudaGetLastError();
}

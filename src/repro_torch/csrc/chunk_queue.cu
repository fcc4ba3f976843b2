// Chunk-queue walker on Hopper: the streamed executor's device-resident
// sum sweep over a ragged tile queue.
//
// Replaces the Pallas kernel src/repro/kernels/chunk_queue/chunk_queue.py::
// chunk_queue_spmm (_queue_kernel):
//
//   Y[i*T + r, :] = act( sum over the tiles k of dst interval i
//                        [tile_ptr[i], tile_ptr[i+1]) and their entries
//                        e in [entry_ptr[k], entry_ptr[k+1]) with
//                        rows[e] == r of  vals[e] * X[tile_src[k]*T + cols[e]] )
//   act is the identity, or relu when `relu` is set; sum only.
//
// Layout.  The reference pads every tile to one store-wide pow2 bucket
// S, a (K, S) queue; after the degree sort the hub tile sets S for all
// tiles, and on the synthD stand-in that layout is 13.7 GB at 65,536
// vertices where the real entries are 12.3 MB.  This kernel walks the
// entries ragged: `entry_ptr` (K+1) over the packed store's flat,
// dst-sorted (row_local, col_local, val) arrays, 12 B per real entry.
//
// Bound on the H100: bytes.  Each entry costs its 12 B and one F-wide
// row of X; the work is 2 operations per entry and feature.  Design:
//   * the work is cut into segments of at most a few thousand entries,
//     each inside one destination interval (`segments`, built on the
//     host with the queue): after the degree sort the hub interval holds
//     a fifth of all entries, and one CTA walking it alone took most of
//     the sweep, so its span is split across many CTAs;
//   * one CTA per (segment, 32-wide feature chunk) keeps a T x 32
//     accumulator in shared memory; a segment that is its interval's
//     only one stores its block (with relu, when asked); the segments of
//     a split interval add theirs into the zeroed output with global
//     atomics, and relu then runs as a second pass;
//   * an interval's tiles, and so their entries, are contiguous: the
//     CTA's eight warps split the segment 32 entries at a time whatever
//     the tile sizes (most tiles hold a few entries, the hub's tens of
//     thousands); each lane finds its entry's tile by a binary search of
//     `entry_ptr` over the interval's span;
//   * each warp broadcasts its 32 entries with __shfl_sync and each
//     lane reads its feature of the referenced X row directly, so only
//     the rows the entries name are read (the reference's one-hot MXU
//     gather is a TPU workaround);
//   * the warps merge into the accumulator with shared-memory float
//     atomics: the order of the adds varies from run to run, so sums
//     agree with the plain version to fp32 rounding, not bitwise;
//   * only rows below n are written, so X and Y keep their n rows.
// Not done yet (later speed work): the reference's double-buffered copy
// of the next entries (cp.async / TMA with mbarriers).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFc = 32;  // features per CTA: one per lane

__global__ void __launch_bounds__(kThreads)
chunk_queue_kernel(const int* __restrict__ tile_ptr,
                   const int* __restrict__ tile_src,
                   const int* __restrict__ entry_ptr,
                   const int* __restrict__ rows, const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const int* __restrict__ segments,
                   const float* __restrict__ x, float* __restrict__ y,
                   int n, int t, int f, int n_fchunks, int relu) {
  extern __shared__ float acc_s[];  // t x kFc
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* seg = segments + 4 * (blockIdx.x / n_fchunks);
  const int dst = seg[0], e_lo = seg[1], e_hi = seg[2], split = seg[3];
  const int f0 = (blockIdx.x % n_fchunks) * kFc;
  const int fcol = f0 + lane;
  const bool live = fcol < f;

  for (int e = tid; e < t * kFc; e += kThreads) acc_s[e] = 0.f;
  __syncthreads();

  const int k_lo = tile_ptr[dst], k_hi = tile_ptr[dst + 1];
  for (int e0 = e_lo + warp * 32; e0 < e_hi; e0 += kWarps * 32) {
    const int e = e0 + lane;
    int r = 0, src_row = 0;
    float v = 0.f;
    if (e < e_hi) {
      // the tile holding entry e: the last k of the span whose first
      // entry is at or before e (empty tiles share a start and lose)
      int lo = k_lo, hi = k_hi - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (entry_ptr[mid] <= e) lo = mid; else hi = mid - 1;
      }
      r = rows[e];
      src_row = tile_src[lo] * t + cols[e];
      v = vals[e];
    }
    const int cnt = min(32, e_hi - e0);  // the same for the whole warp
    for (int j = 0; j < cnt; ++j) {
      const float vj = __shfl_sync(0xffffffffu, v, j);
      const int rj = __shfl_sync(0xffffffffu, r, j);
      const int sj = __shfl_sync(0xffffffffu, src_row, j);
      if (live)
        atomicAdd(&acc_s[rj * kFc + lane], vj * x[(size_t)sj * f + fcol]);
    }
  }
  __syncthreads();

  for (int e = tid; e < t * kFc; e += kThreads) {
    const int row = dst * t + e / kFc, col = f0 + e % kFc;
    if (col >= f || row >= n) continue;
    const float v = acc_s[e];
    if (split) {
      if (v != 0.f) atomicAdd(&y[(size_t)row * f + col], v);
    } else {
      y[(size_t)row * f + col] = relu ? fmaxf(v, 0.f) : v;
    }
  }
}

__global__ void relu_kernel(float* __restrict__ y, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = fmaxf(y[i], 0.f);
}

}  // namespace

// y must hold zeros where `any_split` is set (split intervals add into
// it); otherwise every row below n is stored.
extern "C" int chunk_queue_launch(const void* tile_ptr, const void* tile_src,
                                  const void* entry_ptr, const void* rows,
                                  const void* cols, const void* vals,
                                  const void* segments, int n_segments,
                                  int any_split, const void* x, void* y,
                                  int n, int t, int f, int relu,
                                  void* stream) {
  if (n_segments == 0 || n == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  const int n_fchunks = (f + kFc - 1) / kFc;
  const size_t smem = (size_t)t * kFc * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(chunk_queue_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_segments * n_fchunks);
  chunk_queue_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int*>(tile_ptr), static_cast<const int*>(tile_src),
      static_cast<const int*>(entry_ptr), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const int*>(segments), static_cast<const float*>(x),
      static_cast<float*>(y), n, t, f, n_fchunks, relu);
  if (relu && any_split) {
    const size_t count = (size_t)n * f;
    const unsigned blocks = (unsigned)((count + 255) / 256 < 4096
                                           ? (count + 255) / 256 : 4096);
    relu_kernel<<<blocks, 256, 0, st>>>(static_cast<float*>(y), count);
  }
  return (int)cudaGetLastError();
}

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
// Bound on the H100: bytes.  Each real entry costs 12 B of (row, col,
// val) and one F-wide row of X; the work is 2 operations per entry and
// feature.  Two launchers share one warp walker:
//   * `rer_gather_launch`: a whole aggregate, every bucket group of a
//     plan in one launch, driven by a work table built on the host with
//     the plan's groups (`rer_gather/ops.py::PlanGroups`): the real
//     entries of every tile (real entries come first in a tile's S slots,
//     so no pad slot is read) cut into pieces and packed into segments
//     of at most SEG_ENTRIES (64) entries, in destination order, one warp
//     per segment; a warp walks its segment as one run of entries, each lane
//     finding its entry's piece by a binary search, so many small tiles
//     share a 32-entry load and the hub interval's tens of thousands of
//     entries spread over hundreds of warps (that table walk and the lane
//     mapping are in rer_gather_walk.cuh, shared with the backward passes
//     of rer_gather_bwd.cu, which walk the same table; the warp walker
//     `walk` is there too, shared with chunk_queue.cu);
//   * `rer_gather_part_launch`: the streamed executor's chunk, (C, S)
//     entries against a (C, T, F) source stack into one interval's (T, F)
//     partial; one warp per (tile, 64-slot slice), so a hub tile spreads
//     over the card too; the chunk arrives from the host each step, so
//     there is no table, and a pad slot costs the read of its val;
//   * the walker loads 32 entries with one coalesced read (rows and cols
//     only where val != 0), broadcasts them with __shfl_sync and keeps
//     the running destination row's sum or max in registers, lanes over
//     features (below 32 features, groups of pow2(F) >= 4 lanes take
//     different entries), kU x kNR values of X in flight per lane;
//     entries are row-sorted within a forward tile, so it flushes to Y
//     only when the row changes: atomicAdd into a zero-filled Y (sum), or
//     an integer-atomic float max into a -inf-filled Y, -inf -> 0 after
//     when `finish` (max); both are fire-and-forget reductions, with no
//     shared-memory atomics, no per-group partial and no merge outside
//     the kernel;
//   * entries with val == 0 (pads, and a merged weight of 0) are skipped,
//     which is exact for sum and is the max convention.
// Numerics: max is exact in any order; the order of the atomic adds
// varies from run to run, so sums agree with the plain version to fp32
// rounding, not bitwise.
#include <cuda_runtime.h>
#include <math.h>

#include "rer_gather_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;
using rer_gather_walk::walk;
constexpr int kSlice = 64;   // slots per warp in the tile-part form

// Float max by integer atomics: floats without the sign bit order as
// ints, floats with it (-0 to -inf) inversely as unsigned ints, and each
// kind against the other correctly too, so one atomicMax or atomicMin is
// an exact max, issued without waiting for a reply (a compare-and-swap
// loop waits on every read).  NaN is not ordered.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// B2's sink: the running row's sum or max straight into Y, by
// fire-and-forget atomics.
template <bool kMax>
struct YSink {
  float* y;
  int f;
  __device__ __forceinline__ void operator()(int row, int fi,
                                             float v) const {
    float* out = y + (size_t)row * f + fi;
    if (kMax)
      atomic_max_float(out, v);
    else
      atomicAdd(out, v);
  }
};

// A whole aggregate over a plan's bucket groups, one warp per segment of
// the work table (rer_gather_walk.cuh); gridDim.y runs over feature
// passes of fp * kNR features.
template <bool kMax, int kNR>
__global__ void __launch_bounds__(kThreads)
rer_gather_kernel(const long long* __restrict__ gtab,
                  const int* __restrict__ pieces,
                  const int* __restrict__ poff,
                  const int* __restrict__ seg_ptr, int n_seg,
                  const float* __restrict__ x, float* __restrict__ y, int t,
                  int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;
  const rer_gather_walk::Segment sg =
      rer_gather_walk::segment(gtab, pieces, poff, seg_ptr, s, t);
  auto load = [&](int e0, float* v, int* r, int* c) {
    if (e0 + lane < sg.n_entries) sg.load(e0 + lane, v, r, c);
  };
  walk<kMax, kNR>(sg.n_entries, load, YSink<kMax>{y, f}, x, f,
                  blockIdx.y * fp * kNR, fp, lane);
}

// The streamed chunk: warp w takes tile w / n_slices, slots
// [kSlice * (w % n_slices), +kSlice); X rows c*T + col of the (C, T, F)
// stack, Y rows of the one (T, F) partial.
template <bool kMax, int kNR>
__global__ void __launch_bounds__(kThreads)
rer_gather_part_kernel(const int* __restrict__ rows,
                       const int* __restrict__ cols,
                       const float* __restrict__ vals, int c_tiles, int s,
                       int n_slices, const float* __restrict__ xs,
                       float* __restrict__ y, int t, int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= c_tiles * n_slices) return;
  const int tile = w / n_slices, lo = (w % n_slices) * kSlice;
  const size_t base = (size_t)tile * s + lo;
  const int src = tile * t;
  const int n_entries = min(kSlice, s - lo);
  auto load = [&](int e0, float* v, int* r, int* c) {
    const int e = e0 + lane;
    if (e >= n_entries) return;
    *v = vals[base + e];
    if (*v != 0.f) {
      *r = rows[base + e];
      *c = src + cols[base + e];
    }
  };
  walk<kMax, kNR>(n_entries, load, YSink<kMax>{y, f}, xs, f,
                  blockIdx.y * fp * kNR, fp, lane);
}

__global__ void fill_kernel(float* __restrict__ y, size_t count, float v) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = v;
}

__global__ void finish_kernel(float* __restrict__ y, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    if (y[i] == -INFINITY) y[i] = 0.f;
}

unsigned grid_for(size_t count) {
  const size_t b = (count + 255) / 256;
  return (unsigned)(b < 4096 ? (b ? b : 1) : 4096);
}

// Y filled with 0 (a memset, no kernel) or -inf before pieces merge in.
void fill_y(float* y, size_t count, bool neg_inf, cudaStream_t st) {
  if (neg_inf)
    fill_kernel<<<grid_for(count), 256, 0, st>>>(y, count, -INFINITY);
  else
    cudaMemsetAsync(y, 0, count * sizeof(float), st);
}

template <bool kMax, int kNR>
void launch_table(const long long* gtab, const int* pieces, const int* poff,
                  const int* seg_ptr, int n_seg, const float* x, float* y,
                  int t, int f, int fp, cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  rer_gather_kernel<kMax, kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, x, y, t, f, fp);
}

template <bool kMax, int kNR>
void launch_part(const int* rows, const int* cols, const float* vals, int c,
                 int s, const float* xs, float* y, int t, int f, int fp,
                 cudaStream_t st) {
  const int n_slices = (s + kSlice - 1) / kSlice;
  const long long warps = (long long)c * n_slices;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps),
                  (unsigned)((f + fp * kNR - 1) / (fp * kNR)));
  rer_gather_part_kernel<kMax, kNR><<<grid, kThreads, 0, st>>>(
      rows, cols, vals, c, s, n_slices, xs, y, t, f, fp);
}

template <bool kMax>
void dispatch_table(const long long* gtab, const int* pieces,
                    const int* poff, const int* seg_ptr, int n_seg,
                    const float* x, float* y, int t, int f, cudaStream_t st) {
  int nr;
  const int fp = lanes_for(f, &nr);
  if (nr == 1)
    launch_table<kMax, 1>(gtab, pieces, poff, seg_ptr, n_seg, x, y, t, f,
                          fp, st);
  else if (nr == 2)
    launch_table<kMax, 2>(gtab, pieces, poff, seg_ptr, n_seg, x, y, t, f,
                          fp, st);
  else
    launch_table<kMax, 4>(gtab, pieces, poff, seg_ptr, n_seg, x, y, t, f,
                          fp, st);
}

template <bool kMax>
void dispatch_part(const int* rows, const int* cols, const float* vals,
                   int c, int s, const float* xs, float* y, int t, int f,
                   cudaStream_t st) {
  int nr;
  const int fp = lanes_for(f, &nr);
  if (nr == 1)
    launch_part<kMax, 1>(rows, cols, vals, c, s, xs, y, t, f, fp, st);
  else if (nr == 2)
    launch_part<kMax, 2>(rows, cols, vals, c, s, xs, y, t, f, fp, st);
  else
    launch_part<kMax, 4>(rows, cols, vals, c, s, xs, y, t, f, fp, st);
}

}  // namespace

// Y (q*T, F) over every piece of the work table: filled first (0 for
// sum, -inf for max), -inf -> 0 afterwards when `finish` (max).
extern "C" int rer_gather_launch(const void* gtab, const void* pieces,
                                 const void* poff, const void* seg_ptr,
                                 int n_seg,
                                 const void* x, void* y, int q, int t, int f,
                                 int op_max, int finish, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yy = static_cast<float*>(y);
  const size_t count = (size_t)q * t * f;
  fill_y(yy, count, op_max, st);
  if (n_seg > 0) {
    const long long* gt = static_cast<const long long*>(gtab);
    const int* pc = static_cast<const int*>(pieces);
    const int* po = static_cast<const int*>(poff);
    const int* sp = static_cast<const int*>(seg_ptr);
    const float* xx = static_cast<const float*>(x);
    if (op_max)
      dispatch_table<true>(gt, pc, po, sp, n_seg, xx, yy, t, f, st);
    else
      dispatch_table<false>(gt, pc, po, sp, n_seg, xx, yy, t, f, st);
  }
  if (op_max && finish)
    finish_kernel<<<grid_for(count), 256, 0, st>>>(yy, count);
  return (int)cudaGetLastError();
}

// The streamed chunk: (C, S) entries against the (C, T, F) stack xs ->
// the (T, F) raw partial y (sum from 0; max keeps -inf where uncovered).
extern "C" int rer_gather_part_launch(const void* rows, const void* cols,
                                      const void* vals, int c, int s,
                                      const void* xs, void* y, int t, int f,
                                      int op_max, void* stream) {
  if (t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yy = static_cast<float*>(y);
  const size_t count = (size_t)t * f;
  fill_y(yy, count, op_max, st);
  if (c > 0 && s > 0) {
    const int* rr = static_cast<const int*>(rows);
    const int* cc = static_cast<const int*>(cols);
    const float* vv = static_cast<const float*>(vals);
    const float* xx = static_cast<const float*>(xs);
    if (op_max)
      dispatch_part<true>(rr, cc, vv, c, s, xx, yy, t, f, st);
    else
      dispatch_part<false>(rr, cc, vv, c, s, xx, yy, t, f, st);
  }
  return (int)cudaGetLastError();
}

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
// entries ragged, 12 B per real entry, over its own copy of the packed
// store's flat, dst-sorted entries (see the work table below).
//
// Bound on the H100: bytes and gather latency.  Each entry costs its 12 B
// and one F-wide row of X; the work is 2 operations per entry and
// feature.  Design, destination-stationary:
//   * a work table built on the host with the queue
//     (`chunk_queue/ops.py::queue_work`): the walker's own copy of the
//     entries, each interval's sorted by local row (local row, global
//     source row, value: 12 B per entry, so no tile lookup on the card),
//     and each interval's span cut into pieces of at most a few thousand
//     entries, longest first (the hub's pieces start first and the small
//     intervals fill the last wave); one CTA per (piece, feature pass)
//     keeps the interval's T x F block (F <= 64: up to 64 KB) in shared
//     memory;
//   * the CTA's eight warps split the piece into contiguous runs, and
//     each runs RER-Gather's walker (`rer_gather_walk::walk`): an entry's
//     (row, source, value) is read once for all features up to 64 (lanes
//     over features as `queue_lanes` maps them: F = 50 is 16 lanes x 4
//     features, two entries a warp instruction; wider F takes passes of
//     128), kU entries' X rows are in flight per lane, and the running
//     row's sum stays in registers until the row changes.  Row-sorted, a
//     warp meets each of its rows in one run, so it flushes (a shared
//     atomic add) about once per row instead of once per (tile, row);
//   * an interval in one piece stores its block once, with relu when
//     asked; a piece of a split interval covers a contiguous range of
//     rows and adds only those into a zeroed scratch block (the launcher
//     zeroes only the split intervals' blocks) with global atomics, and
//     the last piece to arrive (a per-interval arrival counter) applies
//     relu and stores the interval: Y is never zero-filled and never
//     passed over a second time;
//   * the entry copy is read with streaming loads and Y written with
//     streaming stores, so the L2 keeps X, which the gathers reuse;
//   * only rows below n are written, so X and Y keep their n rows.
// Numerics: the order of the atomic adds varies from run to run, so sums
// agree with the plain version to fp32 rounding, not bitwise.
//
// B5^T, the second launcher (`chunk_queue_t_launch`): the sum's backward,
//
//   dX[src] += vals[e] * G[dst]  for every entry e of the FORWARD queue,
//
// src = wsrc[e], dst = i*T + wrows[e] for the entry's interval i.  The
// reference differentiates its XLA sweep, so no TPU kernel is replaced;
// this is B5's adjoint, and no transposed queue or A^T carrier is built
// on the card.  Bound: bytes and atomics, the forward's 12 B per entry and
// one gathered G row, with dX taken by float atomics in place of B5's
// shared-memory block (the entries are row-sorted by destination, so their
// sources scatter).  Design: the forward's work table and entry copy as
// they are; one CTA per (piece, feature pass), its eight warps splitting
// the piece into contiguous runs, each running the same warp walker
// (`rer_gather_walk::walk`) with the roles swapped: the gathered row is
// G[dst], the sink an atomic add into dX[src] (a run of one source is
// summed in registers first).  Pieces partition the entries, so a split
// interval is counted once; the launcher zeroes dX first.

#include "rer_gather_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;
using rer_gather_walk::walk;

// dynamic shared memory a CTA may take (227 KB, less a margin for the
// static arrival flag)
constexpr int kSmemMax = 232448 - 128;

// pieces: (P, 5) int32 rows (dst interval, first entry, end entry, split
// slot or -1, pieces of the interval) over wrows, wsrc, wvals: the
// entries row-sorted within each interval (local row, global source row,
// value).  part: (n_split, T, F) zeroed scratch of the split intervals,
// arrive: (n_split, passes) zeroed counters.
template <int kNR>
__global__ void __launch_bounds__(kThreads)
chunk_queue_kernel(const int* __restrict__ pieces,
                   const int* __restrict__ wrows,
                   const int* __restrict__ wsrc,
                   const float* __restrict__ wvals,
                   const float* __restrict__ x, float* __restrict__ y,
                   float* __restrict__ part, int* __restrict__ arrive, int n,
                   int t, int f, int fp, int relu) {
  extern __shared__ float acc_s[];  // t x wf
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pc = pieces + 5 * blockIdx.x;
  const int dst = pc[0], lo = pc[1], hi = pc[2], slot = pc[3];
  const int fb = blockIdx.y * fp * kNR;
  const int wf = min(fp * kNR, f - fb);

  for (int i = tid; i < t * wf; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  // warp w walks [lo + w * step, +step) of the piece
  const int step = ((hi - lo + kWarps - 1) / kWarps + 31) & ~31;
  const int wlo = lo + warp * step;
  const int wn = min(hi, wlo + step) - wlo;
  if (wn > 0) {
    auto load = [&](int e0, float* v, int* r, int* c) {
      if (e0 + lane < wn) {
        const int e = wlo + e0 + lane;
        *v = __ldcs(wvals + e);
        *r = __ldcs(wrows + e);
        *c = __ldcs(wsrc + e);
      }
    };
    auto sink = [&](int row, int fi, float v) {
      atomicAdd(acc_s + row * wf + (fi - fb), v);
    };
    walk<false, kNR>(wn, load, sink, x, f, fb, fp, lane);
  }
  __syncthreads();

  const int row0 = dst * t;
  const int count = min(t, n - row0) * wf;
  if (slot < 0) {
    for (int i = tid; i < count; i += kThreads) {
      const int r = i / wf, c = i - r * wf;
      const float v = acc_s[i];
      __stcs(y + (size_t)(row0 + r) * f + fb + c, relu ? fmaxf(v, 0.f) : v);
    }
    return;
  }
  // this piece's rows: from its first entry's to its last's
  float* blk = part + (size_t)slot * t * f;
  const int r_lo = wrows[lo];
  const int span = (wrows[hi - 1] + 1 - r_lo) * wf;
  for (int i = tid; i < span; i += kThreads) {
    const int r = r_lo + i / wf, c = i % wf;
    const float v = acc_s[r * wf + c];
    if (v != 0.f) atomicAdd(blk + (size_t)r * f + fb + c, v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(arrive + slot * gridDim.y + blockIdx.y, 1) == pc[4] - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < count; i += kThreads) {
    const int r = i / wf, c = i - r * wf;
    const float v = __ldcg(blk + (size_t)r * f + fb + c);
    __stcs(y + (size_t)(row0 + r) * f + fb + c, relu ? fmaxf(v, 0.f) : v);
  }
}

// Lanes per entry and features per lane: `lanes_for`'s, but 32 < F <= 64
// takes 16 lanes x 4 features, two entries per warp instruction, which
// halves the shuffles and row tests per entry (measured 6% faster at
// F = 50 and 10% at F = 64 than 32 x 2, NVIDIA H100 80GB HBM3 at 700 W).
int queue_lanes(int f, int* nr) {
  if (f > 32 && f <= 64) {
    *nr = 4;
    return 16;
  }
  return lanes_for(f, nr);
}

template <int kNR>
void launch(const int* pieces, int n_pieces, const int* wrows,
            const int* wsrc, const float* wvals, const float* x, float* y,
            float* part, int* arrive, int n, int t, int f, int fp,
            int passes, size_t smem, int relu, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(chunk_queue_kernel<kNR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(chunk_queue_kernel<kNR>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    smem_set = smem;
  }
  const dim3 grid((unsigned)n_pieces, (unsigned)passes);
  chunk_queue_kernel<kNR><<<grid, kThreads, smem, st>>>(
      pieces, wrows, wsrc, wvals, x, y, part, arrive, n, t, f, fp, relu);
}

// B5^T: see the head of this file.  g (n, F) row-major, dx (n, F) zeroed.
template <int kNR>
__global__ void __launch_bounds__(kThreads)
chunk_queue_t_kernel(const int* __restrict__ pieces,
                     const int* __restrict__ wrows,
                     const int* __restrict__ wsrc,
                     const float* __restrict__ wvals,
                     const float* __restrict__ g, float* __restrict__ dx,
                     int t, int f, int fp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* pc = pieces + 5 * blockIdx.x;
  const int row0 = pc[0] * t, lo = pc[1], hi = pc[2];
  const int fb = blockIdx.y * fp * kNR;
  const int step = ((hi - lo + kWarps - 1) / kWarps + 31) & ~31;
  const int wlo = lo + warp * step;
  const int wn = min(hi, wlo + step) - wlo;
  if (wn <= 0) return;  // warp-uniform
  auto load = [&](int e0, float* v, int* r, int* c) {
    if (e0 + lane < wn) {
      const int e = wlo + e0 + lane;
      *v = __ldcs(wvals + e);
      *r = __ldcs(wsrc + e);
      *c = row0 + __ldcs(wrows + e);
    }
  };
  auto sink = [&](int row, int fi, float v) {
    atomicAdd(dx + (size_t)row * f + fi, v);
  };
  walk<false, kNR>(wn, load, sink, g, f, fb, fp, lane);
}

template <int kNR>
void launch_t(const int* pieces, int n_pieces, const int* wrows,
              const int* wsrc, const float* wvals, const float* g, float* dx,
              int t, int f, int fp, int passes, cudaStream_t st) {
  const dim3 grid((unsigned)n_pieces, (unsigned)passes);
  chunk_queue_t_kernel<kNR><<<grid, kThreads, 0, st>>>(
      pieces, wrows, wsrc, wvals, g, dx, t, f, fp);
}

}  // namespace

// scratch: n_split * T * F floats then n_split * F ints (at least one
// counter per pass), zeroed here up to what this launch uses.  Every row
// of Y below n is stored.
extern "C" int chunk_queue_launch(const void* pieces, int n_pieces,
                                  const void* wrows, const void* wsrc,
                                  const void* wvals, const void* x, void* y,
                                  void* scratch, int n_split, int n, int t,
                                  int f, int relu, void* stream) {
  if (n_pieces == 0 || n == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  int nr;
  const int fp = queue_lanes(f, &nr);
  // a pass's block must fit the CTA: a tall tile takes narrower passes
  auto block = [&](int w) {
    return (size_t)t * (w < f ? w : f) * sizeof(float);
  };
  while (nr > 1 && block(fp * nr) > kSmemMax) nr >>= 1;
  const size_t smem = block(fp * nr);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int passes = (f + fp * nr - 1) / (fp * nr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int* arrive = reinterpret_cast<int*>(part + (size_t)n_split * t * f);
  if (n_split > 0)
    cudaMemsetAsync(scratch, 0,
                    ((size_t)n_split * t * f + (size_t)n_split * passes) *
                        sizeof(float),
                    st);
  const int* pc = static_cast<const int*>(pieces);
  const int* wr = static_cast<const int*>(wrows);
  const int* ws = static_cast<const int*>(wsrc);
  const float* wv = static_cast<const float*>(wvals);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  if (nr == 1)
    launch<1>(pc, n_pieces, wr, ws, wv, xx, yy, part, arrive, n, t, f, fp,
              passes, smem, relu, st);
  else if (nr == 2)
    launch<2>(pc, n_pieces, wr, ws, wv, xx, yy, part, arrive, n, t, f, fp,
              passes, smem, relu, st);
  else
    launch<4>(pc, n_pieces, wr, ws, wv, xx, yy, part, arrive, n, t, f, fp,
              passes, smem, relu, st);
  return (int)cudaGetLastError();
}

// B5^T: dx (n, F) = A^T g over the forward queue's pieces and entries.
// dx is zeroed here, then every entry adds into it.
extern "C" int chunk_queue_t_launch(const void* pieces, int n_pieces,
                                    const void* wrows, const void* wsrc,
                                    const void* wvals, const void* g,
                                    void* dx, int n, int t, int f,
                                    void* stream) {
  if (n == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dx, 0, (size_t)n * f * sizeof(float), st);
  if (n_pieces == 0 || t == 0) return (int)cudaGetLastError();
  int nr;
  const int fp = queue_lanes(f, &nr);
  const int passes = (f + fp * nr - 1) / (fp * nr);
  const int* pc = static_cast<const int*>(pieces);
  const int* wr = static_cast<const int*>(wrows);
  const int* ws = static_cast<const int*>(wsrc);
  const float* wv = static_cast<const float*>(wvals);
  const float* gg = static_cast<const float*>(g);
  float* out = static_cast<float*>(dx);
  if (nr == 1)
    launch_t<1>(pc, n_pieces, wr, ws, wv, gg, out, t, f, fp, passes, st);
  else if (nr == 2)
    launch_t<2>(pc, n_pieces, wr, ws, wv, gg, out, t, f, fp, passes, st);
  else
    launch_t<4>(pc, n_pieces, wr, ws, wv, gg, out, t, f, fp, passes, st);
  return (int)cudaGetLastError();
}

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
//   * the wrapper picks the features of a pass (`fc`, `feature_chunk` in
//     chunk_queue/ops.py): the widest pass whose T x fc block fits, so a
//     tall interval takes narrower passes (16 features at T = 2048 and
//     F = 64, 1 at T = 32,768), down to a lane per feature, each group
//     of lanes then walking fewer entries than a batch (`walk`'s kFew);
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
// src = tile_src[k]*T + cols[e], dst = i*T + rows[e] for the entry's tile
// k and its destination interval i.  The reference differentiates its XLA
// sweep, so no TPU kernel is replaced; this is B5's adjoint, and no
// transposed queue, A^T carrier or entry copy is built on the card.
// Bound: bytes, the forward's 12 B per entry, one read of G and one write
// of dX; the gathers of G rows, the dependent loads that find an entry
// and the split intervals' merges set its time.  Design,
// source-stationary:
//   * a work table built on the host with the queue
//     (`chunk_queue/ops.py::queue_src_work`), per tile and per piece only:
//     the tiles with entries in source order (`tsrc_tiles`) and their
//     entry offsets in that order (`tsrc_ptr`), each tile's destination
//     interval (`tile_dst`), and each source interval's span of that
//     order cut into pieces (`tpieces`: B5's five columns and the piece's
//     span of tiles) sized from the queue's entries and the SM count, so
//     the grid fills the card;
//   * one CTA per (piece, feature pass) stages its piece's tiles in shared
//     memory, then loads the piece's entries, several a thread at once,
//     each finding its tile by a binary search of the staged offsets and
//     reading the forward queue's own tile-order rows, cols and vals
//     (neighbouring threads, neighbouring entries);
//   * the CTA sorts its piece by source column in shared memory (a count
//     per column with integer atomics, a prefix sum, each entry placed by
//     its rank): the walk's order exists only on chip, and no entry is
//     copied or reordered in device memory;
//   * the sorted entries are cut evenly into one run per lane group
//     (kUT entries' G rows in flight per lane; F a multiple of 4 or 2
//     moves each lane's neighbouring features as one float4 or float2,
//     any other F as `queue_lanes` maps them); a group sums each column
//     in registers and writes a column wholly in its run once, and the
//     part of a column a cut falls inside (a hub's may span many runs)
//     into a per-run partial that one thread adds up after the walk.  No
//     float atomic in shared memory (they compile to compare-and-swap
//     loops: adding every product into a shared T x F block with them
//     measured no faster than one global atomic per product) and none in
//     device memory per entry;
//   * an unsplit interval stores each row once with streaming stores,
//     rows below n only (a row without an entry as zero): dX is never
//     zero-filled; a split interval's pieces add their column sums into a
//     zeroed scratch block with `red` (no value returned, vector where F
//     allows), count arrivals, and the last to arrive stores the interval
//     (the launcher zeroes only the split intervals' scratch and
//     counters), B5's merge;
//   * shared memory holds the run partials, T + 1 counts and 28 B per
//     entry of the longest piece, not a T x F block, so a tall tile takes
//     no narrower pass.
// The sort, the walk of the runs and the sums of the cut columns are
// source_walk.cuh's, shared with B2^T (rer_gather_bwd.cu).

#include "rer_gather_walk.cuh"
#include "source_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kWarps;
using rer_gather_walk::walk;
using source_walk::align4;
using source_walk::kLB;
using source_walk::kSmemMax;
using source_walk::last_le;
using source_walk::merge;
using source_walk::queue_lanes;
using source_walk::store;

// pieces: (P, 5) int32 rows (dst interval, first entry, end entry, split
// slot or -1, pieces of the interval) over wrows, wsrc, wvals: the
// entries row-sorted within each interval (local row, global source row,
// value).  part: (n_split, T, F) zeroed scratch of the split intervals,
// arrive: (n_split, passes) zeroed counters.
template <int kNR, bool kFew>
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
    walk<false, kNR, decltype(load), decltype(sink), kFew>(wn, load, sink, x,
                                                           f, fb, fp, lane);
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

template <int kNR, bool kFew = false>
void launch(const int* pieces, int n_pieces, const int* wrows,
            const int* wsrc, const float* wvals, const float* x, float* y,
            float* part, int* arrive, int n, int t, int f, int fp,
            int passes, size_t smem, int relu, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(chunk_queue_kernel<kNR, kFew>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(chunk_queue_kernel<kNR, kFew>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    smem_set = smem;
  }
  const dim3 grid((unsigned)n_pieces, (unsigned)passes);
  chunk_queue_kernel<kNR, kFew><<<grid, kThreads, smem, st>>>(
      pieces, wrows, wsrc, wvals, x, y, part, arrive, n, t, f, fp, relu);
}

// B5^T: see the head of this file.
constexpr int kUT = 8;       // entries whose G rows a lane has in flight

// B5^T's dynamic shared memory (4-byte words, the kernel's layout) at
// tile t, pieces of at most `piece` entries, wf features a pass and fp
// lanes over them
__host__ __device__ constexpr int t_words(int t, int piece, int wf, int fp) {
  return 2 * align4(kWarps * (32 / fp) * wf) + align4(t + 1) +
         4 * (piece + 1) + 4 * piece;
}

// tpieces: (P', 7) int32 rows (source interval, first, end, split slot or
// -1, pieces of the interval, first tile, end tile): entry offsets and
// tiles of the source order (tsrc_ptr (K'+1), tsrc_tiles (K')); tile_dst
// (K); entry_ptr, rows, cols, vals: the forward queue's tile-order
// entries.  g (n, F) row-major; dx (n, F) is stored, rows below n.  part:
// (t_split, T, F) zeroed scratch of the split source intervals, arrive:
// (t_split, passes) zeroed counters.  A lane holds kNR features: with
// kV = 4 or 2 (F a multiple of kV) neighbouring ones, moved kV at a time,
// else every fp-th (`queue_lanes`' mapping), one at a time.
template <int kNR, int kV>
__global__ void __launch_bounds__(kThreads)
chunk_queue_t_kernel(const int* __restrict__ tpieces,
                     const int* __restrict__ tsrc_ptr,
                     const int* __restrict__ tsrc_tiles,
                     const int* __restrict__ tile_dst,
                     const int* __restrict__ entry_ptr,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const float* __restrict__ vals,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* __restrict__ part, int* __restrict__ arrive,
                     int n, int t, int f, int fp) {
  extern __shared__ __align__(16) int smem_t[];
  __shared__ int warp_sums[kWarps];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pc = tpieces + 7 * blockIdx.x;
  const int src = pc[0], lo = pc[1], hi = pc[2], slot = pc[3];
  const int jb = pc[5], nt = pc[6] - pc[5];
  const int ne = hi - lo;
  const int fb = blockIdx.y * fp * kNR;
  const int wf = min(fp * kNR, f - fb);
  const int nk = kWarps * (32 / fp);  // runs: one per lane group
  // per run two wf-float partials (of the column its start cuts and of
  // the one its end cuts); per column of the interval its entry count,
  // then its first sorted entry; per tile of the piece its first offset
  // (one more), first entry and first G row; per entry as loaded: column
  // << 16 | rank within the column, G row, value; then the entries in
  // column order
  float* part_first = reinterpret_cast<float*>(smem_t);
  float* part_last = part_first + align4(nk * wf);
  int* base = reinterpret_cast<int*>(part_last + align4(nk * wf));
  int* s_ptr = base + align4(t + 1);
  int* s_start = s_ptr + nt + 1;
  int* s_row0 = s_start + nt;
  int* e_key = s_row0 + nt;
  int* e_row = e_key + ne;
  float* e_val = reinterpret_cast<float*>(e_row + ne);
  int* order = reinterpret_cast<int*>(e_val + ne);

  // 1. the piece's tiles; zero counts and partials
  for (int i = tid; i <= nt; i += kThreads) {
    s_ptr[i] = __ldg(tsrc_ptr + jb + i);
    if (i < nt) {
      const int tk = __ldg(tsrc_tiles + jb + i);
      s_start[i] = __ldg(entry_ptr + tk);
      s_row0[i] = __ldg(tile_dst + tk) * t;
    }
  }
  for (int i = tid; i <= t; i += kThreads) base[i] = 0;
  for (int i = tid; i < 2 * align4(nk * wf); i += kThreads)
    part_first[i] = 0.f;
  __syncthreads();

  // 2. its entries, kLB a thread at once (neighbouring threads read
  //    neighbouring entries of a tile), counted per column
  for (int i0 = 0; i0 < ne; i0 += kThreads * kLB) {
    int ee[kLB], r0[kLB], cc[kLB], rw[kLB];
    float vv[kLB];
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      const int i = i0 + b * kThreads + tid;
      ee[b] = -1;
      if (i < ne) {
        const int jl = last_le(s_ptr, 0, nt - 1, lo + i);
        ee[b] = s_start[jl] + lo + i - s_ptr[jl];
        r0[b] = s_row0[jl];
      }
    }
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      if (ee[b] < 0) continue;
      cc[b] = __ldg(cols + ee[b]);
      rw[b] = __ldg(rows + ee[b]);
      vv[b] = __ldg(vals + ee[b]);
    }
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      if (ee[b] < 0) continue;
      const int i = i0 + b * kThreads + tid;
      e_key[i] = (cc[b] << 16) | atomicAdd(base + cc[b], 1);
      e_row[i] = r0[b] + rw[b];
      e_val[i] = vv[b];
    }
  }
  __syncthreads();

  // 3. sort by column in shared memory: counts -> first positions
  source_walk::sort_by_column(e_key, base, order, ne, t, warp_sums);

  // 4. the sorted entries cut evenly into nk runs, one per lane group (fp
  //    lanes, kNR neighbouring features each): a group sums each column
  //    of its run in registers and writes a column wholly in the run once
  //    (a store into dX or, for a split interval, a `red` into its
  //    scratch), the part of a column that a cut falls inside into the
  //    run's partial for it
  const source_walk::Cuts cuts{e_key, order, base, ne, nk};
  const int row0 = src * t;
  const int nrows = min(t, n - row0);
  float* blk = part + (size_t)max(slot, 0) * t * f + fb;
  source_walk::walk_runs<kNR, kV, kUT>(
      cuts, e_row, e_val, g, f, fb, wf, fp, part_first, part_last,
      [&](int c, int fi, const float* v) {
        if (slot < 0)
          store<kV>(dx + (size_t)(row0 + c) * f + fb + fi, v);
        else
          merge<kV>(blk + (size_t)c * f + fi, v);
      });
  __syncthreads();

  // 5. each column a cut falls inside, from its partials; an unsplit
  //    interval's rows without an entry are zero; a split interval's
  //    last piece to arrive stores the merged block
  source_walk::sum_cuts(cuts, wf, part_first, part_last,
                        [&](int c, int fi, float v) {
                          if (slot < 0)
                            __stcs(dx + (size_t)(row0 + c) * f + fb + fi, v);
                          else
                            merge<1>(blk + (size_t)c * f + fi, &v);
                        });
  if (slot < 0) {
    for (int rl = warp; rl < nrows; rl += kWarps)
      if (base[rl + 1] == base[rl])
        for (int c = lane; c < wf; c += 32)
          __stcs(dx + (size_t)(row0 + rl) * f + fb + c, 0.f);
    return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(arrive + slot * gridDim.y + blockIdx.y, 1) == pc[4] - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (((wf | f | fb) & 3) == 0) {
    const int w4 = wf >> 2;
#pragma unroll 4
    for (int i = tid; i < nrows * w4; i += kThreads) {
      const int rl = i / w4, c4 = i - rl * w4;
      const size_t at = (size_t)rl * f + 4 * c4;
      __stcs(reinterpret_cast<float4*>(dx + (size_t)row0 * f + fb + at),
             __ldcg(reinterpret_cast<const float4*>(blk + at)));
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < nrows * wf; i += kThreads) {
      const int rl = i / wf, c = i - rl * wf;
      __stcs(dx + (size_t)(row0 + rl) * f + fb + c,
             __ldcg(blk + (size_t)rl * f + c));
    }
  }
}

template <int kNR, int kV>
void launch_t(const int* tpieces, int n_pieces, const int* tsrc_ptr,
              const int* tsrc_tiles, const int* tile_dst,
              const int* entry_ptr, const int* rows, const int* cols,
              const float* vals, const float* g, float* dx, float* part,
              int* arrive, int n, int t, int f, int fp, int passes,
              size_t smem, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(chunk_queue_t_kernel<kNR, kV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(chunk_queue_t_kernel<kNR, kV>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    smem_set = smem;
  }
  const dim3 grid((unsigned)n_pieces, (unsigned)passes);
  chunk_queue_t_kernel<kNR, kV><<<grid, kThreads, smem, st>>>(
      tpieces, tsrc_ptr, tsrc_tiles, tile_dst, entry_ptr, rows, cols, vals,
      g, dx, part, arrive, n, t, f, fp);
}

}  // namespace

// scratch: n_split * T * F floats then n_split * F ints (at least one
// counter per pass), zeroed here up to what this launch uses.  Every row
// of Y below n is stored.  fc: the most features a pass takes (a power of
// two, the wrapper's `feature_chunk`), its T x fc block within a CTA.
extern "C" int chunk_queue_launch(const void* pieces, int n_pieces,
                                  const void* wrows, const void* wsrc,
                                  const void* wvals, const void* x, void* y,
                                  void* scratch, int n_split, int n, int t,
                                  int f, int fc, int relu, void* stream) {
  if (n_pieces == 0 || n == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  int nr;
  int fp = queue_lanes(f, &nr);
  // a pass of at most fc features: fewer features a lane first, then
  // fewer lanes an entry
  while (nr > 1 && fp * nr > fc) nr >>= 1;
  while (fp > 1 && fp * nr > fc) fp >>= 1;
  const size_t smem = (size_t)t * (fp * nr < f ? fp * nr : f) * sizeof(float);
  if (fc < 1 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
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
  if (fp < rer_gather_walk::kU)
    launch<1, true>(pc, n_pieces, wr, ws, wv, xx, yy, part, arrive, n, t, f,
                    fp, passes, smem, relu, st);
  else if (nr == 1)
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

// B5^T: dx (n, F) = A^T g over the forward queue's entries in source
// order (`tpieces` over `tsrc_ptr` / `tsrc_tiles`), no piece longer than
// `piece` entries.  scratch: t_split * T * F floats then t_split * F ints
// (at least one counter per pass), zeroed here up to what this launch
// uses; dx itself is not zeroed: every row below n is stored by its source
// interval's CTAs.
extern "C" int chunk_queue_t_launch(const void* tpieces, int n_pieces,
                                    const void* tsrc_ptr,
                                    const void* tsrc_tiles,
                                    const void* tile_dst,
                                    const void* entry_ptr, const void* rows,
                                    const void* cols, const void* vals,
                                    const void* g, void* dx, void* scratch,
                                    int t_split, int piece, int n, int t,
                                    int f, void* stream) {
  if (n_pieces == 0 || n == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  int nr;
  const int fp = queue_lanes(f, &nr);
  // the piece's arrays fit the CTA; a column and its rank share one
  // non-negative int: a column below 2^15, a rank below 2^16
  const size_t bytes =
      (size_t)t_words(t, piece, fp * nr < f ? fp * nr : f, fp) * sizeof(int);
  if (t > 32768 || piece > 65536 || bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int passes = (f + fp * nr - 1) / (fp * nr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int* arrive = reinterpret_cast<int*>(part + (size_t)t_split * t * f);
  if (t_split > 0)
    cudaMemsetAsync(scratch, 0,
                    ((size_t)t_split * t * f + (size_t)t_split * passes) *
                        sizeof(float),
                    st);
  const int* tp = static_cast<const int*>(tpieces);
  const int* sp = static_cast<const int*>(tsrc_ptr);
  const int* stl = static_cast<const int*>(tsrc_tiles);
  const int* td = static_cast<const int*>(tile_dst);
  const int* ep = static_cast<const int*>(entry_ptr);
  const int* rw = static_cast<const int*>(rows);
  const int* cl = static_cast<const int*>(cols);
  const float* vl = static_cast<const float*>(vals);
  const float* gg = static_cast<const float*>(g);
  float* out = static_cast<float*>(dx);
  // a lane's neighbouring features move 4 or 2 at a time where every row
  // allows (F = 50 takes float2: one float at a time measured slower)
#define B5T_ARGS                                                         \
  tp, n_pieces, sp, stl, td, ep, rw, cl, vl, gg, out, part, arrive, n, t, \
      f, fp, passes, bytes, st
  if (nr == 4 && (f & 3) == 0)
    launch_t<4, 4>(B5T_ARGS);
  else if (nr == 4 && (f & 1) == 0)
    launch_t<4, 2>(B5T_ARGS);
  else if (nr == 2 && (f & 1) == 0)
    launch_t<2, 2>(B5T_ARGS);
  else if (nr == 4)
    launch_t<4, 1>(B5T_ARGS);
  else if (nr == 2)
    launch_t<2, 1>(B5T_ARGS);
  else
    launch_t<1, 1>(B5T_ARGS);
#undef B5T_ARGS
  return (int)cudaGetLastError();
}

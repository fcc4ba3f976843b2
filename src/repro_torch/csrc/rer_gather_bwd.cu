// The backward of RER-Gather on Hopper, over the forward's packed groups.
//
// Backward of the Pallas kernel src/repro/kernels/rer_gather/rer_gather.py::
// rer_gather (_gather_kernel_sum, _gather_kernel_max), which the reference
// differentiates only through XLA: the sum through its packed einsum, the
// max through packed_flat_xla, one segment_max over every merged entry of
// a destination row, which splits the cotangent evenly over all tied
// entries of the row.  The card runs the forward as one launch over every
// pow2 bucket group of a plan; its backward reads the SAME groups, the
// max through the plan's work table (rer_gather_walk.cuh), the sum
// through a source-order table of their tiles, so no carrier of A^T is
// built.  With y the merged forward output and g its cotangent:
//
//   sum:  dX[s, f] += v * g[d, f]                 for every entry (d, s, v)
//   max:  cnt[d, f] = #{entries (d, s, v) of every group : v != 0 and
//                       v * x[s, f] == y[d, f]}
//         dX[s, f] += v * (g[d, f] / cnt[d, f])   for each such entry.
//
// A row with no entry (y finished from -inf to 0) counts nothing and
// sends nothing.  The product v * x is one fp32 multiply (__fmul_rn, no
// contraction), bitwise the forward kernel's, so the ties are found
// exactly.
//
// The max's winner word.  Most (row, feature) pairs of a max have one
// winner, and it is found by the count, which compares every entry with
// y anyway.  So the count keeps, in place of cnt, one int32 word per
// (row, feature), the same buffer:
//   0       no winner;
//   -(s+1)  exactly one winner, of weight 1, from source row s;
//   c >= 1  c winners (tied), or one winner of another weight.
// The backward is three passes, on any weights:
//   1. count (rer_gather_max_count_launch): the walk below adds each
//      lane's winners of a row into the word with an integer atomicAdd
//      (exact in any order, for any count below 2^31), and where a lane
//      found one winner it stores its source (-1 for a weight other
//      than 1) in the scratch buffer, the dX not yet zero-filled; a word
//      that ends at 1 had exactly that one store, so a dense second
//      launch turns it into -(s+1);
//   2. resolve (rer_gather_max_resolve_launch): dense over the words,
//      no walk: where a word names its one winner s and g[d, f] != 0,
//      dX[s, f] += g[d, f], bitwise the walk's 1 * (g / 1); and a flag
//      per row: whether any feature with g != 0 has a word > 0;
//   3. tie walk (rer_gather_bwd_scatter_launch with the flag): the walk
//      below, where an entry of an unflagged row loads only its 4-byte
//      flag, and in a flagged row only the features whose word is a
//      count add v * (g / word).  The walk still reads every entry of
//      the table, flagged or not.
// Where no entry has weight 1 no word names a winner: every word is a
// count, the resolve pass flags every row with a count and a nonzero g,
// and the walk splits those rows exactly as a scatter over every row.
// Why: a destination row's run inside a segment is about one entry on a
// large sparse graph (about 95 entries a 256 x 256 tile on Reddit), so
// the scatter loads per entry the x, g, y and cnt rows (4 KB at width
// 256) only to find each pair's one winner, which the count had already
// compared; the resolve pass reads each word and g once instead, and
// only rows with ties (a ReLU'd message 0 at every in-neighbour) or
// weights other than 1 are walked again.
//
// The max's bound on the H100: bytes, as the forward: 12 B per real entry
// plus the referenced rows of x, y, g and the words, and dX written once.
// Its walks are ONE launch per aggregate over the whole work table (the
// work is the forward's: one warp per segment of <= 64 real entries in
// destination order, lanes over features as `lanes_for` maps them, 32
// entries loaded with one coalesced read and broadcast by __shfl_sync,
// kU entries' x rows in flight per lane):
//   * rer_gather_max_count_launch: for the running destination row the
//     warp keeps y[d] and, per lane and feature, the winners and the
//     last one's source in registers, and flushes them when the row
//     changes with fire-and-forget stores.  A merge of the word by
//     compare-and-swap, which needs no scratch, measured 8% slower at
//     Reddit's width 256 and 36% slower at 41, where rows tied at 0
//     make most flushes wait for a reply;
//   * rer_gather_bwd_scatter_launch, the tie walk: each lane loads, with
//     the x row of each of its kU entries, the entry's g[d], y[d] and
//     cnt[d], all in flight together, and adds v * (g[d] / cnt[d]) for
//     the winners whose g[d] is not 0 into dX[s] with fire-and-forget
//     atomics: the source rows belong to other intervals, so no warp
//     owns them.  It skips the adds of 0, which change nothing in dX:
//     where a row's values tie every entry is a winner, and a row
//     outside a loss's labelled set has g = 0.  Loading g, y and cnt
//     per entry, rather than once per running row in a branch whose
//     loads the next entry waited on, measured 3x faster at F = 64.
// The resolve pass is one warp a row, lanes over features.
// No per-group partial and no pad slot: entries with v == 0 are skipped.
//
// B2^T, the sum (rer_gather_bwd_sum_launch), source-stationary.  Bound:
// bytes, 12 B per real entry, g read and dX written once (0.35 ms at
// Reddit's 79.0 M entries and width 128 at 3.35 TB/s); what sets its
// time is the gathers of g rows, one per entry as the forward's of x
// rows.  A scatter over the forward's segments would add v * g[d] into
// dX[s] with one global float atomic per entry and feature (no warp owns
// a source row), which cost twice the forward at width 128.  Instead:
//   * a source-order table built on the host with the plan
//     (`rer_gather/ops.py::source_table`), per tile and per piece only:
//     the forward groups' tiles with entries sorted by (source interval,
//     destination interval), their entry offsets in that order, each
//     tile's group, index and destination interval, and each source
//     interval's span of that order cut into pieces of at most a few
//     thousand entries, longest first; it copies no entry;
//   * one CTA per (piece, feature pass) stages its piece's tiles in
//     shared memory, then loads the piece's entries from the groups' own
//     slots through gtab, kLB a thread at once (neighbouring threads,
//     neighbouring entries of a tile), counts them per source column
//     with shared integer atomics, and sorts them by column on chip
//     (source_walk.cuh's prefix sum and rank, shared with B5^T);
//   * each lane group sums its run's columns in registers, kUT g rows in
//     flight per lane (float4 or float2 where F allows), and writes each
//     column once: a plain store where the piece holds its whole source
//     interval (a row with no entry stored as 0, so those rows are never
//     zero-filled), a vector `red` into dX for the pieces of a split
//     interval, whose rows alone (the span from the first split
//     interval to the last, one memset) are zeroed first.  No float
//     atomic per entry and feature, and none in shared memory;
//   * shared memory holds the run partials, T + 1 counts, 16 B per tile
//     and 16 B per entry of the longest piece (sizes the table records).
// Numerics: a split column's merges and a cut column's partials add in a
// varying order, so dX agrees with the plain version to fp32 rounding.
#include <cuda_runtime.h>
#include <math.h>

#include "rer_gather_walk.cuh"
#include "source_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kU;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;
using rer_gather_walk::Segment;
using source_walk::align4;
using source_walk::kLB;
using source_walk::merge;
using source_walk::store;

// The count's first pass, the walk: per running row and lane feature,
// the winners c and the source of the last one (-1 where its weight is
// not 1) in registers; at the row change c goes into the word with a
// fire-and-forget atomicAdd, exact in any order, and the source into
// src with a plain store where c is 1: a word that ends at 1 had
// exactly one such store, its lone winner's; where it ends higher, src
// is not read.  Lane = (group g, feature fl); features fb + fl +
// fp * n, n < kNR.  At most 64 registers, so 4 blocks an SM (kNR = 4
// spills 8 bytes): the pass waits on its x loads, and a
// compare-and-swap form of it measured 12% faster on an H100 at
// Reddit's width 256 under this cap than at 72 registers and 3 blocks
// an SM.
template <int kNR>
__global__ void __launch_bounds__(kThreads, 4)
max_count_kernel(const long long* __restrict__ gtab,
                 const int* __restrict__ pieces,
                 const int* __restrict__ poff,
                 const int* __restrict__ seg_ptr, int n_seg,
                 const float* __restrict__ x, const float* __restrict__ y,
                 int* __restrict__ word, int* __restrict__ src, int t,
                 int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;
  const Segment sg =
      rer_gather_walk::segment(gtab, pieces, poff, seg_ptr, s, t);
  const int g = lane / fp, fl = lane % fp, per = fp;
  const int fb = blockIdx.y * fp * kNR;
  // the running row's y, its winners and the last one's source
  int cur = -1;
  int c[kNR], sr[kNR];
  float yv[kNR];
#pragma unroll
  for (int n = 0; n < kNR; ++n) {
    c[n] = sr[n] = 0;
    yv[n] = 0.f;
  }
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = fb + fl + fp * n;
      if (fi < f && c[n]) {
        const size_t at = (size_t)cur * f + fi;
        atomicAdd(word + at, c[n]);
        if (c[n] == 1) src[at] = sr[n];
      }
    }
  };

  for (int e0 = 0; e0 < sg.n_entries; e0 += 32) {
    float v = 0.f;
    int r = 0, sc = 0;
    if (e0 + lane < sg.n_entries) sg.load(e0 + lane, &v, &r, &sc);
    if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
    for (int i0 = 0; i0 < per; i0 += kU) {
      float vv[kU], xv[kU][kNR];
      int rr[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = g * per + i0 + u;
        vv[u] = __shfl_sync(0xffffffffu, v, j);
        rr[u] = __shfl_sync(0xffffffffu, r, j);
        const int cj = __shfl_sync(0xffffffffu, sc, j);
        const float* xr = x + (size_t)cj * f;
#pragma unroll
        for (int n = 0; n < kNR; ++n) {
          const int fi = fb + fl + fp * n;
          xv[u][n] = (vv[u] != 0.f && fi < f) ? xr[fi] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        // the entry's source again, by a shuffle of the whole warp,
        // rather than a register held over the loads
        const int cs = __shfl_sync(0xffffffffu, sc, g * per + i0 + u);
        if (vv[u] == 0.f) continue;
        if (rr[u] != cur) {
          flush();
          cur = rr[u];
#pragma unroll
          for (int n = 0; n < kNR; ++n) {
            const int fi = fb + fl + fp * n;
            c[n] = 0;
            // NaN matches no product: a lane past F counts nothing
            yv[n] = fi < f ? y[(size_t)cur * f + fi]
                           : __int_as_float(0x7fc00000);
          }
        }
        const int ws = vv[u] == 1.f ? cs : -1;
#pragma unroll
        for (int n = 0; n < kNR; ++n) {
          const bool win = __fmul_rn(vv[u], xv[u][n]) == yv[n];
          c[n] += win;
          if (win) sr[n] = ws;
        }
      }
    }
  }
  flush();
}

// The count's second pass, dense over the n words: a word of 1 whose
// stored source s is not -1 becomes -(s+1).
template <int kNR>
__global__ void __launch_bounds__(kThreads)
max_count_kernel(int* __restrict__ word, const int* __restrict__ src,
                 long long n) {
  const long long base = (long long)blockIdx.x * kThreads * kNR + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kNR; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n && word[i] == 1) {
      const int s = src[i];
      if (s >= 0) word[i] = -(s + 1);
    }
  }
}

// The resolve pass, one warp a row d, lanes over features, kNR of them
// in flight a lane: where the word names one winner s of weight 1,
// dX[s, f] += g[d, f] (bitwise the walk's 1 * (g / 1)); flag[d] = 1
// where a feature of d with g != 0 has a word > 0 (ties, or one winner
// of another weight), which the walk then visits; 0 elsewhere.  Adds of
// 0 are skipped, as in the walk.  With `walked`, each block adds its
// flagged rows into it (one atomic a block).
template <int kNR>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ word, const float* __restrict__ gy,
               float* __restrict__ dx, int* __restrict__ flag, int rows,
               int f, unsigned long long* __restrict__ walked) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = d < rows;
  bool walk = false;
  if (live) {
    const int* wr = word + (size_t)d * f;
    const float* gr = gy + (size_t)d * f;
    for (int f0 = lane; f0 < f; f0 += 32 * kNR) {
      int wv[kNR];
      float gv[kNR];
#pragma unroll
      for (int n = 0; n < kNR; ++n) {
        const int fi = f0 + 32 * n;
        wv[n] = fi < f ? wr[fi] : 0;
        gv[n] = fi < f ? gr[fi] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kNR; ++n) {
        if (gv[n] == 0.f) continue;
        if (wv[n] < 0)
          atomicAdd(dx + (size_t)(-wv[n] - 1) * f + f0 + 32 * n, gv[n]);
        else if (wv[n] > 0)
          walk = true;
      }
    }
  }
  const bool any = __any_sync(0xffffffffu, walk);
  if (live && lane == 0) flag[d] = any;
  if (walked != nullptr) {
    const int n = __syncthreads_count(lane == 0 && any);
    if (threadIdx.x == 0 && n > 0)
      atomicAdd(walked, (unsigned long long)n);
  }
}

// The max's tie walk: cnt holds the words and `flag` the resolve pass's
// row flags (entries of an unflagged row are skipped, and so are the
// features whose word is not a count: their winner is resolved).  kMax
// is always true: it keeps the kernel's name, scatter_kernel<true, R>,
// apart from the resolve pass's scatter_kernel<R> in a trace.
template <bool kMax, int kNR>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ gtab,
               const int* __restrict__ pieces, const int* __restrict__ poff,
               const int* __restrict__ seg_ptr, int n_seg,
               const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gy, const int* __restrict__ cnt,
               float* __restrict__ dx, int t, int f, int fp,
               const int* __restrict__ flag) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;
  const Segment sg =
      rer_gather_walk::segment(gtab, pieces, poff, seg_ptr, s, t);
  const int g = lane / fp, fl = lane % fp, per = fp;
  const int fb = blockIdx.y * fp * kNR;
  for (int e0 = 0; e0 < sg.n_entries; e0 += 32) {
    float v = 0.f;
    int r = 0, sc = 0;
    if (e0 + lane < sg.n_entries) sg.load(e0 + lane, &v, &r, &sc);
    if (v != 0.f && flag[r] == 0) v = 0.f;
    if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
    for (int i0 = 0; i0 < per; i0 += kU) {
      float vv[kU], xv[kU][kNR], yv[kU][kNR], gv[kU][kNR];
      int cv[kU][kNR], cc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = g * per + i0 + u;
        vv[u] = __shfl_sync(0xffffffffu, v, j);
        const int rr = __shfl_sync(0xffffffffu, r, j);
        cc[u] = __shfl_sync(0xffffffffu, sc, j);
#pragma unroll
        for (int n = 0; n < kNR; ++n) {
          const int fi = fb + fl + fp * n;
          const bool ok = vv[u] != 0.f && fi < f;
          const size_t at = (size_t)rr * f + fi;
          gv[u][n] = ok ? gy[at] : 0.f;
          xv[u][n] = ok ? x[(size_t)cc[u] * f + fi] : 0.f;
          yv[u][n] = ok ? y[at] : 0.f;
          cv[u][n] = ok ? cnt[at] : 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (vv[u] == 0.f) continue;
        float* drow = dx + (size_t)cc[u] * f;
#pragma unroll
        for (int n = 0; n < kNR; ++n) {
          const int fi = fb + fl + fp * n;
          if (fi >= f) continue;
          if (gv[u][n] != 0.f && cv[u][n] > 0 &&
              __fmul_rn(vv[u], xv[u][n]) == yv[u][n])
            atomicAdd(drow + fi, vv[u] * (gv[u][n] / (float)cv[u][n]));
        }
      }
    }
  }
}

// B2^T's entries whose g rows a lane has in flight: 4, with more CTAs an
// SM (62 registers at F = 128), measured 24% faster at Reddit's width
// 128 and 30% at 41 than 8 (90 and 114 registers), and 2 no faster
constexpr int kUT = 4;

// B2^T, the sum's dX = A^T G: see the head of this file.  spieces: (P, 6)
// int32 rows (source interval, first, end (offsets in the source order),
// split (1 where the interval has other pieces), first tile, end tile);
// sptr (K'+1): each source-ordered tile's first offset; stiles (K', 3):
// its group, its index within the group and its destination interval;
// gtab (G, 4): each group's rows, cols and vals pointers and its slot
// count S.  g and dx (q*T, F) row-major: an unsplit interval's rows are
// stored, a split one's added into rows zeroed before.  A lane holds kNR
// features: with kV = 4 or 2 (F a multiple of kV) neighbouring ones,
// else every fp-th.  merged, where not null, takes the columns with
// entries of each split piece (the dX rows it adds; feature pass 0).
template <int kNR, int kV>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ gtab,
               const int* __restrict__ spieces, const int* __restrict__ sptr,
               const int* __restrict__ stiles, const float* __restrict__ g,
               float* __restrict__ dx, int t, int f, int fp,
               unsigned long long* __restrict__ merged) {
  extern __shared__ __align__(16) int smem_s[];
  __shared__ int warp_sums[kWarps];
  __shared__ int n_merged;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pc = spieces + 6 * blockIdx.x;
  const int src = pc[0], lo = pc[1], hi = pc[2], split = pc[3];
  const int jb = pc[4], nt = pc[5] - pc[4];
  const int ne = hi - lo;
  const int fb = blockIdx.y * fp * kNR;
  const int wf = min(fp * kNR, f - fb);
  const int nk = kWarps * (32 / fp);  // runs: one per lane group
  // per run two wf-float partials (of the column its start cuts and of
  // the one its end cuts); per column of the interval its entry count,
  // then its first sorted entry; per tile of the piece its first offset
  // (one more), group, index and first g row; per entry as loaded:
  // column << 16 | rank within the column, g row, value; then the
  // entries in column order
  float* part_first = reinterpret_cast<float*>(smem_s);
  float* part_last = part_first + align4(nk * wf);
  int* base = reinterpret_cast<int*>(part_last + align4(nk * wf));
  int* s_ptr = base + align4(t + 1);
  int* s_grp = s_ptr + nt + 1;
  int* s_tile = s_grp + nt;
  int* s_row0 = s_tile + nt;
  int* e_key = s_row0 + nt;
  int* e_row = e_key + ne;
  float* e_val = reinterpret_cast<float*>(e_row + ne);
  int* order = reinterpret_cast<int*>(e_val + ne);

  // 1. the piece's tiles; zero counts and partials
  for (int i = tid; i <= nt; i += kThreads) {
    s_ptr[i] = __ldg(sptr + jb + i);
    if (i < nt) {
      const int* st = stiles + 3 * (jb + i);
      s_grp[i] = __ldg(st);
      s_tile[i] = __ldg(st + 1);
      s_row0[i] = __ldg(st + 2) * t;
    }
  }
  for (int i = tid; i <= t; i += kThreads) base[i] = 0;
  for (int i = tid; i < 2 * align4(nk * wf); i += kThreads)
    part_first[i] = 0.f;
  if (tid == 0) n_merged = 0;
  __syncthreads();

  // 2. its entries, kLB a thread at once (neighbouring threads read
  //    neighbouring slots of a tile), counted per column
  for (int i0 = 0; i0 < ne; i0 += kThreads * kLB) {
    const long long* gt[kLB];
    size_t slot[kLB];
    int r0[kLB], cc[kLB], rw[kLB];
    float vv[kLB];
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      const int i = i0 + b * kThreads + tid;
      gt[b] = nullptr;
      if (i < ne) {
        const int jl = source_walk::last_le(s_ptr, 0, nt - 1, lo + i);
        gt[b] = gtab + 4 * s_grp[jl];
        slot[b] = (size_t)s_tile[jl] * (size_t)__ldg(gt[b] + 3) + lo + i -
                  s_ptr[jl];
        r0[b] = s_row0[jl];
      }
    }
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      if (gt[b] == nullptr) continue;
      rw[b] = __ldg(reinterpret_cast<const int*>(__ldg(gt[b])) + slot[b]);
      cc[b] = __ldg(reinterpret_cast<const int*>(__ldg(gt[b] + 1)) + slot[b]);
      vv[b] = __ldg(reinterpret_cast<const float*>(__ldg(gt[b] + 2)) +
                    slot[b]);
    }
#pragma unroll
    for (int b = 0; b < kLB; ++b) {
      if (gt[b] == nullptr) continue;
      const int i = i0 + b * kThreads + tid;
      e_key[i] = (cc[b] << 16) | atomicAdd(base + cc[b], 1);
      e_row[i] = r0[b] + rw[b];
      e_val[i] = vv[b];
    }
  }
  __syncthreads();

  // 3. sorted by column on chip
  source_walk::sort_by_column(e_key, base, order, ne, t, warp_sums);

  // 4. each lane group's run: a column wholly in it stored once, or for
  //    a split interval added into dX with one vector `red`
  const source_walk::Cuts cuts{e_key, order, base, ne, nk};
  float* drow0 = dx + (size_t)src * t * f + fb;
  source_walk::walk_runs<kNR, kV, kUT>(
      cuts, e_row, e_val, g, f, fb, wf, fp, part_first, part_last,
      [&](int c, int fi, const float* v) {
        if (split)
          merge<kV>(drow0 + (size_t)c * f + fi, v);
        else
          store<kV>(drow0 + (size_t)c * f + fi, v);
      });
  __syncthreads();

  // 5. the columns a cut falls inside, from their partials; an unsplit
  //    interval's rows without an entry are zero
  source_walk::sum_cuts(cuts, wf, part_first, part_last,
                        [&](int c, int fi, float v) {
                          if (split)
                            merge<1>(drow0 + (size_t)c * f + fi, &v);
                          else
                            __stcs(drow0 + (size_t)c * f + fi, v);
                        });
  if (!split) {
    for (int rl = warp; rl < t; rl += kWarps)
      if (base[rl + 1] == base[rl])
        for (int c = lane; c < wf; c += 32)
          __stcs(drow0 + (size_t)rl * f + c, 0.f);
    return;
  }
  if (merged == nullptr || blockIdx.y != 0) return;
  int mine = 0;
  for (int c = tid; c < t; c += kThreads) mine += base[c + 1] > base[c];
  if (mine) atomicAdd(&n_merged, mine);
  __syncthreads();
  if (tid == 0 && n_merged)
    atomicAdd(merged, (unsigned long long)n_merged);
}

template <int kNR>
void launch_count(const long long* gtab, const int* pieces, const int* poff,
                  const int* seg_ptr, int n_seg, const float* x,
                  const float* y, int* word, int* src, int t, int f, int fp,
                  cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  max_count_kernel<kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, x, y, word, src, t, f, fp);
}

template <int kNR>
void launch_walk(const long long* gtab, const int* pieces, const int* poff,
                 const int* seg_ptr, int n_seg, const float* x,
                 const float* y, const float* gy, const int* cnt, float* dx,
                 int t, int f, int fp, const int* flag, cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  scatter_kernel<true, kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, x, y, gy, cnt, dx, t, f, fp, flag);
}

// B2^T's dynamic shared memory (4-byte words, the kernel's layout) at
// tile t, pieces of at most `piece` entries over at most `tiles` tiles,
// wf features a pass and fp lanes over them
constexpr int sum_words(int t, int piece, int tiles, int wf, int fp) {
  return 2 * align4(kWarps * (32 / fp) * wf) + align4(t + 1) +
         4 * tiles + 1 + 4 * piece;
}

using SumKernel = void (*)(const long long*, const int*, const int*,
                           const int*, const float*, float*, int, int, int,
                           unsigned long long*);

template <int kNR, int kV>
void launch_sum(const long long* gtab, const int* spieces, int n_pieces,
                const int* sptr, const int* stiles, const float* g, float* dx,
                int t, int f, int fp, int passes, size_t smem,
                unsigned long long* merged, cudaStream_t st) {
  const SumKernel kernel = scatter_kernel<kNR, kV>;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    smem_set = smem;
  }
  const dim3 grid((unsigned)n_pieces, (unsigned)passes);
  kernel<<<grid, kThreads, smem, st>>>(gtab, spieces, sptr, stiles, g, dx, t,
                                       f, fp, merged);
}

}  // namespace

// word (q*T, F) int32: the winner word of every destination row and
// feature over the whole work table (0: none; -(s+1): one winner, of
// weight 1, from source s; c >= 1: c winners, or one of another weight),
// zero-filled here.  scratch, 4 bytes of the same shape (the backward's
// dX before the resolve pass zero-fills it), takes the sources between
// the walk and the dense second launch.  x is the forward's input, y
// its finished output.
extern "C" int rer_gather_max_count_launch(const void* gtab,
                                           const void* pieces,
                                           const void* poff,
                                           const void* seg_ptr, int n_seg,
                                           const void* x, const void* y,
                                           void* word, void* scratch, int q,
                                           int t, int f, void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)q * t * f;
  cudaMemsetAsync(word, 0, (size_t)n * sizeof(int), st);
  if (n_seg > 0) {
    const long long* gt = static_cast<const long long*>(gtab);
    const int* pc = static_cast<const int*>(pieces);
    const int* po = static_cast<const int*>(poff);
    const int* sp = static_cast<const int*>(seg_ptr);
    const float* xx = static_cast<const float*>(x);
    const float* yy = static_cast<const float*>(y);
    int* ww = static_cast<int*>(word);
    int* sc = static_cast<int*>(scratch);
    int nr;
    const int fp = lanes_for(f, &nr);
    if (nr == 1)
      launch_count<1>(gt, pc, po, sp, n_seg, xx, yy, ww, sc, t, f, fp, st);
    else if (nr == 2)
      launch_count<2>(gt, pc, po, sp, n_seg, xx, yy, ww, sc, t, f, fp, st);
    else
      launch_count<4>(gt, pc, po, sp, n_seg, xx, yy, ww, sc, t, f, fp, st);
    max_count_kernel<4><<<(unsigned)((n + kThreads * 4 - 1) / (kThreads * 4)),
                          kThreads, 0, st>>>(ww, sc, n);
  }
  return (int)cudaGetLastError();
}

// The resolve pass over the words of rer_gather_max_count_launch and the
// cotangent g, both (rows, F): dX (rows, F), zero-filled here, takes the
// adds of the lone winners of weight 1, and flag (rows,) int32 is 1 for
// the rows the walk must visit, 0 for the others.  walked, where not
// null, is one uint64 that the flagged rows are added into.
extern "C" int rer_gather_max_resolve_launch(const void* word,
                                             const void* g, void* dx,
                                             void* flag, void* walked,
                                             int rows, int f, void* stream) {
  if (rows == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dx, 0, (size_t)rows * f * sizeof(float), st);
  const int* ww = static_cast<const int*>(word);
  const float* gg = static_cast<const float*>(g);
  float* dd = static_cast<float*>(dx);
  int* fl = static_cast<int*>(flag);
  unsigned long long* wk = static_cast<unsigned long long*>(walked);
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  if (f > 64)
    scatter_kernel<4><<<grid, kThreads, 0, st>>>(ww, gg, dd, fl, rows, f, wk);
  else if (f > 32)
    scatter_kernel<2><<<grid, kThreads, 0, st>>>(ww, gg, dd, fl, rows, f, wk);
  else
    scatter_kernel<1><<<grid, kThreads, 0, st>>>(ww, gg, dd, fl, rows, f, wk);
  return (int)cudaGetLastError();
}

// The max's tie walk over the whole work table: dX (q*T, F) for the
// cotangent g, with the words in cnt and the resolve pass's flag; walks
// the flagged rows, adds only where a word is a count, and adds into the
// dX of the resolve pass.
extern "C" int rer_gather_bwd_scatter_launch(
    const void* gtab, const void* pieces, const void* poff,
    const void* seg_ptr, int n_seg, const void* x, const void* y,
    const void* g, const void* cnt, const void* flag, void* dx, int q,
    int t, int f, void* stream) {
  if (flag == nullptr) return (int)cudaErrorInvalidValue;
  if (q == 0 || t == 0 || f == 0 || n_seg == 0)
    return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* gt = static_cast<const long long*>(gtab);
  const int* pc = static_cast<const int*>(pieces);
  const int* po = static_cast<const int*>(poff);
  const int* sp = static_cast<const int*>(seg_ptr);
  const float* xx = static_cast<const float*>(x);
  const float* yy = static_cast<const float*>(y);
  const float* gg = static_cast<const float*>(g);
  const int* cc = static_cast<const int*>(cnt);
  const int* fg = static_cast<const int*>(flag);
  float* dd = static_cast<float*>(dx);
  int nr;
  const int fp = lanes_for(f, &nr);
  if (nr == 1)
    launch_walk<1>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t, f, fp, fg,
                   st);
  else if (nr == 2)
    launch_walk<2>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t, f, fp, fg,
                   st);
  else
    launch_walk<4>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t, f, fp, fg,
                   st);
  return (int)cudaGetLastError();
}

// B2^T: dx (q*T, F) = A^T g over the groups of gtab through the source
// table (spieces over sptr / stiles, pieces of at most `piece` entries
// over at most `tiles` tiles).  The rows of intervals [zero_lo, zero_hi),
// the span of the split ones, are zero-filled here (one memset); every
// other row is stored by its interval's one CTA a pass.  merged, where
// not null, is one uint64 that the split pieces' merged rows are added
// into.
extern "C" int rer_gather_bwd_sum_launch(
    const void* gtab, const void* spieces, int n_pieces, const void* sptr,
    const void* stiles, int piece, int tiles, int zero_lo, int zero_hi,
    const void* g, void* dx, int q, int t, int f, void* merged,
    void* stream) {
  if (n_pieces == 0 || q == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  int nr;
  const int fp = source_walk::queue_lanes(f, &nr);
  // the piece's arrays fit the CTA; a column and its rank share one
  // non-negative int: a column below 2^15, a rank below 2^16
  const size_t bytes =
      (size_t)sum_words(t, piece, tiles, fp * nr < f ? fp * nr : f, fp) *
      sizeof(int);
  if (t > 32768 || piece > 65536 || bytes > source_walk::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int passes = (f + fp * nr - 1) / (fp * nr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dx);
  if (zero_hi > zero_lo)
    cudaMemsetAsync(out + (size_t)zero_lo * t * f, 0,
                    (size_t)(zero_hi - zero_lo) * t * f * sizeof(float), st);
  const long long* gt = static_cast<const long long*>(gtab);
  const int* sp = static_cast<const int*>(spieces);
  const int* pt = static_cast<const int*>(sptr);
  const int* tl = static_cast<const int*>(stiles);
  const float* gg = static_cast<const float*>(g);
  unsigned long long* mg = static_cast<unsigned long long*>(merged);
  // a lane's neighbouring features move 4 or 2 at a time where every row
  // (and g, which may be a view) allows
  const size_t al = reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(dx);
  const bool by4 = (f & 3) == 0 && (al & 15) == 0;
  const bool by2 = (f & 1) == 0 && (al & 7) == 0;
#define B2T_ARGS \
  gt, sp, n_pieces, pt, tl, gg, out, t, f, fp, passes, bytes, mg, st
  if (nr == 4 && by4)
    launch_sum<4, 4>(B2T_ARGS);
  else if (nr == 4 && by2)
    launch_sum<4, 2>(B2T_ARGS);
  else if (nr == 2 && by2)
    launch_sum<2, 2>(B2T_ARGS);
  else if (nr == 4 && 3 * fp >= f)
    // three features a lane where they cover F (F = 41: 10% faster than
    // four at Reddit's shapes, 63 registers against 79)
    launch_sum<3, 1>(B2T_ARGS);
  else if (nr == 4)
    launch_sum<4, 1>(B2T_ARGS);
  else if (nr == 2)
    launch_sum<2, 1>(B2T_ARGS);
  else
    launch_sum<1, 1>(B2T_ARGS);
#undef B2T_ARGS
  return (int)cudaGetLastError();
}

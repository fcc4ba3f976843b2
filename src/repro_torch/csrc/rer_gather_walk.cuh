// The work-table walk of RER-Gather, shared by the forward
// (rer_gather.cu), its backward passes (rer_gather_bwd.cu) and Gated-GCN's
// destination walks (rer_gather_gated.cu), and the warp walker `walk_op`
// of the forward, shared with the chunk-queue walker (chunk_queue.cu) and
// the gated walks (their own gather and fold).
//
// A plan's bucket groups are described by:
//   gtab    (G, 4) int64: the rows, cols and vals device pointers and the
//           slot count S of each group;
//   pieces  (P, 6) int32: (group, tile, lo, hi, dst interval, src
//           interval), the real entries [lo, hi) of one tile, sorted by
//           destination interval;
//   poff    (P,) int32: each piece's first entry within its segment;
//   seg_ptr (n_seg + 1) int32: segment s is pieces [seg_ptr[s],
//           seg_ptr[s+1]), at most SEG_ENTRIES (64) entries
// (`rer_gather/ops.py::work_table`, built on the host with the plan).
// One warp walks one segment as one run of entries, 32 at a time; each
// lane finds the piece of its entry by a binary search of poff, so a
// chunk of 32 entries spans as many small tiles as it needs and no pad
// slot is ever read.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rer_gather_walk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;        // entries gathered per lane per batch

struct Segment {
  const long long* gtab;
  const int* pieces;
  const int* poff;
  int p_lo, p_hi;     // its pieces
  int n_entries;      // its entries
  int t;

  // entry e of the segment: its weight v, its global destination (Y) row
  // r and source (X) row c; rows and cols are read only where v != 0
  __device__ __forceinline__ void load(int e, float* v, int* r,
                                       int* c) const {
    int lo = p_lo, hi = p_hi - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (poff[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int* pc = pieces + 6 * lo;
    const long long* gt = gtab + 4 * pc[0];
    const size_t slot =
        (size_t)pc[1] * (size_t)gt[3] + pc[2] + (e - poff[lo]);
    *v = reinterpret_cast<const float*>(gt[2])[slot];
    if (*v != 0.f) {
      *r = pc[4] * t + reinterpret_cast<const int*>(gt[0])[slot];
      *c = pc[5] * t + reinterpret_cast<const int*>(gt[1])[slot];
    }
  }
};

__device__ __forceinline__ Segment segment(const long long* gtab,
                                           const int* pieces,
                                           const int* poff,
                                           const int* seg_ptr, int s,
                                           int t) {
  Segment sg;
  sg.gtab = gtab;
  sg.pieces = pieces;
  sg.poff = poff;
  sg.p_lo = seg_ptr[s];
  sg.p_hi = seg_ptr[s + 1];
  const int* last = pieces + 6 * (sg.p_hi - 1);
  sg.n_entries = poff[sg.p_hi - 1] + last[3] - last[2];
  sg.t = t;
  return sg;
}

// Lanes per entry fp and features per lane nr for width f: one pass of
// fp * nr features (f <= 32: fp = pow2(f) >= 4, nr = 1; f <= 64: 32 x 2;
// wider: 32 x 4 per pass, gridDim.y passes).  A lane is (group g =
// lane / fp, feature fl = lane % fp): the 32 / fp groups take different
// entries of a 32-entry chunk, fp entries each, in order.
inline int lanes_for(int f, int* nr) {
  if (f > 64) {
    *nr = 4;
    return 32;
  }
  if (f > 32) {
    *nr = 2;
    return 32;
  }
  *nr = 1;
  int fp = 4;
  while (fp < f) fp <<= 1;
  return fp;
}

inline dim3 grid_for_table(int n_seg, int f, int fp, int nr) {
  return dim3((unsigned)((n_seg + kWarps - 1) / kWarps),
              (unsigned)((f + fp * nr - 1) / (fp * nr)));
}

// `walk`'s gather and fold: each entry's X row, summed (or maxed) with
// its weight v.  An op of `walk_op` has: Item, one entry's values in a
// lane's registers; empty(), a row's value before any entry (a row still
// at it is not flushed); gather(item, v, r, c, fresh, f0, fp), the loads
// of entry (v, Y row r, X row c) for the lane's features f0 + fp * n
// (fresh: r is not the row of the group's last entry with v != 0); enter
// (item), at the first entry of a row; fold(acc, v, item).
template <bool kMax, int kNR>
struct XFold {
  const float* __restrict__ x;
  int f;
  struct Item {
    float x[kNR];
  };
  __device__ __forceinline__ float empty() const {
    return kMax ? -INFINITY : 0.f;
  }
  __device__ __forceinline__ void gather(Item& it, float v, int, int c,
                                         bool, int f0, int fp) const {
    const float* xr = x + (size_t)c * f;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = f0 + fp * n;
      it.x[n] = (v != 0.f && fi < f) ? xr[fi] : 0.f;
    }
  }
  __device__ __forceinline__ void enter(const Item&) {}
  __device__ __forceinline__ void fold(float* acc, float v,
                                       const Item& it) const {
#pragma unroll
    for (int n = 0; n < kNR; ++n)
      acc[n] = kMax ? fmaxf(acc[n], v * it.x[n]) : fmaf(v, it.x[n], acc[n]);
  }
};

// One warp walks n_entries entries, 32 at a time, and reduces each
// destination row's values in registers, flushing to `sink` only when
// the row changes (the entries of a tile are row-sorted).  The whole warp
// calls load(e0, &v, &row, &src) for the chunk [e0, e0 + 32): each lane
// fills entry e0 + lane's weight, Y row and X row (v stays 0 past the end
// or where the entry is skipped; row and src are read only where v != 0),
// so a Load may use warp collectives.  Lane = (group g, feature fl), as
// `lanes_for` maps them; features fb + fl + fp * n, n < kNR; kU entries'
// gathers are in flight per lane, `op` (XFold's form) loading and folding
// them.  sink(row, feature, value) takes a row's finished value unless it
// is still op.empty().  kFew: fp < kU (fewer than kU entries a group, a
// pass of under 4 features, which `lanes_for` never maps; the chunk-queue
// walker's narrow passes over tall intervals): the batch is cut at the
// group's end (a lane past 31 wraps in the shuffle, its value dropped).
template <int kNR, bool kFew = false, typename Load, typename Op,
          typename Sink>
__device__ __forceinline__ void walk_op(int n_entries, Load load, Op& op,
                                        Sink sink, int f, int fb, int fp,
                                        int lane) {
  const int g = lane / fp, fl = lane % fp;
  const int per = fp;  // entries per group in a 32-entry chunk
  const float empty = op.empty();
  int cur = -1;
  float acc[kNR];
#pragma unroll
  for (int n = 0; n < kNR; ++n) acc[n] = empty;

  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = fb + fl + fp * n;
      if (fi >= f) continue;
      if (acc[n] != empty) sink(cur, fi, acc[n]);
      acc[n] = empty;
    }
  };

  for (int e0 = 0; e0 < n_entries; e0 += 32) {
    float v = 0.f;
    int r = 0, c = 0;
    load(e0, &v, &r, &c);
    if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
    for (int i0 = 0; i0 < per; i0 += kU) {
      float vv[kU];
      int rr[kU];
      typename Op::Item it[kU];
      int last = cur;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = g * per + i0 + u;
        vv[u] = __shfl_sync(0xffffffffu, v, j);
        if (kFew && i0 + u >= per) vv[u] = 0.f;
        rr[u] = __shfl_sync(0xffffffffu, r, j);
        const int cj = __shfl_sync(0xffffffffu, c, j);
        op.gather(it[u], vv[u], rr[u], cj, rr[u] != last, fb + fl, fp);
        if (vv[u] != 0.f) last = rr[u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (vv[u] == 0.f) continue;
        if (rr[u] != cur) {
          flush();
          cur = rr[u];
          op.enter(it[u]);
        }
        op.fold(acc, vv[u], it[u]);
      }
    }
  }
  flush();
}

// `walk_op` summing (kMax false) or maxing each entry's X row times v.
template <bool kMax, int kNR, typename Load, typename Sink,
          bool kFew = false>
__device__ __forceinline__ void walk(int n_entries, Load load, Sink sink,
                                     const float* __restrict__ x, int f,
                                     int fb, int fp, int lane) {
  XFold<kMax, kNR> op{x, f};
  walk_op<kNR, kFew>(n_entries, load, op, sink, f, fb, fp, lane);
}

}  // namespace rer_gather_walk

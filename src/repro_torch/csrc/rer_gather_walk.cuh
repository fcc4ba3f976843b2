// The work-table walk of RER-Gather, shared by the forward
// (rer_gather.cu) and its backward passes (rer_gather_bwd.cu), and the
// warp walker `walk` of the forward, shared with the chunk-queue walker
// (chunk_queue.cu).
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

// One warp walks n_entries entries, 32 at a time, and reduces each
// destination row's products in registers, flushing to `sink` only when
// the row changes (the entries of a tile are row-sorted).  The whole warp
// calls load(e0, &v, &row, &src) for the chunk [e0, e0 + 32): each lane
// fills entry e0 + lane's weight, Y row and X row (v stays 0 past the end
// or where the entry is skipped; row and src are read only where v != 0),
// so a Load may use warp collectives.  Lane = (group g, feature fl), as
// `lanes_for` maps them; features fb + fl + fp * n, n < kNR; kU entries'
// X values are in flight per lane.  sink(row, feature, value) takes a
// row's finished sum or max; a row with nothing (0 for a sum, -inf for a
// max) is not flushed.
template <bool kMax, int kNR, typename Load, typename Sink>
__device__ __forceinline__ void walk(int n_entries, Load load, Sink sink,
                                     const float* __restrict__ x, int f,
                                     int fb, int fp, int lane) {
  const int g = lane / fp, fl = lane % fp;
  const int per = fp;  // entries per group in a 32-entry chunk
  int cur = -1;
  float acc[kNR];
#pragma unroll
  for (int n = 0; n < kNR; ++n) acc[n] = kMax ? -INFINITY : 0.f;

  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = fb + fl + fp * n;
      if (fi >= f) continue;
      if (kMax ? acc[n] != -INFINITY : acc[n] != 0.f) sink(cur, fi, acc[n]);
      acc[n] = kMax ? -INFINITY : 0.f;
    }
  };

  for (int e0 = 0; e0 < n_entries; e0 += 32) {
    float v = 0.f;
    int r = 0, c = 0;
    load(e0, &v, &r, &c);
    if (__ballot_sync(0xffffffffu, v != 0.f) == 0u) continue;
    for (int i0 = 0; i0 < per; i0 += kU) {
      float vv[kU], xv[kU][kNR];
      int rr[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = g * per + i0 + u;
        vv[u] = __shfl_sync(0xffffffffu, v, j);
        rr[u] = __shfl_sync(0xffffffffu, r, j);
        const int cj = __shfl_sync(0xffffffffu, c, j);
        const float* xr = x + (size_t)cj * f;
#pragma unroll
        for (int n = 0; n < kNR; ++n) {
          const int fi = fb + fl + fp * n;
          xv[u][n] = (vv[u] != 0.f && fi < f) ? xr[fi] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (vv[u] == 0.f) continue;
        if (rr[u] != cur) {
          flush();
          cur = rr[u];
        }
#pragma unroll
        for (int n = 0; n < kNR; ++n)
          acc[n] = kMax ? fmaxf(acc[n], vv[u] * xv[u][n])
                        : fmaf(vv[u], xv[u][n], acc[n]);
      }
    }
  }
  flush();
}

}  // namespace rer_gather_walk

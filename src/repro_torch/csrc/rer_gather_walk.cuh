// The work-table walk of RER-Gather, shared by the forward
// (rer_gather.cu) and its backward passes (rer_gather_bwd.cu).
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

}  // namespace rer_gather_walk

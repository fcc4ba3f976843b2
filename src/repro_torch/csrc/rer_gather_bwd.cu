// The backward of RER-Gather on Hopper, over the forward's packed groups.
//
// Backward of the Pallas kernel src/repro/kernels/rer_gather/rer_gather.py::
// rer_gather (_gather_kernel_sum, _gather_kernel_max), which the reference
// differentiates only through XLA: the sum through its packed einsum, the
// max through packed_flat_xla, one segment_max over every merged entry of
// a destination row, which splits the cotangent evenly over all tied
// entries of the row.  The card runs the forward as one launch over every
// pow2 bucket group of a plan; its backward walks the SAME groups through
// the plan's work table (rer_gather_walk.cuh), so no carrier of A^T is
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
// Where no entry of the plan has weight 1, no word can be -(s+1): the
// words are the counts, and the backward is the two passes count and
// scatter (every row walked).  Otherwise it is three passes:
//   1. count (rer_gather_max_count_launch with a scratch buffer): the
//      walk below adds each lane's winners of a row into the word with
//      an integer atomicAdd (exact in any order, for any count below
//      2^31), and where a lane found one winner it stores its source (-1
//      for a weight other than 1) in the scratch buffer, the dX not yet
//      zero-filled; a word that ends at 1 had exactly that one store, so
//      a dense second launch turns it into -(s+1);
//   2. resolve (rer_gather_max_resolve_launch): dense over the words,
//      no walk: where a word names its one winner s and g[d, f] != 0,
//      dX[s, f] += g[d, f], bitwise the walk's 1 * (g / 1); and a flag
//      per row: whether any feature with g != 0 has a word > 0;
//   3. tie walk (rer_gather_bwd_scatter_launch with the flag): the walk
//      below, where an entry of an unflagged row loads only its 4-byte
//      flag, and in a flagged row only the features whose word is a
//      count add v * (g / word).  The walk still reads every entry of
//      the table, flagged or not.
// Why: a destination row's run inside a segment is about one entry on a
// large sparse graph (about 95 entries a 256 x 256 tile on Reddit), so
// the scatter loads per entry the x, g, y and cnt rows (4 KB at width
// 256) only to find each pair's one winner, which the count had already
// compared; the resolve pass reads each word and g once instead, and
// only rows with ties (a ReLU'd message 0 at every in-neighbour) or
// weights other than 1 are walked again.
//
// Bound on the H100: bytes, as the forward: 12 B per real entry plus the
// referenced rows of x, y, g and the words, and dX written once.  The
// walks are ONE launch per aggregate over the whole work table (the work
// is the forward's: one warp per segment of <= 64 real entries in
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
//   * rer_gather_bwd_scatter_launch (op flag): each lane loads, with the
//     x row of each of its kU entries, the entry's g[d] (max: also y[d]
//     and cnt[d]), all in flight together, and adds v * g[d] (max:
//     v * (g[d] / cnt[d]) for the winners whose g[d] is not 0) into
//     dX[s] with fire-and-forget atomics: the source rows belong to
//     other intervals, so no warp owns them, and the order of the adds
//     varies from run to run.  A max skips the adds of 0, which change
//     nothing in dX: where a row's values tie every entry is a winner,
//     and a row outside a loss's labelled set has g = 0.  Loading g, y
//     and cnt per entry, rather than once per running row in a branch
//     whose loads the next entry waited on, measured 3x faster for max
//     at F = 64 and 1.2x for sum.
// The resolve pass is one warp a row, lanes over features.
// No per-group partial and no pad slot: entries with v == 0 are skipped.
#include <cuda_runtime.h>
#include <math.h>

#include "rer_gather_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kU;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;
using rer_gather_walk::Segment;

// The count's first pass, the walk: per running row and lane feature,
// the winners c in registers; at the row change c goes into the word
// with a fire-and-forget atomicAdd, exact in any order.  With kSrc, the
// source of the last winner too (-1 where its weight is not 1), which
// goes into src with a plain store where c is 1: a word that ends at 1
// had exactly one such store, its lone winner's; where it ends higher,
// src is not read.  Lane = (group g, feature fl); features fb + fl +
// fp * n, n < kNR.  With kSrc at most 64 registers, so 4 blocks an SM
// (kNR = 4 spills 8 bytes): the pass waits on its x loads, and a
// compare-and-swap form of it measured 12% faster on an H100 at
// Reddit's width 256 under this cap than at 72 registers and 3 blocks
// an SM.  Without kSrc it is the plain count.
template <int kNR, bool kSrc>
__global__ void __launch_bounds__(kThreads, kSrc ? 4 : 1)
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
        if constexpr (kSrc) {
          if (c[n] == 1) src[at] = sr[n];
        }
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
        int cs = 0;
        if constexpr (kSrc)
          cs = __shfl_sync(0xffffffffu, sc, g * per + i0 + u);
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
          if constexpr (kSrc) {
            if (win) sr[n] = ws;
          }
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

// dX of the sum (kMax false: x, y, cnt and flag unused) or of the max:
// cnt holds the counts, or with kFlag the words and `flag` the resolve
// pass's row flags (entries of an unflagged row are skipped, and so are
// the features whose word is not a count: their winner is resolved).
// Without kFlag, `flag` is not read: the code of the two-pass walk.
template <bool kMax, int kNR, bool kFlag>
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
    if (kFlag && v != 0.f && flag[r] == 0) v = 0.f;
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
          xv[u][n] = (kMax && ok) ? x[(size_t)cc[u] * f + fi] : 0.f;
          yv[u][n] = (kMax && ok) ? y[at] : 0.f;
          cv[u][n] = (kMax && ok) ? cnt[at] : 1;
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
          if (!kMax)
            atomicAdd(drow + fi, vv[u] * gv[u][n]);
          else if (gv[u][n] != 0.f && (!kFlag || cv[u][n] > 0) &&
                   __fmul_rn(vv[u], xv[u][n]) == yv[u][n])
            atomicAdd(drow + fi, vv[u] * (gv[u][n] / (float)cv[u][n]));
        }
      }
    }
  }
}

template <int kNR>
void launch_count(const long long* gtab, const int* pieces, const int* poff,
                  const int* seg_ptr, int n_seg, const float* x,
                  const float* y, int* word, int* src, int t, int f, int fp,
                  cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  if (src != nullptr)
    max_count_kernel<kNR, true><<<grid, kThreads, 0, st>>>(
        gtab, pieces, poff, seg_ptr, n_seg, x, y, word, src, t, f, fp);
  else
    max_count_kernel<kNR, false><<<grid, kThreads, 0, st>>>(
        gtab, pieces, poff, seg_ptr, n_seg, x, y, word, src, t, f, fp);
}

template <bool kMax, int kNR>
void launch_scatter(const long long* gtab, const int* pieces,
                    const int* poff, const int* seg_ptr, int n_seg,
                    const float* x, const float* y, const float* gy,
                    const int* cnt, float* dx, int t, int f, int fp,
                    const int* flag, cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  if (kMax && flag != nullptr)
    scatter_kernel<true, kNR, true><<<grid, kThreads, 0, st>>>(
        gtab, pieces, poff, seg_ptr, n_seg, x, y, gy, cnt, dx, t, f, fp,
        flag);
  else
    scatter_kernel<kMax, kNR, false><<<grid, kThreads, 0, st>>>(
        gtab, pieces, poff, seg_ptr, n_seg, x, y, gy, cnt, dx, t, f, fp,
        flag);
}

template <bool kMax>
void dispatch_scatter(const long long* gtab, const int* pieces,
                      const int* poff, const int* seg_ptr, int n_seg,
                      const float* x, const float* y, const float* gy,
                      const int* cnt, float* dx, int t, int f,
                      const int* flag, cudaStream_t st) {
  int nr;
  const int fp = lanes_for(f, &nr);
  if (nr == 1)
    launch_scatter<kMax, 1>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, flag, st);
  else if (nr == 2)
    launch_scatter<kMax, 2>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, flag, st);
  else
    launch_scatter<kMax, 4>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, flag, st);
}

}  // namespace

// word (q*T, F) int32: the winner word of every destination row and
// feature over the whole work table (0: none; -(s+1): one winner, of
// weight 1, from source s; c >= 1: c winners, or one of another weight),
// zero-filled here.  scratch, 4 bytes of the same shape (the backward's
// dX before the resolve pass zero-fills it), takes the sources between
// the walk and the dense second launch; with no scratch there is no
// second launch and the words are the counts of the winners, which they
// equal wherever no winner has weight 1.  x is the forward's input, y
// its finished output.
extern "C" int rer_gather_max_count_launch(const void* gtab,
                                           const void* pieces,
                                           const void* poff,
                                           const void* seg_ptr, int n_seg,
                                           const void* x, const void* y,
                                           void* word, void* scratch, int q,
                                           int t, int f, void* stream) {
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
    if (sc != nullptr)
      max_count_kernel<4><<<(unsigned)((n + kThreads * 4 - 1) /
                                       (kThreads * 4)),
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

// dX (q*T, F) for the cotangent g over the whole work table: sum
// (op_max 0: x, y, cnt and flag are not read and may be null) or max.
// A max with no flag takes the counts of its winners in cnt and walks
// every row; one with the resolve pass's flag takes the words in cnt,
// walks the flagged rows and adds only where a word is a count.  dX is
// zero-filled here, except after the resolve pass (flag given), whose
// adds it holds.
extern "C" int rer_gather_bwd_scatter_launch(
    const void* gtab, const void* pieces, const void* poff,
    const void* seg_ptr, int n_seg, const void* x, const void* y,
    const void* g, const void* cnt, const void* flag, void* dx, int q,
    int t, int f, int op_max, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* fg = static_cast<const int*>(flag);
  if (!(op_max && fg != nullptr))
    cudaMemsetAsync(dx, 0, (size_t)q * t * f * sizeof(float), st);
  if (n_seg > 0) {
    const long long* gt = static_cast<const long long*>(gtab);
    const int* pc = static_cast<const int*>(pieces);
    const int* po = static_cast<const int*>(poff);
    const int* sp = static_cast<const int*>(seg_ptr);
    const float* xx = static_cast<const float*>(x);
    const float* yy = static_cast<const float*>(y);
    const float* gg = static_cast<const float*>(g);
    const int* cc = static_cast<const int*>(cnt);
    float* dd = static_cast<float*>(dx);
    if (op_max)
      dispatch_scatter<true>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t,
                             f, fg, st);
    else
      dispatch_scatter<false>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t,
                              f, nullptr, st);
  }
  return (int)cudaGetLastError();
}

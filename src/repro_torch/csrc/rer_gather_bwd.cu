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
// Bound on the H100: bytes, as the forward: 12 B per real entry plus the
// referenced rows of x, y, g and cnt, and dX written once.  Two launchers,
// each ONE launch per aggregate over the whole work table (the work is
// the forward's: one warp per segment of <= 64 real entries in
// destination order, lanes over features as `lanes_for` maps them, 32
// entries loaded with one coalesced read and broadcast by __shfl_sync,
// kU entries' x rows in flight per lane):
//   * rer_gather_max_count_launch: for the running destination row the
//     warp keeps y[d] and a per-lane count in registers, and flushes the
//     count into cnt (zero-filled here) with integer atomicAdd when the
//     row changes: exact in any order, including rows split across
//     segments and groups;
//   * rer_gather_bwd_scatter_launch (op flag): each lane loads, with the
//     x row of each of its kU entries, the entry's g[d] (max: also y[d]
//     and cnt[d]), all in flight together, and adds v * g[d] (max:
//     v * (g[d] / cnt[d]) for the winners whose g[d] is not 0) into
//     dX[s] (zero-filled here) with fire-and-forget atomics: the
//     source rows belong to other intervals, so no warp owns them, and
//     the order of the adds varies from run to run.  A max skips the
//     adds of 0, which change nothing in dX: where a row's values tie
//     (a ReLU'd message is 0 at every in-neighbour) every entry is a
//     winner, and a row outside a loss's labelled set has g = 0.
//     Loading g, y and cnt per entry, rather than once per running row
//     in a branch whose loads the next entry waited on, measured 3x
//     faster for max at F = 64 and 1.2x for sum.
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

// The counts of tied winners.  Lane = (group g, feature fl); features
// fb + fl + fp * n, n < kNR.
template <int kNR>
__global__ void __launch_bounds__(kThreads)
max_count_kernel(const long long* __restrict__ gtab,
                 const int* __restrict__ pieces,
                 const int* __restrict__ poff,
                 const int* __restrict__ seg_ptr, int n_seg,
                 const float* __restrict__ x, const float* __restrict__ y,
                 int* __restrict__ cnt, int t, int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;
  const Segment sg =
      rer_gather_walk::segment(gtab, pieces, poff, seg_ptr, s, t);
  const int g = lane / fp, fl = lane % fp, per = fp;
  const int fb = blockIdx.y * fp * kNR;
  int cur = -1;
  int c[kNR];
  float yv[kNR];
#pragma unroll
  for (int n = 0; n < kNR; ++n) {
    c[n] = 0;
    yv[n] = 0.f;
  }
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = fb + fl + fp * n;
      if (fi < f && c[n]) atomicAdd(cnt + (size_t)cur * f + fi, c[n]);
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
#pragma unroll
        for (int n = 0; n < kNR; ++n)
          c[n] += __fmul_rn(vv[u], xv[u][n]) == yv[n];
      }
    }
  }
  flush();
}

// dX of the sum (kMax false: x, y, cnt unused) or of the max.
template <bool kMax, int kNR>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ gtab,
               const int* __restrict__ pieces, const int* __restrict__ poff,
               const int* __restrict__ seg_ptr, int n_seg,
               const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gy, const int* __restrict__ cnt,
               float* __restrict__ dx, int t, int f, int fp) {
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
          else if (gv[u][n] != 0.f && __fmul_rn(vv[u], xv[u][n]) == yv[u][n])
            atomicAdd(drow + fi, vv[u] * (gv[u][n] / (float)cv[u][n]));
        }
      }
    }
  }
}

template <int kNR>
void launch_count(const long long* gtab, const int* pieces, const int* poff,
                  const int* seg_ptr, int n_seg, const float* x,
                  const float* y, int* cnt, int t, int f, int fp,
                  cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  max_count_kernel<kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, x, y, cnt, t, f, fp);
}

template <bool kMax, int kNR>
void launch_scatter(const long long* gtab, const int* pieces,
                    const int* poff, const int* seg_ptr, int n_seg,
                    const float* x, const float* y, const float* gy,
                    const int* cnt, float* dx, int t, int f, int fp,
                    cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  scatter_kernel<kMax, kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, x, y, gy, cnt, dx, t, f, fp);
}

template <bool kMax>
void dispatch_scatter(const long long* gtab, const int* pieces,
                      const int* poff, const int* seg_ptr, int n_seg,
                      const float* x, const float* y, const float* gy,
                      const int* cnt, float* dx, int t, int f,
                      cudaStream_t st) {
  int nr;
  const int fp = lanes_for(f, &nr);
  if (nr == 1)
    launch_scatter<kMax, 1>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, st);
  else if (nr == 2)
    launch_scatter<kMax, 2>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, st);
  else
    launch_scatter<kMax, 4>(gtab, pieces, poff, seg_ptr, n_seg, x, y, gy,
                            cnt, dx, t, f, fp, st);
}

}  // namespace

// cnt (q*T, F) int32: the tied winners of every destination row and
// feature over the whole work table; zero-filled here.  x is the
// forward's input, y its finished output.
extern "C" int rer_gather_max_count_launch(const void* gtab,
                                           const void* pieces,
                                           const void* poff,
                                           const void* seg_ptr, int n_seg,
                                           const void* x, const void* y,
                                           void* cnt, int q, int t, int f,
                                           void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(cnt, 0, (size_t)q * t * f * sizeof(int), st);
  if (n_seg > 0) {
    const long long* gt = static_cast<const long long*>(gtab);
    const int* pc = static_cast<const int*>(pieces);
    const int* po = static_cast<const int*>(poff);
    const int* sp = static_cast<const int*>(seg_ptr);
    const float* xx = static_cast<const float*>(x);
    const float* yy = static_cast<const float*>(y);
    int* cc = static_cast<int*>(cnt);
    int nr;
    const int fp = lanes_for(f, &nr);
    if (nr == 1)
      launch_count<1>(gt, pc, po, sp, n_seg, xx, yy, cc, t, f, fp, st);
    else if (nr == 2)
      launch_count<2>(gt, pc, po, sp, n_seg, xx, yy, cc, t, f, fp, st);
    else
      launch_count<4>(gt, pc, po, sp, n_seg, xx, yy, cc, t, f, fp, st);
  }
  return (int)cudaGetLastError();
}

// dX (q*T, F) for the cotangent g over the whole work table: sum
// (op_max 0: x, y and cnt are not read and may be null) or max (the
// counts of rer_gather_max_count_launch in cnt); zero-filled here.
extern "C" int rer_gather_bwd_scatter_launch(
    const void* gtab, const void* pieces, const void* poff,
    const void* seg_ptr, int n_seg, const void* x, const void* y,
    const void* g, const void* cnt, void* dx, int q, int t, int f,
    int op_max, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
                             f, st);
    else
      dispatch_scatter<false>(gt, pc, po, sp, n_seg, xx, yy, gg, cc, dd, t,
                              f, st);
  }
  return (int)cudaGetLastError();
}

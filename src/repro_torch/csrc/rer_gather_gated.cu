// Gated-GCN's aggregate on Hopper, and its backward, over a plan's packed
// bucket groups.
//
// Replaces no TPU kernel: the reference gathers each merged entry's
// endpoint projections with XLA, src/repro/core/engn.py::_staged_gated's
// flat gather, which holds (E, F) tensors of gates and messages (190 GB
// each at Reddit's 78.8 M entries and width 602).  Here the gate of each
// (entry, feature) is evaluated in registers and never stored.  With the
// projections ph = x W_H (destination) and pc = x W_C (source), every
// merged entry (d, s, v) of every group, z = sigmoid(ph[d] + pc[s]) per
// feature, and g the cotangent of y:
//
//   forward:  y[d]   += v * z * x[s]
//   backward: dx[s]  += v * z * g[d]
//             dpc[s] += v * g[d] * x[s] * z (1 - z)
//             dph[d] += v * g[d] * x[s] * z (1 - z)
//
// Three launchers, each recomputing z, on the walkers B2 and B2^T share
// (their own gather and fold):
//   * rer_gather_gated_launch, the forward: destination-stationary over
//     the plan's work table, as B2 (rer_gather.cu) walks it
//     (rer_gather_walk::walk_op: one warp per segment of <= 64 real
//     entries in destination order, 32 entries loaded with one coalesced
//     read and broadcast by __shfl_sync, lanes over features as
//     `lanes_for` maps them): each lane gathers the entry's ph[d], pc[s]
//     and x[s], kU entries in flight, keeps the running row's sum in
//     registers and adds it into the zero-filled y with fire-and-forget
//     atomics when the row changes;
//   * rer_gather_gated_dph_launch, dph: the same walk, summing
//     v * x[s] * z (1 - z) per row and multiplying by g[d] at the flush;
//   * rer_gather_gated_src_launch, dx and dpc: source-stationary over the
//     plan's source table, as B2^T (rer_gather_bwd.cu) walks it
//     (source_walk::walk_runs_op: one CTA per piece of one source
//     interval sorts its entries by column on chip, each lane group sums
//     its run of columns in registers): per entry it gathers g[d] and
//     ph[d], and pc[s] once per run of its column, kUT entries in flight,
//     sums v * z * g[d] and v * g[d] * z (1 - z) per column, and writes
//     each column once, dpc as x[s] times the second sum: a plain store
//     where the piece holds its whole interval (rows without an entry
//     stored as 0), a vector `red` per piece of a split interval into
//     rows zeroed before (one memset of their span each).  dx is skipped
//     where the layer's input takes no gradient.
// Bound on the H100: operations, at any width (per real entry and
// feature, the exponential not counted: the forward 5, the source walk 7
// and 2 more for dx, the dph walk 8, each recomputing the gate's 3; at 67
// TFLOP/s, 3.54 ms for the forward at Reddit's 78.8 M entries and width
// 602, against 0.95 ms of bytes: 12 B an entry, each (N, F) row read or
// written once).  fp32 on the CUDA cores; expf, not the fast-math
// exponential.  No (E, F) tensor and no per-group partial; entries with
// v == 0 (pads, a merged weight of 0) are skipped.  Numerics: the
// atomics' and merges' order varies from run to run, so sums agree with
// the plain version to fp32 rounding.
#include <cuda_runtime.h>
#include <math.h>

#include "rer_gather_walk.cuh"
#include "source_walk.cuh"

namespace {

using rer_gather_walk::kThreads;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;
using rer_gather_walk::Segment;
using source_walk::align4;
using source_walk::kLB;
using source_walk::load_lane;
using source_walk::merge;
using source_walk::store;

// entries whose rows a lane of the source walk has in flight
constexpr int kUT = 4;

__device__ __forceinline__ float gate(float a) {
  return 1.f / (1.f + expf(-a));
}

// The destination walks' gather and fold (rer_gather_walk::walk_op):
// per entry ph[d], pc[s] and x[s].  The forward (kDph false) sums
// v * z * x[s] per row, dph v * x[s] * z (1 - z).  (Loading ph[d] once
// per run of a row, kept in registers for the run, measured 15% slower
// on an H100 at gatedgcn-reddit.train's width 602: 140.1 against 121.9
// ms for the forward.)
template <bool kDph, int kNR>
struct GatedDst {
  const float* __restrict__ ph;
  const float* __restrict__ pc;
  const float* __restrict__ x;
  int f;
  struct Item {
    float h[kNR], p[kNR], x[kNR];
  };
  __device__ __forceinline__ float empty() const { return 0.f; }
  __device__ __forceinline__ void gather(Item& it, float v, int r, int c,
                                         bool, int f0, int fp) const {
    const float* hr = ph + (size_t)r * f;
    const float* pr = pc + (size_t)c * f;
    const float* xr = x + (size_t)c * f;
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const int fi = f0 + fp * n;
      const bool ok = v != 0.f && fi < f;
      it.h[n] = ok ? hr[fi] : 0.f;
      it.p[n] = ok ? pr[fi] : 0.f;
      it.x[n] = ok ? xr[fi] : 0.f;
    }
  }
  __device__ __forceinline__ void enter(const Item&) {}
  __device__ __forceinline__ void fold(float* acc, float v,
                                       const Item& it) const {
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
      const float z = gate(it.h[n] + it.p[n]);
      acc[n] = kDph ? fmaf(v * it.x[n], z * (1.f - z), acc[n])
                    : fmaf(v * z, it.x[n], acc[n]);
    }
  }
};

// The destination-stationary walk over the work table: the forward
// (kDph false: out = y) or dph (out = dph, each row's sum times g[d] at
// its flush).  out is zero-filled before.  One warp per segment, as B2
// (rer_gather.cu); gridDim.y runs over feature passes of fp * kNR.
template <bool kDph, int kNR>
__global__ void __launch_bounds__(kThreads)
gated_dst_kernel(const long long* __restrict__ gtab,
                 const int* __restrict__ pieces, const int* __restrict__ poff,
                 const int* __restrict__ seg_ptr, int n_seg,
                 const float* __restrict__ ph, const float* __restrict__ pc,
                 const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ out, int t, int f, int fp) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;
  const Segment sg =
      rer_gather_walk::segment(gtab, pieces, poff, seg_ptr, s, t);
  auto load = [&](int e0, float* v, int* r, int* c) {
    if (e0 + lane < sg.n_entries) sg.load(e0 + lane, v, r, c);
  };
  auto sink = [&](int row, int fi, float v) {
    const size_t at = (size_t)row * f + fi;
    const float w = kDph ? v * g[at] : v;
    if (w != 0.f) atomicAdd(out + at, w);
  };
  GatedDst<kDph, kNR> op{ph, pc, x, f};
  rer_gather_walk::walk_op<kNR>(sg.n_entries, load, op, sink, f,
                                blockIdx.y * fp * kNR, fp, lane);
}

// The source walk's gather and fold (source_walk::walk_runs_op): per
// entry g[d] and ph[d], and pc[s] only at the first entry of a column's
// run, kept in registers for the run; the sums of v * z * g[d] (dx, where
// kDx) and of v * g[d] * z (1 - z) (dpc once multiplied by x[s]).  pr0:
// pc's rows of the interval, from the pass's first feature.
template <bool kDx, int kNR, int kV>
struct GatedSrc {
  static constexpr int kA = kDx ? 2 : 1;  // dx's sum (kDx), then dpc's
  const float* __restrict__ g;
  const float* __restrict__ ph;
  const float* __restrict__ pr0;
  int f, fb;
  float pcol[kNR];  // the running column's pc
  struct Item {
    float g[kNR], h[kNR], p[kNR];
  };
  __device__ __forceinline__ void clear(Item& it) const {
#pragma unroll
    for (int q = 0; q < kNR; ++q) it.g[q] = it.h[q] = it.p[q] = 0.f;
  }
  __device__ __forceinline__ void gather(Item& it, int row, int col,
                                         bool fresh, int f0, int fs,
                                         int wf) const {
    const size_t ro = (size_t)row * f + fb + f0;
    load_lane<kNR, kV>(g + ro, it.g, f0, fs, wf);
    load_lane<kNR, kV>(ph + ro, it.h, f0, fs, wf);
    if (fresh) load_lane<kNR, kV>(pr0 + (size_t)col * f + f0, it.p, f0, fs, wf);
  }
  __device__ __forceinline__ void enter(const Item& it) {
#pragma unroll
    for (int q = 0; q < kNR; ++q) pcol[q] = it.p[q];
  }
  __device__ __forceinline__ void fold(float (*acc)[kNR], float v,
                                       const Item& it) const {
#pragma unroll
    for (int q = 0; q < kNR; ++q) {
      const float z = gate(it.h[q] + pcol[q]);
      const float vg = v * it.g[q];
      if (kDx) acc[0][q] = fmaf(vg, z, acc[0][q]);
      acc[kA - 1][q] = fmaf(vg, z * (1.f - z), acc[kA - 1][q]);
    }
  }
};

// dx and dpc, source-stationary: one CTA per (piece, feature pass) of the
// source table (spieces (P, 6) int32 rows: source interval, first, end,
// split, first tile, end tile; sptr (K'+1): each source-ordered tile's
// first offset; stiles (K', 3): its group, index and destination
// interval), its entries loaded through gtab and sorted by column on
// chip as B2^T does, then each lane group's run (GatedSrc), each column
// written once.  A lane holds kNR features: with kV = 4 or 2 (F a
// multiple of kV) neighbouring ones, else every fp-th.  At most 128
// registers: two CTAs an SM.
template <bool kDx, int kNR, int kV>
__global__ void __launch_bounds__(kThreads, 2)
gated_src_kernel(const long long* __restrict__ gtab,
                 const int* __restrict__ spieces, const int* __restrict__ sptr,
                 const int* __restrict__ stiles, const float* __restrict__ ph,
                 const float* __restrict__ pc, const float* __restrict__ x,
                 const float* __restrict__ g, float* __restrict__ dx,
                 float* __restrict__ dpc, int t, int f, int fp) {
  extern __shared__ __align__(16) int smem_g[];
  __shared__ int warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pcs = spieces + 6 * blockIdx.x;
  const int src = pcs[0], lo = pcs[1], hi = pcs[2], split = pcs[3];
  const int jb = pcs[4], nt = pcs[5] - pcs[4];
  const int ne = hi - lo;
  const int fb = blockIdx.y * fp * kNR;
  const int wf = min(fp * kNR, f - fb);
  const int nk = kWarps * (32 / fp);  // runs: one per lane group
  const int pw = align4(nk * wf);
  // per run, of dx and of dpc's sum, two wf-float partials (the column
  // its start cuts and the one its end cuts); then B2^T's layout: per
  // column its entry count, then its first sorted entry; per tile of the
  // piece its first offset (one more), group, index and first g row; per
  // entry as loaded: column << 16 | rank within the column, g row, value;
  // then the entries in column order
  float* pf_x = reinterpret_cast<float*>(smem_g);
  float* pl_x = pf_x + pw;
  float* pf_s = pl_x + pw;
  float* pl_s = pf_s + pw;
  int* base = reinterpret_cast<int*>(pl_s + pw);
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
  for (int i = tid; i < 4 * pw; i += kThreads) pf_x[i] = 0.f;
  __syncthreads();

  // 2. its entries, kLB a thread at once, counted per column
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
  const source_walk::Cuts cuts{e_key, order, base, ne, nk};

  // 4. each lane group's run: a column wholly in it written once, dpc as
  //    x[s] times its sum
  const size_t row0 = (size_t)src * t * f + fb;   // the interval's rows
  float* dxr = kDx ? dx + row0 : nullptr;
  float* dpr = dpc + row0;
  const float* xr0 = x + row0;
  using Op = GatedSrc<kDx, kNR, kV>;
  Op op{g, ph, pc + row0, f, fb};
  float* const pfs[2] = {kDx ? pf_x : pf_s, pf_s};
  float* const pls[2] = {kDx ? pl_x : pl_s, pl_s};
  source_walk::walk_runs_op<kNR, kV, kUT>(
      cuts, e_row, e_val, op, wf, fp, pfs, pls,
      [&](int c, int fi, const float* const* sums) {
        const size_t at = (size_t)c * f + fi;
        const float* vs = sums[Op::kA - 1];
        float w[kV];
#pragma unroll
        for (int v = 0; v < kV; ++v) w[v] = vs[v] * __ldg(xr0 + at + v);
        if (split) {
          if (kDx) merge<kV>(dxr + at, sums[0]);
          merge<kV>(dpr + at, w);
        } else {
          if (kDx) store<kV>(dxr + at, sums[0]);
          store<kV>(dpr + at, w);
        }
      });
  __syncthreads();

  // 5. the columns a cut falls inside, from their partials; an unsplit
  //    interval's rows without an entry are zero
  if (kDx)
    source_walk::sum_cuts(cuts, wf, pf_x, pl_x, [&](int c, int fi, float v) {
      float* y = dxr + (size_t)c * f + fi;
      if (split)
        merge<1>(y, &v);
      else
        __stcs(y, v);
    });
  source_walk::sum_cuts(cuts, wf, pf_s, pl_s, [&](int c, int fi, float v) {
    const size_t at = (size_t)c * f + fi;
    float w = v * __ldg(xr0 + at);
    if (split)
      merge<1>(dpr + at, &w);
    else
      __stcs(dpr + at, w);
  });
  if (!split) {
    for (int rl = warp; rl < t; rl += kWarps)
      if (base[rl + 1] == base[rl])
        for (int c = lane; c < wf; c += 32) {
          if (kDx) __stcs(dxr + (size_t)rl * f + c, 0.f);
          __stcs(dpr + (size_t)rl * f + c, 0.f);
        }
  }
}

template <bool kDph, int kNR>
void launch_dst(const long long* gtab, const int* pieces, const int* poff,
                const int* seg_ptr, int n_seg, const float* ph,
                const float* pc, const float* x, const float* g, float* out,
                int t, int f, int fp, cudaStream_t st) {
  const dim3 grid = rer_gather_walk::grid_for_table(n_seg, f, fp, kNR);
  gated_dst_kernel<kDph, kNR><<<grid, kThreads, 0, st>>>(
      gtab, pieces, poff, seg_ptr, n_seg, ph, pc, x, g, out, t, f, fp);
}

// out (q*T, F) zero-filled, then the destination walk over the whole work
// table
template <bool kDph>
int dst_walk(const void* gtab, const void* pieces, const void* poff,
             const void* seg_ptr, int n_seg, const void* ph, const void* pc,
             const void* x, const void* g, void* out, int q, int t, int f,
             void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* oo = static_cast<float*>(out);
  cudaMemsetAsync(oo, 0, (size_t)q * t * f * sizeof(float), st);
  if (n_seg > 0) {
    const long long* gt = static_cast<const long long*>(gtab);
    const int* pc_ = static_cast<const int*>(pieces);
    const int* po = static_cast<const int*>(poff);
    const int* sp = static_cast<const int*>(seg_ptr);
    const float* hh = static_cast<const float*>(ph);
    const float* cc = static_cast<const float*>(pc);
    const float* xx = static_cast<const float*>(x);
    const float* gg = static_cast<const float*>(g);
    int nr;
    const int fp = lanes_for(f, &nr);
    if (nr == 1)
      launch_dst<kDph, 1>(gt, pc_, po, sp, n_seg, hh, cc, xx, gg, oo, t, f,
                          fp, st);
    else if (nr == 2)
      launch_dst<kDph, 2>(gt, pc_, po, sp, n_seg, hh, cc, xx, gg, oo, t, f,
                          fp, st);
    else
      launch_dst<kDph, 4>(gt, pc_, po, sp, n_seg, hh, cc, xx, gg, oo, t, f,
                          fp, st);
  }
  return (int)cudaGetLastError();
}

// the source walk's dynamic shared memory (4-byte words, the kernel's
// layout) at tile t, pieces of at most `piece` entries over at most
// `tiles` tiles, wf features a pass and fp lanes over them
constexpr int src_words(int t, int piece, int tiles, int wf, int fp) {
  return 4 * align4(kWarps * (32 / fp) * wf) + align4(t + 1) + 4 * tiles +
         1 + 4 * piece;
}

using SrcKernel = void (*)(const long long*, const int*, const int*,
                           const int*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, int);

template <bool kDx, int kNR, int kV>
void launch_src(const long long* gtab, const int* spieces, int n_pieces,
                const int* sptr, const int* stiles, const float* ph,
                const float* pc, const float* x, const float* g, float* dx,
                float* dpc, int t, int f, int fp, int passes, size_t smem,
                cudaStream_t st) {
  const SrcKernel kernel = gated_src_kernel<kDx, kNR, kV>;
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
  kernel<<<grid, kThreads, smem, st>>>(gtab, spieces, sptr, stiles, ph, pc,
                                       x, g, dx, dpc, t, f, fp);
}

template <bool kDx>
void dispatch_src(int nr, bool by4, bool by2, const long long* gt,
                  const int* sp, int n_pieces, const int* pt, const int* tl,
                  const float* hh, const float* cc, const float* xx,
                  const float* gg, float* dd, float* dp, int t, int f, int fp,
                  int passes, size_t smem, cudaStream_t st) {
#define GATED_ARGS \
  gt, sp, n_pieces, pt, tl, hh, cc, xx, gg, dd, dp, t, f, fp, passes, smem, st
  if (nr == 4 && by4)
    launch_src<kDx, 4, 4>(GATED_ARGS);
  else if (nr == 4 && by2)
    launch_src<kDx, 4, 2>(GATED_ARGS);
  else if (nr == 4)
    launch_src<kDx, 4, 1>(GATED_ARGS);
  else
    launch_src<kDx, 1, 1>(GATED_ARGS);
#undef GATED_ARGS
}

}  // namespace

// The forward: y (q*T, F) = the gated sum over every real entry of the
// work table, for the projections ph, pc and the features x, all (q*T,
// F); zero-filled first.
extern "C" int rer_gather_gated_launch(const void* gtab, const void* pieces,
                                       const void* poff, const void* seg_ptr,
                                       int n_seg, const void* ph,
                                       const void* pc, const void* x, void* y,
                                       int q, int t, int f, void* stream) {
  return dst_walk<false>(gtab, pieces, poff, seg_ptr, n_seg, ph, pc, x,
                         nullptr, y, q, t, f, stream);
}

// dph (q*T, F) for the cotangent g, over the same work table; zero-filled
// first.
extern "C" int rer_gather_gated_dph_launch(const void* gtab,
                                           const void* pieces,
                                           const void* poff,
                                           const void* seg_ptr, int n_seg,
                                           const void* ph, const void* pc,
                                           const void* x, const void* g,
                                           void* dph, int q, int t, int f,
                                           void* stream) {
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  return dst_walk<true>(gtab, pieces, poff, seg_ptr, n_seg, ph, pc, x, g,
                        dph, q, t, f, stream);
}

// dx (null: not computed) and dpc, (q*T, F), for the cotangent g, through
// the groups' source table (spieces over sptr / stiles, pieces of at most
// `piece` entries over at most `tiles` tiles).  The rows of intervals
// [zero_lo, zero_hi), the span of the split ones, are zero-filled here
// (one memset each); every other row is stored by its interval's one CTA
// a pass.
extern "C" int rer_gather_gated_src_launch(
    const void* gtab, const void* spieces, int n_pieces, const void* sptr,
    const void* stiles, int piece, int tiles, int zero_lo, int zero_hi,
    const void* ph, const void* pc, const void* x, const void* g, void* dx,
    void* dpc, int q, int t, int f, void* stream) {
  if (dpc == nullptr) return (int)cudaErrorInvalidValue;
  if (n_pieces == 0 || q == 0 || t == 0 || f == 0)
    return (int)cudaGetLastError();
  int nr;
  const int fp = source_walk::queue_lanes(f, &nr);
  // the piece's arrays fit the CTA; a column and its rank share one
  // non-negative int: a column below 2^15, a rank below 2^16
  const size_t bytes =
      (size_t)src_words(t, piece, tiles, fp * nr < f ? fp * nr : f, fp) *
      sizeof(int);
  if (t > 32768 || piece > 65536 || bytes > source_walk::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int passes = (f + fp * nr - 1) / (fp * nr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dd = static_cast<float*>(dx);
  float* dp = static_cast<float*>(dpc);
  if (zero_hi > zero_lo) {
    const size_t off = (size_t)zero_lo * t * f;
    const size_t len = (size_t)(zero_hi - zero_lo) * t * f * sizeof(float);
    cudaMemsetAsync(dp + off, 0, len, st);
    if (dd != nullptr) cudaMemsetAsync(dd + off, 0, len, st);
  }
  const long long* gt = static_cast<const long long*>(gtab);
  const int* sp = static_cast<const int*>(spieces);
  const int* pt = static_cast<const int*>(sptr);
  const int* tl = static_cast<const int*>(stiles);
  const float* hh = static_cast<const float*>(ph);
  const float* cc = static_cast<const float*>(pc);
  const float* xx = static_cast<const float*>(x);
  const float* gg = static_cast<const float*>(g);
  // a lane's neighbouring features move 4 or 2 at a time where every row
  // allows
  const size_t al =
      reinterpret_cast<size_t>(ph) | reinterpret_cast<size_t>(pc) |
      reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(g) |
      reinterpret_cast<size_t>(dx) | reinterpret_cast<size_t>(dpc);
  const bool by4 = (f & 3) == 0 && (al & 15) == 0;
  const bool by2 = (f & 1) == 0 && (al & 7) == 0;
  if (dd != nullptr)
    dispatch_src<true>(nr, by4, by2, gt, sp, n_pieces, pt, tl, hh, cc, xx, gg,
                       dd, dp, t, f, fp, passes, bytes, st);
  else
    dispatch_src<false>(nr, by4, by2, gt, sp, n_pieces, pt, tl, hh, cc, xx,
                        gg, dd, dp, t, f, fp, passes, bytes, st);
  return (int)cudaGetLastError();
}

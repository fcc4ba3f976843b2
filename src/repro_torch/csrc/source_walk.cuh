// The source-stationary walk shared by the two sum adjoints that write
// each dX row once: B5^T (chunk_queue.cu, `chunk_queue_t_launch`, over
// the streamed executor's forward queue) and B2^T (rer_gather_bwd.cu,
// `rer_gather_bwd_sum_launch`, over a plan's bucket groups), and by
// Gated-GCN's source walk (rer_gather_gated.cu, its own gather and fold).
//
// One CTA holds one piece of one source interval's entries in shared
// memory, each as loaded (column << 16 | rank within its column, G row,
// value), counts them per column with integer atomics, and then:
//   * `sort_by_column`: a prefix sum of the counts and each entry placed
//     by its rank, so `order` lists the piece by column, on chip only;
//   * `walk_runs_op` (`walk_runs`: G rows times v): the sorted entries
//     cut evenly into one run per lane group; a group sums each column of
//     its run in registers, kUT entries' gathers in flight per lane, and
//     hands a column wholly in its run to the caller's writer once, the
//     part of a column a cut falls inside to a per-run partial;
//   * `sum_cuts`: after a barrier, each column a cut falls inside summed
//     from its partials and handed to the caller's writer once.
// No float atomic in shared memory (they compile to compare-and-swap
// loops on this card: adding every product into a shared T x F block
// with them measured no faster than one global atomic per product).
#pragma once

#include <cuda_runtime.h>

#include "rer_gather_walk.cuh"

namespace source_walk {

using rer_gather_walk::kThreads;
using rer_gather_walk::kWarps;
using rer_gather_walk::lanes_for;

// dynamic shared memory a CTA may take (227 KB, less a margin for the
// static words)
constexpr int kSmemMax = 232448 - 128;
constexpr int kLB = 4;       // entries a thread loads at once

// Lanes per entry and features per lane: `lanes_for`'s, but 32 < F <= 64
// takes 16 lanes x 4 features, two entries per warp instruction, which
// halves the shuffles and row tests per entry (measured 6% faster at
// F = 50 and 10% at F = 64 than 32 x 2 in B5, NVIDIA H100 80GB HBM3 at
// 700 W).
inline int queue_lanes(int f, int* nr) {
  if (f > 32 && f <= 64) {
    *nr = 4;
    return 16;
  }
  return lanes_for(f, nr);
}

// the last j in [lo, hi] with ptr[j] <= v, given ptr[lo] <= v
__device__ __forceinline__ int last_le(const int* ptr, int lo, int hi,
                                       int v) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ptr[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// *p += v with no value returned (PTX `red`): the issuing warp does not
// wait for it, where `atomicAdd`'s compiles to an ATOMG here
__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// y[0, kV) += x[0, kV) in device memory where any of x is nonzero: one
// vector `red` (sm_90), which returns nothing (CUDA's vector atomicAdd
// returns the old values, and its warp waits for them)
template <int kV>
__device__ __forceinline__ void merge(float* y, const float* x) {
  bool any = false;
#pragma unroll
  for (int v = 0; v < kV; ++v) any |= x[v] != 0.f;
  if (!any) return;
  if constexpr (kV == 4)
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(y),
                 "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]) : "memory");
  else if constexpr (kV == 2)
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(y),
                 "f"(x[0]), "f"(x[1]) : "memory");
  else
    red_add(y, x[0]);
}

// y[0, kV) = x[0, kV), a streaming store
template <int kV>
__device__ __forceinline__ void store(float* y, const float* x) {
  if constexpr (kV == 4)
    __stcs(reinterpret_cast<float4*>(y), make_float4(x[0], x[1], x[2], x[3]));
  else if constexpr (kV == 2)
    __stcs(reinterpret_cast<float2*>(y), make_float2(x[0], x[1]));
  else
    __stcs(y, x[0]);
}

// c[0, m) in shared memory becomes its exclusive prefix sum, c[m] the
// total; the whole CTA calls it
__device__ inline void cta_exclusive_scan(int* c, int m, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int a = min(m, tid * per), b = min(m, a + per);
  int s = 0;
  for (int i = a; i < b; ++i) s += c[i];
  int x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = x - s + (warp ? warp_sums[warp - 1] : 0);
  for (int i = a; i < b; ++i) {
    const int v = c[i];
    c[i] = run;
    run += v;
  }
  if (tid == kThreads - 1) c[m] = run;
  __syncthreads();
}

__host__ __device__ constexpr int align4(int x) { return (x + 3) & ~3; }

// The piece's ne entries, counted per column in base[0, t), sorted: base
// becomes each column's first position (base[t] = ne) and order[] the
// entries in column order (key: column << 16 | rank within the column).
// The whole CTA calls it.
__device__ inline void sort_by_column(const int* e_key, int* base,
                                      int* order, int ne, int t,
                                      int* warp_sums) {
  cta_exclusive_scan(base, t, warp_sums);
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    const int key = e_key[i];
    order[base[key >> 16] + (key & 0xffff)] = i;
  }
  __syncthreads();
}

// The sorted piece cut evenly into nk runs, one per lane group.
struct Cuts {
  const int* e_key;
  const int* order;
  const int* base;
  int ne, nk;

  __device__ __forceinline__ int cut(int kk) const {
    return (int)((long long)ne * kk / nk);
  }
  // the column cut kk falls inside, or -1
  __device__ __forceinline__ int col(int kk) const {
    const int at = cut(kk);
    if (kk <= 0 || kk >= nk || at >= ne) return -1;
    const int c = e_key[order[at]] >> 16;
    return base[c] < at ? c : -1;
  }
};

// kNR features of a lane from `row` (already at the lane's first
// feature f0): kV neighbouring ones at a time, else every fs-th; features
// past wf read nothing
template <int kNR, int kV>
__device__ __forceinline__ void load_lane(const float* __restrict__ row,
                                          float* out, int f0, int fs,
                                          int wf) {
#pragma unroll
  for (int q = 0; q < kNR; q += kV) {
    if (f0 + q * fs >= wf) continue;
    if constexpr (kV == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row + q));
      out[q] = x.x, out[q + 1] = x.y, out[q + 2] = x.z, out[q + 3] = x.w;
    } else if constexpr (kV == 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(row + q));
      out[q] = x.x, out[q + 1] = x.y;
    } else {
      out[q] = __ldg(row + q * fs);
    }
  }
}

// `walk_runs`' gather and fold: each entry's G row times v, one sum.  An
// op of `walk_runs_op` has: kA, its sums per feature; Item, one entry's
// values in a lane's registers; clear(item); gather(item, row, column,
// fresh, f0, fs, wf), the loads of the entry with G row `row` in column
// `column` (fresh: not the column of the group's previous entry); enter
// (item), at the first entry of a column; fold(acc, v, item) into acc[kA]
// [kNR].
template <int kNR, int kV>
struct GFold {
  static constexpr int kA = 1;
  const float* __restrict__ g;
  int f, fb;
  struct Item {
    float g[kNR];
  };
  __device__ __forceinline__ void clear(Item& it) const {
#pragma unroll
    for (int q = 0; q < kNR; ++q) it.g[q] = 0.f;
  }
  __device__ __forceinline__ void gather(Item& it, int row, int, bool,
                                         int f0, int fs, int wf) const {
    load_lane<kNR, kV>(g + (size_t)row * f + fb + f0, it.g, f0, fs, wf);
  }
  __device__ __forceinline__ void enter(const Item&) {}
  __device__ __forceinline__ void fold(float (*acc)[kNR], float v,
                                       const Item& it) const {
#pragma unroll
    for (int q = 0; q < kNR; ++q) acc[0][q] = fmaf(v, it.g[q], acc[0][q]);
  }
};

// Each lane group (fp lanes, kNR features each: with kV = 4 or 2
// neighbouring ones, moved kV at a time, F a multiple of kV; else every
// fp-th, `queue_lanes`' mapping) walks its run of the sorted entries:
// op's kA sums per column in registers, kUT entries' gathers in flight
// per lane; a column wholly in the run goes to write(column, feature,
// sums) once (kA pointers to kV values each), the part of a column that
// a cut falls inside to the run's partials for it (part_first[a] for the
// column its start cuts, part_last[a] for its end's, sum a at k * wf +
// feature).  wf features of the pass.
template <int kNR, int kV, int kUT, typename Op, typename Write>
__device__ __forceinline__ void walk_runs_op(const Cuts& cuts,
                                             const int* e_row,
                                             const float* e_val, Op& op,
                                             int wf, int fp,
                                             float* const* part_first,
                                             float* const* part_last,
                                             Write write) {
  constexpr int kA = Op::kA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lane fl's feature q is f0 + q * fs
  const int gi = lane / fp, fl = lane % fp;
  const int f0 = kV > 1 ? fl * kNR : fl, fs = kV > 1 ? 1 : fp;
  const int k = warp * (32 / fp) + gi;
  const int rb = cuts.cut(k), re = cuts.cut(k + 1);
  const int cf = cuts.col(k), cl = cuts.col(k + 1);
  int cur = -1;
  float acc[kA][kNR];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int q = 0; q < kNR; ++q) acc[a][q] = 0.f;
  auto flush = [&]() {
    if (cur >= 0) {
#pragma unroll
      for (int q = 0; q < kNR; q += kV) {
        const int fi = f0 + q * fs;
        if (fi >= wf) continue;
        if (cur == cf || cur == cl) {
#pragma unroll
          for (int a = 0; a < kA; ++a) {
            float* y = (cur == cf ? part_first[a] : part_last[a]) + k * wf +
                       fi;
#pragma unroll
            for (int v = 0; v < kV; ++v) y[v] = acc[a][q + v];
          }
        } else {
          const float* sums[kA];
#pragma unroll
          for (int a = 0; a < kA; ++a) sums[a] = acc[a] + q;
          write(cur, fi, sums);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int q = 0; q < kNR; ++q) acc[a][q] = 0.f;
  };
  for (int p = rb; p < re; p += kUT) {
    float vv[kUT];
    int cc[kUT];
    typename Op::Item it[kUT];
    int last = cur;
#pragma unroll
    for (int u = 0; u < kUT; ++u) {
      vv[u] = 0.f;
      cc[u] = -1;
      op.clear(it[u]);
      if (p + u < re) {
        const int i = cuts.order[p + u];
        vv[u] = e_val[i];
        cc[u] = cuts.e_key[i] >> 16;
        op.gather(it[u], e_row[i], cc[u], cc[u] != last, f0, fs, wf);
        last = cc[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUT; ++u) {
      if (p + u >= re) break;
      if (cc[u] != cur) {
        flush();
        cur = cc[u];
        op.enter(it[u]);
      }
      op.fold(acc, vv[u], it[u]);
    }
  }
  flush();
}

// `walk_runs_op` summing v * G[row] per column (G rows read from feature
// fb on): write(column, feature, values) and one partial each.
template <int kNR, int kV, int kUT, typename Write>
__device__ __forceinline__ void walk_runs(const Cuts& cuts,
                                          const int* e_row,
                                          const float* e_val,
                                          const float* __restrict__ g,
                                          int f, int fb, int wf, int fp,
                                          float* part_first,
                                          float* part_last, Write write) {
  GFold<kNR, kV> op{g, f, fb};
  float* const pf[1] = {part_first};
  float* const pl[1] = {part_last};
  walk_runs_op<kNR, kV, kUT>(
      cuts, e_row, e_val, op, wf, fp, pf, pl,
      [&](int c, int fi, const float* const* v) { write(c, fi, v[0]); });
}

// After `walk_runs` and a barrier: each column a cut falls inside, from
// the first such cut, summed from the partial of the run before it and
// of every run it starts, to write(column, feature, value) once.  The
// whole CTA calls it.
template <typename Write>
__device__ __forceinline__ void sum_cuts(const Cuts& cuts, int wf,
                                         const float* part_first,
                                         const float* part_last,
                                         Write write) {
  for (int i = threadIdx.x; i < cuts.nk * wf; i += kThreads) {
    const int kk = i / wf, c = cuts.col(kk), fi = i - kk * wf;
    if (c < 0 || cuts.col(kk - 1) == c) continue;
    float v = part_last[(kk - 1) * wf + fi];
    for (int jj = kk; jj < cuts.nk && cuts.col(jj) == c; ++jj)
      v += part_first[jj * wf + fi];
    write(c, fi, v);
  }
}

}  // namespace source_walk

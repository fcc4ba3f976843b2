// The max backward of RER-SpMM on Hopper, over dense T x T tiles.
//
// Backward of the max variant of the Pallas kernel
// src/repro/kernels/rer_spmm/rer_spmm.py::rer_spmm (_spmm_kernel_max),
// which the reference differentiates through its XLA twin
// blocked_spmm_xla: a max over the sources u of each tile (jnp.max), then
// a max over the tiles of each destination interval (segment_max).  Each
// level splits its cotangent evenly over its tied winners, so with y the
// forward output and, for destination row r and feature f,
//
//   c_k[r, f] = #{u : A_k[r, u] != 0 and A_k[r, u] * x[u, f] == y[r, f]}
//   n[r, f]   = #{k : c_k[r, f] > 0}
//
// the source u of tile k receives A_k[r, u] * g[r, f] / (c_k n) from
// every such winner.  A row with no candidate (y finished from -inf to 0)
// has no u with A != 0 and sends nothing.  The products are recomputed
// as the forward kernel computed them (one fp32 multiply), so the ties
// are found exactly.
//
// Bound on the H100: bytes, as the forward: the tiles are mostly
// structural zeros (1.213 GB of them at the training shapes), so every
// tile byte has to be read once and nothing else is worth optimising
// before that.  Design, destination-stationary, one walk:
//   * one CTA per (dst interval, slab of R rows, feature chunk): it walks
//     the interval's whole span once (n needs every tile of the interval
//     before any weight is known), the R x T slab of each tile streaming
//     through two 16-byte cp.async stages as in the forward kernel;
//   * each warp owns whole rows of the slab: it ballots each 32-column
//     run of its row for nonzeros and appends them, in tile order, to
//     the row's segment of one shared list of (source row, value) pairs,
//     the first of each (row, tile) group flagged.  The segments come
//     from `row_nnz`, the nonzeros of each destination row over its
//     interval's tiles, counted on the host from the tile store; R is
//     chosen on the host so that the largest slab fits the list
//     (kCap entries);
//   * then, per 32 features (one per lane), the whole CTA works the
//     list, so a hub row's entries do not fall to one warp (rows worked
//     by their own warps measured 2.46 ms at the training shapes against
//     1.07 for this): each warp takes an equal run of entries, gathers
//     the named X rows and ballots each entry's winners into a mask; then
//     warps take the (row, tile) groups in turn (a table of group
//     starts, built from the flags): n per (row, feature) by shared
//     atomics from each group's OR, then c_k from the group's masks and
//     a * g / (c_k n) scattered into dX with global atomicAdd (the source
//     rows belong to other intervals: no CTA owns its dX rows); only the
//     named X rows are read, and zeros are never multiplied;
//   * a slab whose list would not fit even at R = 1 (a hub row with more
//     than kCap in-edges) walks its span twice instead: first counting
//     n per (row, feature) into shared memory, then recounting c_k per
//     tile and scattering;
//   * fp32 on the CUDA cores.
// No (nnzb, T, F) scratch and no transposed carrier: dX is zero-filled
// and every contribution added in place.  Numerics: the winners are
// exact; the order of the atomic adds varies from run to run, so dX
// agrees with the plain version to rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxRows = 32;                         // R <= this
constexpr int kRowsPerWarp = kMaxRows / kWarps;      // 4
constexpr int kCap = 4096;         // shared list entries (8 bytes each)
constexpr int kFcMax = 1024;       // features per CTA
constexpr unsigned kFirst = 0x80000000u;  // first entry of a (row, tile)

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          s),
      "l"(gmem), "l"(pol));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
max_bwd_kernel(const float* __restrict__ blocks,
               const int* __restrict__ block_col,
               const int* __restrict__ tile_ptr,
               const int* __restrict__ row_nnz,
               const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ g, float* __restrict__ dx, int t,
               int f, int rows, int slab_pad, int fc, int vec) {
  extern __shared__ __align__(16) float smem[];
  // [stages | masks + group table] [list] [y, g, n per row x 32] [off,
  // row ends, group count]
  float* stage_s = smem;                                  // kStages slabs
  unsigned* wmask = reinterpret_cast<unsigned*>(smem);    // after the walk
  int* gtab = reinterpret_cast<int*>(smem) + kCap;
  const int region = max(kStages * slab_pad, 2 * kCap);
  unsigned* lsrc = reinterpret_cast<unsigned*>(smem + region);
  float* lval = reinterpret_cast<float*>(lsrc + kCap);
  float* ysh = lval + kCap;                               // rows x 32
  float* gsh = ysh + rows * 32;
  int* nsh = reinterpret_cast<int*>(gsh + rows * 32);
  int* off = nsh + rows * 32;                             // nrows + 1
  int* rend = off + kMaxRows + 1;                         // nrows
  int* n_groups = rend + kMaxRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dst = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nrows = min(rows, t - r0);
  const int f0 = blockIdx.z * fc;
  const int fcn = min(fc, f - f0);
  const int k_lo = tile_ptr[dst], ntiles = tile_ptr[dst + 1] - k_lo;
  if (ntiles == 0) return;
  if (tid == 0) {
    int s = 0;
    for (int r = 0; r < nrows; ++r) {
      off[r] = s;
      s += row_nnz[(size_t)dst * t + r0 + r];
    }
    off[nrows] = s;
  }
  __syncthreads();
  const int total = off[nrows];
  if (total == 0) return;
  const size_t row0 = (size_t)dst * t + r0;   // global row of slab row 0
  const int slab_n = nrows * t;
  const unsigned long long pol = evict_first_policy();

  // One walk of the span: visit(i, r, slab row, source row of column 0)
  // for each slab row r = warp + kWarps * i the warp owns, tile by tile.
  auto walk = [&](auto&& visit) {
    auto load_slab = [&](int it) {
      float* d = stage_s + (it % kStages) * slab_pad;
      const float* s = blocks + ((size_t)(k_lo + it) * t + r0) * t;
      if (vec) {
        for (int i = tid; i < slab_n / 4; i += kThreads)
          cp_async16(d + 4 * i, s + 4 * i, pol);
      } else {
        for (int i = tid; i < slab_n; i += kThreads) cp_async4(d + i, s + i);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ntiles) load_slab(s);
      cp_commit();
    }
    for (int it = 0; it < ntiles; ++it) {
      cp_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < ntiles) load_slab(it + kStages - 1);
      cp_commit();
      const float* slab = stage_s + (it % kStages) * slab_pad;
      const unsigned src0 = (unsigned)block_col[k_lo + it] * (unsigned)t;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r < nrows) visit(i, r, slab + r * t, src0);
      }
    }
    __syncthreads();  // every warp is done with the stages
  };

  if (total <= kCap) {
    // -- one walk: each row's nonzeros into its segment of the list -----
    int cur[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      cur[i] = r < nrows ? off[r] : 0;
    }
    walk([&](int i, int r, const float* srow, unsigned src0) {
      const int end = off[r + 1], first = cur[i];
      int n = first;
      for (int cb = 0; cb < t; cb += 32) {
        const int c = cb + lane;
        const float a = c < t ? srow[c] : 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
        if (a != 0.f) {
          const int p = n + __popc(m & ((1u << lane) - 1u));
          if (p < end) {
            lsrc[p] = (src0 + (unsigned)c) | (p == first ? kFirst : 0u);
            lval[p] = a;
          }
        }
        n += __popc(m);
      }
      cur[i] = min(n, end);
    });
    // the walk's closing barrier published the list; row r's entries
    // are [off[r], rend[r])
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < nrows && lane == 0) rend[r] = cur[i];
    }
    if (tid == 0) *n_groups = 0;
    __syncthreads();
    // the row holding entry e: the last r with off[r] <= e
    auto row_of = [&](int e) {
      int lo = 0, hi = nrows - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid] <= e) lo = mid; else hi = mid - 1;
      }
      return lo;
    };
    // group table: (row << 16) | first entry, in no particular order
    for (int e = tid; e < total; e += kThreads) {
      const int r = row_of(e);
      if (e < rend[r] && (lsrc[e] & kFirst))
        gtab[atomicAdd(n_groups, 1)] = (r << 16) | e;
    }
    const int per_warp = (total + kWarps - 1) / kWarps;
    const int e_lo = min(total, warp * per_warp);
    const int e_hi = min(total, e_lo + per_warp);
    for (int fb = 0; fb < fcn; fb += 32) {
      const int fi = fb + lane;
      for (int i = tid; i < nrows * 32; i += kThreads) {
        const int r = i >> 5, l = i & 31;
        const bool ok = fb + l < fcn;
        const size_t at = (row0 + r) * f + f0 + fb + l;
        // NaN matches no product: a lane past F finds no winner
        ysh[i] = ok ? y[at] : __int_as_float(0x7fc00000);
        gsh[i] = ok ? g[at] : 0.f;
        nsh[i] = 0;
      }
      __syncthreads();  // also publishes the group table
      const int ng = *n_groups;
      // winner masks: bit l of wmask[e] says entry e wins feature fb + l
      if (e_lo < e_hi) {
        int r = row_of(e_lo);
        const float* xc = x + f0 + fi;
#pragma unroll 4
        for (int e = e_lo; e < e_hi; ++e) {
          while (e >= off[r + 1]) ++r;
          const bool live = e < rend[r] && fi < fcn;
          const float xv =
              live ? xc[(size_t)(lsrc[e] & ~kFirst) * f] : 0.f;
          const unsigned m = __ballot_sync(
              0xffffffffu, live && lval[e] * xv == ysh[r * 32 + lane]);
          if (lane == 0) wmask[e] = m;
        }
      }
      __syncthreads();
      // n: the tiles (groups) of each row holding a winner, per feature
      for (int gi = warp; gi < ng; gi += kWarps) {
        const int r = gtab[gi] >> 16, e0 = gtab[gi] & 0xffff;
        unsigned any = wmask[e0];
        for (int j = e0 + 1; j < rend[r] && !(lsrc[j] & kFirst); ++j)
          any |= wmask[j];
        if ((any >> lane) & 1u) atomicAdd(nsh + r * 32 + lane, 1);
      }
      __syncthreads();
      // c_k per group, then a * g / (c_k n) into the source rows
      for (int gi = warp; gi < ng; gi += kWarps) {
        const int r = gtab[gi] >> 16, e0 = gtab[gi] & 0xffff;
        int e1 = e0 + 1;
        while (e1 < rend[r] && !(lsrc[e1] & kFirst)) ++e1;
        int c = 0;
        for (int j = e0; j < e1; ++j) c += (wmask[j] >> lane) & 1u;
        if (c == 0) continue;
        const float wgt =
            gsh[r * 32 + lane] / ((float)c * (float)nsh[r * 32 + lane]);
        float* dc = dx + f0 + fi;
        for (int j = e0; j < e1; ++j)
          if ((wmask[j] >> lane) & 1u)
            atomicAdd(dc + (size_t)(lsrc[j] & ~kFirst) * f, lval[j] * wgt);
      }
      __syncthreads();  // before the next 32 features reuse the arrays
    }
    return;
  }

  // -- a slab over the list: count n, then recount c_k and scatter ---------
  int* ntie = reinterpret_cast<int*>(lsrc);  // nrows x fc <= 2 * kCap
  for (int i = tid; i < nrows * fc; i += kThreads) ntie[i] = 0;
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    walk([&](int, int r, const float* srow, unsigned src0) {
      const size_t grow = (row0 + r) * f + f0;
      for (int fb = 0; fb < fcn; fb += 32) {
        const int fi = fb + lane;
        const bool active = fi < fcn;
        const float yv = active ? y[grow + fi] : 0.f;
        const float* xc = x + f0 + fi;
        int c = 0;
        for (int cb = 0; cb < t; cb += 32) {
          const float a = cb + lane < t ? srow[cb + lane] : 0.f;
          unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            const float ab = __shfl_sync(0xffffffffu, a, b);
            if (active)
              c += ab * xc[(size_t)(src0 + cb + b) * f] == yv;
          }
        }
        int* np = ntie + r * fc + fi;
        if (pass == 0) {
          if (c) *np += 1;   // c > 0 only on an active lane
          continue;
        }
        const float wgt = c ? g[grow + fi] / ((float)c * (float)*np) : 0.f;
        for (int cb = 0; cb < t; cb += 32) {
          const float a = cb + lane < t ? srow[cb + lane] : 0.f;
          unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            const float ab = __shfl_sync(0xffffffffu, a, b);
            const size_t s = (size_t)(src0 + cb + b) * f;
            if (c && ab * xc[s] == yv) atomicAdd(dx + f0 + fi + s, ab * wgt);
          }
        }
      }
    });
  }
}

}  // namespace

// row_nnz: (q*T,) int32, the nonzeros of each destination row over its
// interval's tiles (`rer_spmm_bwd/ops.py::row_counts`); rows: the slab
// height R the host chose (`slab_rows`), 1 <= R <= 32, R*T <= 4096.
// `vec`: T % 4 == 0 and the tiles are 16-byte aligned.  dX is zero-filled
// here.
extern "C" int rer_spmm_max_bwd_launch(
    const void* blocks, const void* block_col, const void* tile_ptr,
    const void* row_nnz, const void* x, const void* y, const void* g,
    void* dx, int q, int t, int f, int rows, int vec, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dx, 0, (size_t)q * t * f * sizeof(float), st);
  rows = rows < t ? rows : t;
  const int slab_pad = (rows * t + 3) & ~3;
  // the two-walk route keeps n for rows x fc in the list's 2 * kCap ints
  int fc_max = 2 * kCap / rows;
  fc_max = fc_max < kFcMax ? fc_max : kFcMax;
  const int n_fchunks = (f + fc_max - 1) / fc_max;
  const int fc = (f + n_fchunks - 1) / n_fchunks;
  const size_t region = (size_t)(kStages * slab_pad > 2 * kCap
                                     ? kStages * slab_pad : 2 * kCap);
  const size_t smem = sizeof(float) * (region + 2 * (size_t)kCap +
                                       3 * 32 * (size_t)rows +
                                       2 * kMaxRows + 2);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(max_bwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_set = smem;
  }
  const dim3 grid((unsigned)q, (t + rows - 1) / rows, n_fchunks);
  max_bwd_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(block_col),
      static_cast<const int*>(tile_ptr), static_cast<const int*>(row_nnz),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(g), static_cast<float*>(dx), t, f, rows,
      slab_pad, fc, vec);
  return (int)cudaGetLastError();
}

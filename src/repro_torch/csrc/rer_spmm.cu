// RER-SpMM on Hopper: the aggregate over dense T x T tiles.
//
// Replaces the Pallas kernel src/repro/kernels/rer_spmm/rer_spmm.py::rer_spmm
// (_spmm_kernel_sum, _spmm_kernel_max):
//
//   Y[br_k*T : +T] (+)= A_k @ X[bc_k*T : +T]     over dst-sorted tiles k
//   max: Y[r, f] = max over A[r, u] != 0 of A[r, u] * X[u, f], -inf -> 0.
//
// Bound on the H100: bytes.  The tiles are mostly structural zeros
// (0.04-0.08% full on pubmed), so 4*T^2 bytes per tile buy 2*nnz*F
// useful operations; every tile byte has to be read once and nothing
// else is worth optimising before that.  Design:
//   * one CTA per (span piece, row slab, feature chunk of <= 1024): a
//     piece is at most PIECE_TILES (16) consecutive tiles of one
//     destination interval (the host cuts each interval's span into
//     balanced pieces, `pieces`), a slab R <= 32 rows of the tile with
//     R*T <= 4096, so a slab is one contiguous 16 KB run of the row-major
//     tile;
//   * each CTA streams its slabs through two shared-memory stages (the
//     next slab lands while this one is scanned) with 16-byte cp.async
//     (4-byte where T is not a multiple of 4) under an L2 evict-first
//     policy, so every tile byte leaves HBM once per call whatever F is
//     (up to 1024 features; wider F repeats the stream per 1024-wide
//     chunk) and the stream does not push the gathered X rows out of L2;
//     two stages keep four CTAs on an SM (registers allow four), which
//     measured faster than three or four stages with fewer CTAs;
//   * on chip, each warp owns whole rows of the slab: it ballots each
//     32-column run of its row for nonzeros and compacts them with
//     prefix counts into a per-warp (col, val) list, then gathers only
//     the referenced X rows, kU x kNR values in flight per lane, into a
//     shared-memory accumulator of R x F that only it writes: no
//     atomics inside the CTA, and zeros are never multiplied;
//   * lanes run over features (kNR = 1, 2 or 4 per lane); below 32
//     features they are split into groups of fp = pow2(F) lanes that
//     take different nonzeros of the row and combine with a warp
//     shuffle, so F = 3 keeps 24 of 32 lanes busy;
//   * an interval cut into several pieces merges them in Y with global
//     atomicAdd (sum, Y zero-filled first) or an integer-atomic float
//     max (max, Y -inf-filled first, -inf -> 0 afterwards); a piece
//     that is its interval's only one stores its rows;
//   * fp32 on the CUDA cores (the reference contracts in f32; Hopper
//     tensor cores have no IEEE fp32 mode).
// Numerics: max is exact (one fp32 multiply per candidate, max is
// order-free).  Sum skips A == 0, so it differs from a dense product only
// in rounding order on finite inputs, and it drops the 0 * inf = NaN a
// dense product would make of an inf in X; the order of the pieces'
// atomic adds varies from run to run.
//
// B1^T, `rer_spmm_t_launch`: the sum backward dX = A^T G over the SAME
// forward tiles, so no carrier of A^T is ever built (the reference has
// none either: XLA differentiates its tiles):
//
//   dX[bc_k*T + u, :] += sum_r A_k[r, u] * G[br_k*T + r, :]
//
// Bound: bytes, the same tile bytes as the forward.  It keeps the
// forward's tile stream (span pieces, one CTA per (piece, row slab,
// feature chunk), two 16 KB cp.async stages under evict-first, the
// nonzeros of each slab row compacted by ballot); only the inner step
// differs: every tile of a piece shares its destination interval, so
// the CTA loads the slab's rows of G once into shared memory, and each
// nonzero (r, u, a) adds a * G_s[r] into dX[bc_k*T + u] with
// fire-and-forget atomics (float4 ones where F % 4 == 0, so a row of 64
// features is 16 of them; scalar ones below, e.g. F = 3).  The source
// rows belong to other intervals, so no CTA owns its dX rows: dX is
// zero-filled first and every contribution added in place.  The order
// of the adds varies from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;        // shared-memory stages per CTA
constexpr int kSlabFloats = 4096; // R * T <= this: 16 KB per stage
constexpr int kMaxRows = 32;      // R <= this
constexpr int kList = 256;        // per-warp (col, val) list: one window
constexpr int kFcMax = 1024;      // features per CTA
constexpr int kU = 4;             // gathers in flight per lane

// The tiles stream through L2 once; an evict-first policy keeps them
// from pushing out the X rows every CTA gathers.
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

// Float max by integer atomics: floats without the sign bit order as
// ints, floats with it (-0 to -inf) inversely as unsigned ints, and each
// kind against the other correctly too, so one atomicMax or atomicMin is
// an exact max, issued without waiting for a reply (a compare-and-swap
// loop waits on every read).  NaN is not ordered.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// One warp: the nonzeros (lc[e], lv[e]), e < n, of one slab row, into
// that row's accumulator arow[0 : fcn).  Lane = (group g, feature fl);
// a pass covers features fb + fl + fp * j, j < kNR, whose kU x kNR
// gathers are in flight together.
template <bool kMax, int kNR>
__device__ __forceinline__ void gather_row(const int* lc, const float* lv,
                                           int n, const float* xs, int f,
                                           int fcn, int fp, float* arow,
                                           int lane) {
  const int groups = 32 / fp, g = lane / fp, fl = lane % fp;
  for (int fb = 0; fb < fcn; fb += fp * kNR) {
    float s[kNR];
#pragma unroll
    for (int j = 0; j < kNR; ++j) s[j] = kMax ? -INFINITY : 0.f;
    for (int e0 = g; e0 < n; e0 += groups * kU) {
      float av[kU], xv[kU][kNR];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + groups * u;
        const bool ok = e < n;
        av[u] = ok ? lv[e] : 0.f;
        const float* xr = xs + (size_t)(ok ? lc[e] : 0) * f;
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          const int fi = fb + fl + fp * j;
          xv[u][j] = (ok && fi < fcn) ? xr[fi] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int j = 0; j < kNR; ++j) {
          if (kMax) {
            if (av[u] != 0.f) s[j] = fmaxf(s[j], av[u] * xv[u][j]);
          } else {
            s[j] = fmaf(av[u], xv[u][j], s[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNR; ++j) {
      for (int o = fp; o < 32; o <<= 1)
        s[j] = combine<kMax>(s[j], __shfl_xor_sync(0xffffffffu, s[j], o));
      const int fi = fb + fl + fp * j;
      if (g == 0 && fi < fcn) arow[fi] = combine<kMax>(arow[fi], s[j]);
    }
  }
}

__device__ __forceinline__ void add4(float* p, float a, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 &&   \
    (__CUDACC_VER_MAJOR__ > 12 ||                       \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(p),
            make_float4(a * v.x, a * v.y, a * v.z, a * v.w));
#else
  atomicAdd(p, a * v.x);
  atomicAdd(p + 1, a * v.y);
  atomicAdd(p + 2, a * v.z);
  atomicAdd(p + 3, a * v.w);
#endif
}

// One warp: the nonzeros (lc[e], lv[e]), e < n, of one slab row whose
// cotangent row is grow[0 : fcn), each added as lv[e] * grow into the dX
// row lc[e] of dxs.  nv units per row (float4 when vec4, else floats),
// fp lanes per nonzero, 32 / fp nonzeros a pass.
__device__ __forceinline__ void scatter_row(const int* lc, const float* lv,
                                            int n, const float* grow,
                                            float* dxs, int f, int nv,
                                            int fp, bool vec4, int lane) {
  const int groups = 32 / fp, gi = lane / fp, fl = lane % fp;
  for (int e = gi; e < n; e += groups) {
    const float a = lv[e];
    float* drow = dxs + (size_t)lc[e] * f;
    if (vec4) {
      for (int j = fl; j < nv; j += fp)
        add4(drow + 4 * j, a, *reinterpret_cast<const float4*>(grow + 4 * j));
    } else {
      for (int j = fl; j < nv; j += fp) atomicAdd(drow + j, a * grow[j]);
    }
  }
}

template <bool kMax, int kNR>
__global__ void __launch_bounds__(kThreads)
rer_spmm_kernel(const float* __restrict__ blocks,
                const int* __restrict__ block_col,
                const int4* __restrict__ pieces,
                const float* __restrict__ x, float* __restrict__ y, int t,
                int f, int rows, int slab_pad, int fc, int fp, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* stage_s = smem;                                  // kStages slabs
  int* list_c = reinterpret_cast<int*>(smem + kStages * slab_pad);
  float* list_v = reinterpret_cast<float*>(list_c + kWarps * kList);
  float* acc = list_v + kWarps * kList;                   // rows x fc
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* lc = list_c + warp * kList;
  float* lv = list_v + warp * kList;

  const int4 pc = pieces[blockIdx.x];
  const int dst = pc.x, k_lo = pc.y, ntiles = pc.z - pc.y, split = pc.w;
  const int r0 = blockIdx.y * rows;
  const int nrows = min(rows, t - r0);
  const int f0 = blockIdx.z * fc;
  const int fcn = min(fc, f - f0);
  const int slab_n = nrows * t;

  for (int i = tid; i < nrows * fc; i += kThreads)
    acc[i] = kMax ? -INFINITY : 0.f;

  const unsigned long long pol = evict_first_policy();
  auto load_slab = [&](int it) {
    float* dstp = stage_s + (it % kStages) * slab_pad;
    const float* src = blocks + ((size_t)(k_lo + it) * t + r0) * t;
    if (vec) {
      for (int i = tid; i < slab_n / 4; i += kThreads)
        cp_async16(dstp + 4 * i, src + 4 * i, pol);
    } else {
      for (int i = tid; i < slab_n; i += kThreads)
        cp_async4(dstp + i, src + i);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_slab(s);
    cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    // slab `it` has landed for every thread, and every warp is done with
    // slab it-1, whose stage the next load refills
    cp_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < ntiles) load_slab(it + kStages - 1);
    cp_commit();
    const float* slab = stage_s + (it % kStages) * slab_pad;
    const float* xs = x + (size_t)block_col[k_lo + it] * t * f + f0;
    for (int r = warp; r < nrows; r += kWarps) {
      const float* srow = slab + r * t;
      for (int c0 = 0; c0 < t; c0 += kList) {
        const int cend = min(t, c0 + kList);
        int n = 0;
        for (int cb = c0; cb < cend; cb += 32) {
          const int c = cb + lane;
          const float a = c < cend ? srow[c] : 0.f;
          const unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
          if (a != 0.f) {
            const int p = n + __popc(m & ((1u << lane) - 1u));
            lc[p] = c;
            lv[p] = a;
          }
          n += __popc(m);
        }
        __syncwarp();
        if (n) gather_row<kMax, kNR>(lc, lv, n, xs, f, fcn, fp,
                                     acc + r * fc, lane);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nrows * fcn; i += kThreads) {
    const int r = i / fcn, j = i % fcn;
    float v = acc[r * fc + j];
    float* out = y + ((size_t)dst * t + r0 + r) * f + f0 + j;
    if (!split) {
      if (kMax && v == -INFINITY) v = 0.f;
      *out = v;
    } else if (kMax) {
      if (v != -INFINITY) atomic_max_float(out, v);
    } else if (v != 0.f) {
      atomicAdd(out, v);
    }
  }
}

// B1^T over the forward tiles: the forward's walk, G's slab rows in
// shared memory in place of the accumulator, nonzeros scattered into dX.
__global__ void __launch_bounds__(kThreads)
rer_spmm_t_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ block_col,
                  const int4* __restrict__ pieces,
                  const float* __restrict__ g, float* __restrict__ dx,
                  int t, int f, int rows, int slab_pad, int fc, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* stage_s = smem;                                  // kStages slabs
  int* list_c = reinterpret_cast<int*>(smem + kStages * slab_pad);
  float* list_v = reinterpret_cast<float*>(list_c + kWarps * kList);
  float* gs = list_v + kWarps * kList;                    // rows x fc
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* lc = list_c + warp * kList;
  float* lv = list_v + warp * kList;

  const int4 pc = pieces[blockIdx.x];
  const int dst = pc.x, k_lo = pc.y, ntiles = pc.z - pc.y;
  const int r0 = blockIdx.y * rows;
  const int nrows = min(rows, t - r0);
  const int f0 = blockIdx.z * fc;
  const int fcn = min(fc, f - f0);
  const int slab_n = nrows * t;
  // float4 units where every row of G, G_s and dX is 16-byte aligned
  // (F and fc multiples of 4, so fcn is too)
  const bool vec4 = (f & 3) == 0 && (fc & 3) == 0;
  const int nv = vec4 ? fcn / 4 : fcn;
  int fp = 1;
  while (fp < nv && fp < 32) fp <<= 1;

  // the slab's cotangent rows, once per CTA: every tile of a piece
  // belongs to the destination interval `dst`
  const float* gsrc = g + ((size_t)dst * t + r0) * f + f0;
  for (int i = tid; i < nrows * fc; i += kThreads) {
    const int r = i / fc, j = i % fc;
    gs[i] = j < fcn ? gsrc[(size_t)r * f + j] : 0.f;
  }

  const unsigned long long pol = evict_first_policy();
  auto load_slab = [&](int it) {
    float* dstp = stage_s + (it % kStages) * slab_pad;
    const float* src = blocks + ((size_t)(k_lo + it) * t + r0) * t;
    if (vec) {
      for (int i = tid; i < slab_n / 4; i += kThreads)
        cp_async16(dstp + 4 * i, src + 4 * i, pol);
    } else {
      for (int i = tid; i < slab_n; i += kThreads)
        cp_async4(dstp + i, src + i);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_slab(s);
    cp_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    // slab `it` has landed for every thread (and, the first time, G_s),
    // and every warp is done with slab it-1, whose stage is refilled
    cp_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < ntiles) load_slab(it + kStages - 1);
    cp_commit();
    const float* slab = stage_s + (it % kStages) * slab_pad;
    float* dxs = dx + (size_t)block_col[k_lo + it] * t * f + f0;
    for (int r = warp; r < nrows; r += kWarps) {
      const float* srow = slab + r * t;
      for (int c0 = 0; c0 < t; c0 += kList) {
        const int cend = min(t, c0 + kList);
        int n = 0;
        for (int cb = c0; cb < cend; cb += 32) {
          const int c = cb + lane;
          const float a = c < cend ? srow[c] : 0.f;
          const unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
          if (a != 0.f) {
            const int p = n + __popc(m & ((1u << lane) - 1u));
            lc[p] = c;
            lv[p] = a;
          }
          n += __popc(m);
        }
        __syncwarp();
        if (n) scatter_row(lc, lv, n, gs + r * fc, dxs, f, nv, fp, vec4,
                           lane);
        __syncwarp();
      }
    }
  }
}

__global__ void fill_kernel(float* __restrict__ y, size_t count, float v) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = v;
}

__global__ void finish_kernel(float* __restrict__ y, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    if (y[i] == -INFINITY) y[i] = 0.f;
}

unsigned grid_for(size_t count) {
  const size_t b = (count + 255) / 256;
  return (unsigned)(b < 4096 ? (b ? b : 1) : 4096);
}

// Y filled with 0 (a memset, no kernel) or -inf before pieces merge in.
void fill_y(float* y, size_t count, bool neg_inf, cudaStream_t st) {
  if (neg_inf)
    fill_kernel<<<grid_for(count), 256, 0, st>>>(y, count, -INFINITY);
  else
    cudaMemsetAsync(y, 0, count * sizeof(float), st);
}

template <bool kMax, int kNR>
void launch_main(dim3 grid, size_t smem, const float* blocks,
                 const int* block_col, const int4* pieces, const float* x,
                 float* y, int t, int f, int rows, int slab_pad, int fc,
                 int fp, int vec, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(rer_spmm_kernel<kMax, kNR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_set = smem;
  }
  rer_spmm_kernel<kMax, kNR><<<grid, kThreads, smem, st>>>(
      blocks, block_col, pieces, x, y, t, f, rows, slab_pad, fc, fp, vec);
}

template <bool kMax>
int launch(const float* blocks, const int* block_col, const int4* pieces,
           int n_pieces, int fill, const float* x, float* y, int q, int t,
           int f, int vec, cudaStream_t st) {
  const size_t count = (size_t)q * t * f;
  if (fill)
    fill_y(y, count, kMax, st);
  if (n_pieces > 0) {
    int rows = kSlabFloats / t;
    rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
    rows = rows < t ? rows : t;
    const int slab_pad = (rows * t + 3) & ~3;
    const int n_fchunks = (f + kFcMax - 1) / kFcMax;
    const int fc = (f + n_fchunks - 1) / n_fchunks;
    // lanes per nonzero fp and features per lane kNR: fc <= 32 takes
    // pow2(fc) >= 4 lanes and one feature, wider 32 lanes and 2 or 4
    int fp = 32;
    if (fc < 32) {
      fp = 4;
      while (fp < fc) fp <<= 1;
    }
    const size_t smem =
        sizeof(float) * ((size_t)kStages * slab_pad + 2 * kWarps * kList +
                         (size_t)rows * fc);
    const dim3 grid((unsigned)n_pieces, (t + rows - 1) / rows, n_fchunks);
    if (fc <= 32)
      launch_main<kMax, 1>(grid, smem, blocks, block_col, pieces, x, y, t,
                           f, rows, slab_pad, fc, fp, vec, st);
    else if (fc <= 64)
      launch_main<kMax, 2>(grid, smem, blocks, block_col, pieces, x, y, t,
                           f, rows, slab_pad, fc, fp, vec, st);
    else
      launch_main<kMax, 4>(grid, smem, blocks, block_col, pieces, x, y, t,
                           f, rows, slab_pad, fc, fp, vec, st);
  }
  if (kMax && fill)
    finish_kernel<<<grid_for(count), 256, 0, st>>>(y, count);
  return (int)cudaGetLastError();
}

}  // namespace

// pieces: (n_pieces, 4) int32 rows (dst interval, first tile, end tile,
// split), from the host (`rer_spmm/ops.py::span_pieces`).  `fill` is set
// when an interval is split or has no tile: Y is then filled first (0 for
// sum, -inf for max, finished to 0 afterwards) and split pieces merge into
// it; otherwise every row of Y is stored by its interval's one piece.
// `vec`: T % 4 == 0 and the tiles are 16-byte aligned.
extern "C" int rer_spmm_launch(const void* blocks, const void* block_col,
                               const void* pieces, int n_pieces, int fill,
                               const void* x, void* y, int q, int t, int f,
                               int op_max, int vec, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const int* bc = static_cast<const int*>(block_col);
  const int4* pc = static_cast<const int4*>(pieces);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  return op_max ? launch<true>(b, bc, pc, n_pieces, fill, xx, yy, q, t, f,
                               vec, s)
                : launch<false>(b, bc, pc, n_pieces, fill, xx, yy, q, t, f,
                                vec, s);
}

// dX (q*T, F) = A^T G over the forward tiles and the same `pieces` table
// as rer_spmm_launch; dX is zero-filled here.  `vec`: T % 4 == 0 and the
// tiles are 16-byte aligned.
extern "C" int rer_spmm_t_launch(const void* blocks, const void* block_col,
                                 const void* pieces, int n_pieces,
                                 const void* g, void* dx, int q, int t,
                                 int f, int vec, void* stream) {
  if (q == 0 || t == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(dx, 0, (size_t)q * t * f * sizeof(float), st);
  if (n_pieces > 0) {
    int rows = kSlabFloats / t;
    rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
    rows = rows < t ? rows : t;
    const int slab_pad = (rows * t + 3) & ~3;
    const int n_fchunks = (f + kFcMax - 1) / kFcMax;
    int fc = (f + n_fchunks - 1) / n_fchunks;
    if ((f & 3) == 0) fc = (fc + 3) & ~3;   // float4 rows in every chunk
    const size_t smem =
        sizeof(float) * ((size_t)kStages * slab_pad + 2 * kWarps * kList +
                         (size_t)rows * fc);
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
      cudaFuncSetAttribute(rer_spmm_t_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      smem_set = smem;
    }
    const dim3 grid((unsigned)n_pieces, (t + rows - 1) / rows, n_fchunks);
    rer_spmm_t_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(block_col),
        static_cast<const int4*>(pieces), static_cast<const float*>(g),
        static_cast<float*>(dx), t, f, rows, slab_pad, fc, vec);
  }
  return (int)cudaGetLastError();
}

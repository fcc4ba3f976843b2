// Fused feature extraction + RER aggregate on Hopper (paper Fig. 8).
//
// Replaces the Pallas kernel src/repro/kernels/fused_engn/fused_engn.py::
// fused_extract_aggregate (_fused_kernel):
//
//   Y[br_k*T : +T] += A_k @ (X[bc_k*T : +T] @ W)
//
// over the dense T x T tiles of A; P = X W lives only in shared memory,
// never in device memory.
//
// Bound on the H100: bytes at the training shapes (4,627 tiles of
// 256 KB, 0.04-0.08% full), operations at cora's first layer (P = X W
// over F = 1433 is 0.52 GFLOP, the tiles 16 MB).  So P must be computed
// once, and every tile byte read once.  Design, source-stationary:
//   * one CTA per (column piece, slab of RS source rows, output chunk of
//     <= kHcMax = 256 columns): a column piece is at most 16 tiles of
//     one source interval j, taken in the column order of the forward
//     carrier (`order`, the host's stable argsort of block_col, cut into
//     balanced pieces by `pieces`); the slab runs fastest in the launch
//     order, so the CTAs of a piece walk the same tiles at about the same
//     time.  RS is 16, or 8 where the grid at 16 would not fill one wave
//     of four CTAs an SM (cora: 176 CTAs): halving it measured 0.106 ->
//     0.084 ms and 0.039 -> 0.028 ms on cora's two layers, while on the
//     training shapes' 4,600 CTAs the 32-byte runs it reads cost 16%;
//   * phase 1 computes the slab's P = X[j*T + s0 : +RS] @ W[:, hc] into
//     shared memory: X and W stream through a ring of three cp.async
//     stages of 32 rows of the reduction (W at H = 64 is 367 KB, more
//     than a CTA holds); each thread keeps a 4 x 4 block of P in
//     registers, fed by one float4 of X and one of W per reduction row,
//     and up to 8 groups of threads split each stage's rows, their
//     partial tiles summed at the end.  P is computed once per (slab,
//     piece, chunk): once on cora, where no column span is longer than
//     16 tiles.  The kernel is held to 64 registers, so an SM keeps four
//     CTAs walking tiles: a 4 x 8 block took 127 and slowed the walk at
//     the training shapes by 45%, for no gain at cora's.  At F = 1433
//     this phase takes about 70% of the layer (a variant that stops
//     after it), whatever the block shape, the stage depth (2 or 3),
//     64-row stages or the order in which CTAs read W; dropping its X
//     loads, its W loads or its FMAs from that variant saves 18%, 11%
//     and 36% of it;
//   * phase 2 walks the piece's tiles: A_k[:, slab] (T rows x RS
//     columns, 64-byte runs of each tile row at RS = 16) streams through
//     two cp.async stages under an L2 evict-first policy, so every tile byte
//     leaves HBM once per call whatever F is (H above 256 repeats the
//     walk per chunk); each warp ballots 32 entries of the slab at a time
//     and compacts the nonzeros into a per-warp (entry, value) list, so
//     zeros are never multiplied;
//   * for each nonzero (r, u, a) the warp adds a * P[u, :] into
//     Y[br_k*T + r, :] with global atomics, float4 atomics where H is a
//     multiple of 4 (sm_90); Y is zero-filled first, so an interval
//     without tiles comes out 0;
//   * fp32 FMA on the CUDA cores, as the reference contracts in f32
//     (Hopper's tensor cores have no IEEE fp32 mode).
// Numerics: sum skips A == 0, and P's reduction over F runs in another
// order than the plain version's matrix product; the order of the atomic
// adds into Y varies from run to run.  Agreement is therefore allclose,
// as for B1's split spans.  T may be at most 256 (the wrapper checks).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;   // tile stages (phase 2)
constexpr int kP1Stages = 3;  // X / W stages (phase 1)
constexpr int kRs = 16;       // source rows per CTA (kRsSmall on small grids)
constexpr int kRsSmall = 8;
constexpr int kSmallGrid = 4 * 132;  // fewer CTAs at kRs: under one wave
constexpr int kHcMax = 256;   // output columns per CTA
constexpr int kBk = 32;       // reduction depth per phase-1 stage
constexpr int kCw = 4;        // P columns per thread in phase 1 (4 rows)
constexpr int kList = 256;    // per-warp nonzero list

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem,
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

// One phase-1 stage: X's slab rows (masked to `nsrc` rows and F
// columns) transposed into xs[kBk][RS], and the W rows k0 .. k0+kBk of
// the chunk's hc columns into ws[kBk][hcp] (zero past hc).
template <int RS>
__device__ __forceinline__ void load_k_slab(
    float* xs, float* ws, const float* __restrict__ x,
    const float* __restrict__ w, int xrow0, int nsrc, int f, int h, int h0,
    int hc, int hcp, int k0, int wvec, int tid) {
  for (int i = tid; i < RS * kBk; i += kThreads) {
    const int r = i / kBk, c = i % kBk;
    float* d = xs + c * RS + r;
    if (r < nsrc && k0 + c < f)
      cp_async4(d, x + (size_t)(xrow0 + r) * f + k0 + c);
    else
      *d = 0.f;
  }
  const int q4 = hcp / 4;
  if (wvec) {
    for (int i = tid; i < kBk * q4; i += kThreads) {
      const int r = i / q4, c = 4 * (i % q4);
      float* d = ws + r * hcp + c;
      if (k0 + r < f && c < hc)
        cp_async16(d, w + (size_t)(k0 + r) * h + h0 + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < kBk * hcp; i += kThreads) {
      const int r = i / hcp, c = i % hcp;
      float* d = ws + r * hcp + c;
      if (k0 + r < f && c < hc)
        cp_async4(d, w + (size_t)(k0 + r) * h + h0 + c);
      else
        *d = 0.f;
    }
  }
}

// K-groups of phase 1 for a P tile of RS x hcp: a group of
// (RS/4) * (hcp/kCw) threads covers the tile in 4 x kCw blocks, and up
// to 8 groups split each stage's reduction rows between them.
template <int RS>
__host__ __device__ __forceinline__ int k_groups(int hcp) {
  const int per = (RS / 4) * (hcp / kCw);
  const int n = kThreads / per;
  return n < 8 ? n : 8;
}

template <int RS>
__global__ void __launch_bounds__(kThreads, 4)
fused_engn_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ block_row,
                  const int* __restrict__ order,
                  const int4* __restrict__ pieces,
                  const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int t, int f, int h, int hcw,
                  int n_slabs, int wvec, int avec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 pc = pieces[blockIdx.x / n_slabs];
  const int src = pc.x, p_lo = pc.y, ntiles = pc.z - pc.y;
  const int s0 = (blockIdx.x % n_slabs) * RS;
  const int nsrc = min(RS, t - s0);
  const int h0 = blockIdx.z * hcw;
  const int hc = min(hcw, h - h0);
  const int hcp = (hc + 7) & ~7;
  const int kg_n = k_groups<RS>(hcp);
  // shared layout: [tile stages | phase-1 stages | partial P] [P] [lists]
  const int stage_f = t * RS;
  const int p1_f = RS * kBk + kBk * hcp;
  const int region =
      max(kStages * stage_f, max(kP1Stages * p1_f, kg_n * RS * hcp));
  float* p_s = smem + region;
  int* list_e = reinterpret_cast<int*>(p_s + RS * hcp);
  float* list_v = reinterpret_cast<float*>(list_e + kWarps * kList);

  // -- phase 1: P = X[src*T + s0 : +nsrc] @ W[:, h0 : h0+hc] --------------
  // thread: K-group kg, rows 4*ry .. +4, columns kCw*cx .. +kCw
  const int per = (RS / 4) * (hcp / kCw);
  const int kg = tid / per, ry = (tid % per) / (hcp / kCw),
            cx = (tid % per) % (hcp / kCw);
  const bool act = kg < kg_n;
  float acc[4][kCw];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCw; ++j) acc[i][j] = 0.f;
  const int xrow0 = src * t + s0;
  const int nk = (f + kBk - 1) / kBk;
  auto load_k = [&](int s) {
    float* xs = smem + (s % kP1Stages) * p1_f;
    load_k_slab<RS>(xs, xs + RS * kBk, x, w, xrow0, nsrc, f, h, h0, hc, hcp,
                s * kBk, wvec, tid);
  };
#pragma unroll
  for (int s = 0; s < kP1Stages - 1; ++s) {
    if (s < nk) load_k(s);
    cp_commit();
  }
  for (int s = 0; s < nk; ++s) {
    // stage s has landed for every thread, and every thread is done
    // with stage s-1, whose buffer the next load refills
    cp_wait<kP1Stages - 2>();
    __syncthreads();
    if (s + kP1Stages - 1 < nk) load_k(s + kP1Stages - 1);
    cp_commit();
    const float* xs = smem + (s % kP1Stages) * p1_f;
    const float* ws = xs + RS * kBk;
    if (act) {
      for (int kk = kg; kk < kBk; kk += kg_n) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + kk * RS + 4 * ry);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        float wr[kCw];
#pragma unroll
        for (int v = 0; v < kCw / 4; ++v) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + kk * hcp + kCw * cx + 4 * v);
          wr[4 * v] = wv.x;
          wr[4 * v + 1] = wv.y;
          wr[4 * v + 2] = wv.z;
          wr[4 * v + 3] = wv.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCw; ++j)
            acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every thread is done with the phase-1 stages
  // the K-groups' partial tiles, then their sum: P (rows >= nsrc and
  // columns >= hc hold zeros, as their X and W loads did)
  if (act) {
    float* part = smem + kg * RS * hcp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = part + (4 * ry + i) * hcp + kCw * cx;
#pragma unroll
      for (int v = 0; v < kCw / 4; ++v)
        *reinterpret_cast<float4*>(row + 4 * v) =
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                        acc[i][4 * v + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < RS * hcp; i += kThreads) {
    float v = smem[i];
    for (int g = 1; g < kg_n; ++g) v += smem[g * RS * hcp + i];
    p_s[i] = v;
  }
  __syncthreads();  // P is complete and the region free for the tiles

  // -- phase 2: the piece's tiles, Y[br*T + r] += a * P[u] per nonzero ----
  const unsigned long long pol = evict_first_policy();
  auto load_tile = [&](int it) {
    float* d = smem + (it % kStages) * stage_f;
    const float* a = blocks + ((size_t)order[p_lo + it] * t) * t + s0;
    if (avec) {
      const int q4 = nsrc / 4;
      for (int i = tid; i < t * q4; i += kThreads) {
        const int r = i / q4, c = 4 * (i % q4);
        cp_async16_hint(d + r * RS + c, a + (size_t)r * t + c, pol);
      }
    } else {
      for (int i = tid; i < t * nsrc; i += kThreads) {
        const int r = i / nsrc, c = i % nsrc;
        cp_async4(d + r * RS + c, a + (size_t)r * t + c);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  int* le = list_e + warp * kList;
  float* lv = list_v + warp * kList;
  // lanes per nonzero and units (float4 where H % 4 == 0: then every
  // chunk's hc is a multiple of 4, and each output row 16-byte aligned)
  // per output row; P's rows are hcp (a multiple of 8) apart
  const bool vec4 = (h & 3) == 0;
  const int nv = vec4 ? hc / 4 : hc;
  int fp = 1;
  while (fp < nv && fp < 32) fp <<= 1;
  const int groups = 32 / fp, g = lane / fp, fl = lane % fp;
  const int n_ent = t * RS;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < ntiles) load_tile(it + kStages - 1);
    cp_commit();
    const float* slab = smem + (it % kStages) * stage_f;
    const int k = order[p_lo + it];
    float* ybase = y + (size_t)block_row[k] * t * h + h0;
    int n = 0;
    auto flush = [&]() {
      __syncwarp();
      for (int e0 = 0; e0 < n; e0 += groups) {
        const int e = e0 + g;
        if (e < n) {
          const int ent = le[e];
          const float a = lv[e];
          const int r = ent / RS, u = ent % RS;
          float* yrow = ybase + (size_t)r * h;
          const float* prow = p_s + u * hcp;
          if (vec4) {
            for (int j = fl; j < nv; j += fp)
              add4(yrow + 4 * j, a,
                   *reinterpret_cast<const float4*>(prow + 4 * j));
          } else {
            for (int j = fl; j < nv; j += fp) atomicAdd(yrow + j, a * prow[j]);
          }
        }
      }
      __syncwarp();
      n = 0;
    };
    for (int e0 = warp * 32; e0 < n_ent; e0 += kWarps * 32) {
      const int e = e0 + lane;
      const float a = (e < n_ent && e % RS < nsrc) ? slab[e] : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
      if (a != 0.f) {
        const int p = n + __popc(m & ((1u << lane) - 1u));
        le[p] = e;
        lv[p] = a;
      }
      n += __popc(m);
      if (n > kList - 32) flush();
    }
    if (n) flush();
  }
}

template <int RS>
void launch(const void* blocks, const void* block_row, const void* order,
            const void* pieces, int n_pieces, const void* x, const float* w,
            void* y, int t, int f, int h, int hcw, int n_hchunks, int wvec,
            int avec, cudaStream_t st) {
  // the widest chunk sizes every region (each grows with the width)
  size_t region = (size_t)kStages * t * RS;
  const size_t p1 = (size_t)kP1Stages * (RS * kBk + kBk * hcw);
  const size_t part = (size_t)k_groups<RS>(hcw) * RS * hcw;
  region = region > p1 ? region : p1;
  region = region > part ? region : part;
  const size_t smem = sizeof(float) * (region + (size_t)RS * hcw) +
                      (sizeof(int) + sizeof(float)) * kWarps * kList;
  const int n_slabs = (t + RS - 1) / RS;
  const dim3 grid((unsigned)n_pieces * n_slabs, 1, n_hchunks);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaFuncSetAttribute(fused_engn_kernel<RS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    smem_set = smem;
  }
  fused_engn_kernel<RS><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(block_row),
      static_cast<const int*>(order), static_cast<const int4*>(pieces),
      static_cast<const float*>(x), w, static_cast<float*>(y), t, f, h, hcw,
      n_slabs, wvec, avec);
}

}  // namespace

// order: (nnzb,) int32, the tiles in column order (stable argsort of
// block_col); pieces: (n_pieces, 4) int32 rows (source interval, first,
// end position in `order`, split), from the host
// (`fused_engn/ops.py::column_table`).  Y is zero-filled here.
extern "C" int fused_engn_launch(const void* blocks, const void* block_row,
                                 const void* order, const void* pieces,
                                 int n_pieces, const void* x, const void* w,
                                 void* y, int q, int t, int f, int h,
                                 void* stream) {
  if (q == 0 || t == 0 || h == 0) return (int)cudaGetLastError();
  if (t > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(y, 0, (size_t)q * t * h * sizeof(float), st);
  if (n_pieces == 0 || f == 0) return (int)cudaGetLastError();
  const int n_hchunks = (h + kHcMax - 1) / kHcMax;
  // chunk width: a multiple of 8, so P's 4 x kCw blocks and Y's float4
  // rows tile it
  const int hcw = (((h + n_hchunks - 1) / n_hchunks) + 7) & ~7;
  const float* ww = static_cast<const float*>(w);
  const float* bb = static_cast<const float*>(blocks);
  const int wvec = (h % 4 == 0) && ((size_t)ww % 16 == 0);
  const int avec = (t % 4 == 0) && ((size_t)bb % 16 == 0);
  // a grid under one wave of four CTAs an SM takes half-height slabs:
  // twice the CTAs, each with half the P work and tile bytes
  const bool small =
      (size_t)n_pieces * ((t + kRs - 1) / kRs) * n_hchunks < kSmallGrid;
  if (small)
    launch<kRsSmall>(blocks, block_row, order, pieces, n_pieces, x, ww, y,
                     t, f, h, hcw, n_hchunks, wvec, avec, st);
  else
    launch<kRs>(blocks, block_row, order, pieces, n_pieces, x, ww, y, t, f,
                h, hcw, n_hchunks, wvec, avec, st);
  return (int)cudaGetLastError();
}

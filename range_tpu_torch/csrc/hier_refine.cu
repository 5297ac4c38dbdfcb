// Hierarchical retrieval: fine stats over each query block's listed tiles
// (the two-level refine stage), in its two forms.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_refine_kernel`, with
// stats_only=True (reached via _hier_refine_call <- hier_topk on banks
// built with gsz_super) and with has_parts (stats_only=False, reached via
// _hier_refine_call <- _hier_partials2 <- retrieve_hier on banks built
// with gsz_super and without lr_rank: the two-level feature path).  For
// every query and each of the M tiles its query block kept from the coarse
// (supergroup) selection: the fine sem group logits l = q[:, :wf] . g (log2
// e and the temperature are folded into the packed queries) over the
// tile's gpt consecutive groups of g_sem_cat, their max m and the
// exp-mass s = sum exp2(min(l, 86)).  Out: m_f, s_f [Bp, M] f32, column j
// the block's j-th listed tile.  The TPU kernel packs both stats into one
// [Bp, 2 Mp] block through one-hot products (its vector unit has no
// dynamic lane store); here the stats are written straight to their
// [query, column] places.  The has_parts form also sums, over the M tiles,
//   parts = bf16(exp2(min(l_f, 86))) @ g_sem_vw[tile groups]
//         - bf16(exp2(min(q[:, :ws] . g_sup, 86))) @ g_sup_vw[tile supergroups]
// in f32: the fine-minus-supergroup tail partial [Bp, Dvp] (count column
// at Dv), which replaces the coarse scan's supergroup tail by the fine one
// on the M tiles.
//
// What bounds it on an H100: the logits, and in the has_parts form the two
// value products.  At the top-k endpoint's shape (B = 10,000, M = 96 tiles
// of 64 groups, 256 columns) the stats are ~32 GFLOP on the tensor cores
// (~0.032 ms at the bf16 peak) against ~8 MB of f32 stats written and the
// listed tiles' centroids read once (~6 MB): operations.  The has_parts
// form at the two-level feature path's shape (B = 10,000, M = 48 tiles of
// 64 fine and 8 supergroups, Dvp = 1,152) adds 2 x 72 x 1,152 flops per
// (query, listed tile) and writes 46 MB of f32 partials: ~0.1 ms either way.
//
// Design: the stats-only scan (hier_scan_stats.cu) over a gathered list.
// A block owns 64 queries (inside one selection block of bm queries, whose
// idx row it reads) and walks its list's groups 32 at a time: step rows
// are the list's flat positions p (tile idx[p / gpt], group p % gpt),
// fetched row by row with cp.async while the previous step computes.  The
// logits run on mma.sync bf16 tensor cores into a shared f32 tile, from
// which each thread takes 8 groups of one query: max and exp2 sum, reduced
// with warp shuffles across the 4 threads of a query (tiles of 8, 16 or 32
// groups end inside a step; longer tiles carry a running max / sum across
// steps).  A ragged end (M * gpt not a multiple of 32, gpt < 32) reads
// zero rows and writes nothing for them.  Nothing carries between blocks.
// The stats-only form splits a list into chunks of CHUNK_TILES over
// grid.y.  The has_parts form is the correction kernel's block
// (hier_corr.cu) over two lists in turn: the M tiles' fine groups, then
// their supergroups, the bf16 weights of the second negated (exact in
// bf16), each step's product summed in a fresh fragment and added to the
// [64 x slice] f32 accumulator in registers.  The partials are Dv + 128 =
// 1,152 columns at full width, 295 KB of f32 for 64 queries: they are cut
// into ceil(W / 512) column slices over grid.y, each recomputing the
// logits; slice 0 writes the stats.

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;           // queries per block
constexpr int BN = 32;           // groups per step
constexpr int THREADS = 256;     // 8 warps
constexpr int CHUNK_TILES = 16;  // listed tiles per block (x gpt: whole steps)
constexpr int LDL = BN + 1;      // f32 row stride of the logit tile

struct Layout {
  size_t q, g, lg, total;
};

__host__ __device__ inline Layout layout(int wk) {
  Layout l;
  l.q = 0;
  l.g = l.q + (size_t)BM * (wk + 8) * 2;
  l.lg = l.g + (size_t)2 * BN * (wk + 8) * 2;
  l.total = l.lg + (size_t)BM * LDL * 4;
  return l;
}

__global__ void __launch_bounds__(THREADS, 2)
hier_refine_kernel(const __nv_bfloat16* __restrict__ q_cat, const int* __restrict__ idx,
                   const __nv_bfloat16* __restrict__ g_cat, float* __restrict__ m_f,
                   float* __restrict__ s_f, int Bp, int cat_d, int wk, int bm, int M,
                   int gpt, Layout lay) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base + lay.q);
  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(base + lay.g);
  float* lg = reinterpret_cast<float*>(base + lay.lg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int* tiles = idx + (size_t)(q0 / bm) * M;  // this block's list
  const int p_begin = blockIdx.y * CHUNK_TILES * gpt;
  const int p_end = min(p_begin + CHUNK_TILES * gpt, M * gpt);
  const int n_steps = (p_end - p_begin + BN - 1) / BN;
  const int ldk = wk + 8, cpr = wk / 8;

  auto prefetch = [&](int buf, int it) {
    const int p0 = p_begin + it * BN;
    __nv_bfloat16* gs = gs0 + buf * BN * ldk;
    for (int i = tid; i < BN * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int p = p0 + r;
      const bool ok = p < p_end;
      const size_t row = ok ? (size_t)tiles[p / gpt] * gpt + p % gpt : 0;
      cp_async16(gs + r * ldk + c, g_cat + row * wk + c, ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < BM * cpr; i += THREADS) {  // rows past Bp: zeros
    const int r = i / cpr, c = (i % cpr) * 8;
    const bool ok = q0 + r < Bp;
    cp_async16(qs + r * ldk + c, q_cat + (ok ? (size_t)(q0 + r) * cat_d + c : 0), ok);
  }
  cp_async_commit();
  prefetch(0, 0);

  // stats: thread owns query row sr and groups sc*8 .. sc*8+7 of a step
  const int sr = tid >> 2, sc = tid & 3;
  const int seg = gpt < BN ? gpt : BN;  // groups reduced together
  const float NEG_INF = __int_as_float(0xff800000);
  float run_m = NEG_INF, run_s = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();  // the previous step is fully consumed
    const int buf = it & 1;
    if (it + 1 < n_steps) {
      prefetch(buf ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step `it` (and the queries) visible to all threads
    const __nv_bfloat16* gs = gs0 + buf * BN * ldk;

    {  // logits: warp -> m16 tile (warp >> 1), n8 tiles 2 (warp & 1) + {0, 1}
      const int mt = warp >> 1, nt0 = (warp & 1) * 2;
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < wk; kk += 16) {
        uint32_t a[4];
        load_a(a, qs, ldk, mt * 16, kk, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t b0, b1;
          load_bt(b0, b1, gs, ldk, (nt0 + i) * 8, kk, g, t);
          mma_bf16(c[i], a, b0, b1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lg[(mt * 16 + g + 8 * (e >> 1)) * LDL + (nt0 + i) * 8 + 2 * t + (e & 1)] = c[i][e];
    }
    __syncthreads();

    // per-tile max logit and exp-mass of this thread's 8 groups
    float lmax = NEG_INF, lsum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float l = lg[sr * LDL + sc * 8 + k];
      lmax = fmaxf(lmax, l);
      lsum += exp2f(fminf(l, CLAMP2));
    }
    if (seg >= 16) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, 1));
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    }
    if (seg >= 32) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, 2));
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    }
    const int q = q0 + sr;
    const bool lead = sc % (seg / 8) == 0;
    const int p0 = p_begin + it * BN;  // the step's first list position
    if (gpt <= BN) {
      const int col = (p0 + sc * 8) / gpt;
      if (lead && q < Bp && col < M) {
        m_f[(size_t)q * M + col] = lmax;
        s_f[(size_t)q * M + col] = lsum;
      }
    } else {
      run_m = fmaxf(run_m, lmax);
      run_s += lsum;
      if ((p0 + BN) % gpt == 0) {  // the tile ends with this step
        if (lead && q < Bp) {
          const size_t o = (size_t)q * M + p0 / gpt;
          m_f[o] = run_m;
          s_f[o] = run_s;
        }
        run_m = NEG_INF;
        run_s = 0.f;
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit
}

bool gpt_ok(int gpt) { return gpt % 8 == 0 && (gpt <= BN ? BN % gpt == 0 : gpt % BN == 0); }

constexpr int MAX_NT = 8;    // has_parts: output n8 tiles per warp, a slice <= 512 columns
constexpr int LDP = BN + 8;  // bf16 row stride of the weight tile

struct PartsLayout {
  size_t q, g, v, lg, p, total;
};

// wq: the query columns read (max(wf, ws)); sw: the columns of one slice
__host__ __device__ inline PartsLayout parts_layout(int wq, int sw) {
  PartsLayout l;
  l.q = 0;
  l.g = l.q + (size_t)BM * (wq + 8) * 2;
  l.v = l.g + (size_t)2 * BN * (wq + 8) * 2;
  l.lg = l.v + (size_t)2 * BN * (sw + 8) * 2;
  l.p = l.lg + (size_t)BM * LDL * 4;
  l.total = l.p + (size_t)BM * LDP * 2;
  return l;
}

struct PartsParams {
  const __nv_bfloat16* q;     // [Bp, cat_d]
  const int* idx;             // [Bp / bm, M]
  const __nv_bfloat16* gf;    // [G, wf] fine centroids
  const __nv_bfloat16* gs;    // [G_sup, ws] supergroup centroids
  const __nv_bfloat16* vf;    // [G, W] fine group value sums
  const __nv_bfloat16* vs;    // [G_sup, W] supergroup value sums
  float* m_f;                 // [Bp, M]
  float* s_f;                 // [Bp, M]
  float* out;                 // [Bp, W]
  int Bp, cat_d, wf, ws, wq, W, sw, bm, M, gpt, gpt_sup;
};

__global__ void __launch_bounds__(THREADS, 1)
hier_refine_parts_kernel(const PartsParams P, const PartsLayout lay) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base + lay.q);
  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(base + lay.g);
  __nv_bfloat16* vs0 = reinterpret_cast<__nv_bfloat16*>(base + lay.v);
  float* lg = reinterpret_cast<float*>(base + lay.lg);
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(base + lay.p);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int* tiles = P.idx + (size_t)(q0 / P.bm) * P.M;  // this block's list
  const int end_f = P.M * P.gpt, end_s = P.M * P.gpt_sup;
  const int n_f = (end_f + BN - 1) / BN;  // fine steps, then supergroup steps
  const int n_steps = n_f + (end_s + BN - 1) / BN;
  const int col_lo = blockIdx.y * P.sw;  // this block's columns [col_lo, + cols)
  const int cols = P.W - col_lo < P.sw ? P.W - col_lo : P.sw;
  const bool lead = blockIdx.y == 0;     // writes the stats
  const int ldk = P.wq + 8, ldv = P.sw + 8;
  const int cpv = cols / 8;
  const int ntw = cols / 64;         // output n8 tiles of this warp
  const int col_w = warp * ntw * 8;  // first output column of this warp

  auto prefetch = [&](int buf, int it) {
    const bool fine = it < n_f;
    const int p0 = (fine ? it : it - n_f) * BN;
    const int end = fine ? end_f : end_s, gpt = fine ? P.gpt : P.gpt_sup;
    const int wk = fine ? P.wf : P.ws, cpr = wk / 8;
    const __nv_bfloat16* gsrc = fine ? P.gf : P.gs;
    const __nv_bfloat16* vsrc = fine ? P.vf : P.vs;
    __nv_bfloat16* gsb = gs0 + buf * BN * ldk;
    __nv_bfloat16* vsb = vs0 + buf * BN * ldv;
    for (int i = tid; i < BN * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int p = p0 + r;
      const bool ok = p < end;
      const size_t row = ok ? (size_t)tiles[p / gpt] * gpt + p % gpt : 0;
      cp_async16(gsb + r * ldk + c, gsrc + row * wk + c, ok);
    }
    for (int i = tid; i < BN * cpv; i += THREADS) {
      const int r = i / cpv, c = (i % cpv) * 8;
      const int p = p0 + r;
      const bool ok = p < end;
      const size_t row = ok ? (size_t)tiles[p / gpt] * gpt + p % gpt : 0;
      cp_async16(vsb + r * ldv + c, vsrc + row * P.W + col_lo + c, ok);
    }
    cp_async_commit();
  };

  {
    const int cpr = P.wq / 8;
    for (int i = tid; i < BM * cpr; i += THREADS) {  // rows past Bp: zeros
      const int r = i / cpr, c = (i % cpr) * 8;
      const bool ok = q0 + r < P.Bp;
      cp_async16(qs + r * ldk + c, P.q + (ok ? (size_t)(q0 + r) * P.cat_d + c : 0), ok);
    }
    cp_async_commit();
  }
  prefetch(0, 0);

  float acc[4][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // stats and weights: thread owns query row sr and groups sc*8 .. sc*8+7
  const int sr = tid >> 2, sc = tid & 3;
  const int seg = P.gpt < BN ? P.gpt : BN;  // fine groups reduced together
  const float NEG_INF = __int_as_float(0xff800000);
  float run_m = NEG_INF, run_s = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();  // the previous step is fully consumed
    const int buf = it & 1;
    if (it + 1 < n_steps) {
      prefetch(buf ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step `it` (and the queries) visible to all threads
    const bool fine = it < n_f;
    const int wk = fine ? P.wf : P.ws;
    const __nv_bfloat16* gsb = gs0 + buf * BN * ldk;
    const __nv_bfloat16* vsb = vs0 + buf * BN * ldv;

    {  // logits: warp -> m16 tile (warp >> 1), n8 tiles 2 (warp & 1) + {0, 1}
      const int mt = warp >> 1, nt0 = (warp & 1) * 2;
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < wk; kk += 16) {
        uint32_t a[4];
        load_a(a, qs, ldk, mt * 16, kk, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t b0, b1;
          load_bt(b0, b1, gsb, ldk, (nt0 + i) * 8, kk, g, t);
          mma_bf16(c[i], a, b0, b1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lg[(mt * 16 + g + 8 * (e >> 1)) * LDL + (nt0 + i) * 8 + 2 * t + (e & 1)] = c[i][e];
    }
    __syncthreads();

    // the weights bf16(+-exp2(min(l, 86))); on fine steps the stats
    float lmax = NEG_INF, lsum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float l = lg[sr * LDL + sc * 8 + k];
      const float e = exp2f(fminf(l, CLAMP2));
      lmax = fmaxf(lmax, l);
      lsum += e;
      const __nv_bfloat16 eb = __float2bfloat16_rn(e);
      pb[sr * LDP + sc * 8 + k] = fine ? eb : __hneg(eb);
    }
    if (fine) {
      if (seg >= 16) {
        lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, 1));
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      }
      if (seg >= 32) {
        lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, 2));
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      }
      const int q = q0 + sr;
      const bool own = lead && sc % (seg / 8) == 0 && q < P.Bp;
      const int p0 = it * BN;  // the step's first list position
      if (P.gpt <= BN) {
        const int col = (p0 + sc * 8) / P.gpt;
        if (own && col < P.M) {
          P.m_f[(size_t)q * P.M + col] = lmax;
          P.s_f[(size_t)q * P.M + col] = lsum;
        }
      } else {
        run_m = fmaxf(run_m, lmax);
        run_s += lsum;
        if ((p0 + BN) % P.gpt == 0) {  // the tile ends with this step
          if (own) {
            const size_t o = (size_t)q * P.M + p0 / P.gpt;
            P.m_f[o] = run_m;
            P.s_f[o] = run_s;
          }
          run_m = NEG_INF;
          run_s = 0.f;
        }
      }
    }
    __syncthreads();  // weight tile complete

    // acc[64 x this warp's columns] += W[64 x 32] @ VW[32 x ...], the step
    // in a fresh fragment
#pragma unroll
    for (int h = 0; h < MAX_NT / 2; ++h) {
      if (2 * h < ntw) {
        uint32_t b[2][4];
        load_b_pair(b[0], vsb, ldv, 0, col_w + h * 16, lane);
        load_b_pair(b[1], vsb, ldv, 16, col_w + h * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a0[4], a1[4];
          load_a(a0, pb, LDP, mt * 16, 0, g, t);
          load_a(a1, pb, LDP, mt * 16, 16, g, t);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(c, a0, b[0][2 * j], b[0][2 * j + 1]);
            mma_bf16(c, a1, b[1][2 * j], b[1][2 * j + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][2 * h + j][e] += c[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= ntw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + mt * 16 + g + 8 * half;
        if (q >= P.Bp) continue;
        const int col = col_lo + col_w + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(P.out + (size_t)q * P.W + col) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}


}  // namespace

// q_cat [Bp, cat_d] bf16 packed queries (the fine logits contract columns
// [0, wf)), idx [Bp / bm, M] int32 tiles, g_cat [G, wf] bf16 fine
// centroids, gpt groups per tile.  Out: m_f, s_f [Bp, M] f32.  All
// contiguous and 16-byte aligned.
extern "C" int hier_refine_launch(const void* q_cat, const void* idx, const void* g_cat,
                                  void* m_f, void* s_f, int Bp, int cat_d, int wf, int bm, int M,
                                  int gpt, void* stream) {
  if (Bp <= 0 || M <= 0) return 0;
  if (wf % 16 || wf > 256 || wf > cat_d || cat_d % 8 || bm % BM || Bp % bm || !gpt_ok(gpt))
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(wf);
  cudaError_t err = cudaFuncSetAttribute(
      hier_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bp / BM, (M + CHUNK_TILES - 1) / CHUNK_TILES);
  hier_refine_kernel<<<grid, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q_cat), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(g_cat), static_cast<float*>(m_f),
      static_cast<float*>(s_f), Bp, cat_d, wf, bm, M, gpt, lay);
  return (int)cudaGetLastError();
}

// The has_parts form.  q_cat [Bp, cat_d] bf16 packed queries (the fine
// logits contract columns [0, wf), the supergroup logits [0, ws)), idx
// [Bp / bm, M] int32 tiles, g_cat [G, wf] and g_sup [G_sup, ws] bf16
// centroids, vw [G, W] and vw_sup [G_sup, W] bf16 group value sums (W a
// multiple of 128; above 512 in column slices), gpt fine and gpt_sup
// supergroups per tile.  Out: m_f, s_f [Bp, M] and parts [Bp, W] f32.
// All contiguous and 16-byte aligned.
extern "C" int hier_refine_parts_launch(const void* q_cat, const void* idx, const void* g_cat,
                                        const void* g_sup, const void* vw, const void* vw_sup,
                                        void* m_f, void* s_f, void* parts, int Bp, int cat_d,
                                        int wf, int ws, int W, int bm, int M, int gpt,
                                        int gpt_sup, void* stream) {
  if (Bp <= 0 || M <= 0) return 0;
  if (wf % 16 || wf > 256 || wf > cat_d || ws % 16 || ws > 256 || ws > cat_d || cat_d % 8 ||
      bm % BM || Bp % bm || !gpt_ok(gpt) || gpt_sup <= 0 || W <= 0 || W % 128)
    return (int)cudaErrorInvalidValue;
  // ceil(W / 512) column slices of equal width, a multiple of 64
  const int n_sl = (W + 64 * MAX_NT - 1) / (64 * MAX_NT);
  const int sw = ((W + n_sl - 1) / n_sl + 63) / 64 * 64;
  const int wq = wf > ws ? wf : ws;
  const PartsLayout lay = parts_layout(wq, sw);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_refine_parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const PartsParams P{static_cast<const bf*>(q_cat), static_cast<const int*>(idx),
                      static_cast<const bf*>(g_cat),  static_cast<const bf*>(g_sup),
                      static_cast<const bf*>(vw),     static_cast<const bf*>(vw_sup),
                      static_cast<float*>(m_f),       static_cast<float*>(s_f),
                      static_cast<float*>(parts),     Bp, cat_d, wf, ws, wq, W, sw, bm, M,
                      gpt, gpt_sup};
  const dim3 grid(Bp / BM, n_sl);
  hier_refine_parts_kernel<<<grid, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      P, lay);
  return (int)cudaGetLastError();
}

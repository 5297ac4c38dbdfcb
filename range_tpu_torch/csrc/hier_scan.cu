// Hierarchical retrieval, stage 1: the fused group scan.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_scan_kernel` (reached
// via _hier_scan_call <- _hier_partials <- retrieve_hier).  For every query
// and both families (sem, geo): the group logits l = q . g against every
// packed group centroid (log2 e and the temperatures are folded into the
// packed queries), per bank tile (gpt consecutive groups) the max logit m
// and the exp-mass s = sum exp2(min(l, 86)), and the all-tiles tail
// tails = bf16(exp2(min(l, 86))) @ vw  (vw = the low-rank group value
// coefficients with the group count in one column), accumulated in f32.
//
// What bounds it on an H100: the two matmul families.  At the flagship
// shape (B = 10,112 padded queries; 7,168 sem groups x 256 columns with a
// 384-wide tail, 1,792 geo groups x 128 columns with a 512-wide tail) that
// is ~116 GFLOP on the tensor cores against ~90 MB read and written (the
// f32 stats and tails are most of it), above the card's ~295 flop/byte
// balance point: compute-bound.
//
// Design: one block owns 64 queries of ONE family (grid.y = family) and
// walks all of that family's groups 32 at a time (the TPU's sequential
// "arbitrary" axis becomes this loop; nothing carries between blocks).
// The logits run on mma.sync bf16 tensor cores into a shared f32 tile, from
// which each thread takes 8 groups of one query: exp2, the bf16 p tile for
// the tail product, and the per-tile max / sum reduced with warp shuffles
// across the 4 threads of a query (tiles of 8, 16 or 32 groups end inside
// a step; longer tiles carry a running max / sum across steps).  The tail
// accumulator [64 x W <= 512] f32 (one column slice of a wider tail, below)
// stays in registers (warp w owns W/8 columns) and each 32-group step is summed in a fresh fragment before it
// joins the accumulator (IEEE f32 adds, no long tensor-core chain).  The
// next group and value tiles stream in with cp.async while this one
// computes.  Stats are written straight in [query, tile] order, so the
// TPU's transposed [tile, query] layout and its transpose disappear.
//
// sup_r > 0 (tail_super banks, `_hier_scan_call(..., sup_r=)`, the TPU
// kernel's sup_r_s variant): the sem tail operand holds one row per sup_r
// consecutive groups (g_sem_ts_vw).  Each thread adds the f32 exp2 of its
// groups in runs of sup_r (runs of 16 or 32 finish with warp shuffles
// across the query's threads) and rounds each supergroup sum to bf16 once;
// a 32-group step then streams R = 32 / sup_r <= 16 tail rows, and the p
// tile's columns R .. 15 and the value rows R .. 15 stay zero, so one k16
// step of the same mma code takes the product.
//
// has_geo = 0 (RANGE mode, `_hier_scan_call(..., has_geo=False)`): the grid
// holds the sem blocks only.  The TPU kernel still computes the geo stats
// and zero-fills the geo tail there, but RANGE mode reads neither; here the
// geo operands are not touched and the tails hold the sem columns only.
//
// The wide tail (banks without lr_rank / lr_geo: the full-width group value
// sums, W = Dv + 128 = 1,152 columns at Dv = 1,024): a [64 x 1,152] f32
// accumulator is 288 registers a thread at 256 threads and cannot stay in
// registers, nor in shared memory (295 KB).  The tail columns are split
// across blocks instead: grid.y enumerates (family, column slice), each
// family's W cut into ceil(W / 512) slices of at most 512 columns (1,152 ->
// three of 384; a mixed launch, a 384-wide low-rank sem tail beside a
// 1,152-wide geo tail, has 1 + 3 slices).  Every slice recomputes the
// group logits and exponentials of its family and streams only its slice
// of the value rows; slice 0 alone writes the family's two stats.  At the
// default bank's sem family (sem_d 256 against 384-wide slices) the
// recomputation costs 2 x 256 / (256 + 1,152) ~ 36% more tensor-core work
// than one pass.  The alternative, fewer queries per block with the tail
// in shared memory, needs 32 x 1,152 x 4 = 147 KB beside the operand
// tiles for 32 queries, halves the tensor-core tile height the logits and
// the tail run at, and doubles the number of times every block streams
// the group operands; the slices keep the 64-query block, stream each
// value column once per query block, and let the query blocks of one slice
// (launched together, blockIdx.x fastest) share that slice's value rows in
// L2 (11 MB of the 33 MB sem operand at the default bank).

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 32;        // groups per step
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_NT = 8;     // tail n8 tiles per warp: a slice <= 8 warps x 64
constexpr int LDL = BN + 1;   // f32 row stride of the logit tile
constexpr int LDP = BN + 8;   // bf16 row stride of the p tile

struct Family {
  const __nv_bfloat16* g;   // [G, wk] packed group centroids
  const __nv_bfloat16* vw;  // [G, W] tail operand
  float* m;                 // [Bp, t_pad] max group logit per tile
  float* s;                 // [Bp, t_pad] exp-mass per tile
  int wk;                   // logit depth (columns of g)
  int q0;                   // first packed query column of the family
  int G, W, gpt;            // groups, tail width, groups per tile
  int tail0;                // first column of the family in the tails
  int sup_r;                // > 0: vw rows sum sup_r groups each (sem only)
  int n_sl, sw;             // column slices of the tail, columns a slice
};

struct Layout {
  size_t q, g, v, lg, p, total;
  int ldv;  // bf16 row stride of a value tile
};

// Shared memory: the query block, two group tiles, two value tiles (of one
// column slice), the f32 logit tile and the bf16 p tile.  Sized for the
// wider family and the wider slice.
__host__ __device__ inline Layout layout(int wk, int sw) {
  Layout l;
  l.ldv = sw + 8;
  l.q = 0;
  l.g = l.q + (size_t)BM * (wk + 8) * 2;
  l.v = l.g + (size_t)2 * BN * (wk + 8) * 2;
  l.lg = l.v + (size_t)2 * BN * l.ldv * 2;
  l.p = l.lg + (size_t)BM * LDL * 4;
  l.total = l.p + (size_t)BM * LDP * 2;
  return l;
}

__global__ void __launch_bounds__(THREADS, 1)
hier_scan_kernel(const __nv_bfloat16* __restrict__ q_cat, int Bp, int cat_d, int t_pad,
                 float* __restrict__ tails, int tails_w, Family f0, Family f1, Layout lay) {
  const bool fam1 = (int)blockIdx.y >= f0.n_sl;
  const Family f = fam1 ? f1 : f0;
  const int slice = fam1 ? blockIdx.y - f0.n_sl : blockIdx.y;
  const int col_lo = slice * f.sw;  // this block's tail columns [col_lo, + cols)
  const int cols = f.W - col_lo < f.sw ? f.W - col_lo : f.sw;
  const bool stats = slice == 0;    // slice 0 writes the family's stats
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
  const int ldk = f.wk + 8, ldv = lay.ldv;
  const int n_steps = f.G / BN;
  const int ntw = cols / 64;         // tail n8 tiles of this warp
  const int col_w = warp * ntw * 8;  // first tail column of this warp
  // tail rows a step streams, and the k16 steps of its product
  const int rows_v = f.sup_r ? BN / f.sup_r : BN;
  const int ksteps = (rows_v + 15) / 16;

  auto prefetch = [&](int buf, int it) {
    const int n0 = it * BN;
    __nv_bfloat16* gs = gs0 + buf * BN * ldk;
    const int cpr = f.wk / 8;
    for (int idx = tid; idx < BN * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      cp_async16(gs + r * ldk + c, f.g + (size_t)(n0 + r) * f.wk + c, true);
    }
    __nv_bfloat16* vs = vs0 + buf * BN * ldv;
    const int cpv = cols / 8;
    const int v0 = it * rows_v;
    for (int idx = tid; idx < rows_v * cpv; idx += THREADS) {
      const int r = idx / cpv, c = (idx % cpv) * 8;
      cp_async16(vs + r * ldv + c, f.vw + (size_t)(v0 + r) * f.W + col_lo + c, true);
    }
    cp_async_commit();
  };

  if (rows_v % 16) {  // the padding of the last k16 step: zeros, once
    const int pad = 16 - rows_v % 16;
    for (int idx = tid; idx < BM * pad; idx += THREADS)
      pb[(idx / pad) * LDP + rows_v + idx % pad] = __float2bfloat16_rn(0.f);
    for (int idx = tid; idx < 2 * pad * ldv; idx += THREADS) {
      const int buf = idx / (pad * ldv), r = idx % (pad * ldv);
      vs0[buf * BN * ldv + rows_v * ldv + r] = __float2bfloat16_rn(0.f);
    }
  }

  {  // the query block, once (rows past Bp are zeros)
    const int cpr = f.wk / 8;
    for (int idx = tid; idx < BM * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      const bool ok = q0 + r < Bp;
      cp_async16(qs + r * ldk + c, q_cat + (ok ? (size_t)(q0 + r) * cat_d + f.q0 + c : 0), ok);
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

  // stats: thread owns query row sr and groups sc*8 .. sc*8+7 of a step
  const int sr = tid >> 2, sc = tid & 3;
  const int seg = f.gpt < BN ? f.gpt : BN;  // groups reduced together
  const int run_len = f.sup_r < 8 ? f.sup_r : 8;  // a thread's supergroup run
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
    const __nv_bfloat16* vs = vs0 + buf * BN * ldv;

    {  // logits: warp -> m16 tile (warp >> 1), n8 tiles 2 (warp & 1) + {0, 1}
      const int mt = warp >> 1, nt0 = (warp & 1) * 2;
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < f.wk; kk += 16) {
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

    {  // p = exp2(min(l, 86)) -> bf16 tile; per-tile max logit and exp-mass
      float lmax = NEG_INF, lsum = 0.f, run = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float l = lg[sr * LDL + sc * 8 + k];
        const float p = exp2f(fminf(l, CLAMP2));
        lmax = fmaxf(lmax, l);
        lsum += p;
        if (!f.sup_r) {
          pb[sr * LDP + sc * 8 + k] = __float2bfloat16_rn(p);
        } else {  // supergroup sums in f32, rounded to bf16 once
          run += p;
          if ((k + 1) % run_len == 0) {  // uniform across the warp
            float sum = run;
            run = 0.f;
            if (f.sup_r >= 16) sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            if (f.sup_r >= 32) sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const int grp = sc * 8 + k + 1 - run_len;  // the run's first group
            if (grp % f.sup_r == 0)
              pb[sr * LDP + grp / f.sup_r] = __float2bfloat16_rn(sum);
          }
        }
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
      if (!stats) {
      } else if (f.gpt <= BN) {
        if (lead && q < Bp) {
          const size_t o = (size_t)q * t_pad + (it * BN + sc * 8) / f.gpt;
          f.m[o] = lmax;
          f.s[o] = lsum;
        }
      } else {
        run_m = fmaxf(run_m, lmax);
        run_s += lsum;
        if ((it + 1) * BN % f.gpt == 0) {
          if (lead && q < Bp) {
            const size_t o = (size_t)q * t_pad + it * BN / f.gpt;
            f.m[o] = run_m;
            f.s[o] = run_s;
          }
          run_m = NEG_INF;
          run_s = 0.f;
        }
      }
    }
    __syncthreads();  // p tile complete

    // tail: acc[64 x this warp's columns] += P[64 x rows_v] @ V[rows_v x ...]
#pragma unroll
    for (int h = 0; h < MAX_NT / 2; ++h) {
      if (2 * h < ntw) {
        uint32_t b[2][4];
        load_b_pair(b[0], vs, ldv, 0, col_w + h * 16, lane);
        if (ksteps > 1) load_b_pair(b[1], vs, ldv, 16, col_w + h * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a0[4], a1[4];
          load_a(a0, pb, LDP, mt * 16, 0, g, t);
          if (ksteps > 1) load_a(a1, pb, LDP, mt * 16, 16, g, t);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(c, a0, b[0][2 * j], b[0][2 * j + 1]);
            if (ksteps > 1) mma_bf16(c, a1, b[1][2 * j], b[1][2 * j + 1]);
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
        if (q >= Bp) continue;
        const int col = f.tail0 + col_lo + col_w + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(tails + (size_t)q * tails_w + col) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

bool gpt_ok(int gpt) { return gpt % 8 == 0 && (gpt <= BN ? BN % gpt == 0 : gpt % BN == 0); }

// ceil(W / 512) column slices of equal width, a multiple of 64 (W % 128 == 0)
void slices(Family& f) {
  const int cap = 64 * MAX_NT;
  f.n_sl = (f.W + cap - 1) / cap;
  f.sw = ((f.W + f.n_sl - 1) / f.n_sl + 63) / 64 * 64;
}

}  // namespace

// q_cat [Bp, cat_d] bf16 packed queries: the sem family contracts columns
// [0, ws), the geo family the last wg.  g_sem [Gs, ws], g_geo [Gg, wg],
// vw_sem [Gs, Ws], vw_geo [Gg, Wg] bf16, Ws and Wg multiples of 128 (any
// width: above 512 the tail runs in column slices).  Out: m_s, s_s, m_g, s_g
// [Bp, t_pad] f32 and tails [Bp, Ws + Wg] f32 ([sem | geo]).  has_geo = 0:
// only m_s, s_s and tails [Bp, Ws] are written, the geo pointers are not
// read.  sup_r > 0: vw_sem is [Gs / sup_r, Ws], one row per sup_r
// consecutive sem groups (32 % sup_r == gpt_s % sup_r == 0).  All
// contiguous and 16-byte aligned.
extern "C" int hier_scan_launch(const void* q_cat, const void* g_sem, const void* g_geo,
                                const void* vw_sem, const void* vw_geo, void* m_s, void* s_s,
                                void* m_g, void* s_g, void* tails, int Bp, int cat_d, int ws,
                                int wg, int Gs, int Gg, int Ws, int Wg, int gpt_s, int gpt_g,
                                int t_pad, int has_geo, int sup_r, void* stream) {
  if (Bp <= 0) return 0;
  if (ws % 16 || ws > cat_d || cat_d % 8 || Ws <= 0 || Ws % 128 || Gs % BN ||
      !gpt_ok(gpt_s) || Gs != t_pad * gpt_s || sup_r < 0 || sup_r == 1 ||
      (sup_r && (BN % sup_r || gpt_s % sup_r)))
    return (int)cudaErrorInvalidValue;
  if (has_geo && (wg % 16 || wg > cat_d || Wg <= 0 || Wg % 128 || Gg % BN ||
                  !gpt_ok(gpt_g) || Gg != t_pad * gpt_g))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  Family f0{static_cast<const bf*>(g_sem), static_cast<const bf*>(vw_sem),
            static_cast<float*>(m_s), static_cast<float*>(s_s), ws, 0, Gs, Ws, gpt_s, 0,
            sup_r, 0, 0};
  Family f1{static_cast<const bf*>(g_geo), static_cast<const bf*>(vw_geo),
            static_cast<float*>(m_g), static_cast<float*>(s_g), wg, cat_d - wg, Gg, Wg,
            gpt_g, Ws, 0, 0, 0};
  slices(f0);
  if (has_geo) slices(f1);
  const Layout lay = has_geo ? layout(ws > wg ? ws : wg, f0.sw > f1.sw ? f0.sw : f1.sw)
                             : layout(ws, f0.sw);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bp + BM - 1) / BM, f0.n_sl + (has_geo ? f1.n_sl : 0));
  hier_scan_kernel<<<grid, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(q_cat), Bp, cat_d, t_pad, static_cast<float*>(tails),
      has_geo ? Ws + Wg : Ws, f0, f1, lay);
  return (int)cudaGetLastError();
}

// Hierarchical retrieval, stage 2 of the merged path: exact minus group
// approximation of BOTH families over each query block's selected tiles.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_parts_kernel` with lr
// on (reached via _hier_parts_call <- _hier_partials <- retrieve_hier, the
// merged branch that RANGE mode takes), with and without int8 values.  For
// each query and each of the K tiles selected for its block of bm queries
// (idx[block, j]):
//   p_s = exp2(min(q_sem . k_sem + mask, 86))   over the tile's bn rows
//   p_g = exp2(min(q_geo . k_geo + mask, 86))
//   d_s += sum p_s,  d_g += sum p_g
//   acc_s += bf16(p_s * s) @ v,  acc_g += bf16(p_g * s) @ v
//            (s = the row's int8 scale; without one, s = 1)
//   alr += bf16(exp2(min(q_sem . g_sem, 86))) @ vw_lr     (the tile's sem
//          groups; the low-rank sem approximation, subtracted outside)
//   [acc_g | d_g] -= bf16(exp2(min(q_geo . g_geo, 86))) @ vw_geo
//          (the tile's geo groups; the full-width geo approximation)
// Out [Bp, 2 Dv + 128 + Ws] f32: acc_s | acc_g | d_s | d_g | 0 (126) | alr.
// The sem approximation goes into alr only: neither acc_s nor d_s is
// decremented (the caller's corr = tails - alr telescopes it).
//
// GEO = false skips the geo family (RANGE mode reads neither acc_g nor
// d_g): those columns are written as zeros.  GEO = true is what the TPU
// kernel computes.  The geo logits contract one k16 step of columns
// [sem_d, sem_d + 16): the fast tier's 9 real hi/lo columns and zero
// padding, as the dense kernel.
//
// What bounds it on an H100: per (query, selected row) the sem logits and
// the value products, 2 x (sem_d + 2 Dv) flops with GEO = false (2 x
// (sem_d + 16 + 4 Dv) with it): at the RANGE flagship shape (B = 10,240
// padded queries, K = 32 tiles of 512 rows, sem_d = 256, Dv = 1,024) ~430
// GFLOP on the tensor cores, ~0.43 ms at the bf16 peak; the exponentials
// (one or two per query x row) come next.  The bytes are the selected key
// and value rows, re-read by every query block that selects the tile
// (from L2 when neighbouring blocks share tiles).
//
// Design: the TPU kernel carries a [bm, 2 Dv] f32 accumulator across its
// sequential tile axis; no block can hold that.  As the dense kernel
// (fused_retrieval.cu), a block owns 64 queries and one 256-column slice
// of Dv (grid.y), walks its query block's K tiles (it reads its own idx
// row: Hopper has no scalar prefetch) 32 rows at a time with the next rows
// streaming in by cp.async, and recomputes the row logits per slice; the
// [64 x 256] accumulators of both families stay in registers.  int8 value
// tiles stream in raw (half the bytes) and are converted to bf16 in shared
// memory.  At each tile's end the geo group approximation of the slice's
// columns is subtracted.  Slice 0 alone writes d_s, d_g, the pad and alr,
// each exactly once per query: the row sums come free with its logits, and
// after its value loop it walks the K tiles once more over their sem
// groups only (gpt_s of bn rows, ~5% of the slice's work) for alr, whose
// [64 x Ws] accumulator (up to 128 registers a thread) cannot sit beside
// the value accumulators.  A slice of its own would recompute every row
// logit once more for two sums.  Each 32-row step and each tile's group
// product is summed in a fresh tensor-core fragment and joins its
// accumulator with an IEEE f32 add.

#include <type_traits>

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;          // queries per block
constexpr int BN = 32;          // bank rows per step
constexpr int DVS = 256;        // value columns per block
constexpr int THREADS = 256;    // 8 warps
constexpr int GEO_D = 16;       // geo columns read: one k16 step
constexpr int LDV = DVS + 8;    // bf16 row stride of a value tile
constexpr int LDV8 = DVS + 16;  // byte row stride of a raw int8 value tile
constexpr int LDP = BN + 8;     // bf16 row stride of the p tiles
constexpr int LDG = GEO_D + 8;  // bf16 row stride of the geo group tile
constexpr int MAX_NT = 8;       // alr n8 tiles per warp: Ws <= 512
constexpr int MAX_GK = 4;       // k16 steps of one tile's sem groups: gpt_s <= 64
constexpr int MAX_GKG = 2;      // ... of its geo groups: gpt_g <= 32

struct Params {
  const __nv_bfloat16* q;     // [Bp, cat_d]
  const __nv_bfloat16* k;     // [N, cat_d]
  const void* v;              // [N, Dv] bf16, or int8 codes
  const float* scale;         // [N] int8 scales
  const float* mask;          // [N]
  const int* idx;             // [nB, K]
  const __nv_bfloat16* gs;    // [Gs, sem_d] sem group centroids
  const __nv_bfloat16* gg;    // [Gg, gw_g] geo group centroids
  const __nv_bfloat16* vs;    // [Gs, Ws] low-rank sem group coefficients
  const __nv_bfloat16* vg;    // [Gg, Wg] geo group value sums, count in column Dv
  float* out;                 // [Bp, 2 Dv + 128 + Ws]
  int cat_d, sem_d, Dv, bm, bn, gpt_s, gpt_g, K, Ws, Wg, gw_g;
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t qs;                                                   // both phases
  size_t ks, vs, vc, pt, mask, scale, dpart, ggt, vgt, cnt, eg, dgc;  // phase A
  size_t gst, vst, es;                                         // phase B (overlays A)
  size_t total;
  int ldq, gp16s, gp16g;
};

// Shared memory: the idx row, the query block [64 x sem_d + 16]; phase A two
// key/value steps, the int8 conversion tile, the p tiles, mask and scale,
// the row sums and one tile's geo groups; phase B one tile's sem groups and
// their exponentials.
__host__ __device__ inline Layout layout(int K, int sem_d, int gpt_s, int gpt_g, int Ws,
                                         bool i8) {
  Layout l;
  l.ldq = sem_d + GEO_D + 8;
  l.gp16s = (gpt_s + 15) / 16 * 16;
  l.gp16g = (gpt_g + 15) / 16 * 16;
  l.qs = up16((size_t)K * 4);
  l.ks = l.qs + (size_t)BM * l.ldq * 2;
  l.vs = l.ks + (size_t)2 * BN * l.ldq * 2;
  l.vc = l.vs + (size_t)2 * BN * (i8 ? LDV8 : LDV * 2);
  l.pt = l.vc + (i8 ? (size_t)BN * LDV * 2 : 0);
  l.mask = l.pt + (size_t)2 * BM * LDP * 2;
  l.scale = l.mask + 2 * BN * 4;
  l.dpart = l.scale + 2 * BN * 4;
  l.ggt = l.dpart + 4 * BM * 4;
  l.vgt = l.ggt + (size_t)l.gp16g * LDG * 2;
  l.cnt = l.vgt + (size_t)l.gp16g * LDV * 2;
  l.eg = l.cnt + up16((size_t)l.gp16g * 4);
  l.dgc = l.eg + (size_t)BM * (l.gp16g + 8) * 2;
  const size_t end_a = l.dgc + BM * 4;
  l.gst = l.ks;
  l.vst = l.gst + (size_t)l.gp16s * (sem_d + 8) * 2;
  l.es = l.vst + (size_t)l.gp16s * (Ws + 8) * 2;
  const size_t end_b = l.es + (size_t)BM * (l.gp16s + 8) * 2;
  l.total = end_a > end_b ? end_a : end_b;
  return l;
}

template <bool GEO, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
hier_parts_kernel(const Params P, const Layout lay) {
  using bf = __nv_bfloat16;
  using V = typename std::conditional<I8, int8_t, bf>::type;
  constexpr int EV = 16 / sizeof(V);          // value elements per 16-byte copy
  constexpr int LDVR = I8 ? LDV8 : LDV;       // row stride of a streamed value tile
  constexpr int NF = GEO ? 2 : 1;             // families with a value accumulator

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int* idx_s = reinterpret_cast<int*>(base);
  bf* qs = reinterpret_cast<bf*>(base + lay.qs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int blk = q0 / P.bm;
  const int col0 = blockIdx.y * DVS;
  const bool lead = blockIdx.y == 0;  // writes d_s, d_g, the pad and alr
  const int ldq = lay.ldq, U = P.sem_d + GEO_D;
  const int out_w = 2 * P.Dv + 128 + P.Ws;
  const int spt = P.bn / BN, n_steps = P.K * spt;
  const V* vals = static_cast<const V*>(P.v);

  for (int j = tid; j < P.K; j += THREADS) idx_s[j] = P.idx[(size_t)blk * P.K + j];
  {  // the query block, once (Bp is a multiple of 64)
    const int cpr = U / 8;
    for (int i = tid; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      cp_async16(qs + r * ldq + c, P.q + (size_t)(q0 + r) * P.cat_d + c, true);
    }
    cp_async_commit();
  }
  __syncthreads();  // idx_s visible

  // ------------------------------------------------------------ phase A
  {
    bf* ks0 = reinterpret_cast<bf*>(base + lay.ks);
    V* vs0 = reinterpret_cast<V*>(base + lay.vs);
    bf* vconv = reinterpret_cast<bf*>(base + lay.vc);  // I8 only
    bf* ps = reinterpret_cast<bf*>(base + lay.pt);
    bf* pg = ps + BM * LDP;
    float* mask0 = reinterpret_cast<float*>(base + lay.mask);
    float* scale0 = reinterpret_cast<float*>(base + lay.scale);  // I8 only
    float* dpart = reinterpret_cast<float*>(base + lay.dpart);   // [family][part][BM]
    bf* ggt = reinterpret_cast<bf*>(base + lay.ggt);
    bf* vgt = reinterpret_cast<bf*>(base + lay.vgt);
    float* cnt = reinterpret_cast<float*>(base + lay.cnt);
    bf* egb = reinterpret_cast<bf*>(base + lay.eg);
    float* dgc = reinterpret_cast<float*>(base + lay.dgc);
    const int gp16g = lay.gp16g, ldeg = gp16g + 8;

    auto prefetch = [&](int buf, int it) {
      const int row0 = idx_s[it / spt] * P.bn + (it % spt) * BN;
      bf* ks = ks0 + buf * BN * ldq;
      const int cpr = U / 8;
      for (int i = tid; i < BN * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 8;
        cp_async16(ks + r * ldq + c, P.k + (size_t)(row0 + r) * P.cat_d + c, true);
      }
      V* vs = vs0 + buf * BN * LDVR;
      const int cpv = DVS / EV;
      for (int i = tid; i < BN * cpv; i += THREADS) {
        const int r = i / cpv, c = (i % cpv) * EV;
        const bool ok = col0 + c < P.Dv;
        cp_async16(vs + r * LDVR + c, vals + (ok ? (size_t)(row0 + r) * P.Dv + col0 + c : 0), ok);
      }
      if (tid < BN) {
        cp_async4(mask0 + buf * BN + tid, P.mask + row0 + tid, true);
      } else if (I8 && tid < 2 * BN) {
        cp_async4(scale0 + buf * BN + tid - BN, P.scale + row0 + tid - BN, true);
      }
      cp_async_commit();
    };
    prefetch(0, 0);

    float acc[NF][4][4][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][mt][nt][e] = 0.f;
    // this thread's share of rows mt*16 + g (+ 8) ([half]) exp sums
    float dsum_s[2] = {0.f, 0.f}, dsum_g[2] = {0.f, 0.f};
    float dg_corr = 0.f;  // lead, GEO: row tid's geo count approximation

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
      const int j = it / spt, s = it % spt;
      const bf* ks = ks0 + buf * BN * ldq;
      const float* mask_s = mask0 + buf * BN;
      const float* scale_s = scale0 + buf * BN;
      const bf* vs;
      if constexpr (I8) {
        // the raw codes -> the bf16 tile the value products read (exact)
        const int8_t* v8 = reinterpret_cast<const int8_t*>(vs0) + buf * BN * LDV8;
        for (int i = tid; i < BN * (DVS / 16); i += THREADS) {
          const int r = i / (DVS / 16), c = (i % (DVS / 16)) * 16;
          const int4 raw = *reinterpret_cast<const int4*>(v8 + r * LDV8 + c);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          __align__(16) __nv_bfloat162 h[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            h[k] = __floats2bfloat162_rn(static_cast<float>(b[2 * k]),
                                         static_cast<float>(b[2 * k + 1]));
          int4* dst = reinterpret_cast<int4*>(vconv + r * LDV + c);
          dst[0] = reinterpret_cast<const int4*>(h)[0];
          dst[1] = reinterpret_cast<const int4*>(h)[1];
        }
        vs = vconv;
      } else {
        vs = vs0 + buf * BN * LDV;
      }

      {  // row logits -> p (unscaled into the sums, scaled into the bf16 tiles)
        const int mt = warp >> 1, nt0 = (warp & 1) * 2;
        float cs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float cg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < P.sem_d; kk += 16) {
          uint32_t a[4];
          load_a(a, qs, ldq, mt * 16, kk, g, t);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t b0, b1;
            load_bt(b0, b1, ks, ldq, (nt0 + i) * 8, kk, g, t);
            mma_bf16(cs[i], a, b0, b1);
          }
        }
        if constexpr (GEO) {
          uint32_t a[4];
          load_a(a, qs, ldq, mt * 16, P.sem_d, g, t);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t b0, b1;
            load_bt(b0, b1, ks, ldq, (nt0 + i) * 8, P.sem_d, g, t);
            mma_bf16(cg[i], a, b0, b1);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = (nt0 + i) * 8 + 2 * t;
            const float m0 = mask_s[c], m1 = mask_s[c + 1];
            const float c0 = I8 ? scale_s[c] : 1.f, c1 = I8 ? scale_s[c + 1] : 1.f;
            const float s0 = exp2f(fminf(cs[i][2 * h] + m0, CLAMP2));
            const float s1 = exp2f(fminf(cs[i][2 * h + 1] + m1, CLAMP2));
            dsum_s[h] += s0 + s1;
            *reinterpret_cast<__nv_bfloat162*>(ps + r * LDP + c) =
                I8 ? __floats2bfloat162_rn(s0 * c0, s1 * c1) : __floats2bfloat162_rn(s0, s1);
            if constexpr (GEO) {
              const float g0 = exp2f(fminf(cg[i][2 * h] + m0, CLAMP2));
              const float g1 = exp2f(fminf(cg[i][2 * h + 1] + m1, CLAMP2));
              dsum_g[h] += g0 + g1;
              *reinterpret_cast<__nv_bfloat162*>(pg + r * LDP + c) =
                  I8 ? __floats2bfloat162_rn(g0 * c0, g1 * c1) : __floats2bfloat162_rn(g0, g1);
            }
          }
        }
      }
      __syncthreads();  // p tiles (and the converted value tile) complete

      // acc_f[64 x this warp's 32 columns] += P_f[64 x 32] @ V[32 x ...]
      {
        uint32_t b[2][2][4];  // [k16 step][column pair][n8 tiles 2 x fragment]
#pragma unroll
        for (int ks16 = 0; ks16 < 2; ++ks16)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            load_b_pair(b[ks16][h], vs, LDV, ks16 * 16, warp * 32 + h * 16, lane);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const bf* Pt = f ? pg : ps;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a0[4], a1[4];
            load_a(a0, Pt, LDP, mt * 16, 0, g, t);
            load_a(a1, Pt, LDP, mt * 16, 16, g, t);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int h = nt >> 1, e2 = (nt & 1) * 2;
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, a0, b[0][h][e2], b[0][h][e2 + 1]);
              mma_bf16(c, a1, b[1][h][e2], b[1][h][e2 + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[f][mt][nt][e] += c[e];
            }
          }
        }
      }

      if constexpr (GEO) {
        if (s == spt - 1) {  // the tile's geo group approximation, this slice's columns
          const size_t grow0 = (size_t)idx_s[j] * P.gpt_g;
          for (int i = tid; i < gp16g * (GEO_D / 8); i += THREADS) {
            const int r = i / (GEO_D / 8), c = (i % (GEO_D / 8)) * 8;
            int4 v = make_int4(0, 0, 0, 0);
            if (r < P.gpt_g) v = *reinterpret_cast<const int4*>(P.gg + (grow0 + r) * P.gw_g + c);
            *reinterpret_cast<int4*>(ggt + r * LDG + c) = v;
          }
          for (int i = tid; i < gp16g * (DVS / 8); i += THREADS) {
            const int r = i / (DVS / 8), c = (i % (DVS / 8)) * 8;
            int4 v = make_int4(0, 0, 0, 0);
            if (r < P.gpt_g && col0 + c < P.Dv)
              v = *reinterpret_cast<const int4*>(P.vg + (grow0 + r) * P.Wg + col0 + c);
            *reinterpret_cast<int4*>(vgt + r * LDV + c) = v;
          }
          if (lead && tid < gp16g)
            cnt[tid] = tid < P.gpt_g ? __bfloat162float(P.vg[(grow0 + tid) * P.Wg + P.Dv]) : 0.f;
          __syncthreads();
          // eg = bf16(exp2(min(q_geo . g_geo, 86))) [64 x gp16g], zero past gpt_g
          for (int tt = warp; tt < 4 * (gp16g / 8); tt += THREADS / 32) {
            const int mt = tt & 3, nt = tt >> 2;
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            uint32_t a[4], b0, b1;
            load_a(a, qs, ldq, mt * 16, P.sem_d, g, t);
            load_bt(b0, b1, ggt, LDG, nt * 8, 0, g, t);
            mma_bf16(c, a, b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mt * 16 + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
              egb[r * ldeg + col] = __float2bfloat16_rn(
                  col < P.gpt_g ? exp2f(fminf(c[e], CLAMP2)) : 0.f);
            }
          }
          __syncthreads();
          if (lead && tid < BM) {  // the count column: d_g's approximation
            float sacc = 0.f;
            for (int c = 0; c < P.gpt_g; ++c)
              sacc += __bfloat162float(egb[tid * ldeg + c]) * cnt[c];
            dg_corr += sacc;
          }
          // acc_g[64 x this warp's 32 columns] -= EG[64 x gp16g] @ VG[gp16g x ...]
          const int nks = gp16g / 16;
          uint32_t b[MAX_GKG][2][4];
#pragma unroll
          for (int k = 0; k < MAX_GKG; ++k)
            if (k < nks)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                load_b_pair(b[k][h], vgt, LDV, k * 16, warp * 32 + h * 16, lane);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float c[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
            for (int k = 0; k < MAX_GKG; ++k) {
              if (k < nks) {
                uint32_t a[4];
                load_a(a, egb, ldeg, mt * 16, k * 16, g, t);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                  mma_bf16(c[nt], a, b[k][nt >> 1][(nt & 1) * 2], b[k][nt >> 1][(nt & 1) * 2 + 1]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[NF - 1][mt][nt][e] -= c[nt][e];
          }
        }
      }
    }
    cp_async_wait<0>();  // nothing in flight

    // this slice's columns of acc_s and acc_g (zeros without GEO)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t row = (size_t)(q0 + mt * 16 + g + 8 * half) * out_w + f * P.Dv;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int c = col0 + warp * 32 + nt * 8 + 2 * t;
            if (c >= P.Dv) continue;
            const int fi = f < NF ? f : 0;
            const float2 v = f < NF ? make_float2(acc[fi][mt][nt][2 * half],
                                                  acc[fi][mt][nt][2 * half + 1])
                                    : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(P.out + row + c) = v;
          }
        }

    if (!lead) return;
    // d_s and d_g: the 4 lanes of a row share g; the two warps of an m16
    // tile split its columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dsum_s[h] += __shfl_xor_sync(0xffffffffu, dsum_s[h], off);
        dsum_g[h] += __shfl_xor_sync(0xffffffffu, dsum_g[h], off);
      }
      if (t == 0) {
        const int r = (warp >> 1) * 16 + g + 8 * h, part = warp & 1;
        dpart[part * BM + r] = dsum_s[h];
        dpart[(2 + part) * BM + r] = dsum_g[h];
      }
    }
    if (tid < BM) dgc[tid] = dg_corr;
    __syncthreads();
    for (int i = tid; i < BM * 128; i += THREADS) {
      const int r = i / 128, c = i % 128;
      float v = 0.f;
      if (c == 0) v = dpart[r] + dpart[BM + r];
      if (GEO && c == 1) v = dpart[2 * BM + r] + dpart[3 * BM + r] - dgc[r];
      P.out[(size_t)(q0 + r) * out_w + 2 * P.Dv + c] = v;
    }
  }
  __syncthreads();  // phase B reuses phase A's shared memory

  // ------------------------------------------------------------ phase B
  // (the lead slice only) alr += bf16(exp2(min(q_sem . g_sem, 86))) @ vw_lr
  bf* gst = reinterpret_cast<bf*>(base + lay.gst);
  bf* vst = reinterpret_cast<bf*>(base + lay.vst);
  bf* esb = reinterpret_cast<bf*>(base + lay.es);
  const int lds = P.sem_d + 8, ldw = P.Ws + 8, gp16 = lay.gp16s, lde = gp16 + 8;
  const int nks = gp16 / 16, ntw = P.Ws / 64, col_a = warp * ntw * 8;

  float acc[4][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int j = 0; j < P.K; ++j) {
    __syncthreads();  // the previous tile is fully consumed
    const size_t grow0 = (size_t)idx_s[j] * P.gpt_s;
    {  // the tile's sem groups; rows past gpt_s are zeros (a k16 step)
      const int cpr = P.sem_d / 8;
      for (int i = tid; i < gp16 * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 8;
        const bool ok = r < P.gpt_s;
        cp_async16(gst + r * lds + c, P.gs + (ok ? (grow0 + r) * P.sem_d + c : 0), ok);
      }
      const int cpv = P.Ws / 8;
      for (int i = tid; i < gp16 * cpv; i += THREADS) {
        const int r = i / cpv, c = (i % cpv) * 8;
        const bool ok = r < P.gpt_s;
        cp_async16(vst + r * ldw + c, P.vs + (ok ? (grow0 + r) * P.Ws + c : 0), ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int tt = warp; tt < 4 * (gp16 / 8); tt += THREADS / 32) {
      const int mt = tt & 3, nt = tt >> 2;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < P.sem_d; kk += 16) {
        uint32_t a[4], b0, b1;
        load_a(a, qs, ldq, mt * 16, kk, g, t);
        load_bt(b0, b1, gst, lds, nt * 8, kk, g, t);
        mma_bf16(c, a, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
        esb[r * lde + col] =
            __float2bfloat16_rn(col < P.gpt_s ? exp2f(fminf(c[e], CLAMP2)) : 0.f);
      }
    }
    __syncthreads();

    // alr[64 x this warp's columns] += ES[64 x gp16] @ VW[gp16 x ...]
#pragma unroll
    for (int h = 0; h < MAX_NT / 2; ++h) {
      if (2 * h < ntw) {
        uint32_t b[MAX_GK][4];
#pragma unroll
        for (int k = 0; k < MAX_GK; ++k)
          if (k < nks) load_b_pair(b[k], vst, ldw, k * 16, col_a + h * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int k = 0; k < MAX_GK; ++k) {
            if (k < nks) {
              uint32_t a[4];
              load_a(a, esb, lde, mt * 16, k * 16, g, t);
              mma_bf16(c[0], a, b[k][0], b[k][1]);
              mma_bf16(c[1], a, b[k][2], b[k][3]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][2 * h][e] += c[0][e];
            acc[mt][2 * h + 1][e] += c[1][e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= ntw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + mt * 16 + g + 8 * half;
        *reinterpret_cast<float2*>(P.out + (size_t)q * out_w + 2 * P.Dv + 128 + col_a + nt * 8 +
                                   2 * t) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

template <bool GEO, bool I8>
int launch(const Params& P, int Bp, cudaStream_t stream) {
  const Layout lay = layout(P.K, P.sem_d, P.gpt_s, P.gpt_g, P.Ws, I8);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_parts_kernel<GEO, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bp / BM, (P.Dv + DVS - 1) / DVS);
  hier_parts_kernel<GEO, I8><<<grid, THREADS, lay.total, stream>>>(P, lay);
  return (int)cudaGetLastError();
}

}  // namespace

// q_cat [Bp, cat_d], k_cat [N, cat_d] bf16 packed (the row logits contract
// columns [0, sem_d) and [sem_d, sem_d + 16)); values [N, Dv] bf16, or
// int8 codes with scale [N] f32 (i8); mask_neg [N] f32; idx [Bp / bm, K]
// int32 (tiles < N / bn); g_sem [Gs, sem_d] and g_geo [Gg, gw_g] bf16 slim
// group centroids (the geo ones contract the query columns [cat_d - gw_g,
// + 16), which must be sem_d); vw_lr [Gs, Ws] bf16 low-rank sem group
// coefficients; vw_geo [Gg, Wg] bf16 geo group value sums with the count in
// column Dv; out [Bp, 2 Dv + 128 + Ws] f32.  geo = 0 skips the geo family
// (its columns are written as zeros).  All contiguous and 16-byte aligned.
extern "C" int hier_parts_launch(const void* q_cat, const void* k_cat, const void* values,
                                 const void* scale, const void* mask_neg, const void* idx,
                                 const void* g_sem, const void* g_geo, const void* vw_lr,
                                 const void* vw_geo, void* out, int Bp, int cat_d, int sem_d,
                                 int Dv, int bm, int bn, int gpt_s, int gpt_g, int K, int Ws,
                                 int Wg, int gw_g, int geo, int i8, void* stream) {
  if (Bp <= 0 || K <= 0) return 0;
  if (bm % BM || Bp % bm || bn % BN || sem_d % 16 || sem_d + GEO_D > cat_d || cat_d % 8 ||
      Dv % 16 || Ws % 128 || Ws > 64 * MAX_NT || gpt_s < 1 || gpt_s > 16 * MAX_GK ||
      (geo && (gpt_g < 1 || gpt_g > 16 * MAX_GKG || Wg < Dv + 1 || Wg % 8 || gw_g < GEO_D ||
               gw_g % 8 || cat_d - gw_g != sem_d)))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const Params P{static_cast<const bf*>(q_cat), static_cast<const bf*>(k_cat), values,
                 static_cast<const float*>(scale), static_cast<const float*>(mask_neg),
                 static_cast<const int*>(idx), static_cast<const bf*>(g_sem),
                 static_cast<const bf*>(g_geo), static_cast<const bf*>(vw_lr),
                 static_cast<const bf*>(vw_geo), static_cast<float*>(out), cat_d, sem_d, Dv,
                 bm, bn, gpt_s, gpt_g, K, Ws, Wg, gw_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo) return i8 ? launch<true, true>(P, Bp, s) : launch<true, false>(P, Bp, s);
  return i8 ? launch<false, true>(P, Bp, s) : launch<false, false>(P, Bp, s);
}

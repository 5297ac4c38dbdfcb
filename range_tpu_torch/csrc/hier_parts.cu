// Hierarchical retrieval, stage 2 over the bank's values: exact minus group
// approximation over each query block's selected tiles, for the merged
// path (both families) and for the family-split path's value variants
// (one family).
//
// Replaces: range_tpu/ops/retrieval_hier.py,
//   * `_hier_parts_kernel` (reached via _hier_parts_call <- _hier_partials
//     <- retrieve_hier, the merged branch: RANGE mode, and RANGE+ with
//     k_geo = 0 on banks without res_rank), with lr on or off, with and
//     without int8 values;
//   * `_hier_parts_family_kernel` without rr, with lr on or off (reached
//     via _hier_parts_family_call <- _hier_partials, the family-split
//     branch on banks without res_rank), sem or geo, with and without int8
//     values.  Its rr variants, which stream no values, are
//     `hier_parts_family.cu`.
// For each query and each of the K tiles selected for its block of bm
// queries (idx[block, j]), for each family f of the launch (sem: the row
// logits over the packed columns [0, sem_d), its group logits over the
// query's first gw_s columns; geo: both over [sem_d, sem_d + 16), the fast
// tier's 9 real hi/lo columns and zero padding):
//   p_f   = exp2(min(q_f . k_f + mask, 86))   over the tile's bn rows
//   d_f  += sum p_f
//   acc_f += bf16(p_f * s) @ v        (s = the row's int8 scale, else 1)
//   e_f   = bf16(exp2(min(q_f . g_f, 86)))    over the tile's gpt_f groups
// and the group approximation e_f @ vw_f either
//   [acc_f | d_f] -= e_f @ vw_f   (full-width group value sums, the count
//                                  in column Dv: the "plain" families), or
//   alr += e_f @ vw_f             (low-rank coefficients of the first
//                                  family, lr: subtracted outside).
// Out [Bp, nfo Dv + 128 (+ W_alr)] f32:
//   merged (nfo = 2): acc_s | acc_g | d_s | d_g | 0 (126) [| alr]
//   family (nfo = 1): acc | d | 0 (127) [| alr]
// A merged launch without its geo family (RANGE mode reads neither acc_g
// nor d_g) writes those columns as zeros; the TPU kernel computes them.
// The family launches have two more forms: sel (sel_lr banks, the sem
// family) takes its group logits from the query operand's last gw columns,
// the rank-k sketch appended past cat_d (`:2341-2346`; the query block
// carries them past its sem_d row-logit columns), and dedup_pad (lists
// merged by _dedup_union) drops a list entry equal to the one before it,
// the union's repeat padding (`:2319-2324, 2402-2406`), before walking
// the list: running it twice would double its (exact - approx) term.
//
// What bounds it on an H100: per (query, selected row) the row logits and
// the value products, 2 x (sem_d + Dv) flops a family: at the RANGE
// flagship shape (B = 10,240 padded queries, K = 32 tiles of 512 rows,
// sem_d = 256, Dv = 1,024) ~430 GFLOP on the tensor cores, ~0.43 ms at the
// bf16 peak; the exponentials (one per query x row x family) come next.
// The plain families add 2 x gpt x (gk + Dv) flops per (query, tile) for
// their group approximation (~6% at gpt 64, gk 256, bn 512).  The bytes are
// the selected key and value rows, re-read by every query block that
// selects the tile (from L2 when neighbouring blocks share tiles).
//
// Design: the TPU kernel carries a [bm, nfo Dv] f32 accumulator across its
// sequential tile axis; no block can hold that.  As the dense kernel
// (fused_retrieval.cu), a block owns 64 queries and one 256-column slice
// of Dv (grid.y), walks its query block's K tiles (it reads its own idx
// row: Hopper has no scalar prefetch) 32 rows at a time with the next rows
// streaming in by cp.async, and recomputes the row logits per slice; the
// [64 x 256] accumulators of its families stay in registers.  int8 value
// tiles stream in raw (half the bytes) and are converted to bf16 in shared
// memory.  At each tile's end a plain family's group approximation of the
// slice's columns is subtracted (its group logits recomputed per slice,
// 64 x gpt x gk, small beside the tile's 64 x bn x (gk + 256)), and the
// count column's product goes into d.  Slice 0 alone writes the d columns,
// the pad and alr, each exactly once per query: the row sums come free
// with its logits, and after its value loop it walks the K tiles once more
// over the lr family's groups only (gpt of bn rows, ~5% of the slice's
// work) for alr, whose [64 x W_alr] accumulator (up to 128 registers a
// thread) cannot sit beside the value accumulators.  A slice of its own
// would recompute every row logit once more for two sums.  Each 32-row
// step and each tile's group product is summed in a fresh tensor-core
// fragment and joins its accumulator with an IEEE f32 add.  Past 64
// groups a tile (128 for gsz_sem 4 at bn 512) both group parts walk a
// tile's groups in chunks of 64 (the CHUNKED instances), so shared memory
// holds one chunk's centroids, value rows and exponentials; up to 64 they
// take the tile in one pass.

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
constexpr int MAX_NT = 8;       // alr n8 tiles per warp: W_alr <= 512
constexpr int MAX_GK = 4;       // k16 steps of a chunk of a tile's groups
constexpr int GC = 16 * MAX_GK; // groups a chunk: a tile's groups are walked 64 at a time

struct Fam {
  const __nv_bfloat16* g;   // [G, gw] group centroids
  const __nv_bfloat16* vw;  // [G, W] group value sums (count in column Dv), or lr coefficients
  int kc, kf;               // row-logit columns [kc, kc + kf) of the query / key block
  int qg, gk;               // group logits: query-block columns [qg, qg + gk), g's first gk
  int gw, W, gpt;           // centroid row width, vw row width, groups per tile
};

struct Params {
  const __nv_bfloat16* q;  // [Bp, qw]
  const __nv_bfloat16* k;  // [N, cat_d]
  const void* v;           // [N, Dv] bf16, or int8 codes
  const float* scale;      // [N] int8 scales
  const float* mask;       // [N]
  const int* idx;          // [nB, K]
  Fam f[2];
  float* out;              // [Bp, out_w]
  int cat_d, c0, U;        // the query / key blocks hold packed columns [c0, c0 + U)
  int Dv, bm, bn, K, nfo, out_w;
  int qw, qx0, UX;         // query row stride; the query block's columns [U, U + UX)
                           // hold the query's [qx0, qx0 + UX) (sel: the sketch)
  int dedup;               // skip an idx entry equal to the one before it
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline int gp16(int gpt) { return (gpt + 15) / 16 * 16; }

// The groups of a tile's largest chunk, rounded to a k16 step
__host__ __device__ inline int gc16(int gpt) { return gp16(gpt < GC ? gpt : GC); }

struct Layout {
  size_t qs;                                                // both phases
  size_t ks, vs, vc, pt, mask, scale, dpart, gt, vgt, cnt, eg, dgc;  // phase A
  size_t gst, vst, es;                                      // phase B (overlays A)
  size_t total;
  int ldq, ldqs, ldgt, gpm;  // key and query block row strides, group tile
                             // row stride, the plain families' largest gpt
                             // rounded to a k16 step
};

// Shared memory: the idx row, the query block [64 x U]; phase A two
// key/value steps, the int8 conversion tile, the p tiles, mask and scale,
// the row sums, and one tile's groups of a plain family (centroids, value
// slice, counts, exponentials); phase B one tile's lr groups and their
// exponentials.
__host__ __device__ inline Layout layout(const Params& P, int nf, bool alr, bool i8) {
  Layout l;
  l.ldq = P.U + 8;
  l.ldqs = P.U + P.UX + 8;
  int gkm = 0;
  l.gpm = 0;
  for (int f = alr ? 1 : 0; f < nf; ++f) {
    gkm = P.f[f].gk > gkm ? P.f[f].gk : gkm;
    l.gpm = gc16(P.f[f].gpt) > l.gpm ? gc16(P.f[f].gpt) : l.gpm;
  }
  l.ldgt = gkm + 8;
  l.qs = up16((size_t)P.K * 4);
  l.ks = l.qs + (size_t)BM * l.ldqs * 2;
  l.vs = l.ks + (size_t)2 * BN * l.ldq * 2;
  l.vc = l.vs + (size_t)2 * BN * (i8 ? LDV8 : LDV * 2);
  l.pt = l.vc + (i8 ? (size_t)BN * LDV * 2 : 0);
  l.mask = l.pt + (size_t)nf * BM * LDP * 2;
  l.scale = l.mask + 2 * BN * 4;
  l.dpart = l.scale + 2 * BN * 4;
  l.gt = l.dpart + 4 * BM * 4;
  l.vgt = l.gt + (size_t)l.gpm * l.ldgt * 2;
  l.cnt = l.vgt + (size_t)l.gpm * LDV * 2;
  l.eg = l.cnt + up16((size_t)l.gpm * 4);
  l.dgc = l.eg + (size_t)BM * (l.gpm + 8) * 2;
  const size_t end_a = l.dgc + 2 * BM * 4;
  size_t end_b = 0;
  if (alr) {
    const int ga = gc16(P.f[0].gpt);
    l.gst = l.ks;
    l.vst = l.gst + (size_t)ga * (P.f[0].gk + 8) * 2;
    l.es = l.vst + (size_t)ga * (P.f[0].W + 8) * 2;
    end_b = l.es + (size_t)BM * (ga + 8) * 2;
  }
  l.total = end_a > end_b ? end_a : end_b;
  return l;
}

// NF families with a value accumulator; ALR: family 0's approximation goes
// to alr (phase B), every other family's is subtracted at its tiles' ends.
// CHUNKED: a tile's groups in chunks of GC (a family has more than GC).
template <int NF, bool I8, bool ALR, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1)
hier_parts_kernel(const Params P, const Layout lay) {
  using bf = __nv_bfloat16;
  using V = typename std::conditional<I8, int8_t, bf>::type;
  constexpr int EV = 16 / sizeof(V);     // value elements per 16-byte copy
  constexpr int LDVR = I8 ? LDV8 : LDV;  // row stride of a streamed value tile

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int* idx_s = reinterpret_cast<int*>(base);
  bf* qs = reinterpret_cast<bf*>(base + lay.qs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int blk = q0 / P.bm;
  const int col0 = blockIdx.y * DVS;
  const bool lead = blockIdx.y == 0;  // writes the d columns, the pad and alr
  const int ldq = lay.ldq, ldqs = lay.ldqs;
  const V* vals = static_cast<const V*>(P.v);

  for (int j = tid; j < P.K; j += THREADS) idx_s[j] = P.idx[(size_t)blk * P.K + j];
  {  // the query block, once (Bp is a multiple of 64)
    const int cpr = (P.U + P.UX) / 8;
    for (int i = tid; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int src = c < P.U ? P.c0 + c : P.qx0 + c - P.U;
      cp_async16(qs + r * ldqs + c, P.q + (size_t)(q0 + r) * P.qw + src, true);
    }
    cp_async_commit();
  }
  __shared__ int k_run;  // the list's length after the dedup_pad skip
  __syncthreads();       // idx_s visible
  if (tid == 0) {
    int n = P.K;
    if (P.dedup) {
      int prev = idx_s[0];
      n = 1;
      for (int j = 1; j < P.K; ++j) {
        const int v = idx_s[j];
        if (v != prev) idx_s[n++] = v;
        prev = v;
      }
    }
    k_run = n;
  }
  __syncthreads();
  const int K = k_run;
  const int spt = P.bn / BN, n_steps = K * spt;

  // ------------------------------------------------------------ phase A
  {
    bf* ks0 = reinterpret_cast<bf*>(base + lay.ks);
    V* vs0 = reinterpret_cast<V*>(base + lay.vs);
    bf* vconv = reinterpret_cast<bf*>(base + lay.vc);  // I8 only
    bf* pt = reinterpret_cast<bf*>(base + lay.pt);     // [family][BM x LDP]
    float* mask0 = reinterpret_cast<float*>(base + lay.mask);
    float* scale0 = reinterpret_cast<float*>(base + lay.scale);  // I8 only
    float* dpart = reinterpret_cast<float*>(base + lay.dpart);   // [family][part][BM]
    bf* gt = reinterpret_cast<bf*>(base + lay.gt);
    bf* vgt = reinterpret_cast<bf*>(base + lay.vgt);
    float* cnt = reinterpret_cast<float*>(base + lay.cnt);
    bf* egb = reinterpret_cast<bf*>(base + lay.eg);
    float* dgc = reinterpret_cast<float*>(base + lay.dgc);  // [family][BM]
    const int ldgt = lay.ldgt;

    auto prefetch = [&](int buf, int it) {
      const int row0 = idx_s[it / spt] * P.bn + (it % spt) * BN;
      bf* ks = ks0 + buf * BN * ldq;
      const int cpr = P.U / 8;
      for (int i = tid; i < BN * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 8;
        cp_async16(ks + r * ldq + c, P.k + (size_t)(row0 + r) * P.cat_d + P.c0 + c, true);
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
    float dsum[NF][2];
#pragma unroll
    for (int f = 0; f < NF; ++f) dsum[f][0] = dsum[f][1] = 0.f;
    float dcorr[NF];  // lead, plain families: row tid's count approximation
#pragma unroll
    for (int f = 0; f < NF; ++f) dcorr[f] = 0.f;

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
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int kk = P.f[f].kc; kk < P.f[f].kc + P.f[f].kf; kk += 16) {
            uint32_t a[4];
            load_a(a, qs, ldqs, mt * 16, kk, g, t);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              uint32_t b0, b1;
              load_bt(b0, b1, ks, ldq, (nt0 + i) * 8, kk, g, t);
              mma_bf16(c[i], a, b0, b1);
            }
          }
          bf* pf = pt + f * BM * LDP;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + g + 8 * h;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int cc = (nt0 + i) * 8 + 2 * t;
              const float m0 = mask_s[cc], m1 = mask_s[cc + 1];
              const float c0 = I8 ? scale_s[cc] : 1.f, c1 = I8 ? scale_s[cc + 1] : 1.f;
              const float p0 = exp2f(fminf(c[i][2 * h] + m0, CLAMP2));
              const float p1 = exp2f(fminf(c[i][2 * h + 1] + m1, CLAMP2));
              dsum[f][h] += p0 + p1;
              *reinterpret_cast<__nv_bfloat162*>(pf + r * LDP + cc) =
                  I8 ? __floats2bfloat162_rn(p0 * c0, p1 * c1) : __floats2bfloat162_rn(p0, p1);
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
          const bf* Pt = pt + f * BM * LDP;
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

      if (s == spt - 1) {  // the tile's group approximation of the plain families
#pragma unroll
        for (int f = ALR ? 1 : 0; f < NF; ++f)
        for (int c0 = 0; c0 < (CHUNKED ? P.f[f].gpt : 1); c0 += GC) {  // chunks of GC groups
          const Fam& F = P.f[f];
          const int gc = !CHUNKED ? F.gpt : F.gpt - c0 < GC ? F.gpt - c0 : GC;
          const int gpp = gp16(gc), ldeg = gpp + 8;
          const size_t grow0 = (size_t)idx_s[j] * F.gpt + c0;
          __syncthreads();  // the previous chunk's group tiles are consumed
          {
            const int cpr = F.gk / 8;
            for (int i = tid; i < gpp * cpr; i += THREADS) {
              const int r = i / cpr, c = (i % cpr) * 8;
              int4 v = make_int4(0, 0, 0, 0);
              if (r < gc) v = *reinterpret_cast<const int4*>(F.g + (grow0 + r) * F.gw + c);
              *reinterpret_cast<int4*>(gt + r * ldgt + c) = v;
            }
          }
          for (int i = tid; i < gpp * (DVS / 8); i += THREADS) {
            const int r = i / (DVS / 8), c = (i % (DVS / 8)) * 8;
            int4 v = make_int4(0, 0, 0, 0);
            if (r < gc && col0 + c < P.Dv)
              v = *reinterpret_cast<const int4*>(F.vw + (grow0 + r) * F.W + col0 + c);
            *reinterpret_cast<int4*>(vgt + r * LDV + c) = v;
          }
          if (lead && tid < gpp)
            cnt[tid] = tid < gc ? __bfloat162float(F.vw[(grow0 + tid) * F.W + P.Dv]) : 0.f;
          __syncthreads();
          // e = bf16(exp2(min(q_f . g_f, 86))) [64 x gpp], zero past gpt
          for (int tt = warp; tt < 4 * (gpp / 8); tt += THREADS / 32) {
            const int mt = tt & 3, nt = tt >> 2;
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            for (int kk = 0; kk < F.gk; kk += 16) {
              uint32_t a[4], b0, b1;
              load_a(a, qs, ldqs, mt * 16, F.qg + kk, g, t);
              load_bt(b0, b1, gt, ldgt, nt * 8, kk, g, t);
              mma_bf16(c, a, b0, b1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mt * 16 + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
              egb[r * ldeg + col] =
                  __float2bfloat16_rn(col < gc ? exp2f(fminf(c[e], CLAMP2)) : 0.f);
            }
          }
          __syncthreads();
          if (lead && tid < BM) {  // the count column: d_f's approximation
            float sacc = 0.f;
            for (int c = 0; c < gc; ++c) sacc += __bfloat162float(egb[tid * ldeg + c]) * cnt[c];
            dcorr[f] += sacc;
          }
          // acc_f[64 x this warp's 32 columns] -= E[64 x gpp] @ VG[gpp x ...]
          // (the B fragments reloaded per m16 tile: registers go to acc)
          const int nks = gpp / 16;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float c[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
            for (int k = 0; k < nks; ++k) {
              uint32_t a[4], b[2][4];
              load_a(a, egb, ldeg, mt * 16, k * 16, g, t);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                load_b_pair(b[h], vgt, LDV, k * 16, warp * 32 + h * 16, lane);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(c[nt], a, b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[f][mt][nt][e] -= c[nt][e];
          }
        }
      }
    }
    cp_async_wait<0>();  // nothing in flight

    // this slice's columns of every output family (zeros past NF)
    for (int f = 0; f < P.nfo; ++f)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const size_t row = (size_t)(q0 + mt * 16 + g + 8 * half) * P.out_w + f * P.Dv;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int c = col0 + warp * 32 + nt * 8 + 2 * t;
            if (c >= P.Dv) continue;
            float2 v = make_float2(0.f, 0.f);
#pragma unroll
            for (int fi = 0; fi < NF; ++fi)
              if (fi == f) v = make_float2(acc[fi][mt][nt][2 * half], acc[fi][mt][nt][2 * half + 1]);
            *reinterpret_cast<float2*>(P.out + row + c) = v;
          }
        }

    if (!lead) return;
    // d: the 4 lanes of a row share g; the two warps of an m16 tile split
    // its columns
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          dsum[f][h] += __shfl_xor_sync(0xffffffffu, dsum[f][h], off);
        if (t == 0) dpart[(2 * f + (warp & 1)) * BM + (warp >> 1) * 16 + g + 8 * h] = dsum[f][h];
      }
    if (tid < BM)
#pragma unroll
      for (int f = 0; f < NF; ++f) dgc[f * BM + tid] = dcorr[f];
    __syncthreads();
    const int od = P.nfo * P.Dv;
    for (int i = tid; i < BM * 128; i += THREADS) {
      const int r = i / 128, c = i % 128;
      float v = 0.f;
      if (c < NF) v = dpart[2 * c * BM + r] + dpart[(2 * c + 1) * BM + r] - dgc[c * BM + r];
      P.out[(size_t)(q0 + r) * P.out_w + od + c] = v;
    }
  }
  if constexpr (ALR) {
    __syncthreads();  // phase B reuses phase A's shared memory

    // ---------------------------------------------------------- phase B
    // (the lead slice only) alr += bf16(exp2(min(q_0 . g_0, 86))) @ vw_0
    const Fam& F = P.f[0];
    bf* gst = reinterpret_cast<bf*>(base + lay.gst);
    bf* vst = reinterpret_cast<bf*>(base + lay.vst);
    bf* esb = reinterpret_cast<bf*>(base + lay.es);
    const int lds = F.gk + 8, ldw = F.W + 8;
    const int ntw = F.W / 64, col_a = warp * ntw * 8;

    float acc[4][MAX_NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int j = 0; j < K; ++j)
    for (int c0 = 0; c0 < (CHUNKED ? F.gpt : 1); c0 += GC) {  // chunks of GC groups
      const int gc = !CHUNKED ? F.gpt : F.gpt - c0 < GC ? F.gpt - c0 : GC;
      const int gpp = gp16(gc), lde = gpp + 8;
      const int nks = gpp / 16;
      __syncthreads();  // the previous chunk is fully consumed
      const size_t grow0 = (size_t)idx_s[j] * F.gpt + c0;
      {  // the chunk's groups; rows past them are zeros (a k16 step)
        const int cpr = F.gk / 8;
        for (int i = tid; i < gpp * cpr; i += THREADS) {
          const int r = i / cpr, c = (i % cpr) * 8;
          const bool ok = r < gc;
          cp_async16(gst + r * lds + c, F.g + (ok ? (grow0 + r) * F.gw + c : 0), ok);
        }
        const int cpv = F.W / 8;
        for (int i = tid; i < gpp * cpv; i += THREADS) {
          const int r = i / cpv, c = (i % cpv) * 8;
          const bool ok = r < gc;
          cp_async16(vst + r * ldw + c, F.vw + (ok ? (grow0 + r) * F.W + c : 0), ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();

      for (int tt = warp; tt < 4 * (gpp / 8); tt += THREADS / 32) {
        const int mt = tt & 3, nt = tt >> 2;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < F.gk; kk += 16) {
          uint32_t a[4], b0, b1;
          load_a(a, qs, ldqs, mt * 16, F.qg + kk, g, t);
          load_bt(b0, b1, gst, lds, nt * 8, kk, g, t);
          mma_bf16(c, a, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
          esb[r * lde + col] = __float2bfloat16_rn(col < gc ? exp2f(fminf(c[e], CLAMP2)) : 0.f);
        }
      }
      __syncthreads();

      // alr[64 x this warp's columns] += ES[64 x gpp] @ VW[gpp x ...]
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

    const int oa = P.nfo * P.Dv + 128;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (nt >= ntw) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = q0 + mt * 16 + g + 8 * half;
          *reinterpret_cast<float2*>(P.out + (size_t)q * P.out_w + oa + col_a + nt * 8 + 2 * t) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
  }
}

template <int NF, bool I8, bool ALR, bool CHUNKED>
int launch(const Params& P, int Bp, cudaStream_t stream) {
  const Layout lay = layout(P, NF, ALR, I8);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hier_parts_kernel<NF, I8, ALR, CHUNKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bp / BM, (P.Dv + DVS - 1) / DVS);
  hier_parts_kernel<NF, I8, ALR, CHUNKED><<<grid, THREADS, lay.total, stream>>>(P, lay);
  return (int)cudaGetLastError();
}

template <int NF, bool CHUNKED>
int dispatch_as(const Params& P, int Bp, bool i8, bool alr, cudaStream_t s) {
  if (i8)
    return alr ? launch<NF, true, true, CHUNKED>(P, Bp, s)
               : launch<NF, true, false, CHUNKED>(P, Bp, s);
  return alr ? launch<NF, false, true, CHUNKED>(P, Bp, s)
             : launch<NF, false, false, CHUNKED>(P, Bp, s);
}

// More than GC groups a tile in any family: the chunked instances
template <int NF>
int dispatch(const Params& P, int Bp, bool i8, bool alr, cudaStream_t s) {
  bool chunked = false;
  for (int f = 0; f < NF; ++f) chunked = chunked || P.f[f].gpt > GC;
  return chunked ? dispatch_as<NF, true>(P, Bp, i8, alr, s)
                 : dispatch_as<NF, false>(P, Bp, i8, alr, s);
}

// A family's shapes: an lr family's W is a multiple of 128 up to 512, a
// plain family's holds the count in column Dv; any groups a tile (walked
// 64 at a time).
bool fam_ok(const Fam& F, int Dv, int bn, bool lr) {
  return F.gpt >= 1 && bn % F.gpt == 0 && F.gk % 16 == 0 &&
         F.gk >= 16 && F.gk <= F.gw && F.gw % 8 == 0 && F.kf % 16 == 0 &&
         (lr ? (F.W % 128 == 0 && F.W <= 64 * MAX_NT) : (F.W >= Dv + 1 && F.W % 8 == 0));
}

}  // namespace

// The merged launch.  q_cat [Bp, cat_d], k_cat [N, cat_d] bf16 packed (the
// row logits contract columns [0, sem_d) and [sem_d, sem_d + 16)); values
// [N, Dv] bf16, or int8 codes with scale [N] f32 (i8); mask_neg [N] f32;
// idx [Bp / bm, K] int32 (tiles < N / bn); g_sem [Gs, sem_d] and g_geo
// [Gg, gw_g] bf16 slim group centroids (the geo ones contract the query
// columns [cat_d - gw_g, + 16), which must be sem_d); vw_sem [Gs, Ws] bf16:
// lr = 1 the low-rank sem group coefficients (Ws a multiple of 128, <= 512),
// lr = 0 the sem group value sums with the count in column Dv; vw_geo
// [Gg, Wg] bf16 geo group value sums with the count in column Dv; out
// [Bp, 2 Dv + 128 (+ Ws with lr)] f32.  geo = 0 skips the geo family (its
// columns are written as zeros).  All contiguous and 16-byte aligned.
extern "C" int hier_parts_launch(const void* q_cat, const void* k_cat, const void* values,
                                 const void* scale, const void* mask_neg, const void* idx,
                                 const void* g_sem, const void* g_geo, const void* vw_sem,
                                 const void* vw_geo, void* out, int Bp, int cat_d, int sem_d,
                                 int Dv, int bm, int bn, int gpt_s, int gpt_g, int K, int Ws,
                                 int Wg, int gw_g, int geo, int lr, int i8, void* stream) {
  if (Bp <= 0 || K <= 0) return 0;
  using bf = __nv_bfloat16;
  Params P{static_cast<const bf*>(q_cat), static_cast<const bf*>(k_cat), values,
           static_cast<const float*>(scale), static_cast<const float*>(mask_neg),
           static_cast<const int*>(idx),
           {Fam{static_cast<const bf*>(g_sem), static_cast<const bf*>(vw_sem), 0, sem_d, 0, sem_d,
                sem_d, Ws, gpt_s},
            Fam{static_cast<const bf*>(g_geo), static_cast<const bf*>(vw_geo), sem_d, GEO_D,
                cat_d - gw_g, GEO_D, gw_g, Wg, gpt_g}},
           static_cast<float*>(out), cat_d, 0, sem_d + (geo ? GEO_D : 0), Dv, bm, bn, K, 2,
           2 * Dv + 128 + (lr ? Ws : 0), cat_d, 0, 0, 0};
  if (bm % BM || Bp % bm || bn % BN || sem_d % 16 || sem_d + GEO_D > cat_d || cat_d % 8 ||
      Dv % 16 || !fam_ok(P.f[0], Dv, bn, lr) ||
      (geo && (!fam_ok(P.f[1], Dv, bn, false) || cat_d - gw_g != sem_d)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return geo ? dispatch<2>(P, Bp, i8, lr, s) : dispatch<1>(P, Bp, i8, lr, s);
}

// The family-split value variants (no rr): one family, geo = 0 the sem
// family (row logits over [0, sem_d), group logits the query's first gw
// columns against g_cat [G, gw], gw == sem_d), geo = 1 the geo family
// (both over [sem_d, sem_d + 16); cat_d - gw == sem_d).  Operands as
// hier_parts_launch, q_cat [Bp, qw]: qw = cat_d, or in the sel form (sem
// family) qw = cat_d + gw, the group logits then reading the query's last
// gw columns against the sketched centroids g_cat [G, gw].  g_vw [G, W]
// bf16: lr = 1 the family's low-rank coefficients (W a multiple of 128,
// <= 512), lr = 0 its group value sums with the count in column Dv.
// dedup = 1 skips an idx entry equal to the one before it in its row.
// out [Bp, Dv + 128 (+ W with lr)] f32: acc | d | 0 (127) [| alr].
extern "C" int hier_parts_family_values_launch(
    const void* q_cat, const void* k_cat, const void* values, const void* scale,
    const void* mask_neg, const void* idx, const void* g_cat, const void* g_vw, void* out, int Bp,
    int qw, int cat_d, int sem_d, int Dv, int bm, int bn, int gpt, int K, int W, int gw, int geo,
    int lr, int i8, int sel, int dedup, void* stream) {
  if (Bp <= 0 || K <= 0) return 0;
  using bf = __nv_bfloat16;
  const Fam F = geo ? Fam{static_cast<const bf*>(g_cat), static_cast<const bf*>(g_vw), 0, GEO_D,
                          cat_d - gw - sem_d, GEO_D, gw, W, gpt}
                    : Fam{static_cast<const bf*>(g_cat), static_cast<const bf*>(g_vw), 0, sem_d,
                          sel ? sem_d : 0, sel ? gw : sem_d, gw, W, gpt};
  const Params P{static_cast<const bf*>(q_cat), static_cast<const bf*>(k_cat), values,
                 static_cast<const float*>(scale), static_cast<const float*>(mask_neg),
                 static_cast<const int*>(idx), {F, F}, static_cast<float*>(out), cat_d,
                 geo ? sem_d : 0, geo ? GEO_D : sem_d, Dv, bm, bn, K, 1,
                 Dv + 128 + (lr ? W : 0), qw, cat_d, sel ? gw : 0, dedup};
  if (bm % BM || Bp % bm || bn % BN || sem_d % 16 || sem_d + GEO_D > cat_d || cat_d % 8 ||
      Dv % 16 || !fam_ok(F, Dv, bn, lr) ||
      (sel ? geo || qw != cat_d + gw || gw % 16 : qw != cat_d) ||
      (geo ? cat_d - gw != sem_d : !sel && gw != sem_d))
    return (int)cudaErrorInvalidValue;
  return dispatch<1>(P, Bp, i8, lr, static_cast<cudaStream_t>(stream));
}

// Hierarchical retrieval, stage 2: exact minus group approximation of ONE
// family over each query block's selected bank tiles, the residual-rank
// shapes (rr, with or without lr), which stream no values.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_parts_family_kernel`
// with rr on (reached via _hier_parts_family_call <- _hier_partials
// <- retrieve_hier); its value variants (no rr) are `hier_parts.cu`.  For
// each query and each of the K tiles selected for its block of bm queries
// (idx[block, j]):
//   p   = exp2(min(q . k + mask, 86))       over the tile's bn rows
//   e   = exp2(min(q . g, 86))              over the tile's gpt groups
//   ps  = per-group sums of bf16(p), in f32
//   D   = bf16(e - ps / max(cnt, 1))        (cnt = column lrr of vw)
//   az  += bf16(p) @ z
// rr + lr (vw the low-rank coefficients): alr += D @ vw.
//   Out [Bp, rrp + 128 + W] f32: az | d (0: the count rides alr) | 0 pad | alr.
// rr only (vw the full-width group value sums, count in column Dv = lrr):
//   [acc | d] -= D @ vw, which is the TPU kernel's (ps/cnt - e) @ vw:
//   bf16 rounds to nearest symmetrically, so bf16(ps/cnt - e) = -D exactly.
//   Out [Bp, Dv + 128 + rrp] f32: acc | d | 0 pad (127) | az.
// Two forms of either shape: sel (sel_lr banks, the sem family) reads its
// group logits from the query operand's last gw columns, the rank-k sketch
// appended past cat_d (`:2341-2346`): the query operand is wider than the
// keys and has its own row stride.  dedup_pad (lists merged by
// _dedup_union) skips a list entry equal to the one before it, the
// union's repeat padding (`:2319-2324, 2402-2406`): running it twice would
// double its (exact - approx) term.
//
// What bounds it on an H100: the row logits and the az product, 2 x bn x
// (kf + rrp) flops per (query, tile): at the flagship shape (B = 10,112,
// K = 32 sem tiles of 512 rows, kf = 256, rrp = 128) ~127 GFLOP for the
// sem family and ~42 GFLOP for the geo family (k_geo = 16, kf = 128), on
// the tensor cores; the exponentials (one per query x row) come next.
// The bytes are the selected key and z rows, re-read by every query block
// that selects the tile (from L2 when neighbouring blocks share tiles).
//
// Design: one block owns 64 queries (a quarter or half of a selection
// block, which it finds as q0 / bm) and reads its own tile list from idx
// (Hopper has no scalar prefetch); the TPU's sequential tile axis becomes
// a loop.  In the dedup_pad form the block drops the repeats from its
// copy of the list first (one thread, K <= a few hundred), so a skipped
// entry costs neither its logits nor its fetch.  Phase A walks the tiles 32 rows at a time with the next rows
// streaming in by cp.async: logits on mma.sync bf16 tensor cores, p from
// the fragments into a bf16 tile, the per-group sums of that bf16 tile
// reduced with warp shuffles, az in registers.  The group sums of each
// tile go to a global scratch [Bp, K, gpt] the block alone uses.  Phase B
// walks the tiles again over their groups only: the group logits, the
// bf16 difference D, and D @ vw in registers (up to 128 per thread, which
// is why it is not carried through phase A beside az).  A vw wider than
// 512 columns (rr only: Dv + 128 = 1,152 at Dv = 1,024) takes phase B in
// passes of at most 512 columns (three of 384), each walking the tiles
// again and recomputing D: a tile's group work, 64 x gpt x (gw + 384), is
// small beside its phase A work, 64 x bn x (kf + rrp).

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 32;        // bank rows per step
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_NT = 8;     // phase B n8 tiles per warp: a pass <= 512 columns
constexpr int MAX_NZ = 4;     // az n8 tiles per warp: rrp <= 256
constexpr int LDP = BN + 8;   // bf16 row stride of the p tile

struct Params {
  const __nv_bfloat16* q;     // [Bp, qw]
  const __nv_bfloat16* k;     // [N, cat_d]
  const float* mask;          // [N]
  const int* idx;             // [nB, K]
  const __nv_bfloat16* gcat;  // [G, gw]
  const __nv_bfloat16* vw;    // [G, W]
  const __nv_bfloat16* z;     // [N, rrp]
  float* ps;                  // [Bp, K, gpt] scratch
  float* out;                 // [Bp, out_w]
  int Bp, qw, cat_d, kc0, kf, qg0, gw, bm, bn, gpt, K, W, lrr, rrp;
  int out_w, zoff;            // row width of out, its az columns [zoff, + rrp)
  int zlo, zn;                // the zero columns [zlo, zlo + zn) (d and pad, or pad)
  int boff, bcols;            // phase B: vw column c -> out column boff + c, c < bcols
  float bsign;                // +1 (alr) or -1 ([acc | d] -= D @ vw)
  int n_pass, pw;             // phase B passes, columns a pass
  int dedup;                  // skip an entry equal to the one before it
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t qa, ks, zs, ms, pb, pss;  // phase A
  size_t qg, gt, vt, eb, cs;       // phase B (overlays phase A)
  size_t total;
  int gp16;                        // gpt rounded up to one k16 step
};

// W: the columns of one phase B pass
__host__ __device__ inline Layout layout(int K, int kf, int rrp, int gpt, int gw, int W) {
  Layout l;
  l.gp16 = (gpt + 15) / 16 * 16;
  const size_t base = up16((size_t)K * 4);
  l.qa = base;
  l.ks = l.qa + (size_t)BM * (kf + 8) * 2;
  l.zs = l.ks + (size_t)2 * BN * (kf + 8) * 2;
  l.ms = l.zs + (size_t)2 * BN * (rrp + 8) * 2;
  l.pb = l.ms + (size_t)2 * BN * 4;
  l.pss = l.pb + (size_t)BM * LDP * 2;
  const size_t end_a = l.pss + (size_t)BM * gpt * 4;
  l.qg = base;
  l.gt = l.qg + (size_t)BM * (gw + 8) * 2;
  l.vt = l.gt + (size_t)l.gp16 * (gw + 8) * 2;
  l.eb = l.vt + (size_t)l.gp16 * (W + 8) * 2;
  l.cs = l.eb + up16((size_t)BM * (l.gp16 + 8) * 2);
  const size_t end_b = l.cs + (size_t)l.gp16 * 4;
  l.total = end_a > end_b ? end_a : end_b;
  return l;
}

__global__ void __launch_bounds__(THREADS, 1)
hier_parts_family_kernel(const Params P, const Layout lay) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int* idx_s = reinterpret_cast<int*>(base);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int blk = q0 / P.bm;
  const int out_w = P.out_w;
  const int gsz = P.bn / P.gpt;

  __shared__ int k_run;  // the list's length after the dedup_pad skip
  for (int j = tid; j < P.K; j += THREADS) idx_s[j] = P.idx[(size_t)blk * P.K + j];
  __syncthreads();
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

  // ------------------------------------------------------------ phase A
  {
    __nv_bfloat16* qa = reinterpret_cast<__nv_bfloat16*>(base + lay.qa);
    __nv_bfloat16* ks0 = reinterpret_cast<__nv_bfloat16*>(base + lay.ks);
    __nv_bfloat16* zs0 = reinterpret_cast<__nv_bfloat16*>(base + lay.zs);
    float* ms0 = reinterpret_cast<float*>(base + lay.ms);
    __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(base + lay.pb);
    float* pss = reinterpret_cast<float*>(base + lay.pss);
    const int ldk = P.kf + 8, ldz = P.rrp + 8;
    const int spt = P.bn / BN;  // steps per tile
    const int n_steps = K * spt;
    const int ntz = P.rrp / 64;
    const int col_z = warp * ntz * 8;

    auto prefetch = [&](int buf, int it) {
      const int row0 = idx_s[it / spt] * P.bn + (it % spt) * BN;
      __nv_bfloat16* ks = ks0 + buf * BN * ldk;
      const int cpr = P.kf / 8;
      for (int i = tid; i < BN * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 8;
        cp_async16(ks + r * ldk + c, P.k + (size_t)(row0 + r) * P.cat_d + P.kc0 + c, true);
      }
      __nv_bfloat16* zs = zs0 + buf * BN * ldz;
      const int cpz = P.rrp / 8;
      for (int i = tid; i < BN * cpz; i += THREADS) {
        const int r = i / cpz, c = (i % cpz) * 8;
        cp_async16(zs + r * ldz + c, P.z + (size_t)(row0 + r) * P.rrp + c, true);
      }
      if (tid < BN) cp_async4(ms0 + buf * BN + tid, P.mask + row0 + tid, true);
      cp_async_commit();
    };

    {
      const int cpr = P.kf / 8;
      for (int i = tid; i < BM * cpr; i += THREADS) {
        const int r = i / cpr, c = (i % cpr) * 8;
        const bool ok = q0 + r < P.Bp;
        cp_async16(qa + r * ldk + c, P.q + (ok ? (size_t)(q0 + r) * P.qw + P.kc0 + c : 0), ok);
      }
      cp_async_commit();
    }
    prefetch(0, 0);

    float acc[4][MAX_NZ][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_NZ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int sr = tid >> 2, sc = tid & 3;  // segment-sum ownership
    const int seg = gsz < BN ? gsz : BN;

    for (int it = 0; it < n_steps; ++it) {
      __syncthreads();  // the previous step is fully consumed
      const int buf = it & 1;
      if (it + 1 < n_steps) {
        prefetch(buf ^ 1, it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int j = it / spt, s = it % spt;
      const __nv_bfloat16* ks = ks0 + buf * BN * ldk;
      const __nv_bfloat16* zs = zs0 + buf * BN * ldz;
      const float* ms = ms0 + buf * BN;

      {  // row logits -> p = exp2(min(l + mask, 86)) -> bf16 tile
        const int mt = warp >> 1, nt0 = (warp & 1) * 2;
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < P.kf; kk += 16) {
          uint32_t a[4];
          load_a(a, qa, ldk, mt * 16, kk, g, t);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t b0, b1;
            load_bt(b0, b1, ks, ldk, (nt0 + i) * 8, kk, g, t);
            mma_bf16(c[i], a, b0, b1);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + g + 8 * h, col = (nt0 + i) * 8 + 2 * t;
            const float p0 = exp2f(fminf(c[i][2 * h] + ms[col], CLAMP2));
            const float p1 = exp2f(fminf(c[i][2 * h + 1] + ms[col + 1], CLAMP2));
            *reinterpret_cast<__nv_bfloat162*>(pb + r * LDP + col) =
                __floats2bfloat162_rn(p0, p1);
          }
      }
      __syncthreads();  // p tile complete

      {  // per-group sums of bf16(p) in f32
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) v += __bfloat162float(pb[sr * LDP + sc * 8 + k]);
        if (seg >= 16) v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (seg >= 32) v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int r0 = s * BN + sc * 8;  // first tile row of this thread
        if (sc % (seg / 8) == 0) {
          float* dst = pss + sr * P.gpt + r0 / gsz;
          *dst = r0 % gsz == 0 ? v : *dst + v;  // a group's first step assigns
        }
      }

      // az[64 x this warp's columns] += P[64 x 32] @ Z[32 x ...]
#pragma unroll
      for (int h = 0; h < MAX_NZ / 2; ++h) {
        if (2 * h < ntz) {
          uint32_t b[2][4];
          load_b_pair(b[0], zs, ldz, 0, col_z + h * 16, lane);
          load_b_pair(b[1], zs, ldz, 16, col_z + h * 16, lane);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            uint32_t a0[4], a1[4];
            load_a(a0, pb, LDP, mt * 16, 0, g, t);
            load_a(a1, pb, LDP, mt * 16, 16, g, t);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, a0, b[0][2 * jj], b[0][2 * jj + 1]);
              mma_bf16(c, a1, b[1][2 * jj], b[1][2 * jj + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][2 * h + jj][e] += c[e];
            }
          }
        }
      }
      if (s == spt - 1) {  // the tile's group sums -> scratch
        __syncthreads();
        for (int i = tid; i < BM * P.gpt; i += THREADS) {
          const int r = i / P.gpt, c = i % P.gpt;
          if (q0 + r < P.Bp) P.ps[((size_t)(q0 + r) * P.K + j) * P.gpt + c] = pss[i];
        }
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_NZ; ++nt) {
        if (nt >= ntz) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = q0 + mt * 16 + g + 8 * half;
          if (q >= P.Bp) continue;
          *reinterpret_cast<float2*>(P.out + (size_t)q * out_w + P.zoff + col_z + nt * 8 +
                                     2 * t) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    for (int i = tid; i < BM * P.zn; i += THREADS) {  // d (0) and the pad, or the pad
      const int r = i / P.zn, q = q0 + r;
      if (q < P.Bp) P.out[(size_t)q * out_w + P.zlo + i % P.zn] = 0.f;
    }
  }
  __syncthreads();  // phase B reuses phase A's shared memory

  // ------------------------------------------------------------ phase B
  __nv_bfloat16* qg = reinterpret_cast<__nv_bfloat16*>(base + lay.qg);
  __nv_bfloat16* gt = reinterpret_cast<__nv_bfloat16*>(base + lay.gt);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(base + lay.vt);
  __nv_bfloat16* eb = reinterpret_cast<__nv_bfloat16*>(base + lay.eb);
  float* cnt_s = reinterpret_cast<float*>(base + lay.cs);  // the tile's group counts
  const int ldg = P.gw + 8, ldv = P.pw + 8, gp16 = lay.gp16, lde = gp16 + 8;
  const int nks = gp16 / 16;
  {
    const int cpr = P.gw / 8;
    for (int i = tid; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const bool ok = q0 + r < P.Bp;
      cp_async16(qg + r * ldg + c, P.q + (ok ? (size_t)(q0 + r) * P.qw + P.qg0 + c : 0), ok);
    }
    cp_async_commit();
  }
  for (int i = tid; i < BM * lde; i += THREADS) eb[i] = __float2bfloat16_rn(0.f);

  for (int pass = 0; pass < P.n_pass; ++pass) {
    const int c_lo = pass * P.pw;  // this pass's vw columns [c_lo, c_lo + cols)
    const int cols = P.W - c_lo < P.pw ? P.W - c_lo : P.pw;
    const int ntw = cols / 64;
    const int col_a = warp * ntw * 8;
    float acc[4][MAX_NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int j = 0; j < K; ++j) {
      __syncthreads();  // the previous tile is fully consumed
      const size_t grow0 = (size_t)idx_s[j] * P.gpt;
      {
        const int cpr = P.gw / 8;
        for (int i = tid; i < P.gpt * cpr; i += THREADS) {
          const int r = i / cpr, c = (i % cpr) * 8;
          cp_async16(gt + r * ldg + c, P.gcat + (grow0 + r) * P.gw + c, true);
        }
        const int cpv = cols / 8;
        for (int i = tid; i < gp16 * cpv; i += THREADS) {
          const int r = i / cpv, c = (i % cpv) * 8;
          const bool ok = r < P.gpt;  // rows past gpt: zeros (a k16 step)
          cp_async16(vt + r * ldv + c, P.vw + (ok ? (grow0 + r) * P.W + c_lo + c : 0), ok);
        }
        if (tid < gp16)
          cnt_s[tid] = tid < P.gpt ? __bfloat162float(P.vw[(grow0 + tid) * P.W + P.lrr]) : 1.f;
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();

      // group logits e [64 x gpt] -> bf16(e - ps / max(cnt, 1))
      const int n_nt = P.gpt / 8;
      for (int tt = warp; tt < 4 * n_nt; tt += THREADS / 32) {
        const int mt = tt & 3, nt = tt >> 2;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < P.gw; kk += 16) {
          uint32_t a[4], b0, b1;
          load_a(a, qg, ldg, mt * 16, kk, g, t);
          load_bt(b0, b1, gt, ldg, nt * 8, kk, g, t);
          mma_bf16(c, a, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
          const int q = q0 + r;
          const float ps = q < P.Bp ? P.ps[((size_t)q * P.K + j) * P.gpt + col] : 0.f;
          const float cnt = cnt_s[col];
          const float ev = exp2f(fminf(c[e], CLAMP2));
          eb[r * lde + col] = __float2bfloat16_rn(ev - ps / fmaxf(cnt, 1.f));
        }
      }
      __syncthreads();

      // alr[64 x this warp's columns] += D[64 x gp16] @ VW[gp16 x ...]
#pragma unroll
      for (int h = 0; h < MAX_NT / 2; ++h) {
        if (2 * h < ntw) {
          uint32_t b[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < nks) load_b_pair(b[k], vt, ldv, k * 16, col_a + h * 16, lane);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k < nks) {
                uint32_t a[4];
                load_a(a, eb, lde, mt * 16, k * 16, g, t);
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
          const int c = c_lo + col_a + nt * 8 + 2 * t;  // vw columns c, c + 1
          if (q >= P.Bp) continue;
          float* dst = P.out + (size_t)q * out_w + P.boff + c;
          if (c + 1 < P.bcols) {
            *reinterpret_cast<float2*>(dst) = make_float2(P.bsign * acc[mt][nt][2 * half],
                                                          P.bsign * acc[mt][nt][2 * half + 1]);
          } else if (c < P.bcols) {
            *dst = P.bsign * acc[mt][nt][2 * half];
          }
        }
      }
  }
}

}  // namespace

// q_cat [Bp, qw] (qw = cat_d, or cat_d + gw in the sel form), k_cat [N,
// cat_d] bf16: the row logits contract columns [kc0, kc0 + kf), the group
// logits the query columns [qg0, qg0 + gw) against g_cat [G, gw].  mask_neg [N] f32, idx [Bp / bm, K] int32
// (tiles < N / bn), g_vw [G, W] bf16 with the count in column lrr, z
// [N, rrp] bf16, scratch [Bp, K, gpt] f32.  lr = 1: g_vw holds low-rank
// coefficients (W <= 512), out [Bp, rrp + 128 + W] f32.  lr = 0: g_vw holds
// the group value sums (W a multiple of 128, any width), lrr = Dv, out
// [Bp, Dv + 128 + rrp] f32.  dedup = 1 skips an idx entry equal to the one
// before it in its row.  All contiguous and 16-byte aligned.
extern "C" int hier_parts_family_launch(const void* q_cat, const void* k_cat,
                                        const void* mask_neg, const void* idx,
                                        const void* g_cat, const void* g_vw, const void* z,
                                        void* scratch, void* out, int Bp, int qw, int cat_d,
                                        int kc0, int kf, int qg0, int gw, int bm, int bn, int gpt,
                                        int K, int W, int lrr, int rrp, int N, int lr, int dedup,
                                        void* stream) {
  if (Bp <= 0 || K <= 0) return 0;
  const int gsz = gpt > 0 ? bn / gpt : 0;
  if (bm % BM || Bp % bm || bn % BN || gsz * gpt != bn || gsz % 8 ||
      (gsz <= BN ? BN % gsz : gsz % BN) || gpt % 8 || kf % 16 || gw % 16 || kc0 % 8 ||
      qg0 % 8 || kc0 + kf > cat_d || qg0 + gw > qw || qw < cat_d || qw % 8 || cat_d % 8 ||
      W <= 0 || W % 128 ||
      (lr && W > 64 * MAX_NT) || rrp % 128 || rrp > 64 * MAX_NZ || lrr < 0 || lrr >= W ||
      (!lr && lrr % 2) || N % bn)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  Params P{static_cast<const bf*>(q_cat), static_cast<const bf*>(k_cat),
                 static_cast<const float*>(mask_neg), static_cast<const int*>(idx),
                 static_cast<const bf*>(g_cat), static_cast<const bf*>(g_vw),
                 static_cast<const bf*>(z), static_cast<float*>(scratch),
                 static_cast<float*>(out), Bp, qw, cat_d, kc0, kf, qg0, gw, bm, bn, gpt, K, W,
                 lrr, rrp,
                 // lr: az | d, pad | alr;  rr only: acc, d | pad | az
                 lr ? rrp + 128 + W : lrr + 128 + rrp, lr ? 0 : lrr + 128, lr ? rrp : lrr + 1,
                 lr ? 128 : 127, lr ? rrp + 128 : 0, lr ? W : lrr + 1, lr ? 1.f : -1.f, 0, 0,
                 dedup};
  {  // ceil(W / 512) phase B passes of equal width, a multiple of 64
    const int cap = 64 * MAX_NT;
    P.n_pass = (W + cap - 1) / cap;
    P.pw = ((W + P.n_pass - 1) / P.n_pass + 63) / 64 * 64;
  }
  const Layout lay = layout(K, kf, rrp, gpt, gw, P.pw);
  if (lay.total > MAX_SMEM || lay.gp16 > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_parts_family_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  hier_parts_family_kernel<<<Bp / BM, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      P, lay);
  return (int)cudaGetLastError();
}

// Hierarchical retrieval: the weighted-supergroup sem tail correction.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_corr_kernel` (reached
// via _hier_corr_call <- _hier_partials <- retrieve_hier on banks built
// with tail_super).  The scan's sem tail on such banks uses one mean value
// row per supergroup; over the K + m_corr tiles each query block selected,
// this kernel adds back the difference to the fine-group tail:
//   out = sum over the listed tiles of bf16(exp2(min(q[:, :gw] . g, 86))) @ dvw
// with g the tile's gpt fine group centroids (g_sem_cat) and dvw[g] = vw[g]
// - ts_vw[sup(g)] (g_sem_ts_dvw; its count column is 0 where a
// supergroup's groups are full), summed in f32.  Out:
// [Bp, W] f32, added to the scan's sem tail by the caller.
//
// What bounds it on an H100: the two products.  At the flagship shape
// (B = 10,000 at bm = 128, 64 listed tiles of 32 groups, 256 key columns,
// W = 384 with 257 nonzero) that is ~27 GFLOP on the tensor cores
// (~0.027 ms at the bf16 peak) against ~16 MB of f32 output and the union
// of the listed tiles' centroids and dvw rows read once: operations.
//
// Design: the fused scan's block (hier_scan.cu) over a gathered list.  A
// block owns 64 queries (inside one selection block of bm queries, whose
// idx row it reads) and walks that row's M tiles 32 list positions at a
// time (at gpt = 32: one tile a step; step rows are the list's flat
// positions p, tile idx[p / gpt], group p % gpt), the next step's centroid
// and dvw rows streaming in by cp.async while this one computes.  The
// logits run on mma.sync bf16 tensor cores into a shared f32 tile; each
// thread turns 8 of them into bf16 exp2 weights; the product with the dvw
// rows accumulates in registers (warp w owns W / 8 columns of all 64
// queries), each step summed in a fresh fragment and added with f32 adds
// (a long chain through one tensor-core accumulator drifts).  A ragged
// end reads zero centroid and dvw rows, which add nothing.  Nothing
// carries between blocks: the TPU's per-block scratch accumulator becomes
// the registers of the one block that owns the queries.  A dvw wider than
// 512 columns (banks without lr_rank: the full-width sums, Dv + 128) is cut
// into ceil(W / 512) column slices over grid.y, as the scan's wide tail
// (hier_scan.cu): each slice recomputes the logits and weights.

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 32;        // list positions (groups) per step
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_NT = 8;     // output n8 tiles per warp: a slice <= 8 warps x 64
constexpr int LDL = BN + 1;   // f32 row stride of the logit tile
constexpr int LDP = BN + 8;   // bf16 row stride of the weight tile

struct Layout {
  size_t q, g, v, lg, p, total;
};

// sw: the columns of one slice
__host__ __device__ inline Layout layout(int wk, int sw) {
  Layout l;
  l.q = 0;
  l.g = l.q + (size_t)BM * (wk + 8) * 2;
  l.v = l.g + (size_t)2 * BN * (wk + 8) * 2;
  l.lg = l.v + (size_t)2 * BN * (sw + 8) * 2;
  l.p = l.lg + (size_t)BM * LDL * 4;
  l.total = l.p + (size_t)BM * LDP * 2;
  return l;
}

__global__ void __launch_bounds__(THREADS, 1)
hier_corr_kernel(const __nv_bfloat16* __restrict__ q_cat, const int* __restrict__ idx,
                 const __nv_bfloat16* __restrict__ g_cat, const __nv_bfloat16* __restrict__ dvw,
                 float* __restrict__ out, int Bp, int cat_d, int wk, int W, int sw, int bm,
                 int M, int gpt, Layout lay) {
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
  const int* tiles = idx + (size_t)(q0 / bm) * M;  // this block's list
  const int p_end = M * gpt;
  const int n_steps = (p_end + BN - 1) / BN;
  const int col_lo = blockIdx.y * sw;  // this block's columns [col_lo, + cols)
  const int cols = W - col_lo < sw ? W - col_lo : sw;
  const int ldk = wk + 8, ldv = sw + 8;
  const int cpr = wk / 8, cpv = cols / 8;
  const int ntw = cols / 64;         // output n8 tiles of this warp
  const int col_w = warp * ntw * 8;  // first output column of this warp

  auto prefetch = [&](int buf, int it) {
    const int p0 = it * BN;
    __nv_bfloat16* gs = gs0 + buf * BN * ldk;
    __nv_bfloat16* vs = vs0 + buf * BN * ldv;
    for (int i = tid; i < BN * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int p = p0 + r;
      const bool ok = p < p_end;
      const size_t row = ok ? (size_t)tiles[p / gpt] * gpt + p % gpt : 0;
      cp_async16(gs + r * ldk + c, g_cat + row * wk + c, ok);
    }
    for (int i = tid; i < BN * cpv; i += THREADS) {
      const int r = i / cpv, c = (i % cpv) * 8;
      const int p = p0 + r;
      const bool ok = p < p_end;
      const size_t row = ok ? (size_t)tiles[p / gpt] * gpt + p % gpt : 0;
      cp_async16(vs + r * ldv + c, dvw + row * W + col_lo + c, ok);
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

  float acc[4][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int sr = tid >> 2, sc = tid & 3;  // weights: query sr, groups sc*8 ..

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

#pragma unroll
    for (int k = 0; k < 8; ++k)  // e = bf16(exp2(min(l, 86)))
      pb[sr * LDP + sc * 8 + k] =
          __float2bfloat16_rn(exp2f(fminf(lg[sr * LDL + sc * 8 + k], CLAMP2)));
    __syncthreads();  // weight tile complete

    // acc[64 x this warp's columns] += E[64 x 32] @ dvw[32 x ...], the step
    // in a fresh fragment
#pragma unroll
    for (int h = 0; h < MAX_NT / 2; ++h) {
      if (2 * h < ntw) {
        uint32_t b[2][4];
        load_b_pair(b[0], vs, ldv, 0, col_w + h * 16, lane);
        load_b_pair(b[1], vs, ldv, 16, col_w + h * 16, lane);
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
        if (q >= Bp) continue;
        const int col = col_lo + col_w + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)q * W + col) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

}  // namespace

// q_cat [Bp, cat_d] bf16 packed queries (the logits contract columns
// [0, gw)), idx [Bp / bm, M] int32 tiles, g_cat [G, gw] bf16 fine
// centroids, dvw [G, W] bf16 (W a multiple of 128; above 512 in column
// slices), gpt groups per tile.  Out: [Bp, W] f32.
// All contiguous and 16-byte aligned.
extern "C" int hier_corr_launch(const void* q_cat, const void* idx, const void* g_cat,
                                const void* dvw, void* out, int Bp, int cat_d, int gw, int W,
                                int bm, int M, int gpt, void* stream) {
  if (Bp <= 0) return 0;
  if (gw % 16 || gw > 256 || gw > cat_d || cat_d % 8 || W <= 0 || W % 128 || bm % BM ||
      Bp % bm || M <= 0 || gpt <= 0)
    return (int)cudaErrorInvalidValue;
  // ceil(W / 512) column slices of equal width, a multiple of 64
  const int n_sl = (W + 64 * MAX_NT - 1) / (64 * MAX_NT);
  const int sw = ((W + n_sl - 1) / n_sl + 63) / 64 * 64;
  const Layout lay = layout(gw, sw);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bp / BM, n_sl);
  hier_corr_kernel<<<grid, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q_cat), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(g_cat), static_cast<const __nv_bfloat16*>(dvw),
      static_cast<float*>(out), Bp, cat_d, gw, W, sw, bm, M, gpt, lay);
  return (int)cudaGetLastError();
}

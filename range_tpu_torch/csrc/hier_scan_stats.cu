// Hierarchical retrieval: the stats-only group scan (no tail).
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_scan_stats_kernel`
// (reached via _hier_scan_stats_call <- hier_topk, hier_nn and the
// sort="hybrid" pre-scan of retrieve_hier).  For every query and both
// families (sem, geo): the group logits l = q . g against every packed
// group centroid (log2 e and the temperatures are folded into the packed
// queries) and, per bank tile of gpt consecutive groups, the max logit m
// and the exp-mass s = sum exp2(min(l, 86)).  Nothing else: the top-k
// endpoint never needs the group value sums.
//
// What bounds it on an H100: the sem family's logits.  At the top-k
// endpoint's shape (B = 10,000; g_topk_cat: 196 real tiles x 64 groups x
// 256 columns) that is ~64 GFLOP on the tensor cores (~0.065 ms at the
// bf16 peak) against ~37 MB of f32 stats written (~0.011 ms): operations.
//
// Design: hier_scan.cu without its tail accumulator.  A block owns 64
// queries of ONE family and one chunk of ~1,024 of that family's groups
// (whole tiles; grid.y enumerates the sem chunks, then the geo chunks), and
// walks the chunk 32 groups at a time with the next group tile streaming in
// by cp.async.  The logits run on mma.sync bf16 tensor cores into a shared
// f32 tile, from which each thread takes 8 groups of one query: the per-tile
// max and exp2 sum, reduced with warp shuffles across the 4 threads of a
// query (tiles of 8, 16 or 32 groups end inside a step; longer tiles carry
// a running max / sum across steps).  Stats are written in [query, tile]
// order; the TPU's transposed write was its lane rule's, and is gone.
//
// Logit depth: any multiple of 16 columns whose query block and two group
// tiles fit a block's shared memory (up to 864: the `high` tier's 3 x 256
// hi/lo cross terms included; the k16 loop runs over the whole depth, one
// block an SM past ~380 columns).
//
// Block size: with no tail in registers (the scan's 128 accumulator
// registers a thread, which held it to one 8-warp block per SM), a block
// needs ~76 KB of shared memory and few registers, so two blocks share an
// SM.  The group chunks give the grid ~14 x more blocks than the query
// blocks alone (158 at B = 10,000), which would fill only part of 132 SMs
// x 2 and leave the geo blocks idle beside the 8x longer sem blocks.

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;             // queries per block
constexpr int BN = 32;             // groups per step
constexpr int THREADS = 256;       // 8 warps
constexpr int CHUNK_GROUPS = 1024; // groups per block, rounded to whole tiles
constexpr int LDL = BN + 1;        // f32 row stride of the logit tile

struct Family {
  const __nv_bfloat16* g;  // [G, wk] packed group centroids
  float* m;                // [Bp, t_pad] max group logit per tile
  float* s;                // [Bp, t_pad] exp-mass per tile
  int wk;                  // logit depth (columns of g)
  int q0;                  // first packed query column of the family
  int G, gpt;              // groups, groups per tile
  int chunk, n_chunks;     // groups per block, blocks along the groups
};

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
hier_scan_stats_kernel(const __nv_bfloat16* __restrict__ q_cat, int Bp, int cat_d, int t_pad,
                       Family f0, Family f1, Layout lay) {
  const int cy = blockIdx.y;
  const bool geo = cy >= f0.n_chunks;
  const Family f = geo ? f1 : f0;
  const int g_begin = (geo ? cy - f0.n_chunks : cy) * f.chunk;
  const int g_end = min(g_begin + f.chunk, f.G);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base + lay.q);
  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(base + lay.g);
  float* lg = reinterpret_cast<float*>(base + lay.lg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int ldk = f.wk + 8;
  const int n_steps = (g_end - g_begin) / BN;
  const int cpr = f.wk / 8;

  auto prefetch = [&](int buf, int it) {
    const int n0 = g_begin + it * BN;
    __nv_bfloat16* gs = gs0 + buf * BN * ldk;
    for (int idx = tid; idx < BN * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      cp_async16(gs + r * ldk + c, f.g + (size_t)(n0 + r) * f.wk + c, true);
    }
    cp_async_commit();
  };

  for (int idx = tid; idx < BM * cpr; idx += THREADS) {  // rows past Bp: zeros
    const int r = idx / cpr, c = (idx % cpr) * 8;
    const bool ok = q0 + r < Bp;
    cp_async16(qs + r * ldk + c, q_cat + (ok ? (size_t)(q0 + r) * cat_d + f.q0 + c : 0), ok);
  }
  cp_async_commit();
  prefetch(0, 0);

  // stats: thread owns query row sr and groups sc*8 .. sc*8+7 of a step
  const int sr = tid >> 2, sc = tid & 3;
  const int seg = f.gpt < BN ? f.gpt : BN;  // groups reduced together
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
    const int grp = g_begin + it * BN;  // first group of the step
    if (f.gpt <= BN) {
      if (lead && q < Bp) {
        const size_t o = (size_t)q * t_pad + (grp + sc * 8) / f.gpt;
        f.m[o] = lmax;
        f.s[o] = lsum;
      }
    } else {
      run_m = fmaxf(run_m, lmax);
      run_s += lsum;
      if ((grp + BN) % f.gpt == 0) {  // the tile ends with this step
        if (lead && q < Bp) {
          const size_t o = (size_t)q * t_pad + grp / f.gpt;
          f.m[o] = run_m;
          f.s[o] = run_s;
        }
        run_m = NEG_INF;
        run_s = 0.f;
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit
}

bool gpt_ok(int gpt) { return gpt % 8 == 0 && (gpt <= BN ? BN % gpt == 0 : gpt % BN == 0); }

Family family(const void* g, void* m, void* s, int wk, int q0, int G, int gpt) {
  const int unit = gpt > BN ? gpt : BN;  // whole tiles and whole steps
  const int chunk = (CHUNK_GROUPS + unit - 1) / unit * unit;
  return Family{static_cast<const __nv_bfloat16*>(g), static_cast<float*>(m),
                static_cast<float*>(s), wk, q0, G, gpt, chunk, (G + chunk - 1) / chunk};
}

}  // namespace

// q_cat [Bp, cat_d] bf16 packed queries: the sem family contracts columns
// [0, ws), the geo family the last wg.  g_sem [Gs, ws], g_geo [Gg, wg]
// bf16.  Out: m_s, s_s, m_g, s_g [Bp, t_pad] f32.  All contiguous and
// 16-byte aligned.
extern "C" int hier_scan_stats_launch(const void* q_cat, const void* g_sem, const void* g_geo,
                                      void* m_s, void* s_s, void* m_g, void* s_g, int Bp,
                                      int cat_d, int ws, int wg, int Gs, int Gg, int gpt_s,
                                      int gpt_g, int t_pad, void* stream) {
  if (Bp <= 0) return 0;
  if (ws % 16 || wg % 16 || ws > cat_d || wg > cat_d || cat_d % 8 ||
      Gs % BN || Gg % BN || !gpt_ok(gpt_s) || !gpt_ok(gpt_g) || Gs != t_pad * gpt_s ||
      Gg != t_pad * gpt_g)
    return (int)cudaErrorInvalidValue;
  const Family f0 = family(g_sem, m_s, s_s, ws, 0, Gs, gpt_s);
  const Family f1 = family(g_geo, m_g, s_g, wg, cat_d - wg, Gg, gpt_g);
  const Layout lay = layout(ws > wg ? ws : wg);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_scan_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bp + BM - 1) / BM, f0.n_chunks + f1.n_chunks);
  hier_scan_stats_kernel<<<grid, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q_cat), Bp, cat_d, t_pad, f0, f1, lay);
  return (int)cudaGetLastError();
}

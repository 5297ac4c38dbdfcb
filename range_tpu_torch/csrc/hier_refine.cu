// Hierarchical retrieval: fine stats over each query block's listed tiles
// (the two-level top-k's refine stage, stats-only form).
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_refine_kernel` with
// stats_only=True (reached via _hier_refine_call <- hier_topk on banks
// built with gsz_super).  For every query and each of the M tiles its
// query block kept from the coarse (supergroup) selection: the fine sem
// group logits l = q[:, :wf] . g (log2 e and the temperature are folded
// into the packed queries) over the tile's gpt consecutive groups of
// g_sem_cat, their max m and the exp-mass s = sum exp2(min(l, 86)).  Out:
// m_f, s_f [Bp, M] f32, column j the block's j-th listed tile.  The TPU
// kernel also fetches the supergroup centroids in this form and packs both
// stats into one [Bp, 2 Mp] block through one-hot products (its vector
// unit has no dynamic lane store); neither is needed here: the stats are
// written straight to their [query, column] places.
//
// What bounds it on an H100: the logits.  At the top-k endpoint's shape
// (B = 10,000, M = 96 tiles of 64 groups, 256 columns) that is ~32 GFLOP
// on the tensor cores (~0.032 ms at the bf16 peak) against ~8 MB of f32
// stats written and the union of the listed tiles' centroids read once
// (~6 MB): operations.
//
// Design: the stats-only scan (hier_scan_stats.cu) over a gathered list.
// A block owns 64 queries (inside one selection block of bm queries, whose
// idx row it reads) and a chunk of CHUNK_TILES of that row's listed tiles,
// and walks the chunk's groups 32 at a time: step rows are the list's
// flat positions p (tile idx[p / gpt], group p % gpt), fetched row by row
// with cp.async while the previous step computes.  The logits run on
// mma.sync bf16 tensor cores into a shared f32 tile, from which each
// thread takes 8 groups of one query: max and exp2 sum, reduced with warp
// shuffles across the 4 threads of a query (tiles of 8, 16 or 32 groups
// end inside a step; longer tiles carry a running max / sum across steps).
// A ragged end (M * gpt not a multiple of 32, gpt < 32) reads zero rows
// and writes nothing for them.  Nothing carries between blocks.

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

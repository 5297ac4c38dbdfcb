// Hierarchical top-k endpoint: the exact semantic argmax (k = 1) and the
// k-carry top-k (2 <= k <= 8) over each query block's selected bank tiles.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_hier_argmax_kernel` (entry
// point hier_argmax_launch, reached via _hier_argmax_call <- hier_topk(k=1))
// and `_hier_topk_kernel` (hier_topk_launch, via _hier_topk_call <-
// hier_topk(k >= 2)).  For each query and each of the K tiles selected for
// its block of bm queries (idx[block, j], in idx order), over the tile's bn
// rows:
//   l = (q2 . khl + ql . kh) + mask     q2 = [qh | qh], khl = [kh | kl]
// i.e. qh.kh + qh.kl + ql.kh, the hi/lo split at ~f32 logit accuracy.  The
// tile contributes its k best rows in extraction order (value descending,
// the lower in-tile index first among equal values); each replaces the
// first minimum of the query's running, unsorted k-list when strictly
// greater (`:1711-1720`).  For k = 1 that is the argmax kernel's rule: the
// lowest index among a tile's equal maxima, a later tile only when strictly
// greater.  Out: the unsorted list, scores [Bp, k] f32 and rows [Bp, k]
// int32 (the wrapper sorts it, ties keeping list order, as the JAX
// wrapper's lax.top_k does).
//
// What bounds it on an H100: the logits, 2 x bn x 3 Dk flops per (query,
// tile): at the endpoint's shape (B = 10,000, K = 48 tiles of 512 rows,
// Dk = 256) ~0.38 TFLOP on the tensor cores (~0.38 ms at the bf16 peak);
// the selected key tiles are ~0.5 MB each, re-read by every query block
// that selects them.
//
// Design: a block owns 64 queries (a part of one selection block, found as
// q0 / bm; the selection bm is semantic, the CUDA block size is free) and
// reads its own tile list from idx (Hopper has no scalar prefetch); the
// TPU's sequential tile axis becomes a loop over the K tiles in idx order,
// 32 rows a step with the next rows streaming in by cp.async.  The logits
// run on mma.sync bf16 tensor cores: the 512-deep q2 . khl and the 256-deep
// ql . kh each in a fresh fragment, added in f32 as the JAX kernel adds its
// two dots, then the mask.  Each of the 4 threads of a query keeps a sorted
// list of the k best (value, in-tile index) of its columns over the tile;
// at the tile's end the 4 lists merge by shuffles into the tile's k best in
// extraction order, and every thread applies the insertion rule to its copy
// of the running list.  A column at or below the running list's minimum is
// skipped at once: it could never be inserted, and without that filter the
// k = 8 list work took ~60% of the kernel's time (a warp runs the insertion
// when any of its threads needs it).  Lists live in registers, unrolled over KMAX
// (1 for the argmax entry point, 8 for top-k) with the runtime k masking
// the tail.  Shared memory (~176 KB at Dk = 256: the 64 x 768 query block,
// two 32 x 512 key steps, the logit tile) allows one block per SM.

#include <limits.h>

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 32;        // bank rows per step
constexpr int THREADS = 256;  // 8 warps
constexpr int LDL = BN + 1;   // f32 row stride of the logit tile
constexpr float NEG = -1e30f; // the running list's initial score (`NEG`)

struct Params {
  const __nv_bfloat16* q2;   // [Bp, 2 Dk]  [qh | qh]
  const __nv_bfloat16* ql;   // [Bp, Dk]
  const __nv_bfloat16* khl;  // [N, 2 Dk]   [kh | kl]
  const float* mask;         // [N] additive row mask
  const int* idx;            // [Bp / bm, K] selected tiles
  float* scores;             // [Bp, k] unsorted running list
  int* rows;                 // [Bp, k]
  int Bp, Dk, bm, bn, K, k;
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

struct Layout {
  size_t q2, ql, ks, ms, lg, total;
};

__host__ __device__ inline Layout layout(int K, int Dk) {
  Layout l;
  l.q2 = up16((size_t)K * 4);  // the tile list first
  l.ql = l.q2 + (size_t)BM * (2 * Dk + 8) * 2;
  l.ks = l.ql + (size_t)BM * (Dk + 8) * 2;
  l.ms = l.ks + (size_t)2 * BN * (2 * Dk + 8) * 2;
  l.lg = l.ms + (size_t)2 * BN * 4;
  l.total = l.lg + (size_t)BM * LDL * 4;
  return l;
}

// (v, i) ahead of (w, j) in extraction order: larger value, then lower index
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (v, i) into the first k entries of a list sorted in extraction
// order; the last entry drops out.
template <int KMAX>
__device__ __forceinline__ void insert(float (&vals)[KMAX], int (&idxs)[KMAX], int k, float v,
                                       int i) {
#pragma unroll
  for (int j = KMAX - 1; j >= 0; --j) {
    if (j >= k) continue;
    const int p = j > 0 ? j - 1 : 0;
    if (j > 0 && ahead(v, i, vals[p], idxs[p])) {
      vals[j] = vals[p];
      idxs[j] = idxs[p];
    } else if (ahead(v, i, vals[j], idxs[j])) {
      vals[j] = v;
      idxs[j] = i;
    }
  }
}

// Merge the list of the lane `x` apart (the other threads of the query)
// into this one's: both end with the k best of the two, in order.
template <int KMAX>
__device__ __forceinline__ void merge_xor(float (&vals)[KMAX], int (&idxs)[KMAX], int k, int x) {
  float pv[KMAX];
  int pi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    pv[j] = __shfl_xor_sync(0xffffffffu, vals[j], x);
    pi[j] = __shfl_xor_sync(0xffffffffu, idxs[j], x);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) insert<KMAX>(vals, idxs, k, pv[j], pi[j]);
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS, 1) hier_topk_kernel(const Params P, const Layout lay) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  int* idx_s = reinterpret_cast<int*>(base);
  __nv_bfloat16* q2s = reinterpret_cast<__nv_bfloat16*>(base + lay.q2);
  __nv_bfloat16* qls = reinterpret_cast<__nv_bfloat16*>(base + lay.ql);
  __nv_bfloat16* ks0 = reinterpret_cast<__nv_bfloat16*>(base + lay.ks);
  float* ms0 = reinterpret_cast<float*>(base + lay.ms);
  float* lg = reinterpret_cast<float*>(base + lay.lg);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int blk = q0 / P.bm;
  const int D2 = 2 * P.Dk;
  const int ld2 = D2 + 8, ldl = P.Dk + 8;
  const int spt = P.bn / BN;  // steps per tile
  const int n_steps = P.K * spt;

  for (int j = tid; j < P.K; j += THREADS) idx_s[j] = P.idx[(size_t)blk * P.K + j];
  __syncthreads();

  auto prefetch = [&](int buf, int it) {
    const int row0 = idx_s[it / spt] * P.bn + (it % spt) * BN;
    __nv_bfloat16* ks = ks0 + buf * BN * ld2;
    const int cpr = D2 / 8;
    for (int i = tid; i < BN * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      cp_async16(ks + r * ld2 + c, P.khl + (size_t)(row0 + r) * D2 + c, true);
    }
    if (tid < BN) cp_async4(ms0 + buf * BN + tid, P.mask + row0 + tid, true);
    cp_async_commit();
  };

  {  // the query block, once (Bp is a multiple of bm, itself of BM)
    const int c2 = D2 / 8, cl = P.Dk / 8;
    for (int i = tid; i < BM * c2; i += THREADS) {
      const int r = i / c2, c = (i % c2) * 8;
      cp_async16(q2s + r * ld2 + c, P.q2 + (size_t)(q0 + r) * D2 + c, true);
    }
    for (int i = tid; i < BM * cl; i += THREADS) {
      const int r = i / cl, c = (i % cl) * 8;
      cp_async16(qls + r * ldl + c, P.ql + (size_t)(q0 + r) * P.Dk + c, true);
    }
    cp_async_commit();
  }
  prefetch(0, 0);

  const float NEG_INF = __int_as_float(0xff800000);
  const int sr = tid >> 2, sc = tid & 3;  // thread -> query row, 8 columns
  float tv[KMAX], best[KMAX];             // this thread's tile list; running list
  int ti[KMAX], brow[KMAX];
  float kth = NEG_INF;                    // the tile list's k-th value
  float floor_v = NEG;                    // the running list's minimum
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = NEG_INF;
    ti[j] = INT_MAX;
    best[j] = NEG;
    brow[j] = 0;
  }

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
    const int s = it % spt;
    const __nv_bfloat16* ks = ks0 + buf * BN * ld2;
    const float* ms = ms0 + buf * BN;

    {  // logits: warp -> m16 tile (warp >> 1), n8 tiles 2 (warp & 1) + {0, 1}
      const int mt = warp >> 1, nt0 = (warp & 1) * 2;
      float c1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float c2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < D2; kk += 16) {  // q2 . khl
        uint32_t a[4];
        load_a(a, q2s, ld2, mt * 16, kk, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t b0, b1;
          load_bt(b0, b1, ks, ld2, (nt0 + i) * 8, kk, g, t);
          mma_bf16(c1[i], a, b0, b1);
        }
      }
      for (int kk = 0; kk < P.Dk; kk += 16) {  // ql . kh
        uint32_t a[4];
        load_a(a, qls, ldl, mt * 16, kk, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t b0, b1;
          load_bt(b0, b1, ks, ld2, (nt0 + i) * 8, kk, g, t);
          mma_bf16(c2[i], a, b0, b1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (nt0 + i) * 8 + 2 * t + (e & 1);
          lg[(mt * 16 + g + 8 * (e >> 1)) * LDL + col] = (c1[i][e] + c2[i][e]) + ms[col];
        }
    }
    __syncthreads();

    // this thread's 8 columns, in increasing in-tile index: a column enters
    // only ahead of the list's k-th entry (its index is the largest yet, so
    // that means a strictly larger value), and only above the running
    // list's minimum: the insertion rule needs strictly greater and the
    // minimum only rises, so nothing at or below it could ever enter (the
    // tile list's prefix above it, all that is inserted, is unchanged)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = lg[sr * LDL + sc * 8 + c];
      if (v > kth && v > floor_v) {
        insert<KMAX>(tv, ti, P.k, v, s * BN + sc * 8 + c);
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == P.k - 1) kth = tv[j];
      }
    }

    if (s == spt - 1) {  // the tile's end: merge the query's 4 lists
      merge_xor<KMAX>(tv, ti, P.k, 1);
      merge_xor<KMAX>(tv, ti, P.k, 2);
      // the tile's k best, in extraction order, into the running list: the
      // head of the tile list each time, then it is popped (every index
      // static, so the lists stay in registers)
      const int row0 = idx_s[it / spt] * P.bn;
#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        if (r >= P.k) break;
        float cmin = best[0];
        int cpos = 0;
#pragma unroll
        for (int j = 1; j < KMAX; ++j)
          if (j < P.k && best[j] < cmin) {
            cmin = best[j];
            cpos = j;
          }
        if (tv[0] > cmin) {
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j == cpos) {
              best[j] = tv[0];
              brow[j] = row0 + ti[0];
            }
        }
#pragma unroll
        for (int j = 0; j + 1 < KMAX; ++j) {
          tv[j] = tv[j + 1];
          ti[j] = ti[j + 1];
        }
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        tv[j] = NEG_INF;
        ti[j] = INT_MAX;
      }
      kth = NEG_INF;
      floor_v = best[0];
#pragma unroll
      for (int j = 1; j < KMAX; ++j)
        if (j < P.k) floor_v = fminf(floor_v, best[j]);
    }
  }
  cp_async_wait<0>();

  const int q = q0 + sr;
  if (sc == 0 && q < P.Bp) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < P.k) {
        P.scores[(size_t)q * P.k + j] = best[j];
        P.rows[(size_t)q * P.k + j] = brow[j];
      }
  }
}

template <int KMAX>
int launch(const void* q2, const void* ql, const void* khl, const void* mask, const void* idx,
           void* scores, void* rows, int Bp, int Dk, int bm, int bn, int K, int k, void* stream) {
  if (Bp <= 0) return 0;
  if (k < 1 || k > KMAX || K < 1 || bm % BM || Bp % bm || bn % BN || Dk % 16 || Dk > 256)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const Params P{static_cast<const bf*>(q2), static_cast<const bf*>(ql),
                 static_cast<const bf*>(khl), static_cast<const float*>(mask),
                 static_cast<const int*>(idx), static_cast<float*>(scores),
                 static_cast<int*>(rows), Bp, Dk, bm, bn, K, k};
  const Layout lay = layout(K, Dk);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hier_topk_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  hier_topk_kernel<KMAX><<<Bp / BM, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(P,
                                                                                             lay);
  return (int)cudaGetLastError();
}

}  // namespace

// q2 [Bp, 2 Dk], ql [Bp, Dk], khl [N, 2 Dk] bf16; mask [N] f32; idx
// [Bp / bm, K] int32 (tiles < N / bn).  Out: scores [Bp] f32 and rows
// [Bp] int32.  All contiguous and 16-byte aligned.
extern "C" int hier_argmax_launch(const void* q2, const void* ql, const void* khl,
                                  const void* mask, const void* idx, void* scores, void* rows,
                                  int Bp, int Dk, int bm, int bn, int K, void* stream) {
  return launch<1>(q2, ql, khl, mask, idx, scores, rows, Bp, Dk, bm, bn, K, 1, stream);
}

// As hier_argmax_launch with 2 <= k <= 8: scores and rows [Bp, k], the
// running list unsorted.
extern "C" int hier_topk_launch(const void* q2, const void* ql, const void* khl, const void* mask,
                                const void* idx, void* scores, void* rows, int Bp, int Dk, int bm,
                                int bn, int K, int k, void* stream) {
  return launch<8>(q2, ql, khl, mask, idx, scores, rows, Bp, Dk, bm, bn, K, k, stream);
}

// Hierarchical top-k endpoint for Hopper (sm_90a): the exact semantic
// argmax (k = 1) and the k-carry top-k (2 <= k <= 8) over each query
// block's selected bank tiles, with wgmma for the logits, a TMA ring of key
// steps under mbarriers shared by 128 queries, and tile lists split across
// blocks and folded in order.
//
// Replaces: range_tpu/ops/retrieval_hier.py,
//   * :1645 `_hier_argmax_kernel` (entry point hier_argmax_sm90_launch,
//     reached via _hier_argmax_call <- hier_topk(k=1));
//   * :1682 `_hier_topk_kernel` (hier_topk_sm90_launch, via _hier_topk_call
//     <- hier_topk(k >= 2)).
// For each query and each of the K tiles selected for its block of bm
// queries (idx[block, j], in idx order), over the tile's bn rows:
//   l = (q2 . khl + ql . kh) + mask     q2 = [qh | qh], khl = [kh | kl]
// i.e. qh.kh + qh.kl + ql.kh, the hi/lo split at ~f32 logit accuracy.  The
// tile contributes its k best rows in extraction order (value descending,
// the lower in-tile index first among equal values); each replaces the
// first minimum of the query's running, unsorted k-list when strictly
// greater (`:1711-1720`).  For k = 1 that is the argmax kernel's rule.
// Out: the unsorted list, scores [Bp, k] f32 and rows [Bp, k] int32 (the
// wrapper sorts it, ties keeping list order, as JAX's lax.top_k does).
//
// What bounds it on an H100: the logits, 2 x bn x 3 Dk flops per (query,
// tile) on the tensor cores: at the endpoint's shape (B = 10,000, K = 48
// tiles of 512 rows, Dk = 256) ~0.38 TFLOP, ~0.38 ms at the bf16 peak; the
// bytes are the union of the selected tiles' keys and mask (~0.5 MB a tile)
// read once, the queries and the lists.  A block's 128 queries against a
// 1,024-byte key row (Dk = 256) do 192 flops a byte read from L2, near
// what L2 can feed the tensor cores.
//
// What the mma.sync body (csrc/hier_argmax.cu, now chip_smoke's yardstick
// only) lost time on, and what this design does about it:
//   * 64 queries a block under a 256-query selection block: every selected
//     tile read from L2 four times.  Here a block owns 128 queries (two
//     consumer warpgroups of 64, each its own accumulator) and one TMA ring
//     of key steps feeds both: a key byte is read once per 128 queries.  A
//     2-block cluster sharing each step by TMA multicast was not built.
//   * One block per SM and 1.2 waves at B = 10,000; 2 or 16 blocks at
//     small batches.  Here each list is cut into segments of whole tiles
//     (ops/retrieval_hier._klist_plan: enough blocks to fill the card's 132
//     SMs at every batch, few enough that a block's start-up pays), and
//     each block writes each (query, tile)'s k best, in extraction order,
//     to a workspace [Bp, K, k] of (score, row).  klist_fold_kernel then
//     applies the insertion rule over the K tile lists in idx order, one
//     thread a query.  The tile lists depend on no running state, so the
//     fold reproduces the one-pass k-carry bit for bit, ties included (a
//     merge of per-segment running lists would not: the rule evicts the
//     *first* minimum, so a list depends on the list it started from).
//   * mma.sync fed from shared memory every 32-row step (~384 KB of
//     operand reads a step).  Here the logits are one wgmma chain a 64-row
//     step, 3 Dk deep: A = [qh | qh | ql], qh as register fragments loaded
//     once (read twice, against kh and kl), ql from shared memory; B = [kh
//     | kl | kh] from the one ring stage, kh read twice by descriptor.  One
//     768-deep f32 chain a step, fresh every step, where JAX adds a 512-
//     and a 256-deep dot: the same products in another summation order.
//   * A logit tile in shared memory and two block barriers a step.  Here a
//     query row's 64 columns sit in one quad of the accumulator's layout:
//     each thread keeps a sorted k-list of its columns for each of its two
//     rows in registers, straight from the accumulator, and at the tile's
//     end the quad merges its lists by shuffles and a bitonic network.  Only
//     the ring's mbarriers synchronise; the stage is released as soon as
//     its products and mask are read, before the list work.
//   * A column at or below the running list's minimum is skipped (~60% of
//     the body's k = 8 time went to list work without such a filter).  A
//     block does not see the list before its segment, so it keeps the list
//     folded from its segment's start: its minimum is never above the true
//     one (the list holds the k largest values offered), so a skipped column
//     could never have entered, and a tile list keeps every entry that can
//     enter, in order (the rest are written as -inf).  A step whose columns
//     all fail the filter costs one vote a row; the insertions a step needs
//     run in one loop over its passing columns (16 inlined copies of the
//     insertion each step made k = 8 several times slower), and k is a
//     template parameter (with a run-time k the list's k-th entry was read
//     through local memory).
// Layout: 256 threads, two consumer warpgroups (8 warps; a ninth, producer
// warp would leave ptxas 168 registers a thread).  Thread 0 (warpgroup 0)
// is the producer: it loads the block's ql boxes, then keeps a ring of S
// stages filled with the walk's steps (each tile's ceil(bn / 64) steps of 64
// rows: kh and kl as 128-byte swizzled 64-column boxes from two 2-D tensor
// maps, one per half of khl, so TMA zero-fills past Dk in each; the step's
// 64 mask values).  A tile of no whole number of steps ends in a masked
// step (the box loads 64 rows, the columns past the tile are skipped).  A
// stage is freed by an arrive of every consumer warp; the producer refills
// it then.  bm = 64: 64 queries a block, warpgroup 1 idle.  One kernel
// instance for each k (1..8) and each count of 64-column key boxes (1..8).
// Keys wider than 256 columns (5 to 8 boxes) take each step in 3 or 4
// passes of 128 columns (2 boxes; the last what is left), a ring item
// each: the pass's kh and kl boxes through the ring, its ql boxes from the
// block's resident ones, its qh fragments loaded from device memory (L2)
// for the pass; one accumulator chain runs through them all, so a row's
// logit is one f32 chain, summed pass by pass (qh kh, qh kl, ql kh over
// the first 128 columns, then the next).  A stage holds one pass's boxes
// (32 KB for both halves of khl), so 128 queries share a block up to 512
// columns (passes of 256 left room for 64: each key byte read from L2
// twice as often).  At up to 4 boxes the plan, the stages and the sums are
// those of one pass.  Every
// wgmma issue sits between its fence and a wait for all groups, with no
// divergent code between; walk positions advance by counters.  A wait on a
// barrier that never completes traps after ~10 s instead of hanging.

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;            // queries a warpgroup: one wgmma M
constexpr int BN = 64;            // bank rows a step: one wgmma N
constexpr int THREADS = 256;      // two warpgroups
constexpr int BOXB = BN * 128;    // one [64 rows][64 bf16] swizzled box: 8 KB
constexpr int MASKB = BN * 4;     // a step's mask values
constexpr int SCRB = 16 * 32 * 4; // a warp's scratch: a row's 16 columns, 32 lanes
constexpr float NEG = -1e30f;     // the running list's initial score (`NEG`)
constexpr int PASS_BOXES = 4;     // key boxes a step takes in one pass: 256 columns
constexpr int DEEP_BOXES = 2;     // past them, key boxes of a pass: 128 columns
constexpr int MAX_BOXES = 8;      // key widths up to 512 columns: four passes

// Key boxes of one pass of a step (a ring stage's), and passes a step, at a
// key width of KB boxes
__host__ __device__ constexpr int pass_boxes(int kb) { return kb <= PASS_BOXES ? kb : DEEP_BOXES; }
__host__ __device__ constexpr int n_passes(int kb) {
  return (kb + pass_boxes(kb) - 1) / pass_boxes(kb);
}

struct Prm {
  const __nv_bfloat16* q2;  // [Bp, 2 Dk]: qh is its first Dk columns
  const int* idx;           // [Bp / bm, K]
  float2* work;             // [Bp, K, k]: (score, row's int bits)
  int Dk, ld2, bm, bn, K, spt, last_rows, n_seg, halves, n_qb, S;
  uint32_t ring, stage, kl, mask, scr, bars, total;  // shared-memory offsets and size
};

// Offsets from the 1024-byte aligned base: each query half's ql boxes (all
// kb of them), the ring's S stages of [kh boxes | kl boxes] of one pass
// (pass_boxes(kb) each), their masks, each consumer warp's scratch (16 x 32
// floats), the barriers (bq, full[S], empty[S]); `_klist_smem` in
// ops/retrieval_hier.py mirrors it.
__host__ inline Prm layout(Prm P, int kb) {
  const int kbs = pass_boxes(kb);
  P.ring = (uint32_t)(P.halves * kb * BOXB);
  P.stage = (uint32_t)(2 * kbs * BOXB);
  P.kl = (uint32_t)(kbs * BOXB);
  P.mask = P.ring + P.S * P.stage;
  P.scr = P.mask + P.S * MASKB;
  P.bars = P.scr + P.halves * 4 * SCRB;
  P.total = P.bars + 8 * (1 + 2 * P.S) + 1024;
  return P;
}

// d[32] (+)= A[64 x 16] B[16 x 64], A in registers (the m16n8k16 fragment
// of each warp's 16 rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// (v, i) ahead of (w, j) in extraction order: larger value, then lower index
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (v, i) into the first KL entries of a thread's list, sorted in
// extraction order, whose indices are all below i (a thread meets its
// columns in increasing in-tile index): it goes after every entry of equal
// value; the last entry drops out.  Every position's new entry depends on
// the old list alone, so the positions update in parallel.
template <int KL, int N>
__device__ __forceinline__ void insert(float (&vals)[N], int (&idxs)[N], float v, int i) {
#pragma unroll
  for (int j = KL - 1; j >= 0; --j) {
    if (j > 0 && v > vals[j - 1]) {
      vals[j] = vals[j - 1];
      idxs[j] = idxs[j - 1];
    } else if (v > vals[j]) {
      vals[j] = v;
      idxs[j] = i;
    }
  }
}

// Sort a bitonic list into extraction order (N a power of 2).
template <int N>
__device__ __forceinline__ void bitonic_sort(float (&v)[N], int (&i)[N]) {
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1)
#pragma unroll
    for (int a = 0; a < N; ++a)
      if ((a & s) == 0 && ahead(v[a + s], i[a + s], v[a], i[a])) {
        const float tv = v[a];
        const int ti = i[a];
        v[a] = v[a + s];
        i[a] = i[a + s];
        v[a + s] = tv;
        i[a + s] = ti;
      }
}

// Merge the list of the lane `x` apart (another thread of the same row)
// into this one's, both sorted in extraction order (-inf and INT_MAX past
// their entries): both end with the N best of the two, in order.  The
// better of this list's a-th and the other's (N - 1 - a)-th entries form a
// bitonic list holding them, which a bitonic network sorts.
template <int N>
__device__ __forceinline__ void merge_xor(float (&vals)[N], int (&idxs)[N], int x) {
  float pv[N];
  int pi[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    pv[j] = __shfl_xor_sync(0xffffffffu, vals[j], x);
    pi[j] = __shfl_xor_sync(0xffffffffu, idxs[j], x);
  }
#pragma unroll
  for (int a = 0; a < N; ++a)
    if (ahead(pv[N - 1 - a], pi[N - 1 - a], vals[a], idxs[a])) {
      vals[a] = pv[N - 1 - a];
      idxs[a] = pi[N - 1 - a];
    }
  bitonic_sort<N>(vals, idxs);
}

// The N largest values of two lists sorted descending, sorted, into `a`.
template <int N>
__device__ __forceinline__ void merge_values(float (&a)[N], const float (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = fmaxf(a[j], b[N - 1 - j]);
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if ((j & s) == 0) {
        const float hi = fmaxf(a[j], a[j + s]), lo = fminf(a[j], a[j + s]);
        a[j] = hi;
        a[j + s] = lo;
      }
}

// The lists' length: KL, padded to a power of 2 for the merge networks.
template <int KL>
__host__ __device__ constexpr int pad2() {
  return KL <= 1 ? 1 : KL <= 2 ? 2 : KL <= 4 ? 4 : 8;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

struct Maps {
  const CUtensorMap *tql, *tkh, *tkl, *tm;
};

// One pass of a step's logits chain: key boxes [PB PI, + NB) of the stage
// at st (kh, then kl at st + P.kl; PB = pass_boxes(KB)) against the qh
// fragments a of the same columns and the resident ql boxes at qa, into acc
// (fresh at the first pass: one f32 chain a row over every pass).
template <int KB, int PI>
__device__ __forceinline__ void chain_pass(float (&acc)[32],
                                           const uint32_t (&a)[4 * pass_boxes(KB)][4],
                                           uint32_t st, uint32_t kl, uint32_t qa) {
  constexpr int PB = pass_boxes(KB);
  constexpr int NB = KB - PB * PI < PB ? KB - PB * PI : PB;
  constexpr int KS = 4 * NB;
  const uint32_t qp = qa + PB * PI * BOXB;  // this pass's ql boxes
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)  // qh . kh
    wgmma_rs_n64(acc, a[ks], desc_k128(st + (ks >> 2) * BOXB + (ks & 3) * 32),
                 PI > 0 || ks > 0 ? 1 : 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)  // qh . kl
    wgmma_rs_n64(acc, a[ks], desc_k128(st + kl + (ks >> 2) * BOXB + (ks & 3) * 32), 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)  // ql . kh
    wgmma_ss_n64(acc, desc_k128(qp + (ks >> 2) * BOXB + (ks & 3) * 32),
                 desc_k128(st + (ks >> 2) * BOXB + (ks & 3) * 32), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// Pass `pass` (a constant where the pass loop is unrolled) of chain_pass.
template <int KB>
__device__ __forceinline__ void chain_any(int pass, float (&acc)[32],
                                          const uint32_t (&a)[4 * pass_boxes(KB)][4],
                                          uint32_t st, uint32_t kl, uint32_t qa) {
  constexpr int NP = n_passes(KB);
  if (pass == 0) {
    chain_pass<KB, 0>(acc, a, st, kl, qa);
  } else if constexpr (NP > 1) {
    if (pass == 1) {
      chain_pass<KB, 1>(acc, a, st, kl, qa);
    } else if constexpr (NP > 2) {
      if (pass == 2) {
        chain_pass<KB, 2>(acc, a, st, kl, qa);
      } else if constexpr (NP > 3) {
        chain_pass<KB, 3>(acc, a, st, kl, qa);
      }
    }
  }
}

// Warpgroup `wg` of a block: the 64 query rows of its half against every
// step of the block's segment [lo, lo + n) of its list `lst`.  A key width
// of KB > PASS_BOXES boxes takes each step in NP = 3 or 4 passes of
// DEEP_BOXES boxes (128 columns; the last of what is left), an item of
// the ring each, the accumulator carried from one to the next; the qh
// fragments of a pass are loaded for it (the rows' qh over every column
// would not fit the registers).
template <int KL, int KB>
__device__ __forceinline__ void consume(const Prm& P, const Maps& M, uint32_t base, int q0,
                                        const int* lst, int lo, int n, int wg) {
  constexpr int NP = n_passes(KB);      // passes a step
  constexpr int KBS = pass_boxes(KB);   // key boxes of a stage
  constexpr int KS = 4 * KBS;  // k16 steps of a pass's three parts
  static_assert(NP <= 4, "four passes at most");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = threadIdx.x == 0;
  const uint32_t bq = base + P.bars, full = bq + 8, empty = full + 8 * P.S;
  const int n_items = n * P.spt * NP;

  // the producer's walk: the next item to load (its tile slot, step, pass)
  int lj = 0, ls = 0, lp = 0, li = 0;
  auto load = [&](int stg) {
    const int row = __ldg(lst + lj) * P.bn + ls * BN;
    const int b0 = KBS * lp, nb = min(KB - b0, KBS);
    const uint32_t st = base + P.ring + stg * P.stage, f = full + 8 * stg;
    mbar_expect_tx(f, 2 * nb * BOXB + MASKB);
    for (int i = 0; i < nb; ++i) tma_2d(st + i * BOXB, M.tkh, BOX * (b0 + i), row, f);
    for (int i = 0; i < nb; ++i) tma_2d(st + P.kl + i * BOXB, M.tkl, BOX * (b0 + i), row, f);
    tma_1d(base + P.mask + stg * MASKB, M.tm, row, f);
    ++li;
    if (++lp == NP) {
      lp = 0;
      if (++ls == P.spt) {
        ls = 0;
        ++lj;
      }
    }
  };
  if (producer) {
    mbar_expect_tx(bq, P.halves * KB * BOXB);
    for (int h = 0; h < P.halves; ++h)
#pragma unroll
      for (int i = 0; i < KB; ++i)
        tma_2d(base + (h * KB + i) * BOXB, M.tql, BOX * i, q0 + h * BM, bq);
    for (int s = 0; s < P.S && li < n_items; ++s) load(s);
  }
  __syncwarp();

  // qh as register fragments of a pass: rows r and r + 8 of the warp's 16,
  // columns 64 KBS pass + 16 ks + 2t (+1) and + 8; zero past Dk
  uint32_t a[KS][4];
  const __nv_bfloat16* r0 = P.q2 + (size_t)(q0 + wg * BM + 16 * warp + g) * P.ld2;
  const __nv_bfloat16* r1 = r0 + 8 * (size_t)P.ld2;
  auto load_a = [&](int pass) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = KBS * BOX * pass + 16 * ks + 2 * t;
      a[ks][0] = ld_pair(r0 + c, c < P.Dk);
      a[ks][1] = ld_pair(r1 + c, c < P.Dk);
      a[ks][2] = ld_pair(r0 + c + 8, c + 8 < P.Dk);
      a[ks][3] = ld_pair(r1 + c + 8, c + 8 < P.Dk);
    }
  };
  if constexpr (NP == 1) load_a(0);
  const uint32_t qa = base + wg * KB * BOXB;  // this warpgroup's ql boxes
  // this warp's scratch: a row's 16 values a step, [column][lane]
  float* scr = reinterpret_cast<float*>(__cvta_shared_to_generic(base + P.scr)) +
               (threadIdx.x >> 5) * 16 * 32;
  mbar_wait(bq, 0);

  const float NEG_INF = __int_as_float(0xff800000);
  // each row's tile list; the values of its list from the segment's start,
  // sorted descending (-inf past k); that list's minimum; the threshold a
  // column must pass (the larger of the tile list's k-th value and flo)
  constexpr int N = pad2<KL>();
  float tv[2][N], best[2][N], flo[2], thr[2];
  int ti[2][N];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    flo[e2] = thr[e2] = NEG;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      tv[e2][j] = NEG_INF;
      ti[e2][j] = INT_MAX;
      best[e2][j] = j < KL ? NEG : NEG_INF;
    }
  }
  const int qrow = q0 + wg * BM + 16 * warp + g + 8 * (t & 1);  // the row thread t < 2 writes

  int j = 0, s = 0, stg = 0, ph = 0;  // the consumers' walk and ring position
  const int n_steps = n * P.spt;
  for (int it = 0; it < n_steps; ++it) {
    float acc[32];
#pragma unroll
    for (int pass = 0; pass + 1 < NP; ++pass) {  // the passes but the last: released at once
      load_a(pass);
      mbar_wait(full + 8 * stg, ph);
      chain_any<KB>(pass, acc, a, base + P.ring + stg * P.stage, P.kl, qa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stg);
      if (producer && li < n_items) {
        mbar_wait(empty + 8 * stg, ph);
        load(stg);
      }
      __syncwarp();
      if (++stg == P.S) {
        stg = 0;
        ph ^= 1;
      }
    }
    if constexpr (NP > 1) load_a(NP - 1);
    mbar_wait(full + 8 * stg, ph);
    chain_any<KB>(NP - 1, acc, a, base + P.ring + stg * P.stage, P.kl, qa);
    // accumulator element 4 jj + 2 e2 + e is row g + 8 e2, column 8 jj + 2t + e
    const float* mk = reinterpret_cast<const float*>(
        __cvta_shared_to_generic(base + P.mask + stg * MASKB));
    float2 m[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) m[jj] = *reinterpret_cast<const float2*>(mk + 8 * jj + 2 * t);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stg);  // this warp is done with the stage
    if (producer && li < n_items) {  // refill it once every consumer warp is
      mbar_wait(empty + 8 * stg, ph);
      load(stg);
    }
    __syncwarp();

    // this thread's columns of each row, in increasing in-tile index: a
    // column enters only ahead of the tile list's k-th entry (its index is
    // the largest yet, so that means a strictly larger value) and above the
    // segment list's minimum; columns past the tile (its masked last step)
    // never.  The thresholds only rise, so a column failing them at the
    // step's start never enters: a row none of whose columns passes in any
    // lane of the warp costs a vote.  Otherwise the row's 16 values go to
    // the warp's scratch and one loop over the columns some lane passes
    // inserts them (one copy of the insertion in the code, not sixteen).
    const int lim = s + 1 == P.spt ? P.last_rows : BN;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float v16[16];  // the row's columns: 2 jj + e
      uint32_t pm = 0;  // this thread's passing columns
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * jj + e;
          v16[c] = 8 * jj + 2 * t + e < lim ? acc[4 * jj + 2 * e2 + e] + (e ? m[jj].y : m[jj].x)
                                            : NEG_INF;
          if (v16[c] > thr[e2]) pm |= 1u << c;
        }
      uint32_t wm = __reduce_or_sync(0xffffffffu, pm);
      if (wm == 0) continue;
#pragma unroll
      for (int c = 0; c < 16; ++c) scr[c * 32 + lane] = v16[c];
      __syncwarp();
      while (wm) {
        const int c = __ffs(wm) - 1;
        wm &= wm - 1;
        const float v = scr[c * 32 + lane];
        if (v > thr[e2]) {
          insert<KL>(tv[e2], ti[e2], v, s * BN + 8 * (c >> 1) + 2 * t + (c & 1));
          thr[e2] = fmaxf(tv[e2][KL - 1], flo[e2]);
        }
      }
      __syncwarp();  // the scratch is read before the next row overwrites it
    }

    if (s + 1 == P.spt) {  // the tile's end
      const int row0 = __ldg(lst + j) * P.bn;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        merge_xor<N>(tv[e2], ti[e2], 1);
        merge_xor<N>(tv[e2], ti[e2], 2);
      }
      if (t < 2) {  // thread 0 of the quad writes row g's list, thread 1 row g + 8's
        float2* w = P.work + ((size_t)qrow * P.K + lo + j) * KL;
#pragma unroll
        for (int r = 0; r < KL; ++r) {
          const float v = t ? tv[1][r] : tv[0][r];
          const int i = t ? ti[1][r] : ti[0][r];
          w[r] = make_float2(v, __int_as_float(i == INT_MAX ? 0 : row0 + i));
        }
      }
      // the segment's list takes the tile list as the fold will: its values
      // become the k largest of the two lists'; its minimum is the filter
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        merge_values<N>(best[e2], tv[e2]);
        flo[e2] = best[e2][KL - 1];
#pragma unroll
        for (int r = 0; r < N; ++r) {
          tv[e2][r] = NEG_INF;
          ti[e2][r] = INT_MAX;
        }
        thr[e2] = flo[e2];
      }
      s = 0;
      ++j;
    } else {
      ++s;
    }
    if (++stg == P.S) {
      stg = 0;
      ph ^= 1;
    }
  }
}

template <int KL, int KB>
__global__ void __launch_bounds__(THREADS, 1)
    hier_klist_sm90_kernel(const __grid_constant__ CUtensorMap tql,
                           const __grid_constant__ CUtensorMap tkh,
                           const __grid_constant__ CUtensorMap tkl,
                           const __grid_constant__ CUtensorMap tm,
                           const __grid_constant__ Prm P0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // a copy in registers: a reference into the parameter space would be
  // reloaded after every asm statement that clobbers memory
  const Prm P = P0;
  const Maps M{&tql, &tkh, &tkl, &tm};
  const uint32_t base = smem_u32(smem);
  const int qb = blockIdx.x % P.n_qb, seg = blockIdx.x / P.n_qb;  // a segment's query blocks together
  const int q0 = qb * BM * P.halves;
  const int lo = (int)((long long)seg * P.K / P.n_seg);
  const int n = (int)((long long)(seg + 1) * P.K / P.n_seg) - lo;
  const int* lst = P.idx + (size_t)(q0 / P.bm) * P.K + lo;
  if (threadIdx.x == 0) {
    const uint32_t bq = base + P.bars;
    mbar_init(bq, 1);
    for (int s = 0; s < P.S; ++s) {
      mbar_init(bq + 8 + 8 * s, 1);
      mbar_init(bq + 8 + 8 * (P.S + s), 4 * P.halves);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg >= P.halves) return;
  consume<KL, KB>(P, M, base, q0, lst, lo, n, wg);
}

// The k-carry over each query's K tile lists in idx order, one thread a
// query: an entry replaces the list's first minimum when strictly greater;
// a tile list descends, so its first entry that does not enter ends it.
template <int KL>
__global__ void klist_fold_kernel(const float2* __restrict__ work, float* __restrict__ scores,
                                  int* __restrict__ rows, int Bp, int K) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Bp) return;
  float best[KL];
  int brow[KL];
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    best[i] = NEG;
    brow[i] = 0;
  }
  float cmin = NEG;
  int cpos = 0;
  const float2* w = work + (size_t)q * K * KL;
  for (int j = 0; j < K; ++j, w += KL) {
#pragma unroll
    for (int r = 0; r < KL; ++r) {
      const float2 e = w[r];
      if (!(e.x > cmin)) break;
#pragma unroll
      for (int i = 0; i < KL; ++i)
        if (i == cpos) {
          best[i] = e.x;
          brow[i] = __float_as_int(e.y);
        }
      cmin = best[0];
      cpos = 0;
#pragma unroll
      for (int i = 1; i < KL; ++i)
        if (best[i] < cmin) {
          cmin = best[i];
          cpos = i;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    scores[(size_t)q * KL + i] = best[i];
    rows[(size_t)q * KL + i] = brow[i];
  }
}

// The block kernel (its instance for the list length and key boxes), then
// the fold.
template <int KL>
cudaError_t run(int kb, const CUtensorMap& tql, const CUtensorMap& tkh, const CUtensorMap& tkl,
                const CUtensorMap& tm, const Prm& P, float* scores, int* rows, int Bp,
                cudaStream_t s) {
  const auto kernel = kb == 1   ? hier_klist_sm90_kernel<KL, 1>
                      : kb == 2 ? hier_klist_sm90_kernel<KL, 2>
                      : kb == 3 ? hier_klist_sm90_kernel<KL, 3>
                      : kb == 4 ? hier_klist_sm90_kernel<KL, 4>
                      : kb == 5 ? hier_klist_sm90_kernel<KL, 5>
                      : kb == 6 ? hier_klist_sm90_kernel<KL, 6>
                      : kb == 7 ? hier_klist_sm90_kernel<KL, 7>
                                : hier_klist_sm90_kernel<KL, 8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.total);
  if (err != cudaSuccess) return err;
  kernel<<<P.n_qb * P.n_seg, THREADS, P.total, s>>>(tql, tkh, tkl, tm, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  klist_fold_kernel<KL><<<(Bp + 127) / 128, 128, 0, s>>>(P.work, scores, rows, Bp, P.K);
  return cudaGetLastError();
}

int launch(const void* q2, const void* ql, const void* khl, const void* mask, const void* idx,
           void* scores, void* rows, void* work, int Bp, int N, int Dk, int bm, int bn, int K,
           int k, int bmb, int n_seg, int S, void* stream) {
  if (Bp <= 0) return 0;
  if (k < 1 || k > 8 || K < 1 || bm <= 0 || bm % BM || Bp % bm || bn < 32 || bn % 32 ||
      N < bn || N % bn || Dk < 8 || Dk > MAX_BOXES * BOX || Dk % 8 || (bmb != BM && bmb != 2 * BM) ||
      bm % bmb || n_seg < 1 || n_seg > K || S < 2 || S > 4)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q2, ql, khl, mask, idx, scores, rows, work};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  const int kb = (Dk + BOX - 1) / BOX;
  Prm P{};
  P.q2 = static_cast<const __nv_bfloat16*>(q2);
  P.idx = static_cast<const int*>(idx);
  P.work = static_cast<float2*>(work);
  P.Dk = Dk;
  P.ld2 = 2 * Dk;
  P.bm = bm;
  P.bn = bn;
  P.K = K;
  P.spt = (bn + BN - 1) / BN;
  P.last_rows = bn - (P.spt - 1) * BN;
  P.n_seg = n_seg;
  P.halves = bmb / BM;
  P.n_qb = Bp / bmb;
  P.S = S;
  P = layout(P, kb);
  if (P.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  using bf = __nv_bfloat16;
  const bf* kp = static_cast<const bf*>(khl);
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tql, tkh, tkl, tm;
  // each half of khl its own map, so a box past Dk zero-fills in either
  if (!map_2d(&tql, ql, Dk, Bp, Dk, BOX, BM, sw128) ||
      !map_2d(&tkh, kp, Dk, N, 2 * Dk, BOX, BN, sw128) ||
      !map_2d(&tkl, kp + Dk, Dk, N, 2 * Dk, BOX, BN, sw128) || !map_1d(&tm, mask, N, BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  int* rw = static_cast<int*>(rows);
  cudaError_t err;
  switch (k) {
    case 1: err = run<1>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 2: err = run<2>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 3: err = run<3>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 4: err = run<4>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 5: err = run<5>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 6: err = run<6>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    case 7: err = run<7>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
    default: err = run<8>(kb, tql, tkh, tkl, tm, P, sc, rw, Bp, s); break;
  }
  return (int)err;
}

}  // namespace

// q2 [Bp, 2 Dk], ql [Bp, Dk], khl [N, 2 Dk] bf16 (Dk a multiple of 8, at
// most 512: over 256 columns in passes of 128, 3 or 4); mask [N] f32; idx [Bp / bm, K] int32 (tiles < N / bn; bm a
// multiple of 64 dividing Bp, bn of 32 dividing N).  The plan
// (`_klist_plan`): bmb = 64 or 128 queries a block (128 only where it
// divides bm), n_seg segments of each list (1 <= n_seg <= K), S = 2..4 ring
// stages.  work [Bp, K] (score, row) pairs, f32 and int32 bits: each tile's
// list.  Out: scores [Bp] f32 and rows [Bp] int32.  All contiguous and
// 16-byte aligned.  Returns a CUDA error code (cudaErrorInvalidValue for
// what it does not take, with nothing launched).
extern "C" int hier_argmax_sm90_launch(const void* q2, const void* ql, const void* khl,
                                       const void* mask, const void* idx, void* scores,
                                       void* rows, void* work, int Bp, int N, int Dk, int bm,
                                       int bn, int K, int bmb, int n_seg, int S, void* stream) {
  return launch(q2, ql, khl, mask, idx, scores, rows, work, Bp, N, Dk, bm, bn, K, 1, bmb, n_seg,
                S, stream);
}

// As hier_argmax_sm90_launch with 1 <= k <= 8: work [Bp, K, k] pairs,
// scores and rows [Bp, k], the running list unsorted.
extern "C" int hier_topk_sm90_launch(const void* q2, const void* ql, const void* khl,
                                     const void* mask, const void* idx, void* scores,
                                     void* rows, void* work, int Bp, int N, int Dk, int bm,
                                     int bn, int K, int k, int bmb, int n_seg, int S,
                                     void* stream) {
  return launch(q2, ql, khl, mask, idx, scores, rows, work, Bp, N, Dk, bm, bn, K, k, bmb, n_seg,
                S, stream);
}

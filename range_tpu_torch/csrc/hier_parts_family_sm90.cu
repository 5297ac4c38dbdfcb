// Hierarchical retrieval, stage 2: exact minus group approximation of ONE
// family over each query block's selected bank tiles, the residual-rank
// shapes (rr, with or without lr), for Hopper (sm_90a): wgmma on every
// product, a TMA ring under mbarriers, tile lists split across blocks.
//
// Replaces: range_tpu/ops/retrieval_hier.py:2282, `_hier_parts_family_kernel`
// with rr on (reached via _hier_parts_family_call <- _hier_partials <-
// retrieve_hier), in every form that shape takes: rr + lr, rr alone (the
// full-width group value sums), sel (the sem family's group logits from
// the query operand's last gw columns, the rank-k sketch appended past
// cat_d) and dedup_pad (an entry equal to the one before it in its row is
// skipped).  For each query and each tile of its block's list:
//   p   = exp2(min(q . k + mask, 86))       over the tile's bn rows
//   ps  = per-group sums of bf16(p), in f32
//   e   = exp2(min(q_g . g, 86))            over the tile's gpt groups
//   D   = bf16(e - ps / max(cnt, 1))        (cnt = column lrr of vw)
//   az += bf16(p) @ z,  alr += D @ vw
// rr + lr: out [Bp, rrp + 128 + W] = az | d (0: the count rides alr) | 0 | alr.
// rr alone: out [Bp, lrr + 128 + rrp] = -alr[:, :lrr + 1] | 0 (127) | az,
// the TPU kernel's bf16(ps/cnt - e) @ vw: bf16 rounds to nearest
// symmetrically, so bf16(ps/cnt - e) = -D exactly.  These are the TPU
// kernel's rounding points.
//
// What bounds it on an H100: the row logits and the az product, 2 x bn x
// (kf + rrp) flops per (query, tile), on the tensor cores (the flagship's
// sem family, 10,112 padded queries x 32 tiles of 512 rows x (256 + 128),
// is ~127 GFLOP), then the exponentials, one per query and row: 16 times
// the scan's at the flagship's 16 rows a group.  The bytes are the selected
// key and z rows, re-read by every 64-query block that selects the tile
// (from L2 where neighbouring blocks share tiles).
//
// Layout.  A block owns BM = 64 queries (one wgmma M) and one segment of
// its query block's tile list, and walks the segment's rows in steps of
// BN = 64 (a tile of no whole number of steps, 96 or 160 rows, ends in a
// masked step: its TMA box still loads 64 rows, those past the tile, of
// the next tile or zero fill past N, get p = 0, and the groups' walk counts
// only the step's units inside the tile).  Four warpgroups (512 threads,
// one block an SM):
//   * warpgroup 0, the logits: wgmma m64n64k16 with the query block and the
//     key rows K-major in shared memory (the row logits over the family's
//     kf columns: 1 k16 step for the geo family's 16, 4 a 64-column box),
//     p = exp2(min(l + mask, 86)) in registers, bf16(p) into a 2-stage
//     ring of p tiles (32-byte swizzled [64][16] blocks, wgmma's K-major A
//     layout);
//   * warpgroups 1 and 3, az: wgmma m64nNk16 with A = the p tile and B = the
//     z rows (MN-major, transposed by the instruction), half of rrp each
//     (N = rrp / 2); a lane of warpgroup 3 issues the ring's TMA copies
//     (each step's key boxes, z boxes and mask), into the stage a step
//     frees, so the logits warpgroup issues no copy;
//   * warpgroup 2, the groups: for each chunk of EG groups of a tile (the
//     whole tile up to 32 groups, else 32, or 64 for groups of an odd
//     size, so a chunk ends on a step; where EG does not divide the tile's
//     groups, as 64 does not 96, 160, 224 ..., the last chunk holds the
//     rest and ends where the tile ends: on a step or in its masked last
//     step), e on wgmma m64nEGk16 from the chunk's
//     centroids (one TMA copy, issued by its first thread one chunk ahead)
//     into f32 shared memory; then, step by step, the step's sums of
//     bf16(p) over units of u = gcd(gsz, 64) rows on wgmma, ps = P [64 x 64
//     rows] @ S [64 rows x NG], S the 0/1 segment matrix built once in
//     shared memory (JAX's segment product: f32 sums of the bf16 values);
//     at each group's end D into the segment's D block in shared memory
//     (the A layout of the p tiles).  A group of one unit (gsz divides 64)
//     ends inside the step; a group of whole steps (gsz a multiple of 64)
//     carries its sum in the accumulator across its steps; any other group
//     (96 rows: 3 units of 32, ending inside a step) has its units' sums
//     added in order through shared memory, a thread a query row.  (Summing
//     the rows element by element on the CUDA cores took ~3.5 us a step and
//     paced the kernel: PERF.md.)
//   The group part runs in the same walk: no second pass over the tiles and
//   no group sums in device memory.  Groups whose unit is one row (odd gsz,
//   gsz 1) and whose layout does not fit beside the ring otherwise (64 or
//   more groups a tile) read their unit sums straight from the p tile
//   (the DIRECT walk: the bf16 p of one row is its unit's f32 sum, so no
//   segment matrix and no unit-sum buffer); a tile's D block that does not
//   fit in shared memory at all (groups of 1 row from 192 a tile, of 2 from
//   416, of 4 from 448) goes to a device-memory workspace that the caller
//   allocates, a block's own, in the same 2,048-byte k16 blocks, and phase
//   2 streams each k16 block into the ring beside its vw rows (dglob).  Both
//   live only in the kernel of the rare groupings.
//   * Then all four warpgroups run alr = D [64 x segment's groups] @ vw of
//     the segment's groups, the vw rows streamed by TMA 16 a step (one k16
//     step of D) into the ring's freed memory, the columns in passes of up
//     to 8 boxes of 64 (2 a warpgroup: 64 accumulator registers a thread),
//     so the rr shape's 1,025 columns take 3 passes and no logit is
//     computed twice.  A tile of 8 groups takes 16 rows of vw: the 8 past
//     it meet D's zero columns.
// Every wgmma issue sits between its fence and a wait for all groups, with
// no divergent code between: ptxas keeps them asynchronous (no C7514 or
// C7520).  No block-wide barrier in the walk; ring positions, tile, chunk
// and group ends advance by counters (no division on the logits' chain).
//
// Deep logits (the `high` tier's 768 sem columns, wide-key banks at `fast`:
// row or group logits over more than DEEP_BOXES = 4 boxes, up to 2,048
// columns).  The query block over every column stays resident where it
// fits (96 KB at 768), so a ring stage holding a whole step would not fit
// beside it:
// each step becomes np + 1 ring items, np passes of at most 4 key boxes
// (256 columns) each, then its payload (the z boxes and the mask), in
// stages of one pass's boxes (33 KB).  The logits warpgroup carries the
// accumulator from pass to pass (fresh at the first), so a row's logit is
// one f32 chain of wgmma over every column; the az warpgroups wait and
// release the passes (every consumer warp releases every stage, as
// before) and read the payload.  The group logits likewise take their
// chunk's centroids in passes of 4 boxes through the centroid buffer,
// each pass loaded once every warp is done with the one before.  Where
// the query block over every column does not fit (past 768 columns at the
// flagship's grouping), its first `res` boxes (a multiple of 4) stay
// resident and the columns past them take passes of 2 boxes whose 2 query
// boxes ride the ring stage beside the key boxes (row logits) or a buffer
// of their own beside the centroids (group logits): `deep_pass`,
// sm90_common.cuh.  The deep instances are kernels of their own (DEEP):
// the others compile as before.  The rounding points, the group walk and
// the segments are those of the one-pass kernel.
//
// Segments.  The plan (ops/retrieval_hier._parts_plan, a function of the
// shape alone) cuts each list into n_seg segments of whole tiles, enough
// blocks to fill the card's 132 SMs, none over 12,800 rows (one wgmma
// accumulation chain: the dense kernel's SEG_ROWS_MAX) and none with more
// groups than the D block holds.  A block drops its row's dedup_pad
// repeats first (a repeat across a segment boundary too), then takes its
// share of the distinct entries: segment s the entries [s n / n_seg,
// (s + 1) n / n_seg).  With
// more than one segment each block writes its partial rows to a plane of a
// workspace [n_seg, Bp, out_w] and parts_reduce_kernel adds the planes in
// segment order (no atomics: the same request gets the same bits).  The
// tiles are independent (ps, cnt and D belong to one tile), so a segment
// changes only the order of the f32 additions.
//
// Ragged edges: TMA zero-fills columns past the family's kf / gw (a zero
// column adds 0 to every logit) and rows past the operands; the masked last
// step of a tile of no whole number of steps sets p = 0 past the tile.  A wait on a
// barrier that never completes traps after ~10 s instead of hanging the
// card.

#include <algorithm>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;          // queries a block: one wgmma M
constexpr int BN = 64;          // bank rows a step: one wgmma N of the row logits
constexpr int THREADS = 512;    // four warpgroups
constexpr int BOXB = BM * 128;  // one 64-column box of 64 rows: 8 KB
constexpr int PST = BN / 16 * 2048;  // one p tile: [4 k16 blocks][64 rows][32 B]
constexpr int PASS_BOXES = 8;   // alr boxes of 64 columns a pass: 2 a warpgroup
constexpr int DEEP_BOXES = DEEP_PASS;  // logit boxes of one pass of a deep chain: 256 columns
constexpr int MAX_BOXES = 32;   // logit columns at most: 2,048
constexpr int SQ = DEEP_STREAM * BOXB;  // a streamed pass's query boxes within its stage
constexpr float CLAMP2 = 86.0f;
enum { K_COMMON, K_RARE, K_DIRECT };  // the kernel's instances (`groups_any`)

// The launch's shapes and plan, and the shared-memory layout, which the
// caller gives (`_parts_layout` in ops/retrieval_hier.py; offsets from the
// 1024-byte aligned base): the query block [kb boxes], the group query
// block [kbg boxes] (unless it is the query block's), S stages of [kb key
// boxes | nz z boxes | mask], two p tiles, the chunk's centroids [kbg boxes
// of EG rows], its exponentials [64][EG + 1] f32 and counts [EG], the unit
// sums [64][NG + 1] f32 (groups of several units ending inside a step
// only), the segment matrix [NG][64] bf16, the D block [seg_cap x gp16 / 16
// blocks of 2048 B], the tile list, barriers.
// Phase 2 overlays the S stages with S2 stages of [pb boxes of 16 vw rows].
struct Prm {
  const __nv_bfloat16* vw;  // [G, W]: the counts (column lrr)
  const int* idx;           // [nB, K]
  float* out;               // [Bp, out_w], or the planes [n_seg, Bp, out_w]
  size_t plane;             // floats between two planes (0: one segment)
  int n_qb, n_seg, K, bm, bn, gpt, gsz, dedup;
  int kb, kbg, share, nz;   // boxes: logits, group logits (share: the query block's), z
  int ks, ksg;              // k16 steps of the row logits and of the group logits
  int np, npg;              // passes of the row and of the group logits (1: all at once)
  int qres, gres;           // query and group query boxes resident (deep: the rest stream)
  int nsub;                 // ring items a step: np key passes, then (deep) the payload
  int EG, NG, chunks, chunk_steps, gp16;
  int eg_last, cs_last;      // groups and steps of a tile's last chunk
  int lu, nu, upg;          // units of 2^lu rows: nu a step, upg a group
  int spt, last_rows, nu_last;  // steps a tile; rows and units of its last step
  int direct, dglob;        // unit sums read from the p tile; the D block in device memory
  uint8_t* dgw;             // dglob: the D blocks [blocks][dblock bytes]
  size_t dblock;
  int W, lrr, out_w, zoff, aoff, acols, zlo, zn;
  float asign;              // +1: alr; -1: [acc | d] -= D @ vw
  int abox, pb, n_pass, S, S2;
  uint32_t q, qg, ring, stage, kz, msk, p, g, e, cnt, us, sm, d, lst, bars, total;
  uint32_t gqs;             // a streamed group pass's query boxes (past the centroids)
};

// One block's share: its query block and segment, its list entries, and
// the barriers' addresses.
struct Blk {
  int qb, lo, n;
  uint32_t base, bq, full, empty, pfull, pempty, gbar, vfull;
};

// A step's place in a ring of n stages: its stage and the parity of that
// stage's phase, advanced step by step (no division in the loops).
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// This warp is done with a stage: one arrive on its empty barrier.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void wg_sync(int id) {  // one warpgroup's threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Byte offset of element (row m, column k) in [64][16] bf16 blocks,
// 32-byte swizzled: m * 32 + 16 ((k / 8) ^ ((m / 4) & 1)) + 2 (k % 8).
__device__ __forceinline__ uint32_t sw32(int m, int k) {
  return (k >> 4) * 2048 + m * 32 + (((((k & 15) >> 3) ^ (m >> 2)) & 1) << 4) + (k & 7) * 2;
}

// d[4] (+)= A[64 x 16] B[16 x 8], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>  // K-major A and B, N columns
__device__ __forceinline__ void wgmma_k(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 8) {
    wgmma_ss_n8(d, a, b, scale_d);
  } else if constexpr (N == 16) {
    wgmma_ss_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else {
    wgmma_ss_n64(d, a, b, scale_d);
  }
}

template <int N>  // K-major A, MN-major B, N columns
__device__ __forceinline__ void wgmma_t(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_ss_n64_t(d, a, b, 1);
  } else {
    wgmma_ss_n128_t(d, a, b, 1);
  }
}

// The k16 steps of a logits' depth of `width` columns: 1 where it is one
// k16 step (the geo family's 16 columns), else 4 a 64-column box (the
// columns past the width zero-filled).
__host__ __device__ constexpr int k16_steps(int width) { return width <= 16 ? 1 : 4 * ((width + 63) / 64); }

// ---- the ring's producer: ring item `sub` of step `row` into stage s (a
// lane of warpgroup 3): the step's key boxes, z boxes and mask; deep (np >
// 1): a pass's key boxes (sub < np; a streamed pass's query boxes SQ
// bytes in), or the payload, z boxes and mask
template <bool DEEP>
__device__ __forceinline__ void load_step(const Prm& P, const Blk& b, const CUtensorMap* tq,
                                          const CUtensorMap* tk, const CUtensorMap* tz,
                                          const CUtensorMap* tm, int row, int sub, int s) {
  const uint32_t st = b.base + P.ring + s * P.stage, full = b.full + 8 * s;
  if (DEEP && P.np > 1 && sub < P.np) {
    int b0, nb;
    const bool sq = deep_pass(sub, P.kb, P.qres, b0, nb);
    mbar_expect_tx(full, (sq ? 2 : 1) * nb * BOXB);
    for (int i = 0; i < nb; ++i) tma_2d(st + i * BOXB, tk, BOX * (b0 + i), row, full);
    if (sq)
      for (int i = 0; i < nb; ++i) tma_2d(st + SQ + i * BOXB, tq, BOX * (b0 + i), b.qb * BM, full);
    return;
  }
  const int kb = DEEP && P.np > 1 ? 0 : P.kb;
  mbar_expect_tx(full, (kb + P.nz) * BOXB + BN * 4);
  for (int i = 0; i < kb; ++i) tma_2d(st + i * BOXB, tk, BOX * i, row, full);
  tma_3d(st + P.kz, tz, 0, row, 0, full);
  tma_1d(st + P.msk, tm, row, full);
}

// The centroids of chunk c of list tile `tile` (warpgroup 2's first
// thread): every box, or (DEEP, npg > 1) pass `pass`'s of them, with a
// streamed pass's group query boxes (tqg) into their buffer
template <bool DEEP>
__device__ __forceinline__ void load_g(const Prm& P, const Blk& b, const CUtensorMap* tg,
                                       const CUtensorMap* tqg, int tile, int c, int pass) {
  const int row = tile * P.gpt + c * P.EG;
  int b0 = 0, nb = P.kbg;
  const bool sq = DEEP && P.npg > 1 && deep_pass(pass, P.kbg, P.gres, b0, nb);
  mbar_expect_tx(b.gbar, nb * (P.EG * 128 + (sq ? BOXB : 0)));
  for (int i = 0; i < nb; ++i)
    tma_2d(b.base + P.g + i * P.EG * 128, tg, BOX * (b0 + i), row, b.gbar);
  if (sq)
    for (int i = 0; i < nb; ++i)
      tma_2d(b.base + P.gqs + i * BOXB, tqg, BOX * (b0 + i), b.qb * BM, b.gbar);
}

// ---- warpgroup 0, the logits
// sc (+)= the query boxes at qa . the stage's key boxes at kst over KS k16
// steps, fresh at `first`
template <int KS>
__device__ __forceinline__ void row_chain(float (&sc)[BN / 2], uint32_t qa, uint32_t kst,
                                          bool first) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks & 3) * 32;  // k16 step within the 128-byte row
    wgmma_ss_n64(sc, desc_k128(qa + (ks >> 2) * BOXB + off),
                 desc_k128(kst + (ks >> 2) * BOXB + off), first && ks == 0 ? 0 : 1);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(sc);
}

template <int KS, bool DEEP>
__device__ __forceinline__ void logits(const Prm& P, const Blk& b, int steps) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8 of the block
  float sc[BN / 2];
  Ring ring;
  int sub = 0;  // the step within its tile
  mbar_wait(b.bq, 0);
  for (int it = 0; it < steps; ++it) {
    if (DEEP && P.np > 1) {  // the row logits in passes of DEEP_BOXES boxes, a ring item each
      for (int pass = 0; pass < P.np; ++pass) {
        const int s = ring.stage;
        int b0, nb;
        const bool sq = deep_pass(pass, P.kb, P.qres, b0, nb);
        mbar_wait(b.full + 8 * s, ring.phase);
        const uint32_t kst = b.base + P.ring + s * P.stage;
        const uint32_t qa = sq ? kst + SQ : b.base + P.q + b0 * BOXB;
        switch (nb) {
          case 1: row_chain<4>(sc, qa, kst, pass == 0); break;
          case 2: row_chain<8>(sc, qa, kst, pass == 0); break;
          case 3: row_chain<12>(sc, qa, kst, pass == 0); break;
          default: row_chain<16>(sc, qa, kst, pass == 0); break;
        }
        release(b.empty + 8 * s);
        ring.next(P.S);
      }
    }
    const int s = ring.stage;  // the step's last item: its keys (or payload) and mask
    mbar_wait(b.full + 8 * s, ring.phase);
    const uint32_t kst = b.base + P.ring + s * P.stage;
    if (!DEEP || P.np == 1) row_chain<KS>(sc, b.base + P.q, kst, true);
    // accumulator element 4j + e is row r0 + 8 (e >> 1), column 8j + 2t + (e & 1):
    // the mask of columns 8j + 2t, + 1
    float2 m[BN / 8];
    {
      const float2* ms = reinterpret_cast<const float2*>(__cvta_shared_to_generic(kst + P.msk));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) m[j] = ms[4 * j + t];
    }
    if (++sub == P.spt) {
      sub = 0;
      if (P.last_rows < BN) {  // the tile's masked last step: p = 0 past the tile
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * t;
          if (c >= P.last_rows) m[j].x = -1e30f;
          if (c + 1 >= P.last_rows) m[j].y = -1e30f;
        }
      }
    }
    release(b.empty + 8 * s);
    ring.next(P.S);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + 2 * e] = exp2f(fminf(sc[4 * j + 2 * e] + m[j].x, CLAMP2));
        sc[4 * j + 2 * e + 1] = exp2f(fminf(sc[4 * j + 2 * e + 1] + m[j].y, CLAMP2));
      }
    const int ps = it & 1;
    mbar_wait(b.pempty + 8 * ps, ((it >> 1) & 1) ^ 1);
    const uint32_t pst = b.base + P.p + ps * PST;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t v = pack_bf16(sc[4 * j + 2 * e], sc[4 * j + 2 * e + 1]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(pst + sw32(r0 + 8 * e, 8 * j + 2 * t)),
                     "r"(v)
                     : "memory");
      }
    // visible to the tensor cores' (async proxy) reads, then released
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(b.pfull + 8 * ps);
  }
}

// ---- warpgroups 1 and 3, az: NZB boxes of z from box zb0; `producer`, a
// lane of warpgroup 3, issues the ring's copies
template <int NZB, bool DEEP>
__device__ __forceinline__ void az(const Prm& P, const Blk& b, const CUtensorMap* tq,
                                   const CUtensorMap* tqg, const CUtensorMap* tk,
                                   const CUtensorMap* tz, const CUtensorMap* tm, int zb0,
                                   bool producer, int steps, float* out) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int spt = P.spt;
  const int* lst = reinterpret_cast<const int*>(__cvta_shared_to_generic(b.base + P.lst));
  float acc[NZB * 32];
#pragma unroll
  for (int i = 0; i < NZB * 32; ++i) acc[i] = 0.f;
  // the next item to load: list slot, step within the tile, ring item of the step
  int lj = 0, lsub = 0, li = 0;
  const int nsub = DEEP ? P.nsub : 1;
  const int items = steps * nsub;
  auto load_next = [&](int s) {
    load_step<DEEP>(P, b, tq, tk, tz, tm, lst[b.lo + lj] * P.bn + lsub * BN, li, s);
    if (++li == nsub) {
      li = 0;
      if (++lsub == spt) {
        lsub = 0;
        ++lj;
      }
    }
  };
  if (producer) {  // the query block (and the group query block), the first stages
    mbar_expect_tx(b.bq, (P.qres + (P.share ? 0 : P.gres)) * BOXB);
    for (int i = 0; i < P.qres; ++i)
      tma_2d(b.base + P.q + i * BOXB, tq, BOX * i, b.qb * BM, b.bq);
    if (!P.share)
      for (int i = 0; i < P.gres; ++i)
        tma_2d(b.base + P.qg + i * BOXB, tqg, BOX * i, b.qb * BM, b.bq);
    for (int s = 0; s < P.S && s < items; ++s) load_next(s);
  }
  __syncwarp();
  Ring ring;
  int ii = 0;  // items done
  for (int it = 0; it < steps; ++it) {
    for (int pass = 0; pass + 1 < nsub; ++pass, ++ii) {  // deep: the key passes, not read here
      const int s = ring.stage;
      mbar_wait(b.full + 8 * s, ring.phase);
      release(b.empty + 8 * s);
      if (producer && ii + P.S < items) {
        mbar_wait(b.empty + 8 * s, ring.phase);
        load_next(s);
      }
      ring.next(P.S);
      __syncwarp();
    }
    const int s = ring.stage, ps = it & 1;
    mbar_wait(b.full + 8 * s, ring.phase);
    mbar_wait(b.pfull + 8 * ps, (it >> 1) & 1);
    const uint32_t zst = b.base + P.ring + s * P.stage + P.kz + zb0 * BOXB;
    const uint32_t pst = b.base + P.p + ps * PST;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_t<64 * NZB>(acc, desc_k32(pst + kk * 2048), desc_v(zst + kk * 2048, BN));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    release(b.empty + 8 * s);
    release(b.pempty + 8 * ps);
    // the next load into the stage this step read, once every reader is done
    if (producer && ii + P.S < items) {
      mbar_wait(b.empty + 8 * s, ring.phase);
      load_next(s);
    }
    ++ii;
    ring.next(P.S);
    __syncwarp();
  }
  // rows r0 and r0 + 8 of each n8 chunk j: az columns zb0 * 64 + 8j + 2t, + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = out + (size_t)(b.qb * BM + 16 * warp + g + 8 * h) * P.out_w + P.zoff +
                 zb0 * BOX + 2 * t;
#pragma unroll
    for (int j = 0; j < NZB * 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ---- warpgroup 2, the groups
// acc (+)= the group query boxes at qg . the chunk's centroid boxes at gb
// (EG rows each) over KSG k16 steps, fresh at `first`
template <int EG, int KSG>
__device__ __forceinline__ void chunk_chain(float (&acc)[EG / 2], uint32_t qg, uint32_t gb,
                                            bool first) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KSG; ++ks) {
    const uint32_t off = (ks & 3) * 32;
    wgmma_k<EG>(acc, desc_k128(qg + (ks >> 2) * BOXB + off),
                desc_k128(gb + (ks >> 2) * (EG * 128) + off), first && ks == 0 ? 0 : 1);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// A chunk's exponentials e = exp2(min(q_g . g, 86)) [64 x EG] into e_s
// (f32) from its group logits acc
template <int EG>
__device__ __forceinline__ void chunk_exp(const float (&acc)[EG / 2], float* e_s) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < EG / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      e_s[(16 * warp + g + 8 * (e >> 1)) * (EG + 1) + 8 * jj + 2 * t + (e & 1)] =
          exp2f(fminf(acc[4 * jj + e], CLAMP2));
}

// A chunk's exponentials, on wgmma over the group logits' depth: its
// centroids waited at the barrier (gpar its phase), all at once, or (npg >
// 1) in passes through the centroid buffer (`deep_pass`; a streamed pass's
// group query boxes through their buffer beside it), each
// loaded once every warp is done with the one before (the first a chunk
// ahead, as the whole chunk is otherwise), the accumulator carried: one
// f32 chain over every column.  (Taking a pass box by box, one instance
// for every depth, made ptxas spill more.)
template <int EG, bool DEEP>
__device__ __forceinline__ void chunk_e_any(const Prm& P, const Blk& b, const CUtensorMap* tg,
                                            const CUtensorMap* tqg, int j, int c, int& gpar,
                                            float* e_s) {
  const uint32_t qg = b.base + (P.share ? P.q : P.qg), gb = b.base + P.g;
  const int npg = DEEP ? P.npg : 1;
  float acc[EG / 2];
  for (int pass = 0; pass < npg; ++pass) {
    int b0 = 0, nb = P.kbg;
    const bool sq = npg > 1 && deep_pass(pass, P.kbg, P.gres, b0, nb);
    if (pass > 0) {
      wg_sync(1);
      if ((threadIdx.x & 127) == 0) {
        const int* lst = reinterpret_cast<const int*>(__cvta_shared_to_generic(b.base + P.lst));
        load_g<DEEP>(P, b, tg, tqg, lst[b.lo + j], c, pass);
      }
    }
    mbar_wait(b.gbar, gpar);
    gpar ^= 1;
    const int ksg = npg > 1 ? 4 * nb : P.ksg;
    const uint32_t qp = sq ? b.base + P.gqs : qg + b0 * BOXB;
    switch (ksg) {
      case 1: chunk_chain<EG, 1>(acc, qp, gb, pass == 0); break;
      case 4: chunk_chain<EG, 4>(acc, qp, gb, pass == 0); break;
      case 8: chunk_chain<EG, 8>(acc, qp, gb, pass == 0); break;
      case 12: chunk_chain<EG, 12>(acc, qp, gb, pass == 0); break;
      default: chunk_chain<EG, 16>(acc, qp, gb, pass == 0); break;
    }
  }
  chunk_exp<EG>(acc, e_s);
}

// EG groups a chunk; NG columns of a step's unit sums: ps = bf16(p) @ S on
// wgmma, S [NG units x 64 rows] the 0/1 segment matrix (JAX's segment
// product), unit c of the step holding rows [c u, (c + 1) u).  A group of
// one unit ends at its column; a group of whole steps (nu = 1) carries its
// sum in the accumulator across its steps; a group of several units ending
// inside a step adds its units' sums through shared memory (UNITS: only
// the kernel built for such groups holds that path).  DIRECT (units of one
// row, in that kernel alone): no product, the unit sums are the p tile's
// bf16 values.  A tile's masked last step counts its nu_last units only.
template <int EG, int NG, bool UNITS, bool DIRECT, bool DEEP>
__device__ __forceinline__ void groups(const Prm& P, const Blk& b, const CUtensorMap* tg,
                                       const CUtensorMap* tqg, int steps) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int* lst = reinterpret_cast<const int*>(__cvta_shared_to_generic(b.base + P.lst));
  float* e_s = reinterpret_cast<float*>(__cvta_shared_to_generic(b.base + P.e));
  float* cnt_s = reinterpret_cast<float*>(__cvta_shared_to_generic(b.base + P.cnt));
  float* us_s = reinterpret_cast<float*>(__cvta_shared_to_generic(b.base + P.us));
  const int lde = EG + 1, ldu = NG + 1;
  if (tid == 0) load_g<DEEP>(P, b, tg, tqg, lst[b.lo], 0, 0);
  if constexpr (!DIRECT) {  // the segment matrix, K-major and 128-byte swizzled: (unit
                            // c, row r) at c * 128 + 16 ((r / 8) ^ (c % 8)) + 2 (r % 8)
    uint8_t* sm = reinterpret_cast<uint8_t*>(__cvta_shared_to_generic(b.base + P.sm));
    for (int i = tid; i < NG * BN; i += 128) {
      const int c = i / BN, r = i % BN;
      *reinterpret_cast<__nv_bfloat16*>(sm + c * 128 + ((((r >> 3) ^ (c & 7))) << 4) +
                                        (r & 7) * 2) =
          __float2bfloat16_rn((r >> P.lu) == c ? 1.f : 0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  mbar_wait(b.bq, 0);  // the group query block
  const bool units = UNITS && P.nu > 1 && P.upg > 1;  // groups of several units in a step
  const int ng = units ? 0 : P.nu;            // groups that end at a full step's end
  const int gsteps = P.nu == 1 ? P.upg : 1;   // steps a group spans
  // D = bf16(e - ps / max(cnt, 1)) of (query row r, D column col): into the
  // D block in shared memory, or (dglob) this block's in device memory
  const uint32_t dst = b.base + P.d;
  uint8_t* dgb = nullptr;
  if constexpr (UNITS) dgb = P.dglob ? P.dgw + blockIdx.x * P.dblock : nullptr;
  auto put_d = [&](int r, int col, float dv) {
    const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(dv));
    if constexpr (UNITS) {
      if (dgb != nullptr) {
        *reinterpret_cast<unsigned short*>(dgb + sw32(r, col)) = h;
        return;
      }
    }
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst + sw32(r, col)), "h"(h) : "memory");
  };
  // DIRECT: the bf16 p of (row r, column k) of the p tile at pst
  auto p_at = [&](uint32_t pst, int r, int k) {
    unsigned short h;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(h) : "r"(pst + sw32(r, k)) : "memory");
    return __bfloat162float(__ushort_as_bfloat16(h));
  };
  float ps[NG / 2];
#pragma unroll
  for (int i = 0; i < NG / 2; ++i) ps[i] = 0.f;
  int gs = 0;    // steps of the open group done (nu = 1)
  int ci = 0;    // the chunk's groups done
  int dcol = 0;  // the chunk's first column in the D block
  float run = 0.f;  // units: row tid's open group's sum so far, and its units
  int uc = 0;
  int j = 0, c = 0, cs = 0, gpar = 0;  // list slot, chunk of the tile, step of the chunk
  for (int it = 0; it < steps; ++it) {
    if (cs == 0) {  // a chunk begins: its exponentials and counts
      wg_sync(1);   // every thread is done with the previous chunk's
      chunk_e_any<EG, DEEP>(P, b, tg, tqg, j, c, gpar, e_s);
      const int tile = lst[b.lo + j];
      if (tid < EG)  // (a last chunk of fewer groups: the rest are never read)
        cnt_s[tid] = c * EG + tid < P.gpt
                         ? fmaxf(__bfloat162float(
                                     P.vw[(size_t)(tile * P.gpt + c * EG + tid) * P.W + P.lrr]),
                                 1.f)
                         : 1.f;
      wg_sync(1);  // e and the counts visible; the centroid tile is free
      if (tid == 0) {
        if (c + 1 < P.chunks) {
          load_g<DEEP>(P, b, tg, tqg, tile, c + 1, 0);
        } else if (j + 1 < b.n) {
          load_g<DEEP>(P, b, tg, tqg, lst[b.lo + j + 1], 0, 0);
        }
      }
      ci = 0;
      dcol = j * P.gp16 + c * EG;
    }
    // the tile's last step (a chunk of a tile of no whole steps is the tile;
    // its last chunk, of what is left, ends where the tile ends)
    const int csteps = c + 1 == P.chunks ? P.cs_last : P.chunk_steps;
    const bool last = cs + 1 == csteps && c + 1 == P.chunks;
    const int nu_step = last ? P.nu_last : P.nu;
    const int pi = it & 1;
    mbar_wait(b.pfull + 8 * pi, (it >> 1) & 1);
    const uint32_t pst = b.base + P.p + pi * PST, sm = b.base + P.sm;
    if constexpr (!DIRECT) {
      const int cont = gs > 0;  // the open group's sum carries into this step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_k<NG>(ps, desc_k32(pst + kk * 2048), desc_k128(sm + kk * 32),
                    (kk > 0 || cont) ? 1 : 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(ps);
      release(b.pempty + 8 * pi);
    }
    if (units) {  // the step's unit sums, then a thread a row adds its groups' units in order
      if constexpr (!DIRECT) {
#pragma unroll
        for (int jj = 0; jj < NG / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + 2 * t + (e & 1);
            if (col < P.nu) us_s[(16 * warp + g + 8 * (e >> 1)) * ldu + col] = ps[4 * jj + e];
          }
        wg_sync(1);
      }
      if (tid < BM) {
        for (int u = 0; u < nu_step; ++u) {
          run += DIRECT ? p_at(pst, tid, u) : us_s[tid * ldu + u];
          if (++uc == P.upg) {  // D = bf16(e - ps / max(cnt, 1))
            put_d(tid, dcol + ci, e_s[tid * lde + ci] - run / cnt_s[ci]);
            run = 0.f;
            uc = 0;
            ++ci;
          }
        }
      }
      wg_sync(1);  // the unit sums are read
    } else if (++gs == gsteps) {  // the step's groups end here: D = bf16(e - ps / max(cnt, 1))
      gs = 0;
      const int ng_step = last ? P.nu_last : ng;
#pragma unroll
      for (int jj = 0; jj < NG / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1), r = 16 * warp + g + 8 * (e >> 1);
          if (col < ng_step) {
            const int gi = ci + col;
            const float sum = DIRECT ? p_at(pst, r, col) : ps[4 * jj + e];
            put_d(r, dcol + gi, e_s[r * lde + gi] - sum / cnt_s[gi]);
          }
        }
      ci += ng_step;
    }
    if constexpr (DIRECT) release(b.pempty + 8 * pi);  // the p tile is read
    if (++cs == csteps) {
      cs = 0;
      if (++c == P.chunks) {
        c = 0;
        ++j;
      }
    }
  }
  // the D block: visible to phase 2's tensor-core (async proxy) reads, or
  // (dglob) to its bulk copies from device memory
  if (UNITS && P.dglob) {
    asm volatile("fence.proxy.async;\n" ::: "memory");
  } else {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// ---- phase 2, every warpgroup: alr over NB boxes (box0 of the pass on);
// dglob (UNITS only): each step's k16 block of D comes from device memory
// into the ring stage beside its vw rows
template <int NB, bool UNITS>
__device__ __forceinline__ void alr(const Prm& P, const Blk& b, const CUtensorMap* tv,
                                    Ring& ring, int box_lo, int box0, float* out) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool loads = threadIdx.x == 0;
  const int* lst = reinterpret_cast<const int*>(__cvta_shared_to_generic(b.base + P.lst));
  const int kd = P.gp16 / 16, steps = b.n * kd;
  const bool dg = UNITS && P.dglob;
  const uint32_t vbytes = P.pb * 16 * 128, sbytes = vbytes + (dg ? 2048 : 0);
  float acc[NB > 0 ? NB * 32 : 1];
#pragma unroll
  for (int i = 0; i < (NB > 0 ? NB * 32 : 1); ++i) acc[i] = 0.f;
  int lj = 0, lr = 0, ls = 0;  // the next step to load: list slot, k16 block of the tile, step
  Ring lring = ring;
  auto load = [&]() {
    const int s = lring.stage;
    const int row = lst[b.lo + lj] * P.gpt + 16 * lr;
    if (++lr == kd) {
      lr = 0;
      ++lj;
    }
    const uint32_t full = b.vfull + 8 * s, st = b.base + P.ring + s * sbytes;
    mbar_expect_tx(full, sbytes);
    tma_3d(st, tv, 0, row, box_lo, full);
    if (dg) bulk_g2s(st + vbytes, P.dgw + blockIdx.x * P.dblock + ls * 2048, 2048, full);
    ++ls;
    lring.next(P.S2);
  };
  if (loads)
    for (int s = 0; s < P.S2 && s < steps; ++s) load();
  __syncwarp();
  for (int st = 0; st < steps; ++st) {
    const int s = ring.stage;
    mbar_wait(b.vfull + 8 * s, ring.phase);
    if constexpr (NB > 0) {
      const uint32_t stage = b.base + P.ring + s * sbytes, vst = stage + box0 * 2048;
      const uint32_t dsrc = dg ? stage + vbytes : b.base + P.d + st * 2048;
      wgmma_fence();
      wgmma_t<64 * NB>(acc, desc_k32(dsrc), desc_v(vst, 16));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    ring.next(P.S2);
    __syncthreads();  // every warpgroup is done with stage s
    if (loads && st + P.S2 < steps) load();
  }
  if constexpr (NB > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = out + (size_t)(b.qb * BM + 16 * warp + g + 8 * h) * P.out_w + P.aoff;
#pragma unroll
      for (int jj = 0; jj < NB * 8; ++jj) {
        const int c = (box_lo + box0) * BOX + 8 * jj + 2 * t;
        const float a0 = P.asign * acc[4 * jj + 2 * h], a1 = P.asign * acc[4 * jj + 2 * h + 1];
        if (c + 1 < P.acols) {
          *reinterpret_cast<float2*>(row + c) = make_float2(a0, a1);
        } else if (c < P.acols) {
          row[c] = a0;
        }
      }
    }
  }
}

// The (EG, NG) pairs the launch takes: every pair `_parts_groups` gives
// for a tile of a multiple of 64 rows; (16, 16), and (8, 16), (8, 32),
// (16, 32) of the tiles of no whole steps, only in the K_RARE kernel; the
// DIRECT walk (units of one row: NG = 64, any EG) in the K_DIRECT one.
// (The unit-sum path and the (16, 16) pair, inlined beside the common
// groupings, made ptxas spill at 128 registers: the rare groupings get
// kernels of their own.)
template <int MODE, bool DEEP>
__device__ __forceinline__ void groups_any(const Prm& P, const Blk& b, const CUtensorMap* tg,
                                           const CUtensorMap* tqg, int steps) {
  constexpr bool UNITS = MODE == K_RARE;
  if constexpr (MODE == K_DIRECT) {
    if (P.EG == 64) {
      groups<64, 64, true, true, DEEP>(P, b, tg, tqg, steps);
    } else if (P.EG == 32) {
      groups<32, 64, true, true, DEEP>(P, b, tg, tqg, steps);
    } else if (P.EG == 16) {
      groups<16, 64, true, true, DEEP>(P, b, tg, tqg, steps);
    } else {
      groups<8, 64, true, true, DEEP>(P, b, tg, tqg, steps);
    }
  } else if (P.EG == 64) {
    groups<64, 64, UNITS, false, DEEP>(P, b, tg, tqg, steps);
  } else if (P.EG == 8) {
    if (!UNITS || P.NG == 8) {
      groups<8, 8, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    } else if (P.NG == 16) {
      groups<8, 16, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    } else {
      groups<8, 32, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    }
  } else if (P.EG == 16) {
    if (!UNITS || P.NG == 8) {
      groups<16, 8, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    } else if (P.NG == 16) {
      groups<16, 16, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    } else {
      groups<16, 32, UNITS, false, DEEP>(P, b, tg, tqg, steps);
    }
  } else if (P.NG == 8) {
    groups<32, 8, UNITS, false, DEEP>(P, b, tg, tqg, steps);
  } else if (P.NG == 16) {
    groups<32, 16, UNITS, false, DEEP>(P, b, tg, tqg, steps);
  } else {
    groups<32, 32, UNITS, false, DEEP>(P, b, tg, tqg, steps);
  }
}

// MODE: K_COMMON, the common groupings; K_RARE, groups of several units
// ending inside a step and the (16, 16), (8, 16), (8, 32), (16, 32) pairs;
// K_DIRECT, the DIRECT walk; the last two also the D block in device
// memory.  Three kernels, which nvcc compiles in parallel.
template <int MODE, bool DEEP>
__global__ void __launch_bounds__(THREADS, 1)
    hier_parts_family_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tqg,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tz,
                                  const __grid_constant__ CUtensorMap tm,
                                  const __grid_constant__ CUtensorMap tg,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ Prm P0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the launch's parameters read where they lie (the grid constant), not
  // copied into registers: with a copy the 512 threads' 128 registers fell
  // short and the deep and rare instances spilled (92 / 280 and 472 / 832
  // bytes); the reads again after an asm statement that clobbers memory
  // cost no time that shows (PERF.md, section 6)
  const Prm& P = P0;
  Blk b;
  b.base = smem_u32(smem);
  b.qb = blockIdx.x % P.n_qb;  // query block fastest: neighbours share tiles in L2
  const int seg = blockIdx.x / P.n_qb;
  b.bq = b.base + P.bars;
  b.full = b.bq + 8;
  b.empty = b.full + 8 * P.S;
  b.pfull = b.empty + 8 * P.S;
  b.pempty = b.pfull + 16;
  b.gbar = b.pempty + 16;
  b.vfull = b.gbar + 8;
  int* lst = reinterpret_cast<int*>(smem + P.lst);
  int* info = reinterpret_cast<int*>(smem + P.bars + 8 * (6 + 2 * P.S + P.S2));  // lo, n
  const int lb = b.qb * BM / P.bm;  // the query block's list
  for (int i = threadIdx.x; i < P.K; i += THREADS) lst[i] = P.idx[(size_t)lb * P.K + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = P.K;
    if (P.dedup) {  // drop each entry equal to the one before it in the row
      int prev = lst[0];
      n = 1;
      for (int i = 1; i < P.K; ++i) {
        const int v = lst[i];
        if (v != prev) lst[n++] = v;
        prev = v;
      }
    }
    info[0] = (int)((long long)seg * n / P.n_seg);
    info[1] = (int)((long long)(seg + 1) * n / P.n_seg) - info[0];
    mbar_init(b.bq, 1);
    for (int s = 0; s < P.S; ++s) {
      mbar_init(b.full + 8 * s, 1);
      mbar_init(b.empty + 8 * s, 12);  // the logits and az warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(b.pfull + 8 * s, 128);  // every logits thread
      mbar_init(b.pempty + 8 * s, 12);  // the az and group warps
    }
    mbar_init(b.gbar, 1);
    for (int s = 0; s < P.S2; ++s) mbar_init(b.vfull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the D block starts at zero: the columns past a tile's gpt stay so
  for (uint32_t i = threadIdx.x * 16; i < P.lst - P.d; i += THREADS * 16)
    *reinterpret_cast<uint4*>(smem + P.d + i) = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  b.lo = info[0];
  b.n = info[1];
  float* out = P.out + seg * P.plane;
  if (b.n > 0) {
    const int steps = b.n * P.spt;
    const int wg = threadIdx.x / 128;
    if (wg == 0) {
      switch (P.ks) {
        case 1: logits<1, DEEP>(P, b, steps); break;
        case 4: logits<4, DEEP>(P, b, steps); break;
        case 8: logits<8, DEEP>(P, b, steps); break;
        case 12: logits<12, DEEP>(P, b, steps); break;
        default: logits<16, DEEP>(P, b, steps); break;
      }
    } else if (wg == 2) {
      groups_any<MODE, DEEP>(P, b, &tg, &tqg, steps);
    } else {  // warpgroup 1 the first half of z's boxes, 3 the second and the copies
      const int zb0 = wg == 3 ? P.nz / 2 : 0;
      const bool producer = threadIdx.x == 3 * 128;
      if (P.nz == 2) {
        az<1, DEEP>(P, b, &tq, &tqg, &tk, &tz, &tm, zb0, producer, steps, out);
      } else {
        az<2, DEEP>(P, b, &tq, &tqg, &tk, &tz, &tm, zb0, producer, steps, out);
      }
    }
  }
  __syncthreads();  // the walk is done: phase 2 reuses the ring

  // the zero columns (d and the pad, or the pad); an empty segment's rows
  const int zlo = b.n > 0 ? P.zlo : 0, zn = b.n > 0 ? P.zn : P.out_w;
  for (int i = threadIdx.x; i < BM * zn; i += THREADS) {
    const int r = i / zn;
    out[(size_t)(b.qb * BM + r) * P.out_w + zlo + i - r * zn] = 0.f;
  }
  if (b.n == 0) return;
  Ring ring;
  const int wg = threadIdx.x / 128;
  for (int pass = 0; pass < P.n_pass; ++pass) {
    const int box_lo = pass * P.pb, nbox = min(P.pb, P.abox - box_lo);
    // the warpgroups' boxes: as even as may be, the first ones one more
    const int nb = nbox / 4 + (wg < nbox % 4);
    const int box0 = wg * (nbox / 4) + min(wg, nbox % 4);
    if (nb == 0) {
      alr<0, MODE != K_COMMON>(P, b, &tv, ring, box_lo, box0, out);
    } else if (nb == 1) {
      alr<1, MODE != K_COMMON>(P, b, &tv, ring, box_lo, box0, out);
    } else {
      alr<2, MODE != K_COMMON>(P, b, &tv, ring, box_lo, box0, out);
    }
  }
}

// out[q, c] (row stride ld) = sum over s of part[s, q, c] in order s = 0,
// 1, ..., n_seg - 1; part is [n_seg, Bp, W] f32, W % 4 == 0.
__global__ void parts_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int Bp, int W, int n_seg) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int w4 = W / 4;
  if (i >= (size_t)Bp * w4) return;
  const size_t plane = (size_t)Bp * W;
  const float* src = part + i * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_seg; ++s, src += plane) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(out + i * 4) = acc;
}

}  // namespace

// q_cat [Bp, qw] bf16 packed queries: the row logits contract its columns
// [kc0, kc0 + kf) with k_cat's [N, cat_d], the group logits its columns
// [qg0, qg0 + gwe) with the first gwe of g_cat [G, gw] (kf and gwe the
// columns holding the family's real ones, multiples of 16 up to 2,048, in
// passes past 256: the rest add 0).  mask_neg [N] f32, idx [Bp / bm, K] int32 (tiles < N / bn),
// g_vw [G, W] bf16 (W a multiple of 128) with the count in column lrr, z
// [N, rrp] bf16 (rrp 128 or 256).  lr = 1: out [Bp, rrp + 128 + W] = az | 0
// | alr; lr = 0 (g_vw the full-width group value sums, lrr = Dv): out [Bp,
// lrr + 128 + rrp] = -alr[:, :lrr + 1] | 0 | az.  dedup = 1 skips an idx
// entry equal to the one before it in its row.  The plan (`_parts_plan`):
// n_seg segments of each list, of at most seg_cap tiles, S ring stages;
// work holds [n_seg, Bp, out_w] f32 when n_seg > 1.  lay [24] the layout
// (`_parts_layout`): EG, NG, pb, S2, a stage's bytes and its z and mask
// offsets, the offsets q, qg, ring, p, g, e, cnt, us, sm, d, lst, bars and
// the total bytes, then the DIRECT walk (units of one row, EG = NG = 64)
// and dglob (dwork holds each block's D blocks: Bp / 64 x n_seg x seg_cap x
// gpt x 128 bytes, gpt % 16 == 0), the query boxes resident (res: the
// logits' passes past them stream theirs) and the streamed group query
// boxes' offset (gqs).  bn need not be a multiple of 64 (a
// masked last step).  All contiguous and 16-byte aligned.  Returns a CUDA
// error code (cudaErrorInvalidValue for what it does not take, with
// nothing launched).
extern "C" int hier_parts_family_sm90_launch(
    const void* q_cat, const void* k_cat, const void* mask_neg, const void* idx,
    const void* g_cat, const void* g_vw, const void* z, void* out, void* work, void* dwork,
    const void* lay,
    int Bp, int qw, int cat_d, int kc0, int kf, int qg0, int gw, int gwe, int bm, int bn,
    int gpt, int K, int W, int lrr, int rrp, int N, int G, int lr, int dedup, int n_seg,
    int seg_cap, int S, void* stream) {
  if (lay == nullptr || Bp <= 0 || K <= 0 || bm <= 0 || bm % BM || Bp % bm || bn <= 0 ||
      N % bn || gpt < 8 || bn % gpt || (gpt <= 32 ? 32 % gpt : gpt % 32) || kf < 16 ||
      kf > MAX_BOXES * BOX || kf % 16 || kc0 % 8 ||
      kc0 + kf > cat_d || cat_d % 8 || qw < cat_d || qw % 8 || gwe < 16 ||
      gwe > MAX_BOXES * BOX ||
      gwe % 16 || gwe > gw || gw % 8 || qg0 % 8 || qg0 + gwe > qw || (rrp != 128 && rrp != 256) ||
      W <= 0 || W % 128 || lrr < 0 || lrr >= W || (!lr && lrr % 4) || G % gpt || n_seg < 1 ||
      seg_cap < (K + n_seg - 1) / n_seg || S < 2 || S > 4)
    return (int)cudaErrorInvalidValue;
  const int* L = static_cast<const int*>(lay);
  Prm P{};
  P.gpt = gpt;
  P.gsz = bn / gpt;
  // units of u = gcd(gsz, 64) rows: nu a step, upg a group
  P.lu = __builtin_ctz(P.gsz | BN);
  P.nu = BN >> P.lu;
  P.upg = P.gsz >> P.lu;
  // steps a tile, the last one masked past the tile's rows
  P.spt = (bn + BN - 1) / BN;
  P.last_rows = bn - (P.spt - 1) * BN;
  P.nu_last = P.last_rows >> P.lu;
  // a chunk of EG groups ends on a step, or is the tile; NG columns hold a
  // step's units
  P.EG = L[0];
  P.NG = L[1];
  P.direct = L[20];
  P.dglob = L[21];
  const bool rare_pair = (P.EG == 16 && (P.NG == 16 || P.NG == 32)) ||
                         (P.EG == 8 && (P.NG == 16 || P.NG == 32));
  if (P.EG <= 0 || P.EG > gpt || ((P.EG * P.gsz) % BN && P.EG != gpt) || P.NG < P.nu ||
      !((P.EG == 8 && P.NG == 8) || (P.EG == 16 && P.NG == 8) ||
        (P.EG == 32 && (P.NG == 8 || P.NG == 16 || P.NG == 32)) ||
        (P.EG == 64 && P.NG == 64) || rare_pair || P.direct) ||
      (P.direct && (P.NG != 64 || P.lu != 0)) ||
      (P.dglob && (gpt % 16 || dwork == nullptr || !aligned16(dwork))))
    return (int)cudaErrorInvalidValue;  // the (EG, NG) pairs groups_any takes
  // chunks of EG groups, each ending on a step (or the tile); the last holds
  // the gpt mod EG left over (if any), from its step to the tile's end
  P.chunks = (gpt + P.EG - 1) / P.EG;
  P.chunk_steps = (P.EG * P.gsz + BN - 1) / BN;
  P.eg_last = gpt - (P.chunks - 1) * P.EG;
  P.cs_last = P.spt - (P.chunks - 1) * P.chunk_steps;
  P.gp16 = (gpt + 15) / 16 * 16;
  P.vw = static_cast<const __nv_bfloat16*>(g_vw);
  P.idx = static_cast<const int*>(idx);
  P.n_qb = Bp / BM;
  P.n_seg = n_seg;
  P.K = K;
  P.bm = bm;
  P.bn = bn;
  P.dedup = dedup;
  P.kb = (kf + BOX - 1) / BOX;
  P.ks = k16_steps(kf);
  P.kbg = (gwe + BOX - 1) / BOX;
  P.ksg = k16_steps(gwe);
  P.share = qg0 == kc0 && gwe <= kf;
  P.nz = rrp / BOX;
  // logits over more than DEEP_BOXES boxes: passes (the row logits' a ring
  // item each, then the payload; the group logits' through the centroid buffer)
  // (the first `res` boxes of each query block resident, the passes past
  // them streaming theirs: a multiple of DEEP_BOXES)
  const int res = L[22];
  P.qres = std::min(P.kb, res);
  P.gres = std::min(P.kbg, res);
  if (res < 1 || (res < std::max(P.kb, P.kbg) && res % DEEP_BOXES))
    return (int)cudaErrorInvalidValue;
  P.np = P.kb > DEEP_BOXES ? deep_passes(P.kb, P.qres) : 1;
  P.npg = P.kbg > DEEP_BOXES ? deep_passes(P.kbg, P.gres) : 1;
  P.nsub = P.np > 1 ? P.np + 1 : 1;
  P.W = W;
  P.lrr = lrr;
  if (lr) {  // az | 0 (128) | alr
    P.out_w = rrp + 128 + W;
    P.zoff = 0;
    P.aoff = rrp + 128;
    P.acols = W;
    P.asign = 1.f;
    P.zlo = rrp;
    P.zn = 128;
  } else {  // -alr[:, :lrr + 1] | 0 (127) | az
    P.out_w = lrr + 128 + rrp;
    P.zoff = lrr + 128;
    P.aoff = 0;
    P.acols = lrr + 1;
    P.asign = -1.f;
    P.zlo = lrr + 1;
    P.zn = 127;
  }
  P.abox = (P.acols + BOX - 1) / BOX;
  P.pb = L[2];
  P.n_pass = P.pb > 0 ? (P.abox + P.pb - 1) / P.pb : 0;
  P.S = S;
  P.S2 = L[3];
  // a stage's size and its z and mask offsets, then the regions' offsets
  uint32_t* off[] = {&P.stage, &P.kz, &P.msk, &P.q,  &P.qg, &P.ring, &P.p,    &P.g,
                     &P.e,     &P.cnt, &P.us, &P.sm, &P.d,  &P.lst,  &P.bars, &P.total};
  for (int i = 0; i < 16; ++i) {
    if (L[4 + i] < 0) return (int)cudaErrorInvalidValue;
    *off[i] = (uint32_t)L[4 + i];
  }
  // the layout's order, the alignment of what TMA and wgmma read, its size
  // (the sizes of its parts are the caller's)
  // a stage: [key boxes | z boxes | mask]; deep: [a pass's key boxes, or
  // the payload's z boxes (kz = 0) | mask]
  bool in_order = P.pb >= 1 && P.pb <= PASS_BOXES && P.S2 >= 2 && P.S2 <= 4 &&
                  P.kz < P.msk && P.msk < P.stage &&
                  (P.np > 1 ? P.kz == 0 && P.msk >= (uint32_t)(P.nz > DEEP_BOXES ? P.nz : DEEP_BOXES) * BOXB
                            : P.kz >= (uint32_t)P.kb * BOXB && P.msk >= P.kz + P.nz * BOXB);
  for (int i = 4; i < 16; ++i) in_order = in_order && *off[i] >= *off[i - 1];
  // the query boxes: resident ones before the ring, a streamed group pass's
  // in their buffer between the centroids and the exponentials
  P.gqs = (uint32_t)L[23];
  in_order = in_order && P.qg >= P.q + P.qres * BOXB &&
             P.ring >= P.qg + (P.share ? 0 : P.gres * BOXB) &&
             (P.gres == P.kbg ||
              (P.gqs >= P.g + DEEP_BOXES * P.EG * 128 && P.e >= P.gqs + SQ && P.gqs % 1024 == 0));
  if (!in_order || (P.ring | P.stage | P.kz | P.p | P.g | P.sm | P.d) % 1024 ||
      (P.e | P.cnt | P.us | P.lst | P.bars) % 16 || P.total > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, out};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  if (n_seg > 1 && (work == nullptr || !aligned16(work))) return (int)cudaErrorInvalidValue;
  P.out = static_cast<float*>(n_seg > 1 ? work : out);
  P.plane = n_seg > 1 ? (size_t)Bp * P.out_w : 0;
  P.dgw = static_cast<uint8_t*>(dwork);
  P.dblock = (size_t)seg_cap * P.gp16 * 128;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;

  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(q_cat);
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tqg, tk, tz, tm, tg, tv;
  bool ok = map_2d(&tq, q + kc0, kf, Bp, qw, BOX, BM, sw) &&
            map_2d(&tk, static_cast<const bf*>(k_cat) + kc0, kf, N, cat_d, BOX, BN, sw) &&
            map_3d_boxes(&tz, z, rrp, N, rrp, BN, P.nz) && map_1d(&tm, mask_neg, N, BN) &&
            map_2d(&tg, g_cat, gwe, G, gw, BOX, P.EG, sw) &&
            map_3d_boxes(&tv, g_vw, W, G, W, 16, P.pb);
  if (P.share) {
    tqg = tq;  // the group logits' columns are the row logits'
  } else {
    ok = ok && map_2d(&tqg, q + qg0, gwe, Bp, qw, BOX, BM, sw);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rare = (P.nu > 1 && P.upg > 1) || rare_pair || P.dglob;
  // logits over more than DEEP_BOXES boxes: the deep instances
  const bool deep = P.np > 1 || P.npg > 1;
  const auto kernel =
      P.direct ? (deep ? hier_parts_family_sm90_kernel<K_DIRECT, true>
                       : hier_parts_family_sm90_kernel<K_DIRECT, false>)
      : rare   ? (deep ? hier_parts_family_sm90_kernel<K_RARE, true>
                       : hier_parts_family_sm90_kernel<K_RARE, false>)
               : (deep ? hier_parts_family_sm90_kernel<K_COMMON, true>
                       : hier_parts_family_sm90_kernel<K_COMMON, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<P.n_qb * n_seg, THREADS, P.total, s>>>(tq, tqg, tk, tz, tm, tg, tv, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  const size_t n = (size_t)Bp * P.out_w / 4;
  parts_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(out), Bp, P.out_w, n_seg);
  return (int)cudaGetLastError();
}


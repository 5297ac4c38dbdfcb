// Hierarchical retrieval, stage 2 over the bank's values, for Hopper
// (sm_90a): exact minus group approximation over each query block's
// selected tiles, with wgmma on every product, a TMA ring under mbarriers
// over the tile list, and lists split across blocks.
//
// Replaces: range_tpu/ops/retrieval_hier.py,
//   * :2515 `_hier_parts_kernel` (reached via _hier_parts_call <-
//     _hier_partials_merged <- retrieve_hier, the merged branch: RANGE mode,
//     RANGE+ with k_geo = 0 on banks without res_rank, the two-level feature
//     path), both families or only sem (geo = 0), lr or plain sem groups,
//     bf16 values or int8 codes with a row scale;
//   * :2282 `_hier_parts_family_kernel`'s value shapes (the `else` branch at
//     :2379-2399: no rr; reached via _hier_parts_family_call <-
//     _hier_partials, the family split on banks without res_rank): one
//     family, sem or geo, lr or plain, the sel form (the sem family's group
//     logits from the query operand's last gw columns, the rank-k sketch
//     appended past cat_d) and the dedup_pad form (a list entry equal to the
//     one before it dropped before the list is split), bf16 or int8.
// The rr shapes are `hier_parts_family_sm90.cu`.  For each query and each
// tile of its block's list, for each family f of the launch (sem: the row
// logits over the packed columns [0, sem_d), the group logits over the
// query's first sem_d columns, or with sel its last gw; geo: both over the
// 16 columns from sem_d, the fast tier's 9 real hi/lo columns and zero
// padding):
//   p_f   = exp2(min(q_f . k_f + mask, 86))   over the tile's bn rows
//   d_f  += sum p_f
//   acc_f += bf16(p_f * s) @ v        (s = the row's int8 scale, else 1)
//   e_f   = bf16(exp2(min(q_f . g_f, 86)))    over the tile's gpt_f groups
// and the group approximation e_f @ vw_f either taken from [acc_f | d_f]
// (full-width group value sums, the count in column Dv: the plain
// families) or added into alr (lr: the low-rank coefficients, subtracted
// outside).  These are the TPU kernels' rounding points.
// Out [Bp, nfo Dv + 128 (+ W_alr)] f32:
//   merged (nfo = 2): acc_s | acc_g | d_s | d_g | 0 (126) [| alr]
//   family (nfo = 1): acc | d | 0 (127) [| alr]
// A merged launch without its geo family writes acc_g and d_g as zeros.
//
// What bounds it on an H100: per (query, selected row) the row logits and
// the value products, 2 x (sem_d + Dv) flops a family, on the tensor cores
// (RANGE's flagship launch, 10,112 padded queries x 32 tiles of 512 rows x
// (256 + 1,024), ~430 GFLOP, ~0.43 ms at the bf16 peak), then the
// exponentials, one per query, row and family.  The bytes are the selected
// key and value rows, re-read by each query block that selects the tile
// (from L2 where neighbouring blocks share tiles).
//
// Layout.  A block owns one DVS = 256-column slice of Dv, or of alr (the
// alr blocks), a query block and one segment of its list, and walks the
// segment's tiles in 64-row steps (a tile of no whole number of steps ends
// in a masked step: the box still loads 64 rows, those past the tile get p
// = 0).  Two warpgroups (256 threads, one block an SM: with 8 warps ptxas
// may give a thread 255 registers, the value accumulator's 128 beside the
// logits' 32; a ninth warp, a producer's, leaves 168, where the kernel
// spills and ptxas serializes its wgmma, C7512):
//   * thread 0 (warpgroup 0: in a two-family launch the sem family, the
//     slower one) is the producer.  It keeps a ring of S stages filled by
//     TMA, addressed by list entry (tile * bn): a step's key boxes (128-byte
//     swizzled 64-column boxes of the sem columns, the 16 geo columns as
//     one 32-byte box), its mask, with int8 codes its scales and codes, and
//     the value slice as 128-byte swizzled boxes; a group chunk's centroids,
//     its vw rows (the slice's columns, or the alr block's) and the count
//     column.  Each stage is signalled by one mbarrier with its byte count
//     and freed by an arrive from each consumer warp; the producer refills
//     a stage once every warp has released it.  Hopper has no scalar
//     prefetch: the block reads its own list row, and drops a dedup_pad
//     repeat before splitting it.  int8 codes land in the second half of
//     the step's value boxes' memory; every consumer thread reads its share,
//     a barrier, then writes them as bf16 (exactly, as
//     fused_retrieval_sm90.cu's converting warps do) into the boxes: the two
//     warpgroups share each converted tile.
//   * warpgroups 0 and 1, the consumers.  Two-family launches (merged,
//     geo = 1) keep the dense kernel's flat layout: 64 queries, warpgroup 0
//     the sem family, 1 the geo family.  One-family launches (merged geo =
//     0, and every family launch) give the two warpgroups the two 64-query
//     halves of a 128-query selection block, which share its list, so each
//     key and value box is read once per 128 queries (bm = 64, or a layout
//     that does not fit: 64 queries, warpgroup 1 idle).  A step: the row
//     logits on wgmma m64n64k16 (queries and keys K-major in shared
//     memory), p = exp2 in registers, the row sums, bf16(p s) as the A
//     fragments of the value wgmma m64n128k16 (B the value boxes, MN-major,
//     transposed by the instruction) into a [64 x 256] f32 accumulator.
//     The two warpgroups' tensor work and exponentials overlap each other.
//   * A plain family's group approximation is computed inside the walk, at
//     each tile's end, by chunks of up to 64 of its groups (the last chunk
//     of a tile holds what is left): e on wgmma m64nEGk16 from the chunk's
//     centroids, the count column's product into d on the CUDA cores,
//     bf16(e) into shared memory (wgmma's K-major A layout), then e @ vw
//     over the slice's columns in four 64-column pieces, each summed in a
//     fresh fragment and taken from the accumulator with an f32 subtract.
//   * lr's alr (<= 512 columns) would not sit in registers beside the
//     value accumulator, so its columns go to blocks of their own (256
//     columns each, after the value slices): they walk the same lists'
//     group chunks only (a tile's gpt groups, 1/gsz of its rows) and add e
//     @ vw straight into their accumulator (a chain of a segment's groups).
//     No block walks its list twice and no row logit is computed twice.
// Every wgmma issue sits between its fence and a wait for all groups, with
// no divergent code between (ptxas keeps them asynchronous: no C7514 or
// C7520); ring positions and list positions advance by counters.
//
// Deep logits (the `high` tier's 768 sem columns, wide-key banks at `fast`:
// sem logits over more than PASS_BOXES = 4 boxes, up to 2,048 columns).
// Each query half over every sem column stays resident where it fits (96
// KB at 768), so 64 queries a block, and a stage holding a whole step
// would not fit beside it: a step becomes np + 1 ring items (`Walk::sub`),
// np passes of at most 4 sem key boxes (256 columns), then its payload (the geo key
// box, the mask and scales, the value boxes, and int8 codes in 16 KB past
// them, converted without a barrier between reads and writes); a sem
// chunk likewise npg passes of 64 centroid rows (the logits' wgmma N),
// then its payload (the counts and vw rows).  A stage holds one pass's
// boxes or, in their place, the payload's (33 to 51 KB).  The accumulator
// is carried from pass to pass, fresh at the first: a row's (or group's)
// logit is one f32 chain over every column.  Where the query half over
// every column does not fit beside the ring (past 1,024 columns, or 1,024
// with int8 codes), its first qres boxes (a multiple of 4) stay resident
// and the columns past them take passes of 2 key boxes whose 2 query
// boxes ride the same stage (`deep_pass`, sm90_common.cuh).  The geo family's logits ride
// the payload as before.  A one-family launch's block pairs two slices
// (value or alr), a warpgroup each: both warpgroups take the block's 64
// queries and every pass (each its own logits), and an item ends in two
// payloads, one a slice, each read by its warpgroup alone; so the keys
// stream once for two slices, where a block of one slice read them once a
// slice with its second warpgroup idle (6.03 -> 4.28 ms at RANGE's `high`
// flagship shape on the H100, PERF.md).  The deep instances are kernels
// of their own (DEEP): the others compile as before.
//
// Segments.  The plan (ops/retrieval_hier._values_plan, a function of the
// shape alone) cuts each list into n_seg segments of whole tiles, none over
// 12,800 rows (one wgmma accumulation chain: the dense kernel's
// SEG_ROWS_MAX), with enough blocks to fill the card's 132 SMs.  Segment s
// of a block takes its list's distinct entries [s n / n_seg, (s + 1) n /
// n_seg).  With more than one segment each block writes its partial rows to
// a plane of a workspace [n_seg, Bp, out_w] and parts_reduce_kernel adds
// the planes in segment order (no atomics: the same request gets the same
// bits).
//
// Ragged edges: TMA zero-fills rows past N, columns past sem_d / Dv / the
// count, and a chunk's box rows past G; a chunk's columns past its groups
// get e = 0; the masked last step sets p = 0 past the tile; columns past
// Dv or alr are never written.  A wait on a barrier that never completes
// traps after ~10 s instead of hanging the card.

#include <algorithm>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;               // queries a warpgroup: one wgmma M
constexpr int BN = 64;               // bank rows a step
constexpr int DVS = 256;             // value (or alr) columns a block
// Two warpgroups, 8 warps: ptxas's register budget is what 65,536
// registers give the warps of one SM sub-partition (2 of 8 a block: 255 a
// thread; a ninth warp puts 3 on one and leaves 168)
constexpr int THREADS = 256;
constexpr int GEO_D = 16;            // geo columns: one k16 step, a 32-byte box
constexpr int BOXB = BM * 128;       // one 64-row box of 64 bf16 columns: 8 KB
constexpr int GC = 64;               // groups a chunk at most
constexpr int PASS_BOXES = DEEP_PASS;  // sem boxes of one pass of a deep logits chain: 256 columns
constexpr int MAX_BOXES = 32;        // sem logit columns at most: 2,048
constexpr int SQ = DEEP_STREAM * BOXB;  // a streamed pass's query boxes within its stage
constexpr float CLAMP2 = 86.0f;

// One family of the launch.
struct Fam {
  int geo;         // the geo family: row and group logits over one 32-byte box
  int ks;          // k16 steps of the row logits (sem: 4 a 64-column box)
  int ksg;         // k16 steps of the group logits
  uint32_t gq;     // the group query block's offset within a query half
  int kbg;         // centroid boxes of a chunk (sem)
  int gres;        // its group query boxes resident (deep: the rest stream with the passes)
  int gpt;         // groups a tile
  int eg;          // a chunk's box rows: 16, 32 or 64, the first of them that holds it
  int chunks;      // chunks a tile: ceil(gpt / 64)
  int eg_last;     // groups of the tile's last chunk
  int grp;         // value blocks take its chunks (a plain family)
  int nsub;        // ring items of a chunk: 1, or (deep sem) its passes and the payload
  int acc_off, d_off;  // its columns of acc and d in the output
};

// The launch's shapes and plan, and the shared-memory layout the caller
// gives (`_values_layout` in ops/retrieval_hier.py; offsets from the
// 1024-byte aligned base): `halves` query halves [kb sem boxes | the geo
// box | sel boxes], S ring stages of [key boxes | geo box | aux: the mask
// and scales, or a chunk's counts | DVS / 64 value boxes], each warpgroup's
// bf16 e tile, the tile list,
// the barriers.
struct Prm {
  const int* idx;   // [nB, K]
  float* out;       // [Bp, out_w], or the planes [n_seg, Bp, out_w]
  size_t plane;     // floats between two planes (0: one segment)
  int n_qb, nsl, na, n_seg, K, bm, bn, spt, last_rows, dedup, S;
  int two;          // warpgroup 1 takes family 1 over warpgroup 0's queries
  int halves;       // 64-query halves a block (2: warpgroup 1 the second)
  int Dv, Wa, out_w, alr_off;
  int geo_zero;     // a merged launch without geo: acc_g and d_g are zeros
  int pad_lo;       // zero columns [pad_lo, pad_hi) (the value slice 0)
  int pad_hi;
  int kb, has_kg, kbs;  // a half's sem boxes, its geo box, its sel boxes
  int qres;         // sem boxes resident a half: kb, or (deep, 64 queries) a multiple of 4
  int step_bytes;   // TMA bytes of a step but its values
  int deep;         // logits over more than PASS_BOXES sem boxes: passes, then a payload item
  int pair;         // deep, one family: two slices a block, a warpgroup each, one payload each
  int nsub_step;    // ring items of a step: 1, or (deep) its passes and its payloads
  int nslb, nab;    // blocks of a query block's value slices and of its alr slices
  Fam f[2];
  uint32_t qhalf, qgeo, qsel, ring, stage, kg, aux, va, e, etile, lst, bars, total;
  uint32_t codes;   // a step's int8 codes within its stage: over the value boxes' second
                    // half, or (deep) past them
};

// A stage's place in the ring: its index and the parity of its phase,
// advanced item by item (no division in the loops).
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The items of a block, in order: for each tile of its segment its 64-row
// steps (value blocks), then the chunks of each family whose groups the
// block takes (a value block: its plain families'; an alr block: the lr
// family's).  `t` walks a tile's items; kind, step and chunk follow from it
// by comparisons.  A deep launch's step is several ring items (`sub`): its
// passes of the sem keys, PASS_BOXES boxes each, then its payload (the geo
// key box, the mask and scales, the values); a sem chunk likewise its
// passes of the centroids, then its payload (the counts and vw rows).
struct Walk {
  int nst, ch0, ch1, per_tile;  // steps, family 0's and family 1's chunks a tile
  int ns_step, ns0, ns1;        // ring items of a step and of each family's chunk
  int npl;                      // payload items of each (2 in a pair block: a slice each)
  int j = 0, t = 0, sub = 0;    // list slot, item of the tile, its ring item
  __device__ __forceinline__ int nsub() const { return step() ? ns_step : fam() ? ns1 : ns0; }
  // a payload ring item: the whole item, or a deep item's (one of npl)
  __device__ __forceinline__ bool payload() const { return nsub() == 1 || sub + npl >= nsub(); }
  // the slice whose payload it is (0 but in a pair block)
  __device__ __forceinline__ int pslot() const { return nsub() == 1 ? 0 : sub + npl - nsub(); }
  // the next ring item (DEEP: items of several; else each item one)
  template <bool DEEP>
  __device__ __forceinline__ void next() {
    if constexpr (DEEP) {
      if (++sub < nsub()) return;
      sub = 0;
    }
    if (++t == per_tile) {
      t = 0;
      ++j;
    }
  }
  __device__ __forceinline__ bool step() const { return t < nst; }
  __device__ __forceinline__ int fam() const { return t - nst < ch0 ? 0 : 1; }
  __device__ __forceinline__ int chunk() const { return t - nst < ch0 ? t - nst : t - nst - ch0; }
};

struct Blk {
  int qb, y, seg, lo, n;
  bool alr;         // an alr block (y >= nsl)
  int c0[2];        // its slices' first value (or alr) columns (slot 1: a pair block's second)
  int vboxes[2];    // value (or alr) boxes of each slice inside Dv (Wa), 0 past them
  uint32_t base, bq, full, empty;
  Walk walk;
};

__device__ __forceinline__ void release(uint32_t bar) {  // this warp is done with a stage
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void wg_sync(int wg) {  // one consumer warpgroup's threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Byte offset of element (row m, column k) in [64][16] bf16 blocks,
// 32-byte swizzled (wgmma's K-major A layout): m * 32 + 16 ((k / 8) ^ ((m /
// 4) & 1)) + 2 (k % 8).
__device__ __forceinline__ uint32_t sw32(int m, int k) {
  return (k >> 4) * 2048 + m * 32 + (((((k & 15) >> 3) ^ (m >> 2)) & 1) << 4) + (k & 7) * 2;
}

template <int N>  // K-major A and B in shared memory, N columns
__device__ __forceinline__ void wgmma_k(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 16) {
    wgmma_ss_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else {
    wgmma_ss_n64(d, a, b, scale_d);
  }
}

// Four int8 codes (one 32-bit word) as two bf16 pairs, exactly: a code c is
// (128 + (c & 127)) - (c < 0 ? 256 : 128), both terms bf16 built by a byte
// permute (high byte 0x43: 2^7), their difference an integer bf16 holds.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  const uint32_t v0 = __byte_perm(mag, 0x43434343u, 0x4140);
  const uint32_t v1 = __byte_perm(mag, 0x43434343u, 0x4342);
  const uint32_t s0 = __byte_perm(sgn, 0x43434343u, 0x4140);
  const uint32_t s1 = __byte_perm(sgn, 0x43434343u, 0x4342);
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(v0), "r"(s0));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(v1), "r"(s1));
}

// A step's int8 codes, landed by TMA in the second half of its value
// boxes' memory at va ([64 rows][DVS] bytes from va + 16 KB), into the bf16
// value boxes at va (DVS / 64 boxes of [64 rows][64 columns], 128-byte
// swizzled, as TMA writes them), by `nthr` threads (tid of them), 32 codes a
// task: every thread reads its tasks' codes, a barrier (`bar_id`), then
// writes them, so the boxes that overlay the codes are written only once
// all are read; a second barrier publishes the boxes.
__device__ __forceinline__ void convert_step(uint32_t va, int tid, int nthr, int bar_id) {
  constexpr int CH = DVS / 32;                   // 32-code tasks a row
  constexpr int MAXT = BN * CH / 128;            // tasks a thread at 128 threads
  const int nt = BN * CH / nthr;
  uint32_t w[MAXT][8];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < nt) {
      const int i = tid + j * nthr;
      const uint32_t a = va + BN * DVS + (i / CH) * DVS + (i % CH) * 32;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[j][0]), "=r"(w[j][1]), "=r"(w[j][2]), "=r"(w[j][3])
                   : "r"(a));
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[j][4]), "=r"(w[j][5]), "=r"(w[j][6]), "=r"(w[j][7])
                   : "r"(a + 16));
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(nthr) : "memory");
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < nt) {
      const int i = tid + j * nthr, k = i % CH, row = i / CH;
      const uint32_t rb = va + (k >> 1) * BOXB + row * 128, sw = row & 7, c0 = (4 * k) & 7;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t o0, o1, o2, o3;
        codes_bf16(w[j][2 * q], o0, o1);
        codes_bf16(w[j][2 * q + 1], o2, o3);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(rb + (((c0 + q) ^ sw) << 4)),
                     "r"(o0), "r"(o1), "r"(o2), "r"(o3)
                     : "memory");
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(nthr) : "memory");
}

// A deep step's int8 codes, landed apart from its value boxes (at codes,
// [64 rows][DVS] bytes past them), into the bf16 value boxes at va, by
// `nthr` threads (tid of them): each task's 32 codes read and written at
// once (no box overlays the codes: 8 words a thread live, not 32), then a
// barrier (`bar_id`) publishes the boxes.
__device__ __forceinline__ void convert_apart(uint32_t va, uint32_t codes, int tid, int nthr,
                                              int bar_id) {
  constexpr int CH = DVS / 32;  // 32-code tasks a row
  for (int i = tid; i < BN * CH; i += nthr) {
    const int k = i % CH, row = i / CH;
    const uint32_t a = codes + row * DVS + k * 32;
    uint32_t w[8];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(a));
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7])
                 : "r"(a + 16));
    const uint32_t rb = va + (k >> 1) * BOXB + row * 128, sw = row & 7, c0 = (4 * k) & 7;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t o0, o1, o2, o3;
      codes_bf16(w[2 * q], o0, o1);
      codes_bf16(w[2 * q + 1], o2, o3);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(rb + (((c0 + q) ^ sw) << 4)),
                   "r"(o0), "r"(o1), "r"(o2), "r"(o3)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(nthr) : "memory");
}

// ---- the producer, one lane of warpgroup 0: the block's query halves,
// then each item's copies into its ring stage, once the item that stage
// held before is released by every consumer warp

struct Maps {
  const CUtensorMap *tq, *tqg, *tqs, *tk, *tkg, *tm, *ts, *tv, *tg0, *tg1, *tw0, *tw1, *tc0, *tc1;
};

__device__ __forceinline__ void load_queries(const Prm& P, const Blk& b, const Maps& M) {
  const int q0 = b.qb * BM * P.halves;
  mbar_expect_tx(b.bq, P.halves * (P.qres * BOXB + (P.has_kg ? BM * 32 : 0) + P.kbs * BOXB));
  for (int h = 0; h < P.halves; ++h) {
    const uint32_t qa = b.base + h * P.qhalf;
    for (int i = 0; i < P.qres; ++i) tma_2d(qa + i * BOXB, M.tq, BOX * i, q0 + h * BM, b.bq);
    if (P.has_kg) tma_2d(qa + P.qgeo, M.tqg, 0, q0 + h * BM, b.bq);
    for (int i = 0; i < P.kbs; ++i)
      tma_2d(qa + P.qsel + i * BOXB, M.tqs, BOX * i, q0 + h * BM, b.bq);
  }
}

// Item w's copies into stage s: a step's key boxes, geo box, mask (with int8
// codes its scales and the codes, into the second half of the value boxes'
// memory), value boxes; a chunk's centroids, vw boxes and (value blocks)
// counts.  DEEP: a pass's key (or centroid) boxes (a streamed pass's query
// boxes SQ bytes in), or a payload: the rest (a pair block's: its slice's).
template <bool DEEP>
__device__ __forceinline__ void load_item(const Prm& P, const Blk& b, const int* lst,
                                          const Maps& M, const Walk& w, int s, bool i8) {
  if constexpr (!DEEP) {
    const uint32_t st = b.base + P.ring + s * P.stage, full = b.full + 8 * s;
    const int tile = lst[b.lo + w.j];
    if (w.step()) {
      const int row = tile * P.bn + w.t * BN;
      mbar_expect_tx(full, P.step_bytes + (i8 ? BN * DVS : b.vboxes[0] * BOXB));
      for (int i = 0; i < P.kb; ++i) tma_2d(st + i * BOXB, M.tk, BOX * i, row, full);
      if (P.has_kg) tma_2d(st + P.kg, M.tkg, 0, row, full);
      tma_1d(st + P.aux, M.tm, row, full);
      if (i8) {
        tma_1d(st + P.aux + 256, M.ts, row, full);
        tma_2d(st + P.codes, M.tv, b.c0[0], row, full);
      } else {
        for (int h = 0; h < b.vboxes[0]; ++h)
          tma_2d(st + P.va + h * BOXB, M.tv, b.c0[0] + BOX * h, row, full);
      }
      return;
    }
    const int f = w.fam();
    const Fam F = f ? P.f[1] : P.f[0];
    const int grow = tile * F.gpt + w.chunk() * GC;
    mbar_expect_tx(full, (F.geo ? F.eg * 32 : F.kbg * F.eg * 128) + b.vboxes[0] * F.eg * 128 +
                             (b.alr ? 0 : F.eg * 16));
    const CUtensorMap* tg = f ? M.tg1 : M.tg0;
    const CUtensorMap* tw = f ? M.tw1 : M.tw0;
    if (F.geo) {
      tma_2d(st + P.kg, tg, 0, grow, full);
    } else {
      for (int i = 0; i < F.kbg; ++i) tma_2d(st + i * BOXB, tg, BOX * i, grow, full);
    }
    for (int h = 0; h < b.vboxes[0]; ++h)
      tma_2d(st + P.va + h * BOXB, tw, b.c0[0] + BOX * h, grow, full);
    if (!b.alr) tma_2d(st + P.aux, f ? M.tc1 : M.tc0, 0, grow, full);
    return;
  }
  const uint32_t st = b.base + P.ring + s * P.stage, full = b.full + 8 * s;
  const int tile = lst[b.lo + w.j];
  const bool pass = !w.payload();  // a deep item's pass: nb boxes from box b0
  const int q0 = b.qb * BM * P.halves;  // (a streamed pass: 64 queries a block)
  int b0, nb;
  // the payload's slice (selects: an array indexed at run time would live in local memory)
  const bool k1 = !pass && w.pslot() == 1;
  const int c0 = k1 ? b.c0[1] : b.c0[0], vboxes = k1 ? b.vboxes[1] : b.vboxes[0];
  if (w.step()) {
    const int row = tile * P.bn + w.t * BN;
    if (pass) {
      const bool sq = deep_pass(w.sub, P.kb, P.qres, b0, nb);
      mbar_expect_tx(full, (sq ? 2 : 1) * nb * BOXB);
      for (int i = 0; i < nb; ++i) tma_2d(st + i * BOXB, M.tk, BOX * (b0 + i), row, full);
      if (sq)
        for (int i = 0; i < nb; ++i) tma_2d(st + SQ + i * BOXB, M.tq, BOX * (b0 + i), q0, full);
      return;
    }
    const int kb = P.deep ? 0 : P.kb;  // deep: the keys came in the passes
    mbar_expect_tx(full, P.step_bytes - (P.kb - kb) * BOXB +
                             (i8 ? BN * DVS : vboxes * BOXB));
    for (int i = 0; i < kb; ++i) tma_2d(st + i * BOXB, M.tk, BOX * i, row, full);
    if (P.has_kg) tma_2d(st + P.kg, M.tkg, 0, row, full);
    tma_1d(st + P.aux, M.tm, row, full);
    if (i8) {
      tma_1d(st + P.aux + 256, M.ts, row, full);
      tma_2d(st + P.codes, M.tv, c0, row, full);
    } else {
      for (int h = 0; h < vboxes; ++h) tma_2d(st + P.va + h * BOXB, M.tv, c0 + BOX * h, row, full);
    }
    return;
  }
  const int f = w.fam();
  const Fam F = f ? P.f[1] : P.f[0];
  const int grow = tile * F.gpt + w.chunk() * GC;
  const CUtensorMap* tg = f ? M.tg1 : M.tg0;
  if (pass) {  // deep: GC centroid rows of the pass's boxes (the logits' wgmma N)
    const bool sq = deep_pass(w.sub, F.kbg, F.gres, b0, nb);  // (sq: the sem family's)
    mbar_expect_tx(full, (sq ? 2 : 1) * nb * BOXB);
    for (int i = 0; i < nb; ++i) tma_2d(st + i * BOXB, tg, BOX * (b0 + i), grow, full);
    if (sq)
      for (int i = 0; i < nb; ++i) tma_2d(st + SQ + i * BOXB, M.tq, BOX * (b0 + i), q0, full);
    return;
  }
  const int kbg = F.nsub > 1 ? 0 : F.kbg;  // deep: the centroids came in the passes
  mbar_expect_tx(full, (F.geo ? F.eg * 32 : kbg * F.eg * 128) + vboxes * F.eg * 128 +
                           (b.alr ? 0 : F.eg * 16));
  const CUtensorMap* tw = f ? M.tw1 : M.tw0;
  if (F.geo) {
    tma_2d(st + P.kg, tg, 0, grow, full);
  } else {
    for (int i = 0; i < kbg; ++i) tma_2d(st + i * BOXB, tg, BOX * i, grow, full);
  }
  for (int h = 0; h < vboxes; ++h) tma_2d(st + P.va + h * BOXB, tw, c0 + BOX * h, grow, full);
  if (!b.alr) tma_2d(st + P.aux, f ? M.tc1 : M.tc0, 0, grow, full);
}

// ---- a consumer warpgroup

// The logits of a step or a chunk on wgmma m64n64k16 over KS k16 steps:
// A the query boxes at qa, B the stage's 64-row boxes at st (keys, or a
// deep chunk's 64 centroid rows), both K-major; fresh at `first`, else
// added to sc (the passes of a deep chain).  GEO: one k16 step over the geo
// boxes.
template <int KS, bool GEO>
__device__ __forceinline__ void step_logits(const Prm& P, uint32_t qa, uint32_t st,
                                            float (&sc)[BN / 2], bool first) {
  wgmma_fence();
  if constexpr (GEO) {
    wgmma_ss_n64(sc, desc_k32(qa + P.qgeo), desc_k32(st + P.kg), 0);
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks & 3) * 32;  // k16 step within the 128-byte row
      wgmma_ss_n64(sc, desc_k128(qa + (ks >> 2) * BOXB + off),
                   desc_k128(st + (ks >> 2) * BOXB + off), first && ks == 0 ? 0 : 1);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(sc);
}

// One pass of a deep chain: nb (1..4) boxes.
__device__ __forceinline__ void pass_logits(const Prm& P, uint32_t qa, uint32_t st,
                                            float (&sc)[BN / 2], bool first, int nb) {
  switch (nb) {
    case 1: step_logits<4, false>(P, qa, st, sc, first); break;
    case 2: step_logits<8, false>(P, qa, st, sc, first); break;
    case 3: step_logits<12, false>(P, qa, st, sc, first); break;
    default: step_logits<16, false>(P, qa, st, sc, first); break;
  }
}

// A step's weights from its row logits sc: p = exp2(min(sc + mask, 86))
// (the stage's mask and scales), the row sums, bf16(p s) as the A
// fragments pa.  `last`: the tile's masked last step.
template <bool I8>
__device__ __forceinline__ void step_p(const Prm& P, uint32_t st, bool last,
                                       const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4],
                                       float (&dsum)[2], int t) {
  // accumulator element 4j + e is row g + 8 (e >> 1), column 8j + 2t + (e & 1)
  const float* mk = reinterpret_cast<const float*>(__cvta_shared_to_generic(st + P.aux));
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float2 m = *reinterpret_cast<const float2*>(mk + c);
    if (last) {
      if (c >= P.last_rows) m.x = -1e30f;
      if (c + 1 >= P.last_rows) m.y = -1e30f;
    }
    float p00 = exp2f(fminf(sc[4 * j] + m.x, CLAMP2));
    float p01 = exp2f(fminf(sc[4 * j + 1] + m.y, CLAMP2));
    float p10 = exp2f(fminf(sc[4 * j + 2] + m.x, CLAMP2));
    float p11 = exp2f(fminf(sc[4 * j + 3] + m.y, CLAMP2));
    dsum[0] += p00 + p01;
    dsum[1] += p10 + p11;
    if constexpr (I8) {
      const float2 s = *reinterpret_cast<const float2*>(mk + 64 + c);
      p00 *= s.x;
      p01 *= s.y;
      p10 *= s.x;
      p11 *= s.y;
    }
    pa[j >> 1][2 * (j & 1)] = pack_bf16(p00, p01);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p10, p11);
  }
}

// acc += pa @ the stage's value boxes.
__device__ __forceinline__ void step_pv(const Prm& P, uint32_t st,
                                        const uint32_t (&pa)[BN / 16][4], float (&acc)[2][64]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs_n128(acc[h], pa[kk], desc_v(st + P.va + 2 * h * BOXB + kk * 2048, BN));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// A step of the warpgroup's family: the row logits of its 64 queries (at
// qa) against the stage's keys, then `step_values`.
template <int KS, bool GEO, bool I8>
__device__ __forceinline__ void step_item(const Prm& P, uint32_t qa, uint32_t st, bool last,
                                          float (&acc)[2][64], float (&dsum)[2], int t) {
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  step_logits<KS, GEO>(P, qa, st, sc, true);
  step_p<I8>(P, st, last, sc, pa, dsum, t);
  step_pv(P, st, pa, acc);
}

// The rest of a chunk of gc groups from its group logits ea (the first EG
// columns of an accumulator of NA / 4 n8 blocks): e = exp2(min(ea, 86)),
// zero past gc, bf16 into the warpgroup's e tile (at eb); a value block
// (`sub`): the count column's product into dcorr, then acc -= e @ vw over
// the slice in four 64-column pieces, each summed in a fresh fragment; an
// alr block: acc += e @ vw over its columns.
template <int EG, int NA>
__device__ __forceinline__ void group_rest(const Prm& P, uint32_t st, uint32_t eb, int gc,
                                           bool sub, int wg, const float (&ea)[NA],
                                           float (&acc)[2][64], float (&dcorr)[2], int warp,
                                           int g, int t) {
  wg_sync(wg);  // every warp's last product from the e tile is done
  const unsigned short* cnt =
      reinterpret_cast<const unsigned short*>(__cvta_shared_to_generic(st + P.aux));
#pragma unroll
  for (int jj = 0; jj < EG / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * jj + 2 * t + (e & 1), row = 16 * warp + g + 8 * (e >> 1);
      const __nv_bfloat16 h =
          __float2bfloat16_rn(col < gc ? exp2f(fminf(ea[4 * jj + e], CLAMP2)) : 0.f);
      if (sub)
        dcorr[e >> 1] += __bfloat162float(h) * __bfloat162float(__ushort_as_bfloat16(cnt[col * 8]));
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(eb + sw32(row, col)),
                   "h"(__bfloat16_as_ushort(h))
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);  // the e tile is complete
  if (sub) {
#pragma unroll
    for (int h4 = 0; h4 < 4; ++h4) {
      float fr[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < EG / 16; ++kk)
        wgmma_ss_n64_t(fr, desc_k32(eb + kk * 2048),
                       desc_v(st + P.va + h4 * BOXB + kk * 2048, BN), kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(fr);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h4 >> 1][32 * (h4 & 1) + i] -= fr[i];
    }
  } else {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < EG / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss_n128_t(acc[h], desc_k32(eb + kk * 2048),
                        desc_v(st + P.va + 2 * h * BOXB + kk * 2048, BN), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
}

// A chunk of the warpgroup's family's groups (gc of them): e's logits on
// wgmma m64nEGk16 (queries at gqa, the chunk's EG centroid rows in the
// stage's key boxes), then `group_rest`.
template <int EG, int KSG, bool GEO>
__device__ __forceinline__ void group_item(const Prm& P, uint32_t gqa, uint32_t st, uint32_t eb,
                                           int gc, bool sub, int wg, float (&acc)[2][64],
                                           float (&dcorr)[2], int warp, int g, int t) {
  float ea[EG / 2];
  wgmma_fence();
  if constexpr (GEO) {
    wgmma_k<EG>(ea, desc_k32(gqa), desc_k32(st + P.kg), 0);
  } else {
#pragma unroll
    for (int ks = 0; ks < KSG; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      wgmma_k<EG>(ea, desc_k128(gqa + (ks >> 2) * BOXB + off),
                  desc_k128(st + (ks >> 2) * BOXB + off), ks > 0 ? 1 : 0);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(ea);
  group_rest<EG, EG / 2>(P, st, eb, gc, sub, wg, ea, acc, dcorr, warp, g, t);
}

template <int EG, bool GEO>
__device__ __forceinline__ void group_ksg(const Prm& P, int ksg, uint32_t gqa, uint32_t st,
                                          uint32_t eb, int gc, bool sub, int wg,
                                          float (&acc)[2][64], float (&dcorr)[2], int warp, int g,
                                          int t) {
  if constexpr (GEO) {
    group_item<EG, 1, true>(P, gqa, st, eb, gc, sub, wg, acc, dcorr, warp, g, t);
  } else {
    switch (ksg) {
      case 4: group_item<EG, 4, false>(P, gqa, st, eb, gc, sub, wg, acc, dcorr, warp, g, t); break;
      case 8: group_item<EG, 8, false>(P, gqa, st, eb, gc, sub, wg, acc, dcorr, warp, g, t); break;
      case 12: group_item<EG, 12, false>(P, gqa, st, eb, gc, sub, wg, acc, dcorr, warp, g, t); break;
      default: group_item<EG, 16, false>(P, gqa, st, eb, gc, sub, wg, acc, dcorr, warp, g, t); break;
    }
  }
}

// Warpgroup `wg` over the block's items: its family's steps (value blocks;
// int8 codes converted first, by every consumer thread) and chunks; the
// other family's chunks it only releases.  Thread 0 (warpgroup 0: in a
// two-family launch the sem family, the slower one) is the producer.  Then
// the warpgroup's rows of the output.
template <bool GEO, bool I8, bool DEEP>
__device__ __forceinline__ void consume(const Prm& P, const Blk& b, const int* lst,
                                        const Maps& M, int wg, int act) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = threadIdx.x == 0;
  const int f = P.two ? wg : 0;
  const Fam F = f ? P.f[1] : P.f[0];
  // a pair block (DEEP, one family): the two warpgroups take the same 64
  // queries, a slice each (`slot`), each its own logits and its payloads
  const bool pair = DEEP && P.pair;
  const int slot = pair ? wg : 0, c0 = slot ? b.c0[1] : b.c0[0];
  // a pair block's second slice may lie past Dv (Wa)
  const bool has = (slot ? b.vboxes[1] : b.vboxes[0]) > 0;
  const uint32_t qa = b.base + (P.two || pair ? 0 : wg) * P.qhalf;  // this warpgroup's query half
  const uint32_t eb = b.base + P.e + wg * P.etile;
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  float dsum[2] = {0.f, 0.f}, dcorr[2] = {0.f, 0.f};
  float lg[BN / 2];  // DEEP: a sem chain's logits, carried from pass to pass
  Walk lw = b.walk;  // the producer's: the next item to load
  if (producer && b.n > 0) {
    load_queries(P, b, M);
    for (int s = 0; s < P.S && lw.j < b.n; ++s, lw.next<DEEP>())
      load_item<DEEP>(P, b, lst, M, lw, s, I8);
  }
  __syncwarp();
  if (b.n > 0) mbar_wait(b.bq, 0);
  Ring ring;
  Walk w = b.walk;
  for (; w.j < b.n; w.next<DEEP>()) {
    const int s = ring.stage;
    const uint32_t st = b.base + P.ring + s * P.stage;
    mbar_wait(b.full + 8 * s, ring.phase);
    if (DEEP && !w.payload()) {  // a pass of a sem chain (the geo family has none)
      if constexpr (DEEP && !GEO) {
        int b0, nb;
        if (!has) {
        } else if (w.step()) {
          const bool sq = deep_pass(w.sub, P.kb, P.qres, b0, nb);
          pass_logits(P, sq ? st + SQ : qa + b0 * BOXB, st, lg, w.sub == 0, nb);
        } else if (w.fam() == f) {
          const bool sq = deep_pass(w.sub, F.kbg, F.gres, b0, nb);
          pass_logits(P, sq ? st + SQ : qa + F.gq + b0 * BOXB, st, lg, w.sub == 0, nb);
        }
      }
    } else if (pair && (w.pslot() != wg || !has)) {  // (pair implies DEEP)
      // the other warpgroup's payload (or none of this one's slice)
    } else if (w.step()) {
      const bool last = w.t + 1 == P.spt && P.last_rows < BN;
      if constexpr (I8 && DEEP) {  // the codes, apart from the boxes (a pair's: its owner's)
        convert_apart(st + P.va, st + P.codes, pair ? tid : threadIdx.x, pair ? 128 : 128 * act,
                      pair ? 4 + wg : 1);
      } else if constexpr (I8) {
        convert_step(st + P.va, threadIdx.x, 128 * act, 1);
      }
      if constexpr (DEEP && !GEO) {  // the passes' logits
        uint32_t pa[BN / 16][4];
        step_p<I8>(P, st, last, lg, pa, dsum, t);
        step_pv(P, st, pa, acc);
      }
      if constexpr (GEO) {
        step_item<1, true, I8>(P, qa, st, last, acc, dsum, t);
      } else if constexpr (!DEEP) {
        switch (F.ks) {
          case 4: step_item<4, false, I8>(P, qa, st, last, acc, dsum, t); break;
          case 8: step_item<8, false, I8>(P, qa, st, last, acc, dsum, t); break;
          case 12: step_item<12, false, I8>(P, qa, st, last, acc, dsum, t); break;
          default: step_item<16, false, I8>(P, qa, st, last, acc, dsum, t); break;
        }
      }
    } else if (w.fam() == f) {
      const int c = w.chunk();
      const int gc = c + 1 == F.chunks ? F.eg_last : GC;
      const uint32_t gqa = qa + F.gq;
      if (DEEP && !GEO) {  // the passes' logits, over 64 centroid rows
        if (F.eg == 16) {
          group_rest<16, BN / 2>(P, st, eb, gc, !b.alr, wg, lg, acc, dcorr, warp, g, t);
        } else if (F.eg == 32) {
          group_rest<32, BN / 2>(P, st, eb, gc, !b.alr, wg, lg, acc, dcorr, warp, g, t);
        } else {
          group_rest<64, BN / 2>(P, st, eb, gc, !b.alr, wg, lg, acc, dcorr, warp, g, t);
        }
      } else if (F.eg == 16) {
        group_ksg<16, GEO>(P, F.ksg, gqa, st, eb, gc, !b.alr, wg, acc, dcorr, warp, g, t);
      } else if (F.eg == 32) {
        group_ksg<32, GEO>(P, F.ksg, gqa, st, eb, gc, !b.alr, wg, acc, dcorr, warp, g, t);
      } else {
        group_ksg<64, GEO>(P, F.ksg, gqa, st, eb, gc, !b.alr, wg, acc, dcorr, warp, g, t);
      }
    }
    release(b.empty + 8 * s);
    // the next load into the stage this item read, once every reader is done
    if (producer && lw.j < b.n) {
      mbar_wait(b.empty + 8 * s, ring.phase);
      load_item<DEEP>(P, b, lst, M, lw, s, I8);
      lw.next<DEEP>();
    }
    ring.next(P.S);
    __syncwarp();
  }

  // the rows' sums over the four lanes of a row
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], off);
      dcorr[e] += __shfl_xor_sync(0xffffffffu, dcorr[e], off);
    }
  }
  if ((b.alr && f != 0) || !has) return;  // an alr block's columns are family 0's
  float* out = P.out + b.seg * P.plane;
  const int qrow = b.qb * BM * P.halves + (P.two || pair ? 0 : wg * BM) + 16 * warp + g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* row = out + (size_t)(qrow + 8 * e) * P.out_w;
    if (b.alr) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 128 * h + 8 * j + 2 * t;
          if (c < P.Wa)
            *reinterpret_cast<float2*>(row + P.alr_off + c) =
                make_float2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
        }
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 128 * h + 8 * j + 2 * t;
        if (c < P.Dv) {
          *reinterpret_cast<float2*>(row + F.acc_off + c) =
              make_float2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
          if (P.geo_zero) *reinterpret_cast<float2*>(row + P.Dv + c) = make_float2(0.f, 0.f);
        }
      }
    if (b.y == 0 && slot == 0) {  // d, and the zero columns
      if (t == 0) row[F.d_off] = dsum[e] - dcorr[e];
      if (wg == 0 || !P.two)
        for (int c = P.pad_lo + t; c < P.pad_hi; c += 4) row[c] = 0.f;
    }
  }
}

template <bool I8, bool DEEP>
__global__ void __launch_bounds__(THREADS, 1)
    hier_parts_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tqg,
                           const __grid_constant__ CUtensorMap tqs,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tkg,
                           const __grid_constant__ CUtensorMap tm,
                           const __grid_constant__ CUtensorMap ts,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg0,
                           const __grid_constant__ CUtensorMap tg1,
                           const __grid_constant__ CUtensorMap tw0,
                           const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tc0,
                           const __grid_constant__ CUtensorMap tc1,
                           const __grid_constant__ Prm P0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // a copy in registers: a reference into the parameter space would be
  // reloaded after every asm statement that clobbers memory
  const Prm P = P0;
  const Maps M{&tq, &tqg, &tqs, &tk, &tkg, &tm, &ts, &tv, &tg0, &tg1, &tw0, &tw1, &tc0, &tc1};
  Blk b;
  b.base = smem_u32(smem);
  const int nsl = P.nslb + P.nab;  // a query block's blocks: its value slices', its alr ones'
  b.y = blockIdx.x % nsl;  // a query block's slices fastest: they share its tiles in L2
  b.qb = (blockIdx.x / nsl) % P.n_qb;
  b.seg = blockIdx.x / (nsl * P.n_qb);
  b.alr = b.y >= P.nslb;
  const int y0 = b.alr ? b.y - P.nslb : b.y, cols = b.alr ? P.Wa : P.Dv;
  for (int k = 0; k < 2; ++k) {  // slot 1: a pair block's second slice
    b.c0[k] = (P.pair ? 2 * y0 + k : y0) * DVS;
    b.vboxes[k] = max(0, min(DVS / BOX, (cols - b.c0[k] + BOX - 1) / BOX));
  }
  b.bq = b.base + P.bars;
  b.full = b.bq + 8;
  b.empty = b.full + 8 * P.S;
  int* lst = reinterpret_cast<int*>(smem + P.lst);
  int* info = reinterpret_cast<int*>(smem + P.bars + 8 * (1 + 2 * P.S));  // lo, n
  const int act = P.two || P.halves == 2 || P.pair ? 2 : 1;  // consumer warpgroups at work
  const int lb = b.qb * BM * P.halves / P.bm;      // the query block's list
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
    info[0] = (int)((long long)b.seg * n / P.n_seg);
    info[1] = (int)((long long)(b.seg + 1) * n / P.n_seg) - info[0];
    mbar_init(b.bq, 1);
    for (int s = 0; s < P.S; ++s) {
      mbar_init(b.full + 8 * s, 1);
      mbar_init(b.empty + 8 * s, 4 * act);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  b.lo = info[0];
  b.n = info[1];
  Walk& w = b.walk;
  w.nst = b.alr ? 0 : P.spt;
  // the chunks a block takes: a value block its plain families', an alr
  // block family 0's (the lr one)
  w.ch0 = (b.alr || P.f[0].grp) ? P.f[0].chunks : 0;
  w.ch1 = (P.two && !b.alr && P.f[1].grp) ? P.f[1].chunks : 0;
  w.per_tile = w.nst + w.ch0 + w.ch1;
  w.ns_step = P.nsub_step;
  w.ns0 = P.f[0].nsub;
  w.ns1 = P.f[1].nsub;
  w.npl = P.pair ? 2 : 1;
  const int wg = threadIdx.x / 128;
  if (wg >= act) return;
  if ((P.two && wg ? P.f[1] : P.f[0]).geo) {
    consume<true, I8, DEEP>(P, b, lst, M, wg, act);
  } else {
    consume<false, I8, DEEP>(P, b, lst, M, wg, act);
  }
}

// out[q, c] = sum over s of part[s, q, c] in order s = 0, 1, ..., n_seg - 1;
// part is [n_seg, Bp, W] f32, W % 4 == 0.
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

__host__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// The merged launch (merged = 1: family 0 sem, over g0 [G0, sem_d] and vw0,
// family 1 geo with two = 1, over g1 [G1, gw1] and vw1) and the family
// launch (merged = 0: one family, geo0 = 1 the geo family; sel = 1 the sem
// family's group logits from the query's columns [cat_d, cat_d + gw0)
// against g0 [G0, gw0]; dedup = 1 drops a list entry equal to the one
// before it).  q_cat [Bp, qw], k_cat [N, cat_d] bf16 packed: the sem row
// logits over columns [0, sem_d), the geo family's row and group logits
// over the 16 from sem_d (its centroids' first 16 columns; cat_d - gw ==
// sem_d).  values [N, Dv] bf16, or int8 codes with scale [N] f32; mask_neg
// [N] f32; idx [Bp / bm, K] int32 (tiles < N / bn).  A family's vw [G, W]
// bf16: lr (family 0 only) the low-rank coefficients, W a multiple of 128
// up to 512; else the group value sums with the count in column Dv.  out
// [Bp, 2 Dv + 128 (+ W0 with lr)] merged, [Bp, Dv + 128 (+ W0)] family.
// The plan (`_values_plan`): n_seg segments of each list (work holds [n_seg,
// Bp, out_w] f32 when n_seg > 1); lay [16] the layout (`_values_layout`):
// the query rows a block (64 or 128), the ring's stages, then the offsets
// qhalf, qgeo, qsel, ring, stage, kg, aux, va, e, etile, lst, bars and
// the total bytes, and the sem boxes resident a query half (qres).  All contiguous and 16-byte aligned.  Returns a CUDA
// error code (cudaErrorInvalidValue for what it does not take, with nothing
// launched).
extern "C" int hier_parts_sm90_launch(
    const void* q_cat, const void* k_cat, const void* values, const void* scale,
    const void* mask_neg, const void* idx, const void* g0, const void* vw0, const void* g1,
    const void* vw1, void* out, void* work, const void* lay, int Bp, int qw, int cat_d,
    int sem_d, int Dv, int bm, int bn, int K, int N, int merged, int two, int geo0, int lr0,
    int sel, int dedup, int gpt0, int G0, int gw0, int W0, int gpt1, int G1, int gw1, int W1,
    int n_seg, void* stream) {
  const bool i8 = scale != nullptr;
  auto fam_ok = [&](int geo, int lr, int gpt, int G, int gw, int W) {
    return gpt >= 1 && bn % gpt == 0 && G >= 1 && gw % 8 == 0 &&
           (!geo || (gw >= GEO_D && cat_d - gw == sem_d)) &&
           (lr ? W % 128 == 0 && W <= 512 : W >= Dv + 1 && W % 8 == 0);
  };
  if (lay == nullptr || Bp <= 0 || K <= 0 || N <= 0 || bm <= 0 || bm % BM || Bp % bm ||
      bn < 32 || bn % 32 || N % bn || sem_d < 16 || sem_d > MAX_BOXES * BOX || sem_d % 16 ||
      sem_d + GEO_D > cat_d || cat_d % 8 || Dv <= 0 || Dv % 16 || n_seg < 1 || n_seg > K ||
      !fam_ok(geo0, lr0, gpt0, G0, gw0, W0))
    return (int)cudaErrorInvalidValue;
  if (merged ? geo0 || sel || dedup || gw0 != sem_d || qw != cat_d ||
                   (two && !fam_ok(1, 0, gpt1, G1, gw1, W1))
             : two || (sel ? geo0 || gw0 < 16 || gw0 % 16 || gw0 > 256 || qw != cat_d + gw0
                           : qw != cat_d || (!geo0 && gw0 != sem_d)))
    return (int)cudaErrorInvalidValue;
  const int* L = static_cast<const int*>(lay);
  const int bmb = L[0];
  Prm P{};
  P.S = L[1];
  uint32_t* off[] = {&P.qhalf, &P.qgeo, &P.qsel, &P.ring, &P.stage, &P.kg, &P.aux,
                     &P.va,    &P.e,    &P.etile, &P.lst,  &P.bars, &P.total};
  for (int i = 0; i < 13; ++i) {
    if (L[2 + i] < 0) return (int)cudaErrorInvalidValue;
    *off[i] = (uint32_t)L[2 + i];
  }
  if ((bmb != BM && bmb != 2 * BM) || (bmb == 2 * BM && (two || bm % bmb)) || P.S < 2 || P.S > 4)
    return (int)cudaErrorInvalidValue;
  P.idx = static_cast<const int*>(idx);
  P.K = K;
  P.bm = bm;
  P.bn = bn;
  P.dedup = dedup;
  P.n_seg = n_seg;
  P.spt = cdiv(bn, BN);
  P.last_rows = bn - (P.spt - 1) * BN;
  P.two = two;
  P.halves = bmb / BM;
  P.n_qb = Bp / bmb;
  P.Dv = Dv;
  P.nsl = cdiv(Dv, DVS);
  P.Wa = lr0 ? W0 : 0;
  P.na = cdiv(P.Wa, DVS);
  P.out_w = (merged ? 2 * Dv : Dv) + 128 + P.Wa;
  P.alr_off = (merged ? 2 * Dv : Dv) + 128;
  P.geo_zero = merged && !two;
  P.pad_lo = merged ? 2 * Dv + (two ? 2 : 1) : Dv + 1;
  P.pad_hi = (merged ? 2 * Dv : Dv) + 128;
  P.kb = geo0 ? 0 : cdiv(sem_d, BOX);
  P.has_kg = two || geo0;
  P.kbs = sel ? cdiv(gw0, BOX) : 0;
  P.step_bytes = P.kb * BOXB + (P.has_kg ? BN * 32 : 0) + 256 + (i8 ? 256 : 0);
  // deep: sem logits over more than PASS_BOXES boxes (rows or groups) take
  // passes, each a ring item, and the rest of the item its payload
  P.deep = P.kb > PASS_BOXES || P.kbs > PASS_BOXES;
  // deep, one family: pairs of slices share a block (one warpgroup would
  // idle at 64 queries a block), so the keys stream once for two slices
  P.pair = P.deep && !two && bmb == BM;
  const int npl = P.pair ? 2 : 1;
  // the sem boxes resident a half: every one, or (deep, 64 queries a block)
  // a multiple of 4, the passes past them streaming their query boxes
  P.qres = L[15];
  if (P.qres != P.kb && (!P.deep || bmb != BM || P.qres < PASS_BOXES || P.qres > P.kb ||
                         P.qres % PASS_BOXES))
    return (int)cudaErrorInvalidValue;
  P.nsub_step = P.deep ? deep_passes(P.kb, P.qres) + npl : 1;
  auto fam = [&](Fam& F, int geo, int lr, int gpt, int kbg, uint32_t gq) {
    F.geo = geo;
    F.ks = geo ? 1 : 4 * P.kb;
    F.kbg = geo ? 0 : kbg;
    F.ksg = geo ? 1 : 4 * kbg;
    F.gq = gq;
    F.gpt = gpt;
    F.eg = gpt <= 16 ? 16 : gpt <= 32 ? 32 : GC;  // a wgmma N the chunk fits
    F.chunks = cdiv(gpt, GC);
    F.eg_last = gpt - (F.chunks - 1) * GC;
    F.grp = !lr;
    F.gres = gq ? kbg : std::min(kbg, P.qres);  // sel's boxes stay resident
    F.nsub = P.deep && !geo ? deep_passes(kbg, F.gres) + npl : 1;
  };
  fam(P.f[0], geo0, lr0, gpt0, sel ? P.kbs : P.kb, geo0 ? P.qgeo : sel ? P.qsel : 0);
  P.f[0].acc_off = 0;
  P.f[0].d_off = merged ? 2 * Dv : Dv;
  if (two) {
    fam(P.f[1], 1, 0, gpt1, 0, P.qgeo);
    P.f[1].acc_off = Dv;
    P.f[1].d_off = 2 * Dv + 1;
  } else {
    P.f[1] = P.f[0];
  }
  // the layout: what each region must hold, its alignment, the total
  const int egmax = std::max(P.f[0].eg, two ? P.f[1].eg : 0);
  const bool groups = P.f[0].grp || P.Wa || two;
  // a stage: [key (or centroid) boxes | geo box | aux | value boxes]; deep:
  // [a pass's boxes, or the payload's value boxes (va = 0) | geo box | aux]
  const uint32_t kbox = P.deep ? PASS_BOXES : std::max(P.kb, P.f[0].kbg);
  // int8 codes: over the value boxes' second half (converted in two rounds
  // about a barrier), or (deep) in the 16 KB past them, before the geo box
  P.codes = P.deep ? P.va + (DVS / BOX) * BOXB : P.va + BN * DVS;
  bool ok = P.qgeo >= (uint32_t)P.qres * BOXB &&
            P.qsel >= P.qgeo + (P.has_kg ? BM * 32 : 0) &&
            P.qhalf >= P.qsel + P.kbs * BOXB && P.ring >= P.halves * P.qhalf &&
            P.kg >= kbox * BOXB + (P.deep && i8 ? BN * DVS : 0) &&
            P.aux >= P.kg + (P.has_kg ? BN * 32 : 0) &&
            (P.deep ? P.va == 0 && P.stage >= P.aux + 1024
                    : P.va >= P.aux + 1024 && P.stage >= P.va + (DVS / BOX) * BOXB) &&
            P.e >= P.ring + P.S * P.stage &&
            (!groups || P.etile >= (uint32_t)egmax / 16 * 2048) &&
            P.lst >= P.e + 2 * P.etile &&
            P.bars >= P.lst + 4 * K &&
            P.total >= P.bars + 8 * (1 + 2 * P.S) + 16 + 1024 && P.total <= MAX_SMEM &&
            (P.qhalf | P.qgeo | P.qsel | P.ring | P.stage | P.kg | P.aux | P.va | P.e |
             P.etile) % 1024 == 0 &&
            (P.lst | P.bars) % 16 == 0;
  const void* ptrs[] = {q_cat, k_cat, values, mask_neg, idx, g0, vw0, out};
  for (const void* ptr : ptrs) ok = ok && ptr != nullptr && aligned16(ptr);
  ok = ok && aligned16(scale) && (!two || (g1 != nullptr && vw1 != nullptr && aligned16(g1) &&
                                           aligned16(vw1)));
  if (!ok || (n_seg > 1 && (work == nullptr || !aligned16(work))))
    return (int)cudaErrorInvalidValue;
  P.out = static_cast<float*>(n_seg > 1 ? work : out);
  P.plane = n_seg > 1 ? (size_t)Bp * P.out_w : 0;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;

  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(q_cat);
  const bf* k = static_cast<const bf*>(k_cat);
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B, sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tqg, tqs, tk, tkg, tm, ts, tv, tg[2], tw[2], tc[2];
  ok = map_2d(&tq, q, sem_d, Bp, qw, BOX, BM, sw128) &&
       map_2d(&tqg, q + sem_d, GEO_D, Bp, qw, GEO_D, BM, sw32) &&
       map_2d(&tk, k, sem_d, N, cat_d, BOX, BN, sw128) &&
       map_2d(&tkg, k + sem_d, GEO_D, N, cat_d, GEO_D, BN, sw32) && map_1d(&tm, mask_neg, N, BN);
  ok = ok && (sel ? map_2d(&tqs, q + cat_d, gw0, Bp, qw, BOX, BM, sw128) : (tqs = tq, true));
  ok = ok && (i8 ? map_2d_u8(&tv, values, Dv, N, DVS, BN) && map_1d(&ts, scale, N, BN)
                 : map_2d(&tv, values, Dv, N, Dv, BOX, BN, sw128) && (ts = tm, true));
  const void* gs[2] = {g0, two ? g1 : g0};
  const void* vws[2] = {vw0, two ? vw1 : vw0};
  const int Gs[2] = {G0, two ? G1 : G0}, gws[2] = {gw0, two ? gw1 : gw0};
  const int Ws[2] = {W0, two ? W1 : W0};
  for (int f = 0; f < 2 && ok; ++f) {
    const Fam& F = P.f[f];
    const bf* gp = static_cast<const bf*>(gs[f]);
    const bf* vp = static_cast<const bf*>(vws[f]);
    // a deep chain's passes take GC centroid rows (the logits' wgmma N)
    ok = (F.geo ? map_2d(&tg[f], gp, GEO_D, Gs[f], gws[f], GEO_D, F.eg, sw32)
                : map_2d(&tg[f], gp, sel ? gw0 : sem_d, Gs[f], gws[f], BOX,
                         F.nsub > 1 ? GC : F.eg, sw128)) &&
         map_2d(&tw[f], vp, Ws[f], Gs[f], Ws[f], BOX, F.eg, sw128) &&
         (F.grp ? map_2d(&tc[f], vp + Dv, 8, Gs[f], Ws[f], 8, F.eg, CU_TENSOR_MAP_SWIZZLE_NONE)
                : (tc[f] = tm, true));
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = P.deep ? (i8 ? hier_parts_sm90_kernel<true, true>
                                   : hier_parts_sm90_kernel<false, true>)
                             : (i8 ? hier_parts_sm90_kernel<true, false>
                                   : hier_parts_sm90_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.total);
  if (err != cudaSuccess) return (int)err;
  P.nslb = P.pair ? cdiv(P.nsl, 2) : P.nsl;
  P.nab = P.pair ? cdiv(P.na, 2) : P.na;
  kernel<<<P.n_qb * (P.nslb + P.nab) * n_seg, THREADS, P.total, s>>>(
      tq, tqg, tqs, tk, tkg, tm, ts, tv, tg[0], tg[1], tw[0], tw[1], tc[0], tc[1], P);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  const size_t n = (size_t)Bp * P.out_w / 4;
  parts_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(out), Bp, P.out_w, n_seg);
  return (int)cudaGetLastError();
}

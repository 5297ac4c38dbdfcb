// Dense dual-softmax retrieval for Hopper (sm_90a): wgmma on both products,
// a TMA ring under mbarriers, and accumulation chains of bounded length.
//
// Replaces, for bf16 packed operands (the 'fast' and 'high' tiers; the
// 'exact' tier, f32 logits on the CUDA cores, stays on csrc/fused_retrieval.cu):
//   * range_tpu/ops/retrieval_pallas.py:123, `_fused_kernel` (reached via
//     retrieve_fused <- retrieve_pallas): bf16 values;
//   * :181, `_fused_kernel_i8` (retrieve_fused_i8): int8 value codes with a
//     per-row f32 scale;
//   * :314, `_fused_parts_kernel` (retrieve_fused_parts <-
//     parallel/sharded.sharded_retrieve_pallas), with and without the scale:
//     one bank shard's unnormalized partials, laid out [acc_s | acc_g | d_s |
//     d_g | 0 ...], [B, 2 Dv + 128] f32, summed across shards by the caller.
// Per (query, bank row), in order: the semantic logits over [0, sem_d) and
// the geo logits over the 16 columns from sem_d, plus the row mask; p =
// exp2(min(l, 86)) for each family; the sums d_s, d_g of the unrounded p;
// acc_f += bf16(p_f s) V in f32 (s the row's scale with int8 codes, whose
// conversion to bf16 is exact; else 1); at the end beta acc_s / max(d_s,
// 1e-30) + (1 - beta) acc_g / max(d_g, 1e-30), or the raw sums (partials).
// These are the TPU kernels' rounding points.
//
// What bounds it on an H100: the tensor cores and shared memory, about
// equally.  A block of 64 queries and a 256-column value slice needs, per
// 64-row bank tile, 6.4 MFLOP (the two value products, 4.2, and the
// 272-deep logits of its slice, 2.2: each of the 4 slices at Dv = 1,024
// recomputes them) and ~203 KB of shared-memory traffic (68 KB of TMA
// writes; wgmma reads the queries and keys of the logits and the value
// tile once per family): ~0.86 and ~0.80 us of one SM at the card's peaks.
// int8 codes halve the value bytes from device memory, but every block
// converts its slice of each tile (16,384 codes) on the CUDA cores, and
// those instructions pace the int8 path (~0.8 us a tile on the H100).
//
// Layout.  A block owns BM = 64 queries (one wgmma M) and one DVS-column
// slice of the values, and walks the bank rows of one segment in tiles of
// BN rows.  Three warpgroups (384 threads, one block an SM):
//   * warpgroup 2 is the producer: one thread keeps rings of tiles filled
//     by TMA (the key tile's semantic columns as 128-byte swizzled boxes of
//     64 columns, its 16 geo columns as one 32-byte swizzled box, the mask,
//     with int8 codes the scales, the value slice as 128-byte swizzled
//     boxes), each stage signalled by one mbarrier with its byte count and
//     freed by an arrive from each consumer warp.  The query block is loaded
//     once.  setmaxnreg gives it 40 registers and the consumers 232 (168
//     each at launch).
//   * warpgroup 0 takes the semantic family, warpgroup 1 the geo family.
//     Each computes its logits with wgmma m64nBNk16 (queries and keys both
//     K-major in shared memory), takes p = exp2 in registers, keeps its row
//     sums, folds the row scale into p, and runs its value product, wgmma
//     m64n128k16 with B = the value tile (MN-major, transposed by the
//     instruction) into its own accumulator: 64 queries x DVS columns, DVS / 2
//     f32 registers a thread.  The two families run independently on the
//     ring, so one group's exponentials overlap the other's tensor work;
//     one arrive a warp and stage replaces the three block-wide barriers a
//     tile of the mma.sync kernel.
// int8 codes (I8): the producer thread streams each value tile's codes by
// TMA in halves of BN / 2 rows through a ring of two half tiles (one loads
// while the other converts; 16 KB beside the 'fast' form's three key
// stages, where two whole tiles would not fit), and the producer
// warpgroup's other three warps convert each half into the bf16 value
// stage (exactly, by byte permutes and one bf16x2 subtraction: no
// conversion instruction), in its 128-byte swizzle, then arrive on the
// stage's barrier; the consumers run the unchanged value wgmma.  (The
// other way, acc^T = V^T P^T with the codes converted in registers as
// wgmma's A operand, writes 8 KB of p a family a tile instead of 32 KB of
// values, but needs the accumulator transposed and p through shared
// memory: a rewrite of the consumers, where this design leaves them as
// they were.)
// Two forms of that layout:
//   * flat (fused_sm90_kernel): p goes to bf16 straight into wgmma's
//     register A fragments.  Key tiles and value tiles have rings of their
//     own (3 key stages, 2 value stages), so tile it + 1's logits are
//     issued before tile it's value product and their exponentials run
//     while it computes; the logits' k16 steps are unrolled (a loop made
//     ptxas serialize the two products).  Built for the 'fast' tier (BN =
//     64, DVS = 256, 4 key boxes: 209 KB of shared memory, 225 KB with the
//     int8 halves) and the 'high' one (BN = 32, DVS = 128, 12 boxes, 2 key
//     stages; bf16 values only).
//   * cluster (fused_sm90_cluster_kernel): the CS blocks of one query
//     block's slices (4 where the slices divide by 4) share each tile's
//     logits: block `rank` computes the logits of the tile's rows [rank QR,
//     (rank + 1) QR), QR = BN / CS, loads only those key rows, writes bf16
//     p into its shared memory and copies it into the others' (distributed
//     shared memory, a bulk copy completing on the receiver's barrier); the
//     value products take P from shared memory.  The logit work and the key
//     traffic drop by CS, the tile's P crosses SMs.  BN = 64, DVS = 256 or
//     128, 2 or 3 stages, any sem_d that fits.  It is the faster form where
//     the keys are wide (the 'high' tier, sem_d 768: the flat form there
//     needs 32 x 128 tiles and recomputes 784-deep logits 8 times), the
//     slower one at 'fast' (PERF.md); ops/retrieval_fused._segment_plan
//     picks.  With int8 codes each stage's value tile is converted from the
//     same 2-stage ring of half tiles, on a barrier of its own that the
//     consumers wait on before the value product.
// sem_d must be a multiple of 64.
//
// Segments.  The tensor cores add each k16 step into the running f32 sum
// with truncation, so one chain over all of a 100k-row bank drifts.  The
// bank rows are cut into n_seg segments of seg_rows rows (a multiple of
// BN), one block (or cluster) each along grid z: the chain is seg_rows / 16
// steps.  With one segment the block normalizes and blends itself (or
// writes the partials, kernel 5); with more each block writes its
// unnormalized partials [acc_s | acc_g | d_s | d_g] to a workspace [n_seg,
// B, 2 Dv + 2], and segment_reduce_kernel adds them in segment order (no
// atomics: the answer is deterministic) and normalizes and blends, or
// parts_reduce_kernel adds them into kernel 5's layout.  The plan bounds
// seg_rows by the measured drift (12,800 rows) and cuts more segments where
// the request alone would not fill the card's 132 SMs; it depends on (B, N,
// Dv, sem_d, int8 or not) only, so one bank shard and one card cut the same
// bank alike.
//
// Ragged edges: TMA zero-fills rows past B and N and columns past Dv (a box
// wholly past them is not loaded); the kernel sets p = 0 past the
// segment's last row, and writes no row past B or column past Dv.  A wait
// on a barrier that never completes traps after ~10 s (a CUDA error in the
// caller) instead of hanging the card.
//
// The Hopper plumbing (mbarriers, TMA, wgmma descriptors and instructions,
// clusters) lives in sm90_common.cuh, shared with hier_scan_sm90.cu.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;                // queries per block: one wgmma M
constexpr int CONSUMER_THREADS = 256; // warpgroups 0 (semantic) and 1 (geo)
constexpr int THREADS = 384;          // and the producer warpgroup
constexpr int CONVERTERS = 96;        // its warps 1-3: int8 codes to bf16
constexpr int CONVERTER_WARPS = CONVERTERS / 32;
constexpr int GEO_D = 16;             // geo columns: one k16 step, a 32-byte box
constexpr int PARTS_PAD = 128;        // kernel 5's columns past 2 Dv: d_s, d_g, zeros
constexpr int S8 = 2;                 // int8: half tiles of codes in the ring
constexpr float CLAMP2 = 86.0f;

// Shared memory of the flat form (offsets from a 1024-byte aligned base):
// the query block (kb boxes of [64 rows][64 cols], then [64][16] geo),
// `kst` stages of key tiles [kb boxes | geo keys | mask | int8: scales],
// two stages of value tiles [DVS / 64 boxes], int8: S8 half tiles of
// codes [BN / 2 rows][DVS], the barriers (the query's, full and empty of
// each key stage, then of each value stage, then int8: of each half).
// Every 128-byte swizzled box starts on 1024 bytes.
struct Layout {
  uint32_t qg, k0, kstage, kg, mask, scale, v0, vstage, s8, bars, total, q_bytes, k_bytes;
};

__host__ __device__ constexpr Layout layout(int kb, int bn, int dvs, int kst, bool i8) {
  Layout l{};
  l.qg = kb * BM * 128;
  l.q_bytes = l.qg + BM * GEO_D * 2;
  l.k0 = round_up(l.q_bytes, 1024);
  l.kg = kb * bn * 128;
  l.mask = l.kg + bn * GEO_D * 2;
  l.scale = l.mask + bn * 4;
  l.k_bytes = l.scale + (i8 ? bn * 4 : 0);
  l.kstage = round_up(l.k_bytes, 1024);
  l.v0 = l.k0 + kst * l.kstage;
  l.vstage = (dvs / BOX) * bn * 128;
  l.s8 = l.v0 + 2 * l.vstage;
  l.bars = l.s8 + (i8 ? S8 * (bn / 2) * dvs : 0);
  l.total = l.bars + 8 * (1 + 2 * kst + 4 + (i8 ? 2 * S8 : 0)) + 1024;  // + slack to align the base
  return l;
}

// The flat form's key stages: 3 where they fit, else 2.
__host__ __device__ constexpr int flat_stages(int kb, int bn, int dvs, bool i8) {
  return layout(kb, bn, dvs, 3, i8).total <= MAX_SMEM ? 3 : 2;
}

struct Params {
  float* out;       // one segment: [B, Dv] ([B, 2 Dv + 128]: parts); more: [n_seg, B, 2 Dv + 2]
  int B, N, Dv, kb, seg_rows, n_seg;
  int stages;       // ring stages (of key tiles, in the flat form)
  int parts;        // 1: the unnormalized partials of kernel 5
  float beta;
};

template <int BN>
__device__ __forceinline__ void wgmma_logits(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
  if constexpr (BN == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    wgmma_ss_n32(d, a, b, scale_d);
  }
}

// Four int8 codes (one 32-bit word) as two bf16 pairs, exactly and off
// the conversion pipe: a code c is (128 + (c & 127)) - (c < 0 ? 256 : 128),
// both terms bf16 built by a byte permute (high byte 0x43: 2^7), their
// difference an integer that bf16 holds.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  const uint32_t v0 = __byte_perm(mag, 0x43434343u, 0x4140);
  const uint32_t v1 = __byte_perm(mag, 0x43434343u, 0x4342);
  const uint32_t s0 = __byte_perm(sgn, 0x43434343u, 0x4140);
  const uint32_t s1 = __byte_perm(sgn, 0x43434343u, 0x4342);
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(v0), "r"(s0));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(v1), "r"(s1));
}

// Rows [r0, r0 + BN / 2) of a value tile from a half tile of int8 codes at
// src ([BN / 2][DVS] bytes) into the bf16 tile at v (DVS / 64 boxes of [BN
// rows][64 columns], 128-byte swizzled, as TMA writes them); `ct` of the
// CONVERTERS threads, 32 codes (two 16-byte loads, four 16-byte stores) a
// task.  The conversion's instructions pace the int8 path (on the H100,
// skipping it gives the bf16 time, doing it twice adds its time again), so
// a task is as wide as the producer warpgroup's 40 registers allow: wider
// tasks took less time (tools/torch_int8_conversion.py times each width).
template <int BN, int DVS>
__device__ __forceinline__ void convert_half(uint32_t src, uint32_t v, int r0, int ct) {
  constexpr int CH = DVS / 32;  // 32-code chunks a row
  constexpr int TASKS = (BN / 2) * CH, PER = (TASKS + CONVERTERS - 1) / CONVERTERS;
#pragma unroll 1
  for (int j = 0; j < PER; ++j) {
    const int i = ct + j * CONVERTERS;
    if (i >= TASKS) break;
    uint32_t w[8];
    const uint32_t a = src + (i / CH) * DVS + (i % CH) * 32;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(a));
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7])
                 : "r"(a + 16));
    // the task's 4 chunks of 8 columns: box k / 2, chunks 4 (k % 2) + q
    const int k = i % CH, row = r0 + i / CH;
    const uint32_t rb = v + (k >> 1) * (BN * 128) + row * 128, sw = row & 7, c0 = (4 * k) & 7;
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
  // visible to the tensor cores' (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The block's output rows r0 and r0 + 8 of one warp (this thread's columns
// 8j + 2t, + 1 of each 128-column half h), from its accumulator and the
// rows' full sums.  Several segments: the unnormalized partials
// [acc_s | acc_g | d_s | d_g] of this segment; one segment of kernel 5: the
// same sums into its output [acc_s | acc_g | d_s | d_g | 0 ...] (value slice
// 0 writes d and the zeros).  Otherwise the geo group leaves (1 - beta) acc_g
// / d_g in shared memory (`ring`, free once both groups are past their last
// tile), the semantic group adds beta acc_s / d_s and writes the output.
template <int DVS, bool GEO>
__device__ __forceinline__ void epilogue(const Params& p, uint8_t* ring,
                                         float (&acc)[DVS / 128][64], const float (&dsum)[2],
                                         int r0, int t) {
  constexpr int H = DVS / 128;
  const int B = p.B, Dv = p.Dv;
  const int q0 = blockIdx.x * BM, c0 = blockIdx.y * DVS;
  if (p.n_seg > 1 || p.parts) {
    const bool plane = p.n_seg > 1;
    const size_t ld = 2 * (size_t)Dv + (plane ? 2 : PARTS_PAD);
    float* part = p.out + (plane ? (size_t)blockIdx.z * B * ld : 0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + r0 + 8 * e;
      if (q >= B) continue;
      float* row = part + (size_t)q * ld;
      if (blockIdx.y == 0) {
        if (t == 0) row[2 * Dv + (GEO ? 1 : 0)] = dsum[e];
        if (GEO && !plane)
          for (int c = 2 + t; c < PARTS_PAD; c += 4) row[2 * Dv + c] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 128 * h + 8 * j + 2 * t;
          if (c < Dv)
            *reinterpret_cast<float2*>(row + (GEO ? Dv : 0) + c) =
                make_float2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
        }
    }
    return;
  }
  const float beta = p.beta;
  float* out = p.out;
  constexpr int LDG = DVS + 8;  // f32 row stride of the staged geo half
  float* gbuf = reinterpret_cast<float*>(ring);
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  if constexpr (GEO) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dg = fmaxf(dsum[e], 1e-30f);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(gbuf + (r0 + 8 * e) * LDG + 128 * h + 8 * j + 2 * t) =
              make_float2((1.0f - beta) * (acc[h][4 * j + 2 * e] / dg),
                          (1.0f - beta) * (acc[h][4 * j + 2 * e + 1] / dg));
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  if constexpr (!GEO) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e, q = q0 + r;
      if (q >= B) continue;
      const float ds = fmaxf(dsum[e], 1e-30f);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int cl = 128 * h + 8 * j + 2 * t, c = c0 + cl;
          if (c >= Dv) continue;
          const float2 geo = *reinterpret_cast<const float2*>(gbuf + r * LDG + cl);
          *reinterpret_cast<float2*>(out + (size_t)q * Dv + c) =
              make_float2(beta * (acc[h][4 * j + 2 * e] / ds) + geo.x,
                          beta * (acc[h][4 * j + 2 * e + 1] / ds) + geo.y);
        }
    }
  }
}

// ---- the flat form (see the head of the file)

// Issue (not wait for) the logits [64 x BN] of one family against the key
// tile at kst; the KB boxes' k16 steps unrolled, so that ptxas can keep
// this product in flight beside the value product (a loop over them made
// it serialize the two).
template <int BN, int KB, bool GEO>
__device__ __forceinline__ void issue_logits(float (&sc)[BN / 2], uint32_t base,
                                             const Layout& lay, uint32_t kst) {
  if constexpr (GEO) {
    wgmma_logits<BN>(sc, desc_k32(base + lay.qg), desc_k32(kst + lay.kg), 0);
  } else {
#pragma unroll
    for (int ks = 0; ks < 4 * KB; ++ks) {
      const uint32_t off = (ks & 3) * 32;  // k16 step within the 128-byte row
      wgmma_logits<BN>(sc, desc_k128(base + (ks >> 2) * (BM * 128) + off),
                       desc_k128(kst + (ks >> 2) * (BN * 128) + off), ks > 0 ? 1 : 0);
    }
  }
  wgmma_commit();
}

// One consumer warpgroup of the flat form: family GEO (else semantic) over
// the block's tiles, then its share of the epilogue.  Tile it + 1's logits
// are issued ahead of tile it's value product and their exponentials run
// while that product computes; bf16(p) goes into the register A fragments
// once the product is done.
template <int BN, int DVS, int KB, bool GEO, bool I8>
__device__ __forceinline__ void consume(const Params& p, const Layout& lay, uint8_t* smem,
                                       uint32_t base, int tiles, int n_rows) {
  constexpr int H = DVS / 128, KST = flat_stages(KB, BN, DVS, I8);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t bq = base + lay.bars, kfull = bq + 8, kempty = kfull + 8 * KST;
  const uint32_t vfull = kempty + 8 * KST, vempty = vfull + 16;
  float acc[H][64];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  float dsum[2] = {0.f, 0.f};  // rows 16 warp + g and + 8: this thread's columns
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  auto kaddr = [&](int it) { return lay.k0 + (it % KST) * lay.kstage; };
  // p = exp2(min(l + mask, 86)) in place of tile it's logits (0 past its
  // valid rows) and the row sums, then p times the row's scale (int8
  // codes): accumulator element 4j + e is row g + 8 (e >> 1), column 8j +
  // 2t + (e & 1)
  auto exps = [&](int it) {
    const float* mk = reinterpret_cast<const float*>(smem + kaddr(it) + lay.mask);
    const float* sk = reinterpret_cast<const float*>(smem + kaddr(it) + lay.scale);
    const int left = n_rows - it * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 m = *reinterpret_cast<const float2*>(mk + c);
      const bool v0 = c < left, v1 = c + 1 < left;
      sc[4 * j] = v0 ? exp2f(fminf(sc[4 * j] + m.x, CLAMP2)) : 0.f;
      sc[4 * j + 1] = v1 ? exp2f(fminf(sc[4 * j + 1] + m.y, CLAMP2)) : 0.f;
      sc[4 * j + 2] = v0 ? exp2f(fminf(sc[4 * j + 2] + m.x, CLAMP2)) : 0.f;
      sc[4 * j + 3] = v1 ? exp2f(fminf(sc[4 * j + 3] + m.y, CLAMP2)) : 0.f;
      dsum[0] += sc[4 * j] + sc[4 * j + 1];
      dsum[1] += sc[4 * j + 2] + sc[4 * j + 3];
      if constexpr (I8) {
        const float2 s = *reinterpret_cast<const float2*>(sk + c);
        sc[4 * j] *= s.x;
        sc[4 * j + 1] *= s.y;
        sc[4 * j + 2] *= s.x;
        sc[4 * j + 3] *= s.y;
      }
    }
  };
  // bf16(p) as A fragments: k16 step kk takes chunks 2kk (a0, a1) and 2kk + 1
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      pa[j >> 1][2 * (j & 1)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };
  auto values = [&](int it) {  // issue acc += bf16(p) [64 x BN] @ V [BN x DVS]
    const uint32_t v = base + lay.v0 + (it & 1) * lay.vstage;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs_n128(acc[h], pa[kk], desc_v(v + 2 * h * (BN * 128) + kk * 16 * 128, BN));
    wgmma_commit();
  };
  auto arrive = [&](uint32_t bar) {  // this warp is done with a stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  mbar_wait(bq, 0);  // the query block
  mbar_wait(kfull, 0);
  wgmma_fence();
  issue_logits<BN, KB, GEO>(sc, base, lay, base + kaddr(0));
  wgmma_wait0();
  fence_regs(sc);
  exps(0);
  arrive(kempty);
  pack();
  // every tile but the last, then the last alone: no wgmma is issued under
  // a condition, which also made ptxas serialize them
  for (int it = 0; it + 1 < tiles; ++it) {
    const int k1 = (it + 1) % KST, vs = it & 1;
    mbar_wait(kfull + 8 * k1, ((it + 1) / KST) & 1);
    mbar_wait(vfull + 8 * vs, (it >> 1) & 1);
    wgmma_fence();
    issue_logits<BN, KB, GEO>(sc, base, lay, base + kaddr(it + 1));
    values(it);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the logits
    fence_regs(sc);
    exps(it + 1);
    arrive(kempty + 8 * k1);
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(acc[h]);
    arrive(vempty + 8 * vs);
    pack();
  }
  {
    const int vs = (tiles - 1) & 1;
    mbar_wait(vfull + 8 * vs, ((tiles - 1) >> 1) & 1);
    wgmma_fence();
    values(tiles - 1);
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(acc[h]);
    arrive(vempty + 8 * vs);
  }

  // ---- row sums over the four lanes of a row
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], 1);
    dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], 2);
  }
  epilogue<DVS, GEO>(p, smem + lay.k0, acc, dsum, 16 * warp + g, t);
}

// The producer thread's int8 codes of tile `it` (rows from n0): each half
// into its stage of the ring of half tiles once the converters are done
// with it (a half wholly past the bank is not loaded: its rows have p
// = 0).
template <int BN, int DVS>
__device__ __forceinline__ void load_codes(const CUtensorMap* tv, uint32_t s8, uint32_t sfull,
                                           uint32_t sempty, int it, int n0, int c0, int N) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int hh = 2 * it + h, s = hh % S8;
    mbar_wait(sempty + 8 * s, ((hh / S8) & 1) ^ 1);
    const int r = n0 + h * (BN / 2);
    if (r < N) {
      mbar_expect_tx(sfull + 8 * s, (BN / 2) * DVS);
      tma_2d(s8 + s * (BN / 2) * DVS, tv, c0, r, sfull + 8 * s);
    } else {
      mbar_arrive(sfull + 8 * s);
    }
  }
}

// One arrive of this converting warp on a barrier, once every lane's
// reads and (fenced) writes are done.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// A converting thread's share of tile `it`: both halves into value tile v,
// once each has landed; each warp arrives on the half's empty barrier.
template <int BN, int DVS>
__device__ __forceinline__ void convert_tile(uint32_t s8, uint32_t v, uint32_t sfull,
                                             uint32_t sempty, int it, int ct) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int hh = 2 * it + h, s = hh % S8;
    mbar_wait(sfull + 8 * s, (hh / S8) & 1);
    convert_half<BN, DVS>(s8 + s * (BN / 2) * DVS, v, h * (BN / 2), ct);
    warp_arrive(sempty + 8 * s);
  }
}

template <int BN, int DVS, int KB, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
    fused_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tqg,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tkg,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tm,
                      const __grid_constant__ CUtensorMap ts, const Params p) {
  constexpr int KST = flat_stages(KB, BN, DVS, I8);
  constexpr Layout lay = layout(KB, BN, DVS, KST, I8);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bq = base + lay.bars, kfull = bq + 8, kempty = kfull + 8 * KST;
  const uint32_t vfull = kempty + 8 * KST, vempty = vfull + 16;
  const uint32_t sfull = vempty + 16, sempty = sfull + 8 * S8;  // int8: the half tiles
  const int n_begin = blockIdx.z * p.seg_rows;
  const int n_rows = min(p.N - n_begin, p.seg_rows);  // > 0: the plan has no empty segment
  const int tiles = (n_rows + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bq, 1);
#pragma unroll
    for (int s = 0; s < KST; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, CONSUMER_THREADS / 32);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(vfull + 8 * s, I8 ? CONVERTER_WARPS : 1);
      mbar_init(vempty + 8 * s, CONSUMER_THREADS / 32);
    }
    if constexpr (I8) {
#pragma unroll
      for (int s = 0; s < S8; ++s) {
        mbar_init(sfull + 8 * s, 1);
        mbar_init(sempty + 8 * s, CONVERTER_WARPS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- the producer warpgroup: one thread issues every copy, the keys
    // one tile ahead of the values; with int8 codes three warps convert
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int c0 = blockIdx.y * DVS;
    if (threadIdx.x == CONSUMER_THREADS) {
      const int q0 = blockIdx.x * BM, geo_col = BOX * KB;
      const int vboxes = min(DVS / BOX, (p.Dv - c0 + BOX - 1) / BOX);  // boxes inside Dv
      mbar_expect_tx(bq, lay.q_bytes);
      for (int i = 0; i < KB; ++i) tma_2d(base + i * BM * 128, &tq, BOX * i, q0, bq);
      tma_2d(base + lay.qg, &tqg, geo_col, q0, bq);
      int kt = 0;  // the next key tile to load
      for (int it = 0; it < tiles; ++it) {
        for (; kt < tiles && kt <= it + 1; ++kt) {
          const int s = kt % KST, n0 = n_begin + kt * BN;
          mbar_wait(kempty + 8 * s, ((kt / KST) & 1) ^ 1);
          const uint32_t st = base + lay.k0 + s * lay.kstage, full = kfull + 8 * s;
          mbar_expect_tx(full, lay.k_bytes);
          for (int i = 0; i < KB; ++i) tma_2d(st + i * BN * 128, &tk, BOX * i, n0, full);
          tma_2d(st + lay.kg, &tkg, geo_col, n0, full);
          tma_1d(st + lay.mask, &tm, n0, full);
          if constexpr (I8) tma_1d(st + lay.scale, &ts, n0, full);
        }
        const int n0 = n_begin + it * BN;
        if constexpr (I8) {
          load_codes<BN, DVS>(&tv, base + lay.s8, sfull, sempty, it, n0, c0, p.N);
        } else {
          const int s = it & 1;
          mbar_wait(vempty + 8 * s, ((it >> 1) & 1) ^ 1);
          const uint32_t st = base + lay.v0 + s * lay.vstage, full = vfull + 8 * s;
          mbar_expect_tx(full, vboxes * BN * 128);
          for (int j = 0; j < vboxes; ++j) tma_2d(st + j * BN * 128, &tv, c0 + BOX * j, n0, full);
        }
      }
    } else if (I8 && threadIdx.x >= CONSUMER_THREADS + 32) {
      const int ct = threadIdx.x - CONSUMER_THREADS - 32;
      for (int it = 0; it < tiles; ++it) {
        const int vs = it & 1;
        mbar_wait(vempty + 8 * vs, ((it >> 1) & 1) ^ 1);
        convert_tile<BN, DVS>(base + lay.s8, base + lay.v0 + vs * lay.vstage, sfull,
                                       sempty, it, ct);
        warp_arrive(vfull + 8 * vs);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (threadIdx.x < 128) {
      consume<BN, DVS, KB, false, I8>(p, lay, smem, base, tiles, n_rows);
    } else {
      consume<BN, DVS, KB, true, I8>(p, lay, smem, base, tiles, n_rows);
    }
  }
}

// ---- the cluster form (see the head of the file)

constexpr int MAX_STAGES = 4;

// Shared memory of the cluster form: the query block, `stages` stages of
// [DVS / 64 value boxes | kb key boxes of QR rows | P: two families x BN /
// 16 blocks of [64 rows][16 cols], 32-byte swizzled | QR geo key rows |
// QR mask entries | int8: QR scales], int8: S8 half tiles of codes [BN / 2
// rows][DVS], the barriers (the query's, and per stage: full, empty, P of
// each family; int8: the converted values of each stage, full and empty of
// each half), and the row sums of every rank.
struct CLayout {
  uint32_t qg, stage0, stage, kq, p, kg, mask, scale, s8, bars, dpart, total, q_bytes, tx_bytes;
};

__host__ __device__ inline CLayout clayout(int kb, int bn, int dvs, int cs, int stages, bool i8) {
  const int qr = bn / cs;
  const uint32_t qmask = round_up(qr * 4, 16);
  CLayout l;
  l.qg = kb * BM * 128;
  l.q_bytes = l.qg + BM * GEO_D * 2;
  l.stage0 = round_up(l.q_bytes, 1024);
  l.kq = (dvs / BOX) * bn * 128;
  l.p = l.kq + kb * qr * 128;
  l.kg = l.p + 2 * (bn / 16) * 2048;
  l.mask = l.kg + qr * GEO_D * 2;
  l.scale = l.mask + round_up(qmask, 128);  // a TMA destination starts on 128 bytes
  l.stage = round_up(l.scale + (i8 ? qmask : 0), 1024);
  // what TMA writes into a stage: the bf16 values (the converters write them
  // from int8 codes), this rank's key rows, geo keys, mask (and scales)
  l.tx_bytes = (i8 ? 0 : l.kq) + kb * qr * 128 + qr * GEO_D * 2 + qmask * (i8 ? 2 : 1);
  l.s8 = l.stage0 + stages * l.stage;
  l.bars = l.s8 + (i8 ? bn * dvs : 0);
  l.dpart = l.bars + 8 * (1 + 4 * MAX_STAGES + (i8 ? MAX_STAGES + 4 : 0));
  l.total = l.dpart + cs * 2 * BM * 4 + 1024;
  return l;
}

template <int QR>
__device__ __forceinline__ void wgmma_quarter(float (&d)[QR / 2], uint64_t a, uint64_t b,
                                              int scale_d) {
  if constexpr (QR == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else if constexpr (QR == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else {
    wgmma_ss_n16(d, a, b, scale_d);
  }
}

template <int BN, int DVS, int CS, bool GEO, bool I8>
__device__ __forceinline__ void consume_cluster(const Params& p, const CLayout& lay,
                                               uint8_t* smem, uint32_t rank, int tiles,
                                               int n_rows) {
  constexpr int H = DVS / 128, QR = BN / CS, KS = BN / 16, KSQ = QR / 16;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t base = smem_u32(smem), bars = base + lay.bars;
  const uint32_t full0 = bars + 8, empty0 = full0 + 8 * MAX_STAGES;
  const uint32_t pfull0 = empty0 + 8 * MAX_STAGES + (GEO ? 8 * MAX_STAGES : 0);
  const uint32_t vready0 = empty0 + 24 * MAX_STAGES;

  float acc[H][64];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  float dsum[2] = {0.f, 0.f};

  mbar_wait(bars, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % p.stages;
    const uint32_t ph = (it / p.stages) & 1;
    mbar_wait(full0 + 8 * s, ph);
    const uint32_t st = base + lay.stage0 + s * lay.stage;
    const uint32_t pbase = st + lay.p + (GEO ? KS * 2048 : 0);

    // ---- logits [64 x QR] of this block's rows of the tile
    float sc[QR / 2];
    wgmma_fence();
    if constexpr (GEO) {
      wgmma_quarter<QR>(sc, desc_k32(base + lay.qg), desc_k32(st + lay.kg), 0);
    } else {
      for (int ks = 0; ks < 4 * p.kb; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        wgmma_quarter<QR>(sc, desc_k128(base + (ks >> 2) * (BM * 128) + off),
                          desc_k128(st + lay.kq + (ks >> 2) * (QR * 128) + off), ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // ---- p, the row sums, bf16(p s) into this block's P blocks: element
    // (m, k) of a [64][16] block at m * 32 + 16 ((k / 8) ^ ((m / 4) & 1)) + 2 (k % 8)
    const float* mk = reinterpret_cast<const float*>(smem + (st - base) + lay.mask);
    const float* sk = reinterpret_cast<const float*>(smem + (st - base) + lay.scale);
    const int left = n_rows - it * BN - (int)rank * QR;  // valid rows of this block's share
#pragma unroll
    for (int j = 0; j < QR / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 m = *reinterpret_cast<const float2*>(mk + c);
      const bool v0 = c < left, v1 = c + 1 < left;
      float p00 = v0 ? exp2f(fminf(sc[4 * j] + m.x, CLAMP2)) : 0.f;
      float p01 = v1 ? exp2f(fminf(sc[4 * j + 1] + m.y, CLAMP2)) : 0.f;
      float p10 = v0 ? exp2f(fminf(sc[4 * j + 2] + m.x, CLAMP2)) : 0.f;
      float p11 = v1 ? exp2f(fminf(sc[4 * j + 3] + m.y, CLAMP2)) : 0.f;
      dsum[0] += p00 + p01;
      dsum[1] += p10 + p11;
      if constexpr (I8) {
        const float2 sv = *reinterpret_cast<const float2*>(sk + c);
        p00 *= sv.x;
        p01 *= sv.y;
        p10 *= sv.x;
        p11 *= sv.y;
      }
      const int k = c & 15;
      const uint32_t blk = pbase + (rank * KSQ + (c >> 4)) * 2048;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * warp + g + 8 * e;
        const uint32_t addr = blk + row * 32 + ((((k >> 3) ^ (row >> 2)) & 1) << 4) + (k & 7) * 2;
        const uint32_t v = e ? pack_bf16(p10, p11) : pack_bf16(p00, p01);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
      }
    }
    // visible to the tensor cores and the bulk copies, then sent to the
    // other blocks of the cluster
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + (GEO ? 1 : 0)) : "memory");
    const uint32_t pfull = pfull0 + 8 * s;
    if (tid == 0) {
      const uint32_t own = pbase + rank * KSQ * 2048;
      mbar_expect_tx(pfull, (CS - 1) * KSQ * 2048);
#pragma unroll
      for (uint32_t r = 1; r < CS; ++r) {
        const uint32_t to = (rank + r) % CS;
        copy_to_rank(map_rank(own, to), own, KSQ * 2048, map_rank(pfull, to));
      }
    }
    mbar_wait(pfull, ph);
    if constexpr (I8) mbar_wait(vready0 + 8 * s, ph);  // the stage's values, converted

    // ---- acc += bf16(p) [64 x BN] @ V [BN x DVS]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_ss_n128_t(acc[h], desc_k32(pbase + kk * 2048),
                        desc_v(st + 2 * h * (BN * 128) + kk * 16 * 128, BN), 1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) {  // this warp is done with stage s in every block's memory
#pragma unroll
      for (uint32_t r = 0; r < CS; ++r) mbar_arrive_remote(map_rank(empty0 + 8 * s, r));
    }
  }

  // ---- the row sums: this block's share to every block, then the total
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], 1);
    dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], 2);
  }
  const int r0 = 16 * warp + g;
  const uint32_t dpart = base + lay.dpart;  // [rank][family][row] f32
  if (t == 0) {
#pragma unroll
    for (uint32_t r = 0; r < CS; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st_remote(map_rank(dpart + ((rank * 2 + GEO) * BM + r0 + 8 * e) * 4, r), dsum[e]);
  }
  cluster_sync();  // every block's sums are in, and nothing remote follows
  const float* dp = reinterpret_cast<const float*>(smem + lay.dpart);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float d = 0.f;
#pragma unroll
    for (int r = 0; r < CS; ++r) d += dp[(r * 2 + GEO) * BM + r0 + 8 * e];
    dsum[e] = d;
  }
  epilogue<DVS, GEO>(p, smem + lay.stage0, acc, dsum, r0, t);
}

template <int BN, int DVS, int CS, bool I8>
__global__ void __launch_bounds__(THREADS, 1)
    fused_sm90_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tqg,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tkg,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tm,
                              const __grid_constant__ CUtensorMap ts, const Params p) {
  constexpr int QR = BN / CS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const CLayout lay = clayout(p.kb, BN, DVS, CS, p.stages, I8);
  const uint32_t base = smem_u32(smem), bars = base + lay.bars;
  const uint32_t full0 = bars + 8, empty0 = full0 + 8 * MAX_STAGES;
  const uint32_t pfull0 = empty0 + 8 * MAX_STAGES;
  const uint32_t vready0 = empty0 + 24 * MAX_STAGES;
  const uint32_t sfull = vready0 + 8 * MAX_STAGES, sempty = sfull + 16;  // int8: the halves
  const uint32_t rank = cluster_rank();
  const int n_begin = blockIdx.z * p.seg_rows;
  const int n_rows = min(p.N - n_begin, p.seg_rows);
  const int tiles = (n_rows + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CS * CONSUMER_THREADS / 32);
      mbar_init(pfull0 + 8 * s, 1);
      mbar_init(pfull0 + 8 * (MAX_STAGES + s), 1);
      if constexpr (I8) mbar_init(vready0 + 8 * s, CONVERTER_WARPS);
    }
    if constexpr (I8) {
      for (int h = 0; h < 2; ++h) {
        mbar_init(sfull + 8 * h, 1);
        mbar_init(sempty + 8 * h, CONVERTER_WARPS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any remote use

  if (threadIdx.x >= CONSUMER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int c0 = blockIdx.y * DVS;
    if (threadIdx.x == CONSUMER_THREADS) {
      const int q0 = blockIdx.x * BM, geo_col = BOX * p.kb;
      const int vboxes = min(DVS / BOX, (p.Dv - c0 + BOX - 1) / BOX);  // boxes inside Dv
      const uint32_t qmask = round_up(QR * 4, 16);
      const uint32_t kbytes = p.kb * QR * 128 + QR * GEO_D * 2 + qmask * (I8 ? 2 : 1);
      const uint32_t tx = lay.tx_bytes - (I8 ? 0 : (DVS / BOX - vboxes) * BN * 128);
      mbar_expect_tx(bars, lay.q_bytes);
      for (int i = 0; i < p.kb; ++i) tma_2d(base + i * BM * 128, &tq, BOX * i, q0, bars);
      tma_2d(base + lay.qg, &tqg, geo_col, q0, bars);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % p.stages, n0 = n_begin + it * BN, nq = n0 + (int)rank * QR;
        mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);
        const uint32_t st = base + lay.stage0 + s * lay.stage, full = full0 + 8 * s;
        const bool keys = nq < p.N;  // this block's rows of the tile exist
        mbar_expect_tx(full, keys ? tx : tx - kbytes);
        if constexpr (!I8)
          for (int j = 0; j < vboxes; ++j) tma_2d(st + j * BN * 128, &tv, c0 + BOX * j, n0, full);
        if (keys) {
          for (int i = 0; i < p.kb; ++i) tma_2d(st + lay.kq + i * QR * 128, &tk, BOX * i, nq, full);
          tma_2d(st + lay.kg, &tkg, geo_col, nq, full);
          tma_1d(st + lay.mask, &tm, nq, full);
          if constexpr (I8) tma_1d(st + lay.scale, &ts, nq, full);
        }
        if constexpr (I8)
          load_codes<BN, DVS>(&tv, base + lay.s8, sfull, sempty, it, n0, c0, p.N);
      }
    } else if (I8 && threadIdx.x >= CONSUMER_THREADS + 32) {
      // the converters: a stage's value tile once every block is done with it
      const int ct = threadIdx.x - CONSUMER_THREADS - 32;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % p.stages;
        mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);
        convert_tile<BN, DVS>(base + lay.s8, base + lay.stage0 + s * lay.stage,
                                          sfull, sempty, it, ct);
        warp_arrive(vready0 + 8 * s);
      }
    }
    cluster_sync();  // the consumers' closing exchange
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (threadIdx.x < 128) {
      consume_cluster<BN, DVS, CS, false, I8>(p, lay, smem, rank, tiles, n_rows);
    } else {
      consume_cluster<BN, DVS, CS, true, I8>(p, lay, smem, rank, tiles, n_rows);
    }
  }
}

// out[q, c] = beta sum_s acc_s / max(sum_s d_s, 1e-30) + (1 - beta) (geo
// alike), the segments added in order 0, 1, ..., n_seg - 1.
__global__ void segment_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      int B, int Dv, int n_seg, float beta) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * Dv) return;
  const int q = (int)(i / Dv), c = (int)(i % Dv);
  const size_t ld = 2 * (size_t)Dv + 2, plane = (size_t)B * ld;
  const float* row = part + (size_t)q * ld;
  float as = 0.f, ag = 0.f, ds = 0.f, dg = 0.f;
  for (int s = 0; s < n_seg; ++s, row += plane) {
    as += row[c];
    ag += row[Dv + c];
    ds += row[2 * Dv];
    dg += row[2 * Dv + 1];
  }
  out[i] = beta * (as / fmaxf(ds, 1e-30f)) + (1.0f - beta) * (ag / fmaxf(dg, 1e-30f));
}

// Kernel 5's output [B, 2 Dv + 128] = [acc_s | acc_g | d_s | d_g | 0 ...]:
// column c < 2 Dv + 2 the sum of the segments' partials in order 0, 1, ...,
// n_seg - 1, the rest zeros.
__global__ void parts_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int B, int Dv, int n_seg) {
  const size_t ldo = 2 * (size_t)Dv + PARTS_PAD;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * ldo) return;
  const size_t q = i / ldo, c = i % ldo;
  const size_t ld = 2 * (size_t)Dv + 2, plane = (size_t)B * ld;
  float acc = 0.f;
  if (c < ld) {
    const float* src = part + q * ld + c;
    for (int s = 0; s < n_seg; ++s, src += plane) acc += *src;
  }
  out[i] = acc;
}

template <int BN, int DVS, int KB, bool I8>
int launch(const void* q_cat, const void* k_cat, const void* values, const void* scale,
           const void* mask_neg, const Params& p, int cat_d, cudaStream_t stream) {
  constexpr Layout lay = layout(KB, BN, DVS, flat_stages(KB, BN, DVS, I8), I8);
  static_assert(lay.total <= MAX_SMEM, "the flat form's tiles do not fit");
  if (p.kb != KB || p.stages != flat_stages(KB, BN, DVS, I8)) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tqg, tk, tkg, tv, tm, ts;
  bool ok = map_2d(&tq, q_cat, cat_d, p.B, cat_d, BOX, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
            map_2d(&tqg, q_cat, cat_d, p.B, cat_d, GEO_D, BM, CU_TENSOR_MAP_SWIZZLE_32B) &&
            map_2d(&tk, k_cat, cat_d, p.N, cat_d, BOX, BN, CU_TENSOR_MAP_SWIZZLE_128B) &&
            map_2d(&tkg, k_cat, cat_d, p.N, cat_d, GEO_D, BN, CU_TENSOR_MAP_SWIZZLE_32B) &&
            map_1d(&tm, mask_neg, p.N, BN);
  if constexpr (I8) {
    ok = ok && map_2d_u8(&tv, values, p.Dv, p.N, DVS, BN / 2) && map_1d(&ts, scale, p.N, BN);
  } else {
    ok = ok && map_2d(&tv, values, p.Dv, p.N, p.Dv, BOX, BN, CU_TENSOR_MAP_SWIZZLE_128B);
    ts = tm;  // never read
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = fused_sm90_kernel<BN, DVS, KB, I8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.B + BM - 1) / BM, (p.Dv + DVS - 1) / DVS, p.n_seg);
  kernel<<<grid, THREADS, lay.total, stream>>>(tq, tqg, tk, tkg, tv, tm, ts, p);
  return (int)cudaGetLastError();
}

template <int BN, int DVS, int CS, bool I8>
int launch_cluster(const void* q_cat, const void* k_cat, const void* values, const void* scale,
                   const void* mask_neg, const Params& p, int cat_d, cudaStream_t stream) {
  constexpr int QR = BN / CS;
  const CLayout lay = clayout(p.kb, BN, DVS, CS, p.stages, I8);
  if (lay.total > MAX_SMEM || p.stages < 2 || p.stages > MAX_STAGES ||
      ((p.Dv + DVS - 1) / DVS) % CS)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tqg, tk, tkg, tv, tm, ts;
  bool ok = map_2d(&tq, q_cat, cat_d, p.B, cat_d, BOX, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
            map_2d(&tqg, q_cat, cat_d, p.B, cat_d, GEO_D, BM, CU_TENSOR_MAP_SWIZZLE_32B) &&
            map_2d(&tk, k_cat, cat_d, p.N, cat_d, BOX, QR, CU_TENSOR_MAP_SWIZZLE_128B) &&
            map_2d(&tkg, k_cat, cat_d, p.N, cat_d, GEO_D, QR, CU_TENSOR_MAP_SWIZZLE_32B) &&
            map_1d(&tm, mask_neg, p.N, QR);
  if constexpr (I8) {
    ok = ok && map_2d_u8(&tv, values, p.Dv, p.N, DVS, BN / 2) && map_1d(&ts, scale, p.N, QR);
  } else {
    ok = ok && map_2d(&tv, values, p.Dv, p.N, p.Dv, BOX, BN, CU_TENSOR_MAP_SWIZZLE_128B);
    ts = tm;  // never read
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = fused_sm90_cluster_kernel<BN, DVS, CS, I8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.B + BM - 1) / BM, (p.Dv + DVS - 1) / DVS, p.n_seg);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CS;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tqg, tk, tkg, tv, tm, ts, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int DVS, bool I8>
int launch_cluster_any(const void* q, const void* k, const void* v, const void* sc,
                       const void* m, const Params& p, int cat_d, int cs, cudaStream_t s) {
  switch (cs) {
    case 1: return launch_cluster<64, DVS, 1, I8>(q, k, v, sc, m, p, cat_d, s);
    case 2: return launch_cluster<64, DVS, 2, I8>(q, k, v, sc, m, p, cat_d, s);
    case 4: return launch_cluster<64, DVS, 4, I8>(q, k, v, sc, m, p, cat_d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool I8>
int launch_any(const void* q, const void* k, const void* v, const void* sc, const void* m,
               const Params& p, int cat_d, int bn, int dvs, int cs, cudaStream_t s) {
  if (cs > 0 && bn == 64 && dvs == 256) return launch_cluster_any<256, I8>(q, k, v, sc, m, p, cat_d, cs, s);
  if (cs > 0 && bn == 64 && dvs == 128) return launch_cluster_any<128, I8>(q, k, v, sc, m, p, cat_d, cs, s);
  if (cs == 0 && bn == 64 && dvs == 256) return launch<64, 256, 4, I8>(q, k, v, sc, m, p, cat_d, s);
  if constexpr (!I8) {  // the 'high' tier's flat tiles: bf16 values only
    if (cs == 0 && bn == 32 && dvs == 128) return launch<32, 128, 12, false>(q, k, v, sc, m, p, cat_d, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_cat [B, cat_d], k_cat [N, cat_d] bf16 (pack_queries / pack_bank), the
// semantic group in columns [0, sem_d), the geo group in [sem_d, sem_d +
// 16); values [N, Dv] bf16, or int8 codes when scale [N] f32 is given;
// mask_neg [N] f32.  out [B, Dv] f32, or with parts = 1 the unnormalized
// partials [B, 2 Dv + 128] (kernel 5; beta unused).  The form: cs = 0 the
// flat form, tiles (bn, dvs) = (64, 256) or (bf16 values) (32, 128), stages
// = 2; cs = 1, 2 or 4 the cluster form (cs dividing the value slices), bn =
// 64, dvs = 256 or 128, 2 to 4 stages.  The bank rows in n_seg = ceil(N /
// seg_rows) segments (seg_rows % bn == 0); with n_seg > 1, work holds
// [n_seg, B, 2 Dv + 2] f32 partials.  sem_d % 64 == 0, sem_d + 16 <= cat_d,
// cat_d % 8 == 0, Dv % 8 == 0 (int8: % 16); every pointer 16-byte aligned.
// Returns a CUDA error code (cudaErrorInvalidValue for what it does not
// take, with nothing launched).
extern "C" int fused_sm90_launch(const void* q_cat, const void* k_cat, const void* values,
                                 const void* scale, const void* mask_neg, void* out, void* work,
                                 int B, int N, int cat_d, int sem_d, int Dv, float beta, int bn,
                                 int dvs, int cs, int stages, int seg_rows, int n_seg, int parts,
                                 void* stream) {
  const bool i8 = scale != nullptr;
  if (B < 0 || N < 0 || Dv <= 0 || sem_d <= 0 || sem_d % BOX || sem_d + GEO_D > cat_d ||
      cat_d % 8 || Dv % (i8 ? 16 : 8) || seg_rows <= 0 || seg_rows % bn ||
      n_seg != (N > 0 ? (N + seg_rows - 1) / seg_rows : 1) || (n_seg > 1 && work == nullptr) ||
      !aligned16(q_cat) || !aligned16(k_cat) || !aligned16(values) || !aligned16(mask_neg) ||
      !aligned16(scale) || !aligned16(out) || !aligned16(work))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_w = parts ? 2 * (size_t)Dv + PARTS_PAD : (size_t)Dv;
  if (N == 0) {  // no rows: every sum is 0, and so is the blend
    cudaMemsetAsync(out, 0, (size_t)B * out_w * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  Params p{};
  p.out = static_cast<float*>(n_seg > 1 ? work : out);
  p.B = B;
  p.N = N;
  p.Dv = Dv;
  p.kb = sem_d / BOX;
  p.seg_rows = seg_rows;
  p.n_seg = n_seg;
  p.stages = stages;
  p.parts = parts ? 1 : 0;
  p.beta = beta;
  const int rc = i8 ? launch_any<true>(q_cat, k_cat, values, scale, mask_neg, p, cat_d, bn, dvs,
                                       cs, s)
                    : launch_any<false>(q_cat, k_cat, values, scale, mask_neg, p, cat_d, bn, dvs,
                                        cs, s);
  if (rc != 0 || n_seg == 1) return rc;
  const size_t n = (size_t)B * out_w;
  const float* part = static_cast<const float*>(work);
  float* o = static_cast<float*>(out);
  if (parts) {
    parts_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, o, B, Dv, n_seg);
  } else {
    segment_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, o, B, Dv, n_seg,
                                                                     beta);
  }
  return (int)cudaGetLastError();
}

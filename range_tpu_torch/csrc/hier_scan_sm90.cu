// Hierarchical retrieval, stage 1: the fused group scan, for Hopper (sm_90a):
// wgmma on both products, TMA rings under mbarriers, segments that fill the
// card.
//
// Replaces: range_tpu/ops/retrieval_hier.py:1443, `_hier_scan_kernel`
// (reached via _hier_scan_call <- _hier_partials <- retrieve_hier), in every
// form `_hier_scan_call` takes: both families or the sem family alone
// (has_geo = 0, RANGE mode), the segment-sum sem tail of tail_super banks
// (sup_r > 0), and tails of any width that is a multiple of 128 (the
// full-width group value sums, W = Dv + 128 = 1,152, in column slices).  Per
// query and family: the group logits l = q . g in f32 (log2 e and the
// temperatures are folded into the packed queries), per tile of gpt groups
// the max l and the sum of the unrounded p = exp2(min(l, 86)), and the tail
// += bf16(p) @ vw in f32 (sup_r: bf16 of the f32 sum of each sup_r
// consecutive p, rounded once).  These are the TPU kernel's rounding points.
//
// What bounds it on an H100: at the card's peaks, the tensor cores (the
// flagship, 10,112 padded queries over 7,168 sem groups x 256 columns with a
// 384-wide tail and 1,792 geo groups x 128 columns with a 512-wide tail, is
// ~116 GFLOP against ~90 MB of HBM traffic).  In practice the logits
// warpgroup's chain a step (wait for the tile, wgmma, exp2 and the stats on
// one warp per SM sub-partition, the p tile, its barrier) sets the pace,
// several times a step's tensor work (PERF.md, PR 11).  So nothing on that
// chain divides, issues a copy or waits for another warpgroup's copies.
//
// Layout.  A block owns BM = 64 queries (one wgmma M) of one family, one
// column slice of that family's tail and one segment of its groups, and
// walks the segment in steps of BN = 32 groups.  Four warpgroups (512
// threads, one block an SM):
//   * warpgroup 0, the logits: wgmma m64nBNk16 with queries and centroids
//     K-major in shared memory, exp2 in registers, each tile's max and sum
//     from the accumulator fragments with quad shuffles (a tile of 8, 16 or
//     32 groups ends inside a step; longer tiles carry a running max and sum
//     across steps), written straight to [Bp, t_pad]; bf16(p), or the
//     supergroup sums rounded once, into a 2-stage ring of p tiles in shared
//     memory (32-byte swizzled [64][16] blocks, wgmma's K-major A layout).
//   * warpgroups 1 to 3, the tail: the slice's 64-column boxes split
//     between them (at most 3 each), each running wgmma m64nNk16 with A =
//     the p tile and B = the value tile (MN-major, transposed by the
//     instruction) into an accumulator in registers (N / 2 f32 a thread).
//     Step it's products are issued before step it - 1's stages are freed,
//     so the tensor cores never wait on the release.
//   * TMA rings under mbarriers: the query block once (the logits
//     warpgroup's first thread); the centroid tiles gs steps ahead of the
//     tail (at least gs - 2 ahead of the logits) and the value tiles of the
//     slice vs - 1 steps ahead, each one 3-D copy of all its 64-column
//     boxes (128-byte swizzled), issued by a lane of the first tail
//     warpgroup's second and first warp.  Each stage has a full barrier
//     with its byte count and an empty one freed by one arrive a reading
//     warp.  Ring positions, tile and supergroup ends advance by counters:
//     an integer division a step cost the kernel more than its exp2.
// No block-wide barrier after the setup, and no producer warp: ptxas
// compiles every warp's code within the launch's registers a thread
// (setmaxnreg moves registers between warpgroups at run time, not the
// compiler's budget: a 256-column accumulator did not compile at 512
// threads, nor a 192-column one with a fifth warp), 128 at 512 threads.
// That bounds a tail warpgroup at 192 columns, so three of them hold a
// 576-column slice: the logits are computed once a slice, and a wide tail
// (1,152 columns) runs in two slices.
//
// Segments.  Each family's tiles are cut into segments of whole tiles, one
// block each, so a tile's stats come from the one block that owns it.  With
// more than one segment each block writes its partial tail to a workspace
// [n_seg, Bp, W] and scan_reduce_kernel adds them in segment order (no
// atomics: the answer is deterministic).  The plan (ops/retrieval_hier.
// _scan_plan) is a function of the shape alone: enough blocks to fill the
// card's 132 SMs, blocks of about equal work across the families, and no
// accumulation chain over 12,800 tail rows (wgmma's running f32 sum drifts
// over longer chains, PERF.md PR 10).
//
// Ragged edges: TMA zero-fills rows past Bp and past the operands, and
// columns past the centroids' width (a zero column adds 0 to every logit);
// the logits warpgroup sets p = 0 past the segment's last group; no row past
// Bp is written.  A wait on a barrier that never completes traps after ~10 s
// instead of hanging the card.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;          // queries per block: one wgmma M
constexpr int BN = 32;          // groups a step: one wgmma N of the logits
constexpr int TAILS = 3;        // tail warpgroups
constexpr int TAIL_BOXES = 3;   // 64-column boxes a tail warpgroup holds at most
constexpr int THREADS = 128 * (1 + TAILS);  // the logits and tail warpgroups
constexpr float CLAMP2 = 86.0f;

// One family's operands, plan and shared-memory layout (offsets from the
// 1024-byte aligned base): the query block [kb boxes of 64 rows], gs stages
// of centroid tiles [kb boxes of BN rows], vs stages of value tiles
// [sl_boxes boxes of rv rows], two p tiles [rv / 16 blocks of 64 x 16], the
// barriers (the query's; full and empty of each stage of each ring).
struct Fam {
  float* m;            // [Bp, t_pad] max group logit of each tile
  float* s;            // [Bp, t_pad] exp-mass of each tile
  float* out;          // the tails (+ the family's first column), or the partials
  size_t seg_stride;   // floats between two segments' partials (0: one segment)
  int ld;              // row stride of out
  int G, W;            // groups, tail width
  int kb;              // 64-column boxes of the logits' depth
  int q_col;           // the family's first packed query column
  int gpt, sup, rv;    // groups a tile, a tail row (1 or sup_r), tail rows a step (>= 16)
  int n_sl, sl_boxes;  // column slices, boxes a slice
  int n_qb, seg_groups, blocks;
  int g_boxes;         // the centroid width is whole boxes: one copy a tile
  uint32_t g0, gstage, v0, vstage, p0, pstage, bars, total;
};

inline void layout(Fam& f, int gs, int vs) {
  f.g0 = f.kb * BM * 128;
  f.gstage = f.kb * BN * 128;
  f.v0 = f.g0 + gs * f.gstage;
  f.vstage = f.sl_boxes * f.rv * 128;
  f.p0 = f.v0 + vs * f.vstage;
  f.pstage = f.rv / 16 * 2048;
  f.bars = f.p0 + 2 * f.pstage;
  f.total = f.bars + 8 * (1 + 2 * gs + 2 * vs + 4) + 1024;  // + slack to align the base
}

// One block's share: its query block, segment and slice.
struct Blk {
  int qb, g_begin, n_groups, steps, box_lo, nbox;
  uint32_t bq, gfull, gempty, vfull, vempty, pfull, pempty;
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

template <int N>
__device__ __forceinline__ void wgmma_tail(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_ss_n64_t(d, a, b, 1);
  } else if constexpr (N == 128) {
    wgmma_ss_n128_t(d, a, b, 1);
  } else {
    wgmma_ss_n192_t(d, a, b, 1);
  }
}

// Byte offset of element (row m, column k) in a ring of [64][16] bf16 p
// blocks, 32-byte swizzled: m * 32 + 16 ((k / 8) ^ ((m / 4) & 1)) + 2 (k % 8).
__device__ __forceinline__ uint32_t p_offset(int m, int k) {
  return (k >> 4) * 2048 + m * 32 + (((((k & 15) >> 3) ^ (m >> 2)) & 1) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ void st_bf16(uint32_t addr, float v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr),
               "h"(__bfloat16_as_ushort(__float2bfloat16_rn(v)))
               : "memory");
}

// ---- TMA loads, each issued by one lane of the first tail warpgroup: step
// j's centroid tile once the logits of step j - gs are done with its stage
// (`empty_parity`: that phase), step j's value tile (from tail row `row`)
// once every tail warp is done with step j - vs
__device__ __forceinline__ void load_g(const Fam& f, const Blk& k, const CUtensorMap* tg,
                                       uint32_t base, int j, int s, int empty_parity) {
  mbar_wait(k.gempty + 8 * s, empty_parity);
  const uint32_t st = base + f.g0 + s * f.gstage, full = k.gfull + 8 * s;
  const int row = k.g_begin + j * BN;
  mbar_expect_tx(full, f.kb * BN * 128);
  if (f.g_boxes) {  // the kb boxes in one copy
    tma_3d(st, tg, 0, row, 0, full);
  } else {  // the last box ragged: one copy a box, zero-filled past the width
    for (int i = 0; i < f.kb; ++i) tma_2d(st + i * BN * 128, tg, BOX * i, row, full);
  }
}

__device__ __forceinline__ void load_v(const Fam& f, const Blk& k, const CUtensorMap* tv,
                                       uint32_t base, int row, int s, int empty_parity) {
  mbar_wait(k.vempty + 8 * s, empty_parity);
  const uint32_t st = base + f.v0 + s * f.vstage, full = k.vfull + 8 * s;
  // the slice's boxes in one copy (those past the tail's width zero-filled)
  mbar_expect_tx(full, f.sl_boxes * f.rv * 128);
  tma_3d(st, tv, 0, row, k.box_lo, full);
}

// ---- the logits warpgroup
template <int KB>
__device__ __forceinline__ void logits(const Fam& f, const Blk& k, const CUtensorMap* tq,
                                       uint32_t base, int gs, int Bp, int t_pad) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows r0 and r0 + 8 of the block
  const float NEG_INF = __int_as_float(0xff800000);
  float run_m[2] = {NEG_INF, NEG_INF}, run_s[2] = {0.f, 0.f};
  float sup_acc[2] = {0.f, 0.f};
  int tile = k.g_begin / f.gpt, tile_left = f.gpt;  // the tile being summed, its groups left
  int sup_left = f.sup;                             // groups left in the supergroup
  Ring ring;                                        // step it's centroid stage
  float sc[BN / 2];
  // this thread's rows of the stats (written by the quad's first lane)
  float* m_row[2];
  float* s_row[2];
  bool write_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = k.qb * BM + r0 + 8 * e;
    write_row[e] = t == 0 && q < Bp;
    m_row[e] = f.m + (size_t)(write_row[e] ? q : 0) * t_pad;
    s_row[e] = f.s + (size_t)(write_row[e] ? q : 0) * t_pad;
  }

  // a tile's stats, reduced over the quad that holds its rows
  auto flush = [&]() {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = run_m[e], s = run_s[e];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (write_row[e]) {
        m_row[e][tile] = m;
        s_row[e][tile] = s;
      }
      run_m[e] = NEG_INF;
      run_s[e] = 0.f;
    }
    ++tile;
    tile_left = f.gpt;
  };

  if (tid == 0) {  // the query block, once
    mbar_expect_tx(k.bq, f.kb * BM * 128);
    for (int i = 0; i < f.kb; ++i)
      tma_2d(base + i * BM * 128, tq, f.q_col + BOX * i, k.qb * BM, k.bq);
  }
  mbar_wait(k.bq, 0);
  for (int it = 0; it < k.steps; ++it) {
    const int s = ring.stage;
    mbar_wait(k.gfull + 8 * s, ring.phase);
    ring.next(gs);
    const uint32_t kst = base + f.g0 + s * f.gstage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * KB; ++ks) {
      const uint32_t off = (ks & 3) * 32;  // k16 step within the 128-byte row
      wgmma_ss_n32(sc, desc_k128(base + (ks >> 2) * (BM * 128) + off),
                       desc_k128(kst + (ks >> 2) * (BN * 128) + off), ks > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    release(k.gempty + 8 * s);

    // p = exp2(min(l, 86)) in place (0 past the segment), the tiles' stats:
    // accumulator element 4j + e is row r0 + 8 (e >> 1), column 8j + 2t + (e & 1)
    const int valid = k.n_groups - it * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (8 * j < valid) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l0 = sc[4 * j + 2 * e], l1 = sc[4 * j + 2 * e + 1];
          const float p0 = exp2f(fminf(l0, CLAMP2)), p1 = exp2f(fminf(l1, CLAMP2));
          run_m[e] = fmaxf(run_m[e], fmaxf(l0, l1));
          run_s[e] += p0 + p1;
          sc[4 * j + 2 * e] = p0;
          sc[4 * j + 2 * e + 1] = p1;
        }
        tile_left -= 8;
        if (tile_left == 0) flush();
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[4 * j + i] = 0.f;
      }
    }

    // bf16(p), or the supergroup sums rounded once, into p tile it & 1
    const int ps = it & 1;
    mbar_wait(k.pempty + 8 * ps, ((it >> 1) & 1) ^ 1);
    const uint32_t pst = base + f.p0 + ps * f.pstage;
    if (f.sup == 1) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t v = pack_bf16(sc[4 * j + 2 * e], sc[4 * j + 2 * e + 1]);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(pst + p_offset(r0 + 8 * e, 8 * j + 2 * t)),
                       "r"(v)
                       : "memory");
        }
    } else if (f.sup == 2) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st_bf16(pst + p_offset(r0 + 8 * e, 4 * j + t), sc[4 * j + 2 * e] + sc[4 * j + 2 * e + 1]);
    } else if (f.sup == 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[4 * j + 2 * e] + sc[4 * j + 2 * e + 1];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          if ((t & 1) == 0) st_bf16(pst + p_offset(r0 + 8 * e, 2 * j + (t >> 1)), v);
        }
    } else {  // runs of sup / 8 chunks, then the quad
      int sg = 0;  // the step's supergroup
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) sup_acc[e] += sc[4 * j + 2 * e] + sc[4 * j + 2 * e + 1];
        sup_left -= 8;
        if (sup_left == 0) {  // a supergroup ends with chunk j (a step is whole ones)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sup_acc[e];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) st_bf16(pst + p_offset(r0 + 8 * e, sg), v);
            sup_acc[e] = 0.f;
          }
          ++sg;
          sup_left = f.sup;
        }
      }
    }
    // visible to the tensor cores' (async proxy) reads, then released
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(k.pfull + 8 * ps);
  }
}

// ---- a tail warpgroup: NB boxes of the slice from box0 on, KSV k16 steps a
// step (rv / 16)
template <int NB, int KSV>
__device__ __forceinline__ void tail(const Fam& f, const Blk& k, const CUtensorMap* tg,
                                     const CUtensorMap* tv, uint32_t base, int gs, int vs,
                                     int box0, int seg, int Bp) {
  // the first tail warpgroup's first two warps load: a lane of one the
  // value tiles, of the other the centroid tiles (the logits warpgroup, on
  // the critical path, issues no copy)
  const bool loads_v = threadIdx.x == 128, loads_g = threadIdx.x == 160;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float a0[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) a0[i] = 0.f;
  Ring vr, vprev, gr;  // the value stage of steps it and it - 1, the centroid stage of it

  // the first stages, empty: their previous phase counts as complete
  // step j's first tail row: row0 + j * rows (a step is whole supergroups)
  const int row0 = k.g_begin / f.sup, rows = BN / f.sup;
  if (loads_v)
    for (int j = 0; j < vs && j < k.steps; ++j) load_v(f, k, tv, base, row0 + j * rows, j, 1);
  if (loads_g)
    for (int j = 0; j < gs && j < k.steps; ++j) load_g(f, k, tg, base, j, j, 1);
  __syncwarp();
  for (int it = 0; it < k.steps; ++it) {
    const int s = vr.stage, ps = it & 1;
    mbar_wait(k.vfull + 8 * s, vr.phase);
    mbar_wait(k.pfull + 8 * ps, (it >> 1) & 1);
    const uint32_t vst = base + f.v0 + s * f.vstage + box0 * f.rv * 128;
    const uint32_t pst = base + f.p0 + ps * f.pstage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSV; ++kk) {
      const uint64_t da = desc_k32(pst + kk * 2048);
      wgmma_tail<64 * NB>(a0, da, desc_v(vst + kk * 2048, f.rv));
    }
    wgmma_commit();
    wgmma_wait<1>();  // step it - 1's products are done
    // the centroid tile into the stage the logits of step it read (done:
    // p of step it is in), gs - 2 steps ahead of the logits warpgroup
    if (loads_g && it + gs < k.steps) load_g(f, k, tg, base, it + gs, gr.stage, gr.phase);
    gr.next(gs);
    if (it > 0) {  // this warp is done with step it - 1's stages
      release(k.vempty + 8 * vprev.stage);
      if (lane == 0) mbar_arrive(k.pempty + 8 * ((it - 1) & 1));
      // into the stage step it - 1 read, once every tail warp is done with it
      if (loads_v && it - 1 + vs < k.steps)
        load_v(f, k, tv, base, row0 + (it - 1 + vs) * rows, vprev.stage, vprev.phase);
      vprev.next(vs);
    }
    vr.next(vs);
    __syncwarp();
  }
  wgmma_wait0();
  fence_regs(a0);

  // rows r0 and r0 + 8 of each n8 chunk j: columns 8j + 2t, + 1
  float* out = f.out + seg * f.seg_stride;
  const int col0 = (k.box_lo + box0) * BOX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = k.qb * BM + 16 * warp + g + 8 * h;
    if (q >= Bp) continue;
    float* row = out + (size_t)q * f.ld + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NB * 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(a0[4 * j + 2 * h], a0[4 * j + 2 * h + 1]);
  }
}

template <int NB>
__device__ __forceinline__ void tail_ksv(const Fam& f, const Blk& k, const CUtensorMap* tg,
                                         const CUtensorMap* tv, uint32_t base, int gs, int vs,
                                         int box0, int seg, int Bp) {
  if (f.rv == 16) {  // a step's supergroups: one k16 step
    tail<NB, 1>(f, k, tg, tv, base, gs, vs, box0, seg, Bp);
  } else {
    tail<NB, 2>(f, k, tg, tv, base, gs, vs, box0, seg, Bp);
  }
}

__device__ __forceinline__ void tail_any(int nb, const Fam& f, const Blk& k,
                                         const CUtensorMap* tg, const CUtensorMap* tv,
                                         uint32_t base, int gs, int vs, int box0, int seg,
                                         int Bp) {
  static_assert(TAIL_BOXES == 3, "one case a box count");
  switch (nb) {
    case 1: tail_ksv<1>(f, k, tg, tv, base, gs, vs, box0, seg, Bp); break;
    case 2: tail_ksv<2>(f, k, tg, tv, base, gs, vs, box0, seg, Bp); break;
    default: tail_ksv<3>(f, k, tg, tv, base, gs, vs, box0, seg, Bp); break;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    hier_scan_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg0,
                          const __grid_constant__ CUtensorMap tg1,
                          const __grid_constant__ CUtensorMap tv0,
                          const __grid_constant__ CUtensorMap tv1,
                          const __grid_constant__ Fam f0, const __grid_constant__ Fam f1,
                          int Bp, int t_pad, int gs, int vs) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  // the block's family (f0's blocks first), then query block fastest, slice, segment
  int b = blockIdx.x;
  const bool fam1 = b >= f0.blocks;
  if (fam1) b -= f0.blocks;
  // a copy in registers: a reference into the parameter space would be
  // reloaded after every asm statement that clobbers memory
  const Fam f = fam1 ? f1 : f0;
  Blk k;
  k.qb = b % f.n_qb;
  const int rest = b / f.n_qb, sl = rest % f.n_sl, seg = rest / f.n_sl;
  k.g_begin = seg * f.seg_groups;
  k.n_groups = min(f.G - k.g_begin, f.seg_groups);  // > 0: the plan has no empty segment
  k.steps = (k.n_groups + BN - 1) / BN;
  k.box_lo = sl * f.sl_boxes;
  k.nbox = min(f.sl_boxes, f.W / BOX - k.box_lo);
  // the tail warpgroups' boxes: as even as may be, the first ones one more
  const int tw = (int)threadIdx.x / 128 - 1;  // this thread's tail warpgroup, -1: logits
  const int nb = tw >= 0 ? k.nbox / TAILS + (tw < k.nbox % TAILS) : 0;
  const int box0 = tw * (k.nbox / TAILS) + min(tw, k.nbox % TAILS);
  const int tail_warps = 4 * (k.nbox < TAILS ? k.nbox : TAILS);
  k.bq = base + f.bars;
  k.gfull = k.bq + 8;
  k.gempty = k.gfull + 8 * gs;
  k.vfull = k.gempty + 8 * gs;
  k.vempty = k.vfull + 8 * vs;
  k.pfull = k.vempty + 8 * vs;
  k.pempty = k.pfull + 16;

  if (threadIdx.x == 0) {
    mbar_init(k.bq, 1);
    for (int s = 0; s < gs; ++s) {
      mbar_init(k.gfull + 8 * s, 1);
      mbar_init(k.gempty + 8 * s, 4);  // the logits warps
    }
    for (int s = 0; s < vs; ++s) {
      mbar_init(k.vfull + 8 * s, 1);
      mbar_init(k.vempty + 8 * s, tail_warps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(k.pfull + 8 * s, 128);  // every logits thread
      mbar_init(k.pempty + 8 * s, tail_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the p tiles start at zero: columns past a step's supergroups stay so
  for (uint32_t i = threadIdx.x * 16; i < 2 * f.pstage; i += THREADS * 16)
    *reinterpret_cast<uint4*>(smem + f.p0 + i) = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // no setmaxnreg: ptxas compiles every warp's code within the launch's 128
  // registers a thread, so each role is sized to fit in them
  if (tw < 0) {
    switch (f.kb) {
      case 1: logits<1>(f, k, &tq, base, gs, Bp, t_pad); break;
      case 2: logits<2>(f, k, &tq, base, gs, Bp, t_pad); break;
      case 3: logits<3>(f, k, &tq, base, gs, Bp, t_pad); break;
      default: logits<4>(f, k, &tq, base, gs, Bp, t_pad); break;
    }
  } else if (nb) {
    tail_any(nb, f, k, fam1 ? &tg1 : &tg0, fam1 ? &tv1 : &tv0, base, gs, vs, box0, seg, Bp);
  }
}

// tails[q, c] (row stride ld) = sum over s of part[s, q, c] in order
// s = 0, 1, ..., n_seg - 1; part is [n_seg, Bp, W] f32, W % 4 == 0.
__global__ void scan_reduce_kernel(const float* __restrict__ part, float* __restrict__ tails,
                                   int Bp, int W, int n_seg, int ld) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int w4 = W / 4;
  if (i >= (size_t)Bp * w4) return;
  const int q = (int)(i / w4), c = (int)(i % w4) * 4;
  const size_t plane = (size_t)Bp * W;
  const float* src = part + (size_t)q * W + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_seg; ++s, src += plane) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(tails + (size_t)q * ld + c) = acc;
}

// Checks one family's shapes and plan and fills its descriptor; false for
// what the kernel does not take.
bool family(Fam& f, int Bp, int cat_d, int wk, int G, int W, int gpt, int sup, int t_pad,
            int n_sl, int sl_boxes, int n_seg, int seg_tiles, int q_col) {
  const int boxes = W / BOX;
  if (wk <= 0 || wk % 16 || wk > 4 * BOX || wk > cat_d || W <= 0 || W % 128 || gpt <= 0 ||
      gpt % 8 || G != t_pad * gpt || gpt % sup || BN % sup || sl_boxes < 1 ||
      sl_boxes > TAILS * TAIL_BOXES || n_sl < 1 || n_sl * sl_boxes < boxes ||
      (n_sl - 1) * sl_boxes >= boxes || seg_tiles < 1 ||
      n_seg != (t_pad + seg_tiles - 1) / seg_tiles)
    return false;
  f.G = G;
  f.W = W;
  f.kb = (wk + BOX - 1) / BOX;
  f.g_boxes = wk % BOX == 0;
  f.q_col = q_col;
  f.gpt = gpt;
  f.sup = sup;
  f.rv = BN / sup < 16 ? 16 : BN / sup;
  f.n_sl = n_sl;
  f.sl_boxes = sl_boxes;
  f.n_qb = (Bp + BM - 1) / BM;
  f.seg_groups = seg_tiles * gpt;
  f.blocks = f.n_qb * n_sl * n_seg;
  return true;
}

}  // namespace

// q_cat [Bp, cat_d] bf16 packed queries: the sem family contracts columns
// [0, ws), the geo family the last wg.  g_sem [Gs, ws], g_geo [Gg, wg],
// vw_sem [Gs / max(sup_r, 1), Ws], vw_geo [Gg, Wg] bf16, Ws and Wg multiples
// of 128.  Out: m_s, s_s, m_g, s_g [Bp, t_pad] f32 and tails [Bp, Ws + Wg]
// f32 ([sem | geo]).  has_geo = 0: only m_s, s_s and tails [Bp, Ws] are
// written, the geo pointers are not read.  The plan (`_scan_plan`): bn
// groups a step (32: the kernel's BN), gs and vs ring stages (2 to 4), and per family n_sl
// column slices of sl_boxes 64-column boxes (at most 9) and n_seg segments
// of seg_tiles tiles (the last one ragged); work holds the [n_seg, Bp, W]
// f32 partials of every family with n_seg > 1, the sem family's first.
// All contiguous and 16-byte aligned.  Returns a CUDA error code
// (cudaErrorInvalidValue for what it does not take, with nothing launched).
extern "C" int hier_scan_sm90_launch(const void* q_cat, const void* g_sem, const void* g_geo,
                                     const void* vw_sem, const void* vw_geo, void* m_s, void* s_s,
                                     void* m_g, void* s_g, void* tails, void* work, int Bp,
                                     int cat_d, int ws, int wg, int Gs, int Gg, int Ws, int Wg,
                                     int gpt_s, int gpt_g, int t_pad, int has_geo, int sup_r,
                                     int bn, int gs, int vs, int n_sl_s, int sl_boxes_s,
                                     int n_seg_s, int seg_tiles_s, int n_sl_g, int sl_boxes_g,
                                     int n_seg_g, int seg_tiles_g, void* stream) {
  if (Bp < 0 || cat_d % 8 || bn != BN || gs < 2 || gs > 4 || vs < 2 || vs > 4 ||
      sup_r < 0 || sup_r == 1)
    return (int)cudaErrorInvalidValue;
  if (Bp == 0) return 0;
  const int sup = sup_r ? sup_r : 1;
  Fam f[2] = {};
  if (!family(f[0], Bp, cat_d, ws, Gs, Ws, gpt_s, sup, t_pad, n_sl_s, sl_boxes_s, n_seg_s,
              seg_tiles_s, 0))
    return (int)cudaErrorInvalidValue;
  if (has_geo && !family(f[1], Bp, cat_d, wg, Gg, Wg, gpt_g, 1, t_pad, n_sl_g, sl_boxes_g,
                         n_seg_g, seg_tiles_g, cat_d - wg))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q_cat, g_sem, vw_sem, m_s, s_s, tails};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  if (has_geo && (!aligned16(g_geo) || !aligned16(vw_geo) || !aligned16(m_g) ||
                  !aligned16(s_g) || g_geo == nullptr || vw_geo == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tails_w = has_geo ? Ws + Wg : Ws;
  const int n_seg[2] = {n_seg_s, has_geo ? n_seg_g : 1};
  if ((n_seg[0] > 1 || n_seg[1] > 1) && (work == nullptr || !aligned16(work)))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(work);
  size_t smem = 0;
  for (int i = 0; i < (has_geo ? 2 : 1); ++i) {
    Fam& fi = f[i];
    fi.m = static_cast<float*>(i ? m_g : m_s);
    fi.s = static_cast<float*>(i ? s_g : s_s);
    if (n_seg[i] > 1) {
      fi.out = part;
      fi.ld = fi.W;
      fi.seg_stride = (size_t)Bp * fi.W;
      part += (size_t)n_seg[i] * Bp * fi.W;
    } else {
      fi.out = static_cast<float*>(tails) + (i ? Ws : 0);
      fi.ld = tails_w;
      fi.seg_stride = 0;
    }
    layout(fi, gs, vs);
    smem = fi.total > smem ? fi.total : smem;
  }
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;

  CUtensorMap tq, tg[2], tv[2];
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // the centroid tiles as kb boxes in one copy where the width is whole
  // boxes, else box by box; a slice of the value rows in one copy
  auto map_g = [&](CUtensorMap* m, const void* g, int wk, int G, bool boxes) {
    return boxes ? map_3d_boxes(m, g, wk, G, wk, BN, wk / BOX)
                 : map_2d(m, g, wk, G, wk, BOX, BN, sw);
  };
  bool ok = map_2d(&tq, q_cat, cat_d, Bp, cat_d, BOX, BM, sw) &&
            map_g(&tg[0], g_sem, ws, Gs, f[0].g_boxes) &&
            map_3d_boxes(&tv[0], vw_sem, Ws, Gs / sup, Ws, f[0].rv, f[0].sl_boxes);
  if (has_geo) {
    ok = ok && map_g(&tg[1], g_geo, wg, Gg, f[1].g_boxes) &&
         map_3d_boxes(&tv[1], vw_geo, Wg, Gg, Wg, f[1].rv, f[1].sl_boxes);
  } else {  // never read: the grid holds sem blocks only
    tg[1] = tg[0];
    tv[1] = tv[0];
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(hier_scan_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hier_scan_sm90_kernel<<<f[0].blocks + f[1].blocks, THREADS, smem, s>>>(
      tq, tg[0], tg[1], tv[0], tv[1], f[0], f[1], Bp, t_pad, gs, vs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  part = static_cast<float*>(work);
  for (int i = 0; i < (has_geo ? 2 : 1); ++i) {
    if (n_seg[i] == 1) continue;
    const size_t n = (size_t)Bp * f[i].W / 4;
    scan_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(tails) + (i ? Ws : 0), Bp, f[i].W, n_seg[i], tails_w);
    part += (size_t)n_seg[i] * Bp * f[i].W;
  }
  return (int)cudaGetLastError();
}

// Hierarchical retrieval, stage 2 over the bank's values, for Hopper
// (sm_90a), with f32 logits (the `exact` tier) on the tensor cores: every
// f32 product three TF32 products with a fresh fragment a 32-deep chunk
// (tf32_sm90.cuh).
//
// Replaces, at f32 operands (the TPU kernels take them at
// Precision.HIGHEST): range_tpu/ops/retrieval_hier.py
//   * :2515 `_hier_parts_kernel` (reached via _hier_parts_call <-
//     _hier_partials_merged <- retrieve_hier), lr or plain, ± the geo family;
//   * :2282 `_hier_parts_family_kernel`'s value shapes (no z: lr, plain, the
//     sel and dedup_pad forms; reached via _hier_parts_family_call);
// and at the bf16 tiers, where a bank's values are f32
// (build_hier_bank(value_dtype=)), both with bf16 logits (exact in TF32:
// lo = 0), up to 1,536 columns (the `high` tier's 768).  Its value pass
// also computes kernel 8's tail at f32 (:1443 `_hier_scan_kernel`) over
// the D tiles csrc/hier_scan_tf32_sm90.cu writes: every tile of 64 groups
// listed for each 64 queries, vw as the values (ops/retrieval_hier.py
// `_scan_tf32`), and kernel 12's parts (:2077 `_hier_refine_kernel`) over
// the D units csrc/hier_refine_sm90.cu writes: each query block's listed
// tiles, a tile's fine vw rows and its negated supergroup rows as the
// values (`_refine_sm90`).
// Per query block of bm and each tile of its list, for each family:
//   p    = exp2(min(q . k + mask, 86))   over the tile's bn rows
//   d   += sum p
//   acc += w @ v,  w = bf16(p * s) with int8 codes (s the row's scale),
//          bf16(p) with bf16 values, p itself with f32 values
// and the group products e @ vw (e = exp2(min(q_g . g, 86)) in f32: vw is
// f32 at `exact`) into alr (lr) or taken from [acc | d] (plain), which
// csrc/hier_rr_tf32_sm90.cu's groups pass computes (no group sums: D = e,
// or -e added into the output).
//
// Design.  Two passes over each family's list, and the groups pass:
//   * p_kernel: a block owns 128 queries (64 where bm is no multiple of
//     128) and one segment of their list.  Each consumer warpgroup takes
//     its 64 queries' logits over a 64-row step [64 x 64] chunk by chunk
//     over kf (A: its resident f32 query block split into registers as it
//     is read, past its KCRES chunks from device memory; B: the keys' split
//     image, one ring that both warpgroups read: half the key traffic of a
//     query, and wgmmas twice as wide as the rr rows pass's 32 rows).  p
//     goes once into device memory, as the value pass's A tiles: w in bf16
//     as one [64 queries][64 rows] 128-byte swizzled box a step, or with
//     f32 values p split hi | lo as [64 queries][32 rows] tiles, each k8
//     block's columns in the images' order (0 2 4 6 1 3 5 7).  d = sum p
//     per query (thread, then quad).
//   * values_kernel: a block owns 64 queries, one segment and two 128-column
//     slices of the values (a consumer warpgroup each).  Per step (bf16:
//     four k16 wgmmas, A = the p box, B = the values' MN-major boxes) or per
//     32-row chunk (f32: twelve tf32 products, A = p's split tile, B = the
//     values' split K-major image) into a fresh fragment, added into the
//     running sum in f32.
//   * the fold (tf32_sm90.cuh): where a list is split into segments (few
//     query blocks),
//     each segment's partial sums go to a plane of `work` and are added in
//     segment order.
// p in device memory is 8 KB a (64 queries, 64-row step) in bf16, 32 KB at
// f32: RANGE's flagship (10,112 queries, 32 tiles of 512 rows) writes 331
// MB once and reads it once a pair of value slices; recomputing the logits
// for each pair instead would cost their TF32 x3 products again (0.5 ms at
// the peak rate, four times at Dv = 1,024).
//
// What bounds it on an H100: the logits' three TF32 products a term (495
// TFLOP/s) and the value products (989 TFLOP/s bf16, three TF32 products a
// term with f32 values); the bytes are the selected keys and values, re-read
// from L2 by each query block that selects their tile, and p.
//
// A wait on a barrier that never completes traps after ~10 s.

#include "tf32_sm90.cuh"

namespace {

using namespace sm90;
using tf32::fold;
using tf32::global_frags;
using tf32::next_stage;
using tf32::segment;

constexpr int BM = 64;            // queries of a consumer warpgroup (and of a p tile)
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int NSK = 4;            // stages of the key ring
constexpr int KCMAX = 48;         // 32-column chunks of the logits, at most (1,536 columns)
constexpr int KCRES = 8;          // of them, the query block holds (256 columns)
constexpr float CLAMP2 = 86.0f;
constexpr uint32_t PBOX = BM * 64 * 2;        // bf16 w of a step: [64 queries][64 rows]
constexpr uint32_t PCHUNK = 2 * BM * 32 * 4;  // f32 p of 32 rows: [hi | lo][64 queries][32]
constexpr uint32_t KCHUNK = 2 * BM * 128;     // a key chunk: [hi | lo][64 rows][32]

// ---------------------------------------------------------------- p

struct PParams {
  const float* q;      // [Bp, qw]
  const float* kimg;   // [T][spt][KC][hi | lo][64][32]
  const float* mask;   // [N]
  const float* scale;  // [N] (int8 codes) or null
  const int* idx;      // [Bp / bm, K]
  uint8_t* pimg;       // [Bp / 64][K][spt] boxes (bf16) or [.][2] chunks (f32)
  float* out;          // [Bp, ow]: d at column dcol (one segment)
  float* work;         // [n_seg, Bp] (several)
  int Bp, qw, kc0, kf, KC, bm, bn, spt, K, mode, ow, dcol, dedup, n_seg;
};

// mode: 0 bf16 values (w = bf16(p)), 1 f32 values (p split), 2 int8 codes
// (w = bf16(p * s)).  A block holds 128 queries (a warpgroup's 64 each)
// where bm allows it, else 64 (one warpgroup).

__host__ __device__ inline int p_warpgroups(int bm) { return bm % 128 == 0 ? 2 : 1; }

struct PLayout {
  int SQ;                      // f32 row stride of a warpgroup's query block
  uint32_t kring, bars, total;
};

__host__ __device__ inline PLayout p_layout(int KC) {
  PLayout l;
  l.SQ = 32 * (KC < KCRES ? KC : KCRES) + 8;
  l.kring = round_up(2 * BM * l.SQ * 4, 1024);
  l.bars = l.kring + NSK * KCHUNK;
  l.total = l.bars + 8 * 2 * NSK + 1024;  // + slack to align the base
  return l;
}

__device__ __forceinline__ void p_consume(const PParams& p, const PLayout& lay, uint8_t* smem,
                                          uint32_t base, int nw) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x * nw + wg;  // this warpgroup's 64-query block
  const int q0 = qb * BM;
  const int r0 = 16 * warp + g;
  const int* list = p.idx + (size_t)(blockIdx.x * nw * BM / p.bm) * p.K;
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * NSK;
  float* qs = reinterpret_cast<float*>(smem) + wg * BM * lay.SQ;

  // ---- the warpgroup's query block: its first KCRES chunks of logit
  // columns, f32, zero past kf (the chunks past them are read from device
  // memory)
  const int kcols = 32 * min(p.KC, KCRES);
  for (int i = tid; i < BM * kcols; i += 128) {
    const int r = i / kcols, c = i % kcols;
    qs[r * lay.SQ + c] = c < p.kf ? p.q[(size_t)(q0 + r) * p.qw + p.kc0 + c] : 0.f;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");

  auto n64 = [](float (&d)[32], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n64(d, a, b, sd);
  };

  float dsum[2] = {0.f, 0.f};
  const float* qrow = qs + r0 * lay.SQ + 2 * t;
  const float* qg = p.q + (size_t)(q0 + r0) * p.qw + p.kc0 + 2 * t;
  uint32_t ah[4][4], al[4][4];
  int ks = 0;
  uint32_t kph = 0;
  int e0, e1;
  segment(p.K, blockIdx.y, p.n_seg, e0, e1);
  for (int i = e0; i < e1; ++i) {
    const int tile = list[i];
    if (p.dedup && i > 0 && list[i - 1] == tile) continue;
    for (int st = 0; st < p.spt; ++st) {
      // ---- the mask (and int8 scales) of this thread's rows, read before
      // the logits' chunks (rows past the tile's bn take p = 0 below)
      const int rs = 64 * st;  // the tile row of column 0
      const size_t row0 = (size_t)tile * p.bn;
      float mk[16], sc[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ir = rs + 8 * j + 2 * t + e;
          mk[2 * j + e] = ir < p.bn ? __ldg(p.mask + row0 + ir) : 0.f;
          sc[2 * j + e] = p.mode == 2 && ir < p.bn ? __ldg(p.scale + row0 + ir) : 1.f;
        }
      // ---- the logits [64 queries x the step's 64 rows]
      float lg[32];
#pragma unroll 1
      for (int c = 0; c < p.KC; ++c) {
        float lf[32];
        if (c < KCRES)
          tf32::load_frags(qrow, lay.SQ, c, ah, al);
        else
          global_frags(qg + 32 * c, (size_t)8 * p.qw, p.kf - 32 * c - 2 * t, ah, al);
        mbar_wait(kfull + 8 * ks, kph);
        wgmma_fence();
        tf32::issue_chunk(lf, ah, al, base + lay.kring + ks * KCHUNK, BM * 128, n64);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(lf);
        __syncwarp();
        if (lane == 0) mbar_arrive(kempty + 8 * ks);
        next_stage(ks, kph, NSK);
#pragma unroll
        for (int j = 0; j < 32; ++j) lg[j] = c ? lg[j] + lf[j] : lf[j];
      }
      // ---- p (0 past the tile's bn rows) and its sums; element 4j + e: query
      // row r0 + 8 (e >> 1), tile row rs + 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rs + 8 * j + 2 * t + e < p.bn;
          const float m = mk[2 * j + e];
          lg[4 * j + e] = ok ? exp2f(fminf(lg[4 * j + e] + m, CLAMP2)) : 0.f;
          lg[4 * j + 2 + e] = ok ? exp2f(fminf(lg[4 * j + 2 + e] + m, CLAMP2)) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dsum[0] += lg[4 * j] + lg[4 * j + 1];
        dsum[1] += lg[4 * j + 2] + lg[4 * j + 3];
      }
      // ---- into the value pass's A tiles
      const size_t step = ((size_t)qb * p.K + i) * p.spt + st;
      if (p.mode != 1) {
        uint8_t* box = p.pimg + step * PBOX;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            float w0 = lg[4 * j + 2 * h], w1 = lg[4 * j + 2 * h + 1];
            if (p.mode == 2) {
              w0 *= sc[2 * j];
              w1 *= sc[2 * j + 1];
            }
            *reinterpret_cast<uint32_t*>(box + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
                pack_bf16(w0, w1);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // tile row 8j + 2t + e: chunk j / 4, at its k8 block's column t + 4e
              const int r = r0 + 8 * h;
              uint8_t* chunk = p.pimg + (step * 2 + (j >> 2)) * PCHUNK;
              const uint32_t off = r * 128 + (((2 * (j & 3) + e) ^ (r & 7)) << 4) + 4 * t;
              uint32_t hi, lo;
              tf32::split(lg[4 * j + 2 * h + e], hi, lo);
              *reinterpret_cast<uint32_t*>(chunk + off) = hi;
              *reinterpret_cast<uint32_t*>(chunk + PCHUNK / 2 + off) = lo;
            }
      }
    }
  }

  // ---- d: each thread's sums over its quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
    if (t == 0) {
      const int r = r0 + 8 * h;
      if (p.n_seg == 1)
        p.out[(size_t)(q0 + r) * p.ow + p.dcol] = dsum[h];
      else
        p.work[(size_t)blockIdx.y * p.Bp + q0 + r] = dsum[h];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) p_kernel(const __grid_constant__ PParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const PLayout lay = p_layout(p.KC);
  const int nw = p_warpgroups(p.bm);
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * NSK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSK; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, 4 * nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per entry and 64-row step, the keys' KC chunks
    const int* list = p.idx + (size_t)(blockIdx.x * nw * BM / p.bm) * p.K;
    int ks = 0;
    uint32_t kph = 0;
    int e0, e1;
    segment(p.K, blockIdx.y, p.n_seg, e0, e1);
    for (int i = e0; i < e1; ++i) {
      const int tile = list[i];
      if (p.dedup && i > 0 && list[i - 1] == tile) continue;
      for (int st = 0; st < p.spt; ++st) {
        const size_t step = (size_t)tile * p.spt + st;
        for (int c = 0; c < p.KC; ++c) {
          mbar_wait(kempty + 8 * ks, kph ^ 1);
          mbar_expect_tx(kfull + 8 * ks, KCHUNK);
          bulk_g2s(base + lay.kring + ks * KCHUNK, p.kimg + (step * p.KC + c) * (KCHUNK / 4),
                   KCHUNK, kfull + 8 * ks);
          next_stage(ks, kph, NSK);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (threadIdx.x >= 128 * nw) return;
  p_consume(p, lay, smem, base, nw);
}

// ---------------------------------------------------------------- values

struct VParams {
  const uint8_t* pimg;  // the p pass's tiles
  const uint8_t* vimg;  // bf16: [T][spt][VS][2 boxes][64 rows][64]; f32: [T][spt][2][VS][hi | lo][128][32]
  const int* idx;       // [Bp / bm, K]
  float* out;           // [Bp, ow]: acc at columns oc0 .. oc0 + Dv (one segment)
  float* work;          // [n_seg, Bp, 128 VS] (several)
  int Bp, bm, spt, K, VS, Dv, ow, oc0, dedup, n_seg;
  int nu;               // units (stages) a list entry: spt U, or the refine's own count
};

// A stage: the A tile (a step's bf16 box, or a 32-row chunk's split f32
// tile) and each warpgroup's B tile of 128 value columns (two 64-column
// boxes of the step's rows, or the chunk's split [128][32] K-major tile)
template <bool F32>
struct VCfg {
  static constexpr int S = F32 ? 2 : 5;  // stages
  static constexpr uint32_t A = F32 ? PCHUNK : PBOX;
  static constexpr uint32_t B = F32 ? 2 * 128 * 128 : 2 * 64 * 128;
  static constexpr uint32_t STAGE = A + 2 * B;
  static constexpr uint32_t BARS = S * STAGE;
  static constexpr uint32_t TOTAL = BARS + 8 * 2 * S + 1024;
};

template <bool F32>
__device__ __forceinline__ void values_consume(const VParams& p, uint32_t base, int active) {
  using C = VCfg<F32>;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, sl = 2 * blockIdx.z + wg;
  const int r0 = 16 * warp + g;
  const int* list = p.idx + (size_t)(q0 / p.bm) * p.K;
  const uint32_t full = base + C::BARS, empty = full + 8 * C::S;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  int e0, e1;
  segment(p.K, blockIdx.y, p.n_seg, e0, e1);
  for (int i = e0; i < e1; ++i) {
    if (p.dedup && i > 0 && list[i - 1] == list[i]) continue;
#pragma unroll 1
    for (int u = 0; u < p.nu; ++u) {
      const uint32_t a = base + s * C::STAGE, b = a + C::A + wg * C::B;
      float fr[64];
      mbar_wait(full + 8 * s, ph);
      wgmma_fence();
      if constexpr (F32) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t ah = desc_k128(a + 32 * k), al = desc_k128(a + C::A / 2 + 32 * k);
          const uint64_t bh = desc_k128(b + 32 * k), bl = desc_k128(b + C::B / 2 + 32 * k);
          tf32::wgmma_tf32_ss_n128(fr, al, bh, k > 0 ? 1 : 0);
          tf32::wgmma_tf32_ss_n128(fr, ah, bl, 1);
          tf32::wgmma_tf32_ss_n128(fr, ah, bh, 1);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss_n128_t(fr, desc_k128(a + 32 * k), desc_v(b + 2048 * k, 64), k > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(fr);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      next_stage(s, ph, C::S);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += fr[j];
    }
  }

  // ---- the slice's columns (element 4j + e: row r0 + 8 (e >> 1), column
  // 8j + 2t + (e & 1))
  float* dst;
  size_t ld;
  int cols;
  if (p.n_seg == 1) {
    dst = p.out + p.oc0 + 128 * sl;
    ld = p.ow;
    cols = min(128, p.Dv - 128 * sl);
  } else {
    dst = p.work + (size_t)blockIdx.y * p.Bp * (128 * p.VS) + 128 * sl;
    ld = 128 * p.VS;
    cols = 128;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * j + 2 * t;
      if (c < cols)
        *reinterpret_cast<float2*>(dst + (size_t)(q0 + r0 + 8 * h) * ld + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

template <bool F32>
__global__ void __launch_bounds__(THREADS, 1) values_kernel(const __grid_constant__ VParams p) {
  using C = VCfg<F32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int active = min(2, p.VS - 2 * (int)blockIdx.z);  // consumer warpgroups with a slice
  const uint32_t full = base + C::BARS, empty = full + 8 * C::S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per entry and unit, p's tile and the active
    // warpgroups' value tiles (adjacent slices: one copy)
    const int* list = p.idx + (size_t)(blockIdx.x * BM / p.bm) * p.K;
    const uint32_t vbytes = active * C::B;
    int s = 0;
    uint32_t ph = 0;
    int e0, e1;
    segment(p.K, blockIdx.y, p.n_seg, e0, e1);
    for (int i = e0; i < e1; ++i) {
      const int tile = list[i];
      if (p.dedup && i > 0 && list[i - 1] == tile) continue;
      const size_t prow = ((size_t)blockIdx.x * p.K + i) * p.nu;
      for (int u = 0; u < p.nu; ++u) {
        const size_t vt = ((size_t)tile * p.nu + u) * p.VS;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, C::A + vbytes);
        bulk_g2s(base + s * C::STAGE, p.pimg + (prow + u) * C::A, C::A, full + 8 * s);
        bulk_g2s(base + s * C::STAGE + C::A, p.vimg + (vt + 2 * blockIdx.z) * C::B, vbytes,
                 full + 8 * s);
        next_stage(s, ph, C::S);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (threadIdx.x >= 128 * active) return;
  values_consume<F32>(p, base, active);
}

template <bool F32>
int launch_values(const VParams& p, cudaStream_t s) {
  using C = VCfg<F32>;
  cudaError_t err = cudaFuncSetAttribute(values_kernel<F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::TOTAL);
  if (err != cudaSuccess) return (int)err;
  values_kernel<F32><<<dim3(p.Bp / BM, p.n_seg, (p.VS + 1) / 2), THREADS, C::TOTAL, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of a p block at KC chunks of logit columns (which
// == 0), of a values block with bf16 (1) or f32 (2) values; -1 for what is
// not taken.
extern "C" int hier_values_tf32_smem(int KC, int which) {
  if (which == 1) return (int)VCfg<false>::TOTAL;
  if (which == 2) return (int)VCfg<true>::TOTAL;
  if (which != 0 || KC < 1 || KC > KCMAX) return -1;
  return (int)p_layout(KC).total;
}

// The p pass: q [Bp, qw] f32; kimg the keys' split image (`_rr_tf32_images`);
// mask [N] f32; scale [N] f32 with int8 codes (mode 2), else null; idx
// [Bp / bm, K] int32; pimg the value pass's A tiles (written); out [Bp, ow]
// f32 (d at column dcol, with one segment); work [n_seg, Bp] f32 with
// several (then folded into out).  ints: Bp, qw, kc0, kf, KC, bm, bn, spt,
// K, mode, ow, dcol, dedup, n_seg.  Returns a CUDA error code
// (cudaErrorInvalidValue for what it does not take, with nothing launched).
extern "C" int hier_values_tf32_p_launch(const void* q, const void* kimg, const void* mask,
                                         const void* scale, const void* idx, void* pimg,
                                         void* out, void* work, const int* a, void* stream) {
  PParams p{};
  p.q = static_cast<const float*>(q);
  p.kimg = static_cast<const float*>(kimg);
  p.mask = static_cast<const float*>(mask);
  p.scale = static_cast<const float*>(scale);
  p.idx = static_cast<const int*>(idx);
  p.pimg = static_cast<uint8_t*>(pimg);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.Bp = a[0], p.qw = a[1], p.kc0 = a[2], p.kf = a[3], p.KC = a[4], p.bm = a[5], p.bn = a[6];
  p.spt = a[7], p.K = a[8], p.mode = a[9], p.ow = a[10], p.dcol = a[11], p.dedup = a[12];
  p.n_seg = a[13];
  if (p.Bp <= 0 || p.bm % BM || p.Bp % p.bm || p.KC < 1 || p.KC > KCMAX || p.kf < 1 ||
      p.kf > 32 * p.KC || p.spt != (p.bn + 63) / 64 || p.K <= 0 || p.mode < 0 || p.mode > 2 ||
      (p.mode == 2) != (scale != nullptr) || p.dcol < 0 || p.dcol >= p.ow || p.n_seg < 1 ||
      p.n_seg > p.K || (p.n_seg > 1 && work == nullptr) || !aligned16(kimg) ||
      !aligned16(pimg))
    return (int)cudaErrorInvalidValue;
  const PLayout lay = p_layout(p.KC);
  cudaError_t err = cudaFuncSetAttribute(p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p_kernel<<<dim3(p.Bp / (BM * p_warpgroups(p.bm)), p.n_seg), THREADS, lay.total, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_seg == 1) return (int)err;
  return fold(p.work, p.out, p.Bp, 1, 1, p.n_seg, p.ow, p.dcol, s);
}

// The value pass: pimg the p pass's tiles; vimg the values' image (bf16:
// MN-major swizzled boxes; f32: split K-major tiles, `_values_tf32_images`);
// idx; out [Bp, ow] (acc at columns oc0 .. oc0 + Dv, one segment); work
// [n_seg, Bp, 128 VS] with several.  ints: Bp, bm, spt, K, VS, Dv, f32, ow,
// oc0, dedup, n_seg, nu: the units (a bf16 box of 64 rows, an f32 chunk of
// 32) a list entry, 0 for spt steps' (the refine's tiles of
// csrc/hier_refine_sm90.cu take their own count).
extern "C" int hier_values_tf32_v_launch(const void* pimg, const void* vimg, const void* idx,
                                         void* out, void* work, const int* a, void* stream) {
  VParams p{};
  p.pimg = static_cast<const uint8_t*>(pimg);
  p.vimg = static_cast<const uint8_t*>(vimg);
  p.idx = static_cast<const int*>(idx);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.Bp = a[0], p.bm = a[1], p.spt = a[2], p.K = a[3], p.VS = a[4], p.Dv = a[5];
  const int f32 = a[6];
  p.ow = a[7], p.oc0 = a[8], p.dedup = a[9], p.n_seg = a[10];
  p.nu = a[11] > 0 ? a[11] : p.spt * (f32 ? 2 : 1);
  if (p.Bp <= 0 || p.bm % BM || p.Bp % p.bm || p.spt < 1 || p.K <= 0 || p.VS < 1 ||
      p.Dv > 128 * p.VS || p.Dv <= 128 * (p.VS - 1) || p.Dv % 2 || f32 < 0 || f32 > 1 ||
      p.n_seg < 1 || p.n_seg > p.K || (p.n_seg > 1 && work == nullptr) || !aligned16(pimg) ||
      !aligned16(vimg) || !aligned16(out) || p.ow % 2 || p.oc0 % 2 || p.oc0 + p.Dv > p.ow)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = f32 ? launch_values<true>(p, s) : launch_values<false>(p, s);
  if (rc != 0 || p.n_seg == 1) return rc;
  return fold(p.work, p.out, p.Bp, 128 * p.VS, p.Dv, p.n_seg, p.ow, p.oc0, s);
}

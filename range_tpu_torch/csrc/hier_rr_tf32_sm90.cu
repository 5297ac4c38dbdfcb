// Hierarchical retrieval, stage 2, for Hopper (sm_90a): kernel 14's rr
// shapes with f32 operands (the `exact` tier) on the tensor cores, every
// f32 product three TF32 products with a fresh fragment a 32-deep chunk
// (tf32_sm90.cuh).
//
// Replaces: range_tpu/ops/retrieval_hier.py:2282 `_hier_parts_family_kernel`
// (reached via _hier_parts_family_call <- retrieve_hier), its rr shapes (z
// given: rr + lr and rr alone, with the sel and dedup_pad forms) at f32
// operands, which the TPU kernel takes at Precision.HIGHEST.  Per query
// block of bm and each tile of its list (bn rows of gpt groups of gsz):
//   p = exp2(min(q . k + mask, 86)) over the family's kf columns (f32: no
//       rounding point before the value products);
//   ps = each group's sum of p;  az += p @ z;
//   e = exp2(min(q_g . g, 86));  D = e - ps / max(cnt, 1) (rr + lr; rr alone
//       ps / max(cnt, 1) - e), cnt vw's column lrr;
//   alr += D @ vw (rr alone: [acc | d] += D @ vw[:, :Dv + 1]).
//
// Design.  Two passes, as csrc/hier_cores.cu composes the same function
// (ops/retrieval_hier.py `_rr_tf32`): at f32 a query block's operands are
// four times the `fast` body's (f32, then split into hi | lo), so its
// resident query block, a ring and the group walk beside the logits do not
// fit one block's 227 KB together.
//   * rows_kernel: a block owns 64 queries, one segment of their list and
//     one 128-column slice of z.  Its two consumer warpgroups split each
//     64-row step's rows (32 each): the logits [64 x 32] chunk by chunk
//     over kf (A: the resident f32 query block, split into registers as it
//     is read; past its KCRES chunks (kf over 256) each thread reads its
//     rows' columns from device memory (L2) the same way; B: the keys'
//     split image), p in registers, then az +=
//     p @ z's rows (p's accumulator registers are the A fragments: the
//     images' k8 columns are permuted to match).  p goes to a shared tile,
//     and after the step's barrier the 256 consumer threads sum each
//     group's rows in row order (a group crossing a step carries its
//     partial sum) into ps [Bp, K gpt] in device memory.  The two
//     warpgroups' az add at the end (warpgroup 0's + 1's).
//   * groups_kernel: a block owns 64 queries, one segment and two 128-
//     column slices of alr (a consumer warpgroup each); per entry and
//     block of NG = 32 groups, e [64 x 32] chunk by chunk over the group
//     logits' columns (both warpgroups, redundant, from one ring; the
//     query block's first GCRES chunks resident, 512 columns, the rest
//     read from device memory as the rows pass reads its; up to 1,536
//     columns: the value shapes of a bf16-logit bank with f32 values,
//     csrc/hier_values_tf32_sm90.cu), D in
//     registers from e, ps and the counts (read ahead of the products),
//     then alr += D @ vw's rows (D's registers the A fragments).
//   * the fold (tf32_sm90.cuh): where a list is split into segments (few
//     query blocks),
//     each segment's partial sums go to a plane of `work` and are added in
//     segment order.
// A producer warpgroup's first lane streams every B tile (bulk copies of
// images laid out once per bank: ops/retrieval_hier `_rr_tf32_images`)
// through full / empty mbarriers: a three-stage ring of key (or centroid)
// chunks that both warpgroups read, and one stage per warpgroup of its z
// (or vw) chunk, refilled while the next step's logits run.
//
// What bounds it on an H100: the tensor cores and L2.  Three TF32
// products a term at 495 TFLOP/s; each block reads its tiles' split keys
// and z from L2 (~192 KB a 64-row step at kf = 256, rrp = 128), about as
// much time as the step's products.
//
// A wait on a barrier that never completes traps after ~10 s.

#include "tf32_sm90.cuh"

namespace {

using namespace sm90;
using tf32::fold;
using tf32::global_frags;
using tf32::next_stage;
using tf32::segment;

constexpr int BM = 64;            // queries of a block
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int NSK = 3;            // stages of the key / centroid ring
constexpr int KCMAX = 16;         // 32-column chunks of the logits, at most (512 f32 columns)
constexpr int KCRES = 8;          // of them, the rows pass's query block holds (256 columns)
constexpr int GCMAX = 48;         // of the group logits, at most (1,536 columns)
constexpr int GCRES = 16;         // of them, the groups pass's query block holds (512 columns)
constexpr int LDP = 65;           // f32 row stride of the p tile (odd: a warp's 32 rows
                                  // of one column, the group sums' reads, meet each bank once)
constexpr int NG = 32;            // groups of a block: e's N, alr's one 32-deep chunk
constexpr float CLAMP2 = 86.0f;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The A fragments of accumulator k8 blocks 4 c .. 4 c + 3 (element 4j + e:
// row g + 8 (e >> 1), column 8j + 2t + (e & 1)).
template <int N>
__device__ __forceinline__ void acc_frags(const float (&v)[N], int c, uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = 4 * c + s;
    tf32::split_frag(v[4 * j], v[4 * j + 2], v[4 * j + 1], v[4 * j + 3], ah[s], al[s]);
  }
}

// ---------------------------------------------------------------- rows

struct RowsParams {
  const float* q;      // [Bp, qw]
  const float* kimg;   // [T][spt][KC][hi | lo][64][32]
  const float* zimg;   // [T][spt][2 halves][ZS][hi | lo][128][32]
  const float* mask;   // [N]
  const int* idx;      // [Bp / bm, K]
  float* ps;           // [Bp, K gpt]
  float* out;          // [Bp, ow]: az at columns oc0 + 128 zs (one segment)
  float* work;         // [n_seg, Bp, ZS 128] (several)
  int Bp, qw, kc0, kf, KC, bm, bn, spt, gpt, gsz, K, ZS, ow, oc0, dedup, n_seg;
};

struct RowsLayout {
  int SQ;                      // f32 row stride of the query block
  uint32_t kring, z, p, carry, bars, total;
};

__host__ __device__ inline RowsLayout rows_layout(int KC) {
  RowsLayout l;
  l.SQ = 32 * (KC < KCRES ? KC : KCRES) + 8;
  const uint32_t qbytes = round_up(BM * l.SQ * 4, 1024);
  l.kring = qbytes;
  l.z = l.kring + NSK * 2 * BM * 128;            // [stage][hi | lo][64][32]
  l.p = l.z + 2 * 2 * 128 * 128;                 // [wg][hi | lo][128][32]
  l.carry = l.p + 2 * BM * LDP * 4;              // two p tiles
  l.bars = l.carry + 2 * BM * 4;                 // two carry rows
  l.total = l.bars + 8 * (2 * NSK + 4) + 1024;   // + slack to align the base
  return l;
}

__device__ __forceinline__ void rows_consume(const RowsParams& p, const RowsLayout& lay,
                                             uint8_t* smem, uint32_t base) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, zs = blockIdx.z;
  const int r0 = 16 * warp + g;
  const int* list = p.idx + (size_t)(q0 / p.bm) * p.K;
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * NSK;
  const uint32_t zfull = kempty + 8 * NSK + 8 * wg, zempty = kempty + 8 * NSK + 16 + 8 * wg;
  const uint32_t zst = base + lay.z + wg * 2 * 128 * 128;
  float* qs = reinterpret_cast<float*>(smem);
  float* ptile = reinterpret_cast<float*>(smem + lay.p);
  float* carry = reinterpret_cast<float*>(smem + lay.carry);

  // ---- the query block's first KCRES chunks of logit columns, f32, zero
  // past kf (the chunks past them are read from device memory)
  const int kcols = 32 * min(p.KC, KCRES);
  for (int i = threadIdx.x; i < BM * kcols; i += CONSUMERS) {
    const int r = i / kcols, c = i % kcols;
    qs[r * lay.SQ + c] = c < p.kf ? p.q[(size_t)(q0 + r) * p.qw + p.kc0 + c] : 0.f;
  }
  consumers_sync();

  auto arrive = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto n32 = [](float (&d)[16], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n32(d, a, b, sd);
  };
  auto n128 = [](float (&d)[64], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n128(d, a, b, sd);
  };

  float az[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) az[i] = 0.f;
  const float* qrow = qs + r0 * lay.SQ + 2 * t;
  const float* qg = p.q + (size_t)(q0 + r0) * p.qw + p.kc0 + 2 * t;
  uint32_t ah[4][4], al[4][4];
  int ks = 0, buf = 0;
  uint32_t kph = 0, zph = 0;
  int e0, e1;
  segment(p.K, blockIdx.y, p.n_seg, e0, e1);
  for (int i = e0; i < e1; ++i) {
    const int tile = list[i];
    if (p.dedup && i > 0 && list[i - 1] == tile) continue;
    for (int st = 0; st < p.spt; ++st) {
      // ---- the mask of this thread's rows, read before the logits' chunks
      // (rows past the tile's bn take p = 0 below)
      const int rs = 64 * st + 32 * wg;  // the tile row of this warpgroup's column 0
      const float* mrow = p.mask + (size_t)tile * p.bn;
      float mk[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ir = rs + 8 * j + 2 * t + e;
          mk[2 * j + e] = ir < p.bn ? __ldg(mrow + ir) : 0.f;
        }
      // ---- the logits of this warpgroup's 32 rows of the step
      float lg[16];
#pragma unroll 1
      for (int c = 0; c < p.KC; ++c) {
        float lf[16];
        if (c < KCRES)
          tf32::load_frags(qrow, lay.SQ, c, ah, al);
        else
          global_frags(qg + 32 * c, (size_t)8 * p.qw, p.kf - 32 * c - 2 * t, ah, al);
        mbar_wait(kfull + 8 * ks, kph);
        wgmma_fence();
        tf32::issue_chunk(lf, ah, al, base + lay.kring + ks * 2 * BM * 128 + wg * 32 * 128,
                          BM * 128, n32);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(lf);
        arrive(kempty + 8 * ks);
        next_stage(ks, kph, NSK);
#pragma unroll
        for (int j = 0; j < 16; ++j) lg[j] = c ? lg[j] + lf[j] : lf[j];
      }
      // ---- p (0 past the tile's bn rows), into the p tile
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rs + 8 * j + 2 * t + e < p.bn;
          const float m = mk[2 * j + e];
          lg[4 * j + e] = ok ? exp2f(fminf(lg[4 * j + e] + m, CLAMP2)) : 0.f;
          lg[4 * j + 2 + e] = ok ? exp2f(fminf(lg[4 * j + 2 + e] + m, CLAMP2)) : 0.f;
        }
      float* pt = ptile + buf * BM * LDP;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[(r0 + 8 * (e >> 1)) * LDP + 32 * wg + 8 * j + 2 * t + (e & 1)] = lg[4 * j + e];
      // ---- az += p @ z's 32 rows (one chunk)
      acc_frags(lg, 0, ah, al);
      {
        float zf[64];
        mbar_wait(zfull, zph);
        wgmma_fence();
        tf32::issue_chunk(zf, ah, al, zst, 128 * 128, n128);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(zf);
        arrive(zempty);
        zph ^= 1;
#pragma unroll
        for (int j = 0; j < 64; ++j) az[j] += zf[j];
      }
      // ---- ps: each group's rows in this step, in row order; a group
      // crossing the step's end carries its partial sum to the next
      consumers_sync();
      if (zs == 0) {
        const int lo = 64 * st, hi = min(lo + 64, p.bn);
        const int g_lo = lo / p.gsz, ng = (hi - 1) / p.gsz - g_lo + 1;
        const float* cin = carry + buf * BM;
        float* cout = carry + (buf ^ 1) * BM;
        for (int u = threadIdx.x; u < BM * ng; u += CONSUMERS) {
          const int qq = u & (BM - 1), gg = g_lo + (u >> 6);
          const int a = max(gg * p.gsz, lo), b = min((gg + 1) * p.gsz, hi);
          float s = gg * p.gsz < lo ? cin[qq] : 0.f;
          for (int r = a; r < b; ++r) s += pt[qq * LDP + r - lo];
          if ((gg + 1) * p.gsz > hi)
            cout[qq] = s;
          else
            p.ps[(size_t)(q0 + qq) * p.K * p.gpt + (size_t)i * p.gpt + gg] = s;
        }
      }
      buf ^= 1;
    }
  }

  // ---- az: warpgroup 1's sums through the p tiles, added to warpgroup 0's
  consumers_sync();  // every read of the p tiles is done
  float* azs = ptile;  // [64][128 + 2] over the two p tiles
  constexpr int LA = 130;
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(azs + (r0 + 8 * h) * LA + 8 * j + 2 * t) =
            make_float2(az[4 * j + 2 * h], az[4 * j + 2 * h + 1]);
  }
  consumers_sync();
  if (wg == 0) {
    float* dst;
    size_t ld;
    if (p.n_seg == 1) {
      dst = p.out + p.oc0 + 128 * zs;
      ld = p.ow;
    } else {
      dst = p.work + (size_t)blockIdx.y * p.Bp * (128 * p.ZS) + 128 * zs;
      ld = 128 * p.ZS;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float2 o = *reinterpret_cast<const float2*>(azs + r * LA + 8 * j + 2 * t);
        *reinterpret_cast<float2*>(dst + (size_t)(q0 + r) * ld + 8 * j + 2 * t) =
            make_float2(az[4 * j + 2 * h] + o.x, az[4 * j + 2 * h + 1] + o.y);
      }
  }
}

__global__ void __launch_bounds__(THREADS, 1) rows_kernel(const RowsParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const RowsLayout lay = rows_layout(p.KC);
  // [k full | k empty][NSK], [z full][wg], [z empty][wg]
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * NSK;
  const uint32_t zfull = kempty + 8 * NSK, zempty = zfull + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSK; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, CONSUMERS / 32);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(zfull + 8 * w, 1);
      mbar_init(zempty + 8 * w, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per entry and 64-row step, the keys' KC chunks,
    // then each warpgroup's 32 rows of z (this block's slice)
    const int* list = p.idx + (size_t)(blockIdx.x * BM / p.bm) * p.K;
    const uint32_t kbytes = 2 * BM * 128, zbytes = 2 * 128 * 128;
    int ks = 0;
    uint32_t kph = 0, zph = 0;
    int e0, e1;
    segment(p.K, blockIdx.y, p.n_seg, e0, e1);
    for (int i = e0; i < e1; ++i) {
      const int tile = list[i];
      if (p.dedup && i > 0 && list[i - 1] == tile) continue;
      for (int st = 0; st < p.spt; ++st) {
        const size_t step = (size_t)tile * p.spt + st;
        // z's chunks go once the ring holds the step's first key chunks: the
        // stages free up as the previous step's az ends, a step's logits
        // ahead of their use
        const int zc = min(NSK, p.KC) - 1;
        for (int c = 0; c < p.KC; ++c) {
          mbar_wait(kempty + 8 * ks, kph ^ 1);
          mbar_expect_tx(kfull + 8 * ks, kbytes);
          bulk_g2s(base + lay.kring + ks * kbytes, p.kimg + (step * p.KC + c) * (kbytes / 4),
                   kbytes, kfull + 8 * ks);
          next_stage(ks, kph, NSK);
          if (c != zc) continue;
          for (int w = 0; w < 2; ++w) {
            mbar_wait(zempty + 8 * w, zph ^ 1);
            mbar_expect_tx(zfull + 8 * w, zbytes);
            bulk_g2s(base + lay.z + w * zbytes,
                     p.zimg + ((step * 2 + w) * p.ZS + blockIdx.z) * (zbytes / 4), zbytes,
                     zfull + 8 * w);
          }
          zph ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  rows_consume(p, lay, smem, base);
}

// ---------------------------------------------------------------- groups

struct GroupsParams {
  const float* q;      // [Bp, qw]
  const float* gimg;   // [T][nsb][GC][hi | lo][NG][32]
  const float* vwimg;  // [T][nsb][NS][NG / 32][hi | lo][128][32]
  const float* vw;     // [G, W] (counts at column lrr)
  const float* ps;     // [Bp, K gpt]; null: no group sums (the value shapes: D = e or -e)
  const int* idx;      // [Bp / bm, K]
  float* out;          // [Bp, ow]: alr at columns oc0 .. oc0 + acols (one segment)
  float* work;         // [n_seg, Bp, NS 128] (several)
  int Bp, qw, qg0, gwe, GC, bm, gpt, nsb, K, W, lrr, NS, acols, lr, ow, oc0, dedup, n_seg;
  int accumulate;      // add into out instead of writing it
  int dcol;            // >= 0: column lrr of the product goes to out column dcol
  int ebf16;           // e rounded to bf16 (bf16 group sums: the TPU kernel's cast)
};

struct GroupsLayout {
  int SQ;
  uint32_t gring, vw, bars, total;
};

__host__ __device__ inline GroupsLayout groups_layout(int GC) {
  GroupsLayout l;
  l.SQ = 32 * (GC < GCRES ? GC : GCRES) + 8;
  l.gring = round_up(BM * l.SQ * 4, 1024);
  l.vw = l.gring + NSK * 2 * NG * 128;           // [stage][hi | lo][NG][32]
  l.bars = l.vw + 2 * 2 * 128 * 128;             // [wg][hi | lo][128][32]
  l.total = l.bars + 8 * (2 * NSK + 4) + 1024;
  return l;
}

__device__ __forceinline__ void groups_consume(const GroupsParams& p, const GroupsLayout& lay,
                                               uint8_t* smem, uint32_t base, int active) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, sl = 2 * blockIdx.z + wg;
  const int r0 = 16 * warp + g;
  const int* list = p.idx + (size_t)(q0 / p.bm) * p.K;
  const uint32_t gfull = base + lay.bars, gempty = gfull + 8 * NSK;
  const uint32_t vfull = gempty + 8 * NSK + 8 * wg, vempty = gempty + 8 * NSK + 16 + 8 * wg;
  const uint32_t vst = base + lay.vw + wg * 2 * 128 * 128;
  float* qs = reinterpret_cast<float*>(smem);

  const int gcols = 32 * min(p.GC, GCRES);
  for (int i = threadIdx.x; i < BM * gcols; i += 128 * active) {
    const int r = i / gcols, c = i % gcols;
    qs[r * lay.SQ + c] = c < p.gwe ? p.q[(size_t)(q0 + r) * p.qw + p.qg0 + c] : 0.f;
  }
  if (active == 2)
    consumers_sync();
  else
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

  auto arrive = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto nng = [](float (&d)[NG / 2], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n32(d, a, b, sd);
  };
  auto n128 = [](float (&d)[64], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n128(d, a, b, sd);
  };

  float alr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) alr[i] = 0.f;
  const float* qrow = qs + r0 * lay.SQ + 2 * t;
  const float* qg = p.q + (size_t)(q0 + r0) * p.qw + p.qg0 + 2 * t;
  const size_t psw = (size_t)p.K * p.gpt;
  uint32_t ah[4][4], al[4][4];
  int ks = 0;
  uint32_t kph = 0, vph = 0;
  int e0, e1;
  segment(p.K, blockIdx.y, p.n_seg, e0, e1);
  for (int i = e0; i < e1; ++i) {
    const int tile = list[i];
    if (p.dedup && i > 0 && list[i - 1] == tile) continue;
    for (int sb = 0; sb < p.nsb; ++sb) {
      // ---- ps / max(cnt, 1) of this thread's groups (0 past gpt), read
      // from device memory before e's chunks: their latency under the
      // products
      float psn[NG / 2];
#pragma unroll
      for (int j = 0; j < NG / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gg = NG * sb + 8 * j + 2 * t + e;
          const bool ok = gg < p.gpt && p.ps != nullptr;
          const float cnt =
              ok ? __ldg(p.vw + ((size_t)tile * p.gpt + gg) * p.W + p.lrr) : 1.0f;
          const size_t col = (size_t)i * p.gpt + (ok ? gg : 0);
          const float c1 = fmaxf(cnt, 1.0f);
          psn[4 * j + e] = ok ? __ldg(p.ps + (size_t)(q0 + r0) * psw + col) / c1 : 0.f;
          psn[4 * j + 2 + e] = ok ? __ldg(p.ps + (size_t)(q0 + r0 + 8) * psw + col) / c1 : 0.f;
        }
      // ---- e over this block of NG groups
      float ev[NG / 2];
#pragma unroll 1
      for (int c = 0; c < p.GC; ++c) {
        float ef[NG / 2];
        if (c < GCRES)
          tf32::load_frags(qrow, lay.SQ, c, ah, al);
        else
          global_frags(qg + 32 * c, (size_t)8 * p.qw, p.gwe - 32 * c - 2 * t, ah, al);
        mbar_wait(gfull + 8 * ks, kph);
        wgmma_fence();
        tf32::issue_chunk(ef, ah, al, base + lay.gring + ks * 2 * NG * 128, NG * 128, nng);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(ef);
        arrive(gempty + 8 * ks);
        next_stage(ks, kph, NSK);
#pragma unroll
        for (int j = 0; j < NG / 2; ++j) ev[j] = c ? ev[j] + ef[j] : ef[j];
      }
      // ---- D = e - ps / max(cnt, 1) (rr alone: the negation; without ps,
      // e or -e), 0 past gpt
#pragma unroll
      for (int j = 0; j < NG / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = NG * sb + 8 * j + 2 * t + (e & 1) < p.gpt;
          float ex = exp2f(fminf(ev[4 * j + e], CLAMP2));
          if (p.ebf16) ex = __bfloat162float(__float2bfloat16_rn(ex));
          ev[4 * j + e] = ok ? (p.lr ? ex - psn[4 * j + e] : psn[4 * j + e] - ex) : 0.f;
        }
      // ---- alr += D @ vw's NG rows (one chunk), D's registers the A
      // fragments
      {
        float af[64];
        acc_frags(ev, 0, ah, al);
        mbar_wait(vfull, vph);
        wgmma_fence();
        tf32::issue_chunk(af, ah, al, vst, 128 * 128, n128);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(af);
        arrive(vempty);
        vph ^= 1;
#pragma unroll
        for (int j = 0; j < 64; ++j) alr[j] += af[j];
      }
    }
  }

  // ---- alr's columns of slice sl (with one segment, added into out with
  // `accumulate`; where dcol >= 0 the product's last column, lrr (even:
  // written alone), goes to out column dcol)
  float* dst;
  size_t ld;
  int cols;
  const bool one = p.n_seg == 1;
  if (one) {
    dst = p.out + p.oc0 + 128 * sl;
    ld = p.ow;
    cols = min(128, p.acols - 128 * sl);
  } else {
    dst = p.work + (size_t)blockIdx.y * p.Bp * (128 * p.NS) + 128 * sl;
    ld = 128 * p.NS;
    cols = 128;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = 8 * j + 2 * t;
      float* o = dst + (size_t)(q0 + r) * ld + c;
      const float2 v = make_float2(alr[4 * j + 2 * h], alr[4 * j + 2 * h + 1]);
      if (c + 1 < cols) {
        float2 w = v;
        if (one && p.accumulate) {
          const float2 was = *reinterpret_cast<const float2*>(o);
          w = make_float2(was.x + v.x, was.y + v.y);
        }
        *reinterpret_cast<float2*>(o) = w;
      } else if (c < cols) {
        if (one && p.dcol >= 0 && 128 * sl + c == p.lrr)
          o = p.out + (size_t)(q0 + r) * p.ow + p.dcol;
        o[0] = one && p.accumulate ? o[0] + v.x : v.x;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1) groups_kernel(const GroupsParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const GroupsLayout lay = groups_layout(p.GC);
  const int active = min(2, p.NS - 2 * (int)blockIdx.z);  // consumer warpgroups with a slice
  const uint32_t gfull = base + lay.bars, gempty = gfull + 8 * NSK;
  const uint32_t vfull = gempty + 8 * NSK, vempty = vfull + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSK; ++s) {
      mbar_init(gfull + 8 * s, 1);
      mbar_init(gempty + 8 * s, 4 * active);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(vfull + 8 * w, 1);
      mbar_init(vempty + 8 * w, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per entry and block of NG groups, the centroids'
    // GC chunks, then each active warpgroup's vw chunks, interleaved
    const int* list = p.idx + (size_t)(blockIdx.x * BM / p.bm) * p.K;
    const uint32_t gbytes = 2 * NG * 128, vbytes = 2 * 128 * 128;
    int ks = 0;
    uint32_t kph = 0, vph = 0;
    int e0, e1;
    segment(p.K, blockIdx.y, p.n_seg, e0, e1);
    for (int i = e0; i < e1; ++i) {
      const int tile = list[i];
      if (p.dedup && i > 0 && list[i - 1] == tile) continue;
      for (int sb = 0; sb < p.nsb; ++sb) {
        const size_t blk = (size_t)tile * p.nsb + sb;
        for (int c = 0; c < p.GC; ++c) {
          mbar_wait(gempty + 8 * ks, kph ^ 1);
          mbar_expect_tx(gfull + 8 * ks, gbytes);
          bulk_g2s(base + lay.gring + ks * gbytes, p.gimg + (blk * p.GC + c) * (gbytes / 4),
                   gbytes, gfull + 8 * ks);
          next_stage(ks, kph, NSK);
        }
        for (int c = 0; c < NG / 32; ++c) {
          for (int w = 0; w < active; ++w) {
            const int sl = 2 * blockIdx.z + w;
            mbar_wait(vempty + 8 * w, vph ^ 1);
            mbar_expect_tx(vfull + 8 * w, vbytes);
            bulk_g2s(base + lay.vw + w * vbytes,
                     p.vwimg + ((blk * p.NS + sl) * (NG / 32) + c) * (vbytes / 4), vbytes,
                     vfull + 8 * w);
          }
          vph ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (threadIdx.x >= 128 * active) return;
  groups_consume(p, lay, smem, base, active);
}

int launch_groups(const GroupsParams& p, cudaStream_t s) {
  const GroupsLayout lay = groups_layout(p.GC);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(groups_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.Bp / BM, p.n_seg, (p.NS + 1) / 2);
  groups_kernel<<<grid, THREADS, lay.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of a rows block at KC chunks of logit columns
// (which == 0), of a groups block at KC chunks of group logit columns
// (which == 1); -1 for what is not taken.
extern "C" int hier_rr_tf32_smem(int KC, int which) {
  if (KC < 1 || KC > (which ? GCMAX : KCMAX) || which < 0 || which > 1) return -1;
  return (int)(which ? groups_layout(KC).total : rows_layout(KC).total);
}

// The rows pass: q [Bp, qw] f32; kimg, zimg the split images of
// `_rr_tf32_images`; mask [N] f32; idx [Bp / bm, K] int32; ps [Bp, K gpt]
// f32 (written); out [Bp, ow] f32 (az at columns oc0 .. oc0 + 128 ZS, with
// one segment); work [n_seg, Bp, 128 ZS] f32 with several (then folded
// into out).  ints: Bp, qw, kc0, kf, KC, bm, bn, spt, gpt, gsz, K, ZS, ow,
// oc0, dedup, n_seg.  Returns a CUDA error code (cudaErrorInvalidValue for
// what it does not take, with nothing launched).
extern "C" int hier_rr_tf32_rows_launch(const void* q, const void* kimg, const void* zimg,
                                        const void* mask, const void* idx, void* ps, void* out,
                                        void* work, const int* a, void* stream) {
  RowsParams p{};
  p.q = static_cast<const float*>(q);
  p.kimg = static_cast<const float*>(kimg);
  p.zimg = static_cast<const float*>(zimg);
  p.mask = static_cast<const float*>(mask);
  p.idx = static_cast<const int*>(idx);
  p.ps = static_cast<float*>(ps);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.Bp = a[0], p.qw = a[1], p.kc0 = a[2], p.kf = a[3], p.KC = a[4], p.bm = a[5], p.bn = a[6];
  p.spt = a[7], p.gpt = a[8], p.gsz = a[9], p.K = a[10], p.ZS = a[11], p.ow = a[12];
  p.oc0 = a[13], p.dedup = a[14], p.n_seg = a[15];
  if (p.Bp <= 0 || p.Bp % BM || p.bm % BM || p.KC < 1 || p.KC > KCMAX || p.kf > 32 * p.KC ||
      p.spt != (p.bn + 63) / 64 || p.gpt * p.gsz != p.bn || p.K <= 0 || p.ZS < 1 ||
      p.n_seg < 1 || p.n_seg > p.K || (p.n_seg > 1 && work == nullptr) || !aligned16(kimg) ||
      !aligned16(zimg) || !aligned16(out) || p.ow % 2 || p.oc0 % 2)
    return (int)cudaErrorInvalidValue;
  const RowsLayout lay = rows_layout(p.KC);
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rows_kernel<<<dim3(p.Bp / BM, p.n_seg, p.ZS), THREADS, lay.total, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_seg == 1) return (int)err;
  return fold(p.work, p.out, p.Bp, 128 * p.ZS, 128 * p.ZS, p.n_seg, p.ow, p.oc0, s);
}

// The groups pass: q [Bp, qw]; gimg, vwimg the split images; vw [G, W] f32;
// ps the rows pass's (null for the value shapes: D = e with lr, else -e);
// idx; out [Bp, ow] (alr's acols columns at oc0); work [n_seg, Bp, 128 NS]
// with several.  ints: Bp, qw, qg0, gwe, GC, bm, gpt, NG, nsb, K, W, lrr,
// NS, acols, lr, ow, oc0, dedup, n_seg, accumulate (add into out), dcol
// (>= 0: the product's column lrr goes to out column dcol), ebf16 (e
// rounded to bf16: the value shapes' bf16 group sums).
extern "C" int hier_rr_tf32_groups_launch(const void* q, const void* gimg, const void* vwimg,
                                          const void* vw, const void* ps, const void* idx,
                                          void* out, void* work, const int* a, void* stream) {
  GroupsParams p{};
  p.q = static_cast<const float*>(q);
  p.gimg = static_cast<const float*>(gimg);
  p.vwimg = static_cast<const float*>(vwimg);
  p.vw = static_cast<const float*>(vw);
  p.ps = static_cast<const float*>(ps);
  p.idx = static_cast<const int*>(idx);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.Bp = a[0], p.qw = a[1], p.qg0 = a[2], p.gwe = a[3], p.GC = a[4], p.bm = a[5], p.gpt = a[6];
  p.nsb = a[8], p.K = a[9], p.W = a[10], p.lrr = a[11], p.NS = a[12], p.acols = a[13];
  p.lr = a[14], p.ow = a[15], p.oc0 = a[16], p.dedup = a[17], p.n_seg = a[18];
  p.accumulate = a[19], p.dcol = a[20], p.ebf16 = a[21];
  if (p.Bp <= 0 || p.Bp % BM || p.bm % BM || p.GC < 1 || p.GC > GCMAX || p.gwe > 32 * p.GC ||
      a[7] != NG || p.gpt < 1 || p.nsb != (p.gpt + NG - 1) / NG || p.K <= 0 ||
      p.NS < 1 || p.acols > 128 * p.NS || p.acols <= 128 * (p.NS - 1) || p.lrr < 0 ||
      p.lrr >= p.W || p.n_seg < 1 || p.n_seg > p.K || (p.n_seg > 1 && work == nullptr) ||
      !aligned16(gimg) || !aligned16(vwimg) || p.ow % 2 || p.oc0 % 2 ||
      (p.dcol >= 0 && (p.lrr % 2 || p.acols != p.lrr + 1)) || p.dcol >= p.ow)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_groups(p, s);
  if (rc != 0 || p.n_seg == 1) return rc;
  return fold(p.work, p.out, p.Bp, 128 * p.NS, p.acols, p.n_seg, p.ow, p.oc0, s, p.accumulate,
              p.lrr, p.dcol);
}

// Hierarchical retrieval, stage 1, for Hopper (sm_90a): the fused group
// scan (kernel 8) at f32 operands and the stats-only scan (kernel 9) at
// every tier, on the tensor cores.  Every f32 product is three TF32
// products with a fresh fragment a 32-deep chunk (tf32_sm90.cuh); a product
// of two bf16 operands (bf16 logits) is one TF32 product, since a bf16
// value's TF32 lo half is 0.
//
// Replaces: range_tpu/ops/retrieval_hier.py:1443 `_hier_scan_kernel`
// (reached via _hier_scan_call <- retrieve_hier) where an operand is f32
// (the `exact` tier, which the TPU kernel takes at Precision.HIGHEST), and
// :1582 `_hier_scan_stats_kernel` (via _hier_scan_stats_call <- hier_topk,
// hier_nn, the hybrid sort and RANGE's home-tile sort) in every form.  Per
// query and family, over all G = T gpt groups of the family:
//   l = q . g over the family's columns;
//   per tile of gpt groups: m = max l, s = sum of p = exp2(min(l, 86));
//   the scan's tail += D @ vw in f32, D = p rounded to vw's dtype (none at
//   f32), or with sup > 1 (tail_super banks) the f32 sum of each sup
//   consecutive p rounded once.
//
// Design: one pass over every group, the logits once.  A block owns 128
// queries (64 a consumer warpgroup, both reading one ring of the
// centroids' split chunks) and one segment of whole tiles
// (ops/retrieval_hier.py `_scan_tf32_segments`), and walks its groups as one
// flat sequence, 64 a step (128 at bf16 logits; a step may hold pieces of
// several tiles, or a piece of one).  A step's logits [64 x 64] chunk by
// chunk (A: the warpgroup's resident f32 query rows, split as read, past
// RES chunks read from device memory; B: a [64 groups][32] chunk: m64n64
// wgmmas, m64n128 at bf16 logits; a smaller N costs as many instructions
// for less work).  The stats: where tiles are whole octets of groups, each
// octet's max and exp2 sum over its quad by shuffles, then the tiles in
// order in registers; else each warp's rows to a shared tile, walked group
// by group.  For the scan, D goes once into device memory as the A tiles
// of `csrc/hier_values_tf32_sm90.cu`'s value pass, which computes the tail
// (ops/retrieval_hier.py `_scan_tf32`): f32 D split hi | lo in its [64
// queries][32 groups] chunks (the images' k8 order), or bf16 D in its [64
// queries][64 groups] boxes.  The other layout, the logits again for every
// pair of 128-column tail slices, measured slower (PERF.md, PR 21).
// A producer warpgroup's first lane streams the split images (laid out once
// a bank: ops/retrieval_hier `_scan_tf32_images`) by bulk copies through
// full / empty mbarriers, as many stages as shared memory holds.
//
// What bounds it on an H100: the tensor cores (three TF32 products a term
// at 495 TFLOP/s; bf16 logits one) and, past the resident query chunks,
// L2; the scan's D writes (8 bytes a (query, group) at f32).
//
// A wait on a barrier that never completes traps after ~10 s.

#include "tf32_sm90.cuh"

namespace {

using namespace sm90;
using tf32::next_stage;
using tf32::segment;

constexpr int BM = 64;            // queries of a consumer warpgroup
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int NSK_MAX = 12;       // stages of the centroid ring, at most (as many as fit)
constexpr uint32_t STAGE = 16384; // a ring stage: [hi | lo][64][32] or [hi][128][32]
constexpr int GCMAX = 48;         // 32-column chunks of the logits, at most (1,536 columns)
constexpr int RES = 8;            // of them, a block's resident query rows hold (256 columns)
constexpr int LDL = 65;           // f32 row stride of the l tile (64 groups)
constexpr uint32_t PCHUNK = 2 * BM * 32 * 4;  // f32 D of 32 groups: [hi | lo][64 queries][32]
constexpr uint32_t PBOX = BM * 64 * 2;        // bf16 D of 64 groups: [64 queries][64]
constexpr float CLAMP2 = 86.0f;
#define NEG_INF __int_as_float(0xff800000)

// Groups of a step: 64 (three products a term: m64n64 fragments), 128
// (one: m64n128, its registers free of the lo halves)
__host__ __device__ constexpr int ng_of(bool x3) { return x3 ? 64 : 128; }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

struct Params {
  const float* q;      // [Bq, 32 GC]: the family's logit columns, zero past them
  const float* gimg;   // [nblk][GC][hi | lo][ng][32]
  float* m;            // [Bq, ts]
  float* s;            // [Bq, ts]
  uint8_t* d;          // the value pass's A tiles of D (the scan), or null
  int Bq, GC, gpt, T, ts, n_seg, dmode, KT, sup, tbf16;
};

// Whether the stats walk tiles in whole octets of groups (gpt a multiple of
// 8): then in registers, else group by group from a shared l tile.
__host__ __device__ inline bool octets(int gpt) { return gpt % 8 == 0; }

struct Layout {
  int res, SQ, nsk;
  uint32_t lt, bars, gring, total;
};

// The query rows' first res chunks, the l tile (128 rows of 64 groups,
// where tiles are no whole octets), the barriers, then as many ring stages
// as fit.
__host__ __device__ inline Layout layout(int GC, int gpt) {
  Layout l;
  l.res = GC < RES ? GC : RES;
  l.SQ = 32 * l.res + 8;
  l.lt = round_up(2 * BM * l.SQ * 4, 1024);
  l.bars = l.lt + (octets(gpt) ? 0 : 2 * BM * LDL * 4);
  l.gring = round_up(l.bars + 8 * 2 * NSK_MAX, 1024);
  const int fit = ((int)MAX_SMEM - 1024 - (int)l.gring) / (int)STAGE;
  l.nsk = fit < NSK_MAX ? fit : NSK_MAX;
  l.total = l.gring + l.nsk * STAGE + 1024;  // + slack to align the base
  return l;
}

// A chunk's A fragments: split (X3) or the hi halves alone.
template <bool X3>
__device__ __forceinline__ void frags(const float* row, int ld, int c, bool resident,
                                      const float* grow, size_t ld8, uint32_t (&ah)[4][4],
                                      uint32_t (&al)[4][4]) {
  if (resident) {
    if (X3) {
      tf32::load_frags(row, ld, c, ah, al);
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 v0 = *reinterpret_cast<const float2*>(row + 32 * c + 8 * s);
        const float2 v1 = *reinterpret_cast<const float2*>(row + 8 * ld + 32 * c + 8 * s);
        ah[s][0] = tf32::rna(v0.x), ah[s][1] = tf32::rna(v1.x);
        ah[s][2] = tf32::rna(v0.y), ah[s][3] = tf32::rna(v1.y);
      }
    }
  } else {
    tf32::global_frags(grow + 32 * c, ld8, 32, ah, al);
  }
}

// Issue one 32-deep chunk of hi-hi products alone into the fresh fragment d.
template <int N, typename F>
__device__ __forceinline__ void issue_hi(float (&d)[N], const uint32_t (&ah)[4][4], uint32_t tile,
                                         F mma) {
#pragma unroll
  for (int s = 0; s < 4; ++s) mma(d, ah[s], desc_k128(tile + 32 * s), s > 0 ? 1 : 0);
}

// The stats of one row over the step columns [ca, cb) of its l tile row, in
// group order, p = exp2(min(l, 86)); a tile ends where g0 + c == tend, its
// (max, sum) written at (row qr, tile cur).
__device__ __forceinline__ void walk_row(const Params& p, const float* lrow, int g0, int ca,
                                         int cb, size_t qr, int& cur, int& tend, float& mx,
                                         float& sm) {
  for (int c = ca; c < cb; ++c) {
    if (g0 + c == tend) {
      p.m[qr * p.ts + cur] = mx;
      p.s[qr * p.ts + cur] = sm;
      ++cur, tend += p.gpt, mx = NEG_INF, sm = 0.f;
    }
    mx = fmaxf(mx, lrow[c]);
    sm += exp2f(fminf(lrow[c], CLAMP2));
  }
}

__device__ __forceinline__ float pexp(float l) { return exp2f(fminf(l, CLAMP2)); }

template <bool LX3>
__device__ __forceinline__ void consume(const Params& p, const Layout& lay, uint8_t* smem,
                                        uint32_t base) {
  constexpr int NG = ng_of(LX3), NE = NG / 2, NO = NG / 8;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 2 * BM;
  const int r0 = BM * wg + 16 * warp + g;  // block row of the fragments' row g
  const int QW = 32 * p.GC;
  const uint32_t gfull = base + lay.bars, gempty = gfull + 8 * NSK_MAX;
  float* qs = reinterpret_cast<float*>(smem);
  float* lt = reinterpret_cast<float*>(smem + lay.lt);
  {
    const int c4 = 8 * lay.res;
    for (int i = threadIdx.x; i < 2 * BM * c4; i += CONSUMERS) {
      const int r = i / c4, c = i % c4;
      *reinterpret_cast<float4*>(qs + r * lay.SQ + 4 * c) =
          *reinterpret_cast<const float4*>(p.q + (size_t)(q0 + r) * QW + 4 * c);
    }
  }
  consumers_sync();
  auto mma = [](float (&d)[NE], const uint32_t (&a)[4], uint64_t b, int sd) {
    if constexpr (LX3)
      tf32::wgmma_tf32_rs_n64(d, a, b, sd);
    else
      tf32::wgmma_tf32_rs_n128(d, a, b, sd);
  };
  int e0, e1;
  segment(p.T, blockIdx.y, p.n_seg, e0, e1);
  const int g_lo = e0 * p.gpt, g_hi = e1 * p.gpt;
  const bool oct = octets(p.gpt), last = e1 == p.T;
  // the running stats: in registers, rows r0 and r0 + 8 (tiles of whole
  // octets: every thread of a quad holds them, its first writes); else of
  // block row wrow, walked by lanes 0..15
  const int wrow = BM * wg + 16 * warp + lane;
  int cur = e0, tend = g_lo + p.gpt;
  float mx[2] = {NEG_INF, NEG_INF}, sm[2] = {0.f, 0.f};
  const float* qrow = qs + r0 * lay.SQ + 2 * t;
  const float* qg = p.q + (size_t)(q0 + r0) * QW + 2 * t;
  const size_t qb = (q0 + BM * wg) / BM;  // the warpgroup's 64-query block (D's tiles)
  int ks = 0;
  uint32_t kph = 0;
  for (int b = g_lo / NG; b < (g_hi + NG - 1) / NG; ++b) {
    // ---- the step's logits, each 32-deep chunk's products in a fresh
    // fragment added in chunk order
    float ev[NE];
    {
      uint32_t ah[4][4], al[4][4];
#pragma unroll 1
      for (int c = 0; c < p.GC; ++c) {
        float ef[NE];
        frags<LX3>(qrow, lay.SQ, c, c < lay.res, qg, (size_t)8 * QW, ah, al);
        mbar_wait(gfull + 8 * ks, kph);
        wgmma_fence();
        const uint32_t tile = base + lay.gring + ks * STAGE;
        if constexpr (LX3)
          tf32::issue_chunk(ef, ah, al, tile, NG * 128, mma);
        else
          issue_hi(ef, ah, tile, mma);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(ef);
        __syncwarp();
        if (lane == 0) mbar_arrive(gempty + 8 * ks);
        next_stage(ks, kph, lay.nsk);
#pragma unroll
        for (int j = 0; j < NE; ++j) ev[j] = c ? ev[j] + ef[j] : ef[j];
      }
    }
    const int g0 = NG * b;
    // an octet's sum of p (row r0 + 8h) over its quad, ((p0 + p1) + (p2 +
    // p3)) + ((p4 + p5) + (p6 + p7)), in every thread of the quad
    auto osum = [&](int j, int h) {
      float o = pexp(ev[4 * j + 2 * h]) + pexp(ev[4 * j + 2 * h + 1]);
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      return o + __shfl_xor_sync(0xffffffffu, o, 2);
    };
    // ---- the stats
    if (oct) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        float om[2], os[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          om[h] = fmaxf(ev[4 * j + 2 * h], ev[4 * j + 2 * h + 1]);
          om[h] = fmaxf(om[h], __shfl_xor_sync(0xffffffffu, om[h], 1));
          om[h] = fmaxf(om[h], __shfl_xor_sync(0xffffffffu, om[h], 2));
          os[h] = osum(j, h);
        }
        const int go = g0 + 8 * j;
        if (go < g_lo || go >= g_hi) continue;
        if (go == tend) {
          if (t == 0)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              p.m[(size_t)(q0 + r0 + 8 * h) * p.ts + cur] = mx[h];
              p.s[(size_t)(q0 + r0 + 8 * h) * p.ts + cur] = sm[h];
            }
          ++cur, tend += p.gpt;
          mx[0] = mx[1] = NEG_INF, sm[0] = sm[1] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], om[h]), sm[h] += os[h];
      }
    } else {
      // each warp's 16 rows to the l tile, 64 groups at a time, walked group
      // by group
#pragma unroll
      for (int half = 0; half < NG / 64; ++half) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            lt[(r0 + 8 * (e >> 1)) * LDL + 8 * j + 2 * t + (e & 1)] = ev[4 * (8 * half + j) + e];
        __syncwarp();
        const int h0 = g0 + 64 * half;
        if (lane < 16)
          walk_row(p, lt + wrow * LDL, h0, max(g_lo - h0, 0), min(g_hi - h0, 64), q0 + wrow,
                   cur, tend, mx[0], sm[0]);
        __syncwarp();
      }
    }
    // ---- the scan: D into the value pass's A tiles.  A group's weight: p,
    // 0 past the segment's last tile; with sup > 1 (a power of 2, up to 32)
    // each supergroup's sum at its first group, 0 at the others, summed as
    // the tree of pairs, quads, octets, octet pairs, octet quads; rounded to
    // bf16 with tbf16.  Written where this segment owns the group (the last
    // segment also the zeros past G).
    if (p.d == nullptr) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float w[2] = {pexp(ev[4 * j + 2 * h]), pexp(ev[4 * j + 2 * h + 1])};
        if (p.sup > 1) {
          float x;
          if (p.sup <= 4) {
            x = w[0] + w[1];
            if (p.sup == 4) x += __shfl_xor_sync(0xffffffffu, x, 1);
          } else if (p.sup == 8) {
            x = osum(j, h);
          } else if (p.sup == 16) {
            x = j % 2 ? 0.f : osum(j, h) + osum((j + 1) % NO, h);
          } else {
            x = j % 4 ? 0.f
                      : (osum(j, h) + osum((j + 1) % NO, h)) +
                            (osum((j + 2) % NO, h) + osum((j + 3) % NO, h));
          }
          w[0] = (8 * j + 2 * t) & (p.sup - 1) ? 0.f : x;
          w[1] = 0.f;
        }
        const int row = 16 * warp + g + 8 * h;  // row of the 64-query block
        const int tt = (g0 + 8 * j) / 64, jj = j % 8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gg = g0 + 8 * j + 2 * t + e;
          if (gg < g_lo || (gg >= g_hi && !last)) continue;
          float x = gg < g_hi ? w[e] : 0.f;
          if (p.tbf16) x = __bfloat162float(__float2bfloat16_rn(x));
          if (p.dmode == 1) {
            // group 8 jj + 2t + e: chunk jj / 4, at its k8 block's column t + 4e
            uint8_t* chunk = p.d + ((qb * p.KT + tt) * 2 + (jj >> 2)) * PCHUNK;
            const uint32_t off = row * 128 + (((2 * (jj & 3) + e) ^ (row & 7)) << 4) + 4 * t;
            uint32_t hi, lo;
            tf32::split(x, hi, lo);
            *reinterpret_cast<uint32_t*>(chunk + off) = hi;
            *reinterpret_cast<uint32_t*>(chunk + PCHUNK / 2 + off) = lo;
          } else {
            uint8_t* box = p.d + (qb * p.KT + tt) * PBOX;
            *reinterpret_cast<__nv_bfloat16*>(box + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * t +
                                              2 * e) = __float2bfloat16_rn(x);
          }
        }
      }
  }
  if (e1 <= e0) return;  // the segment's last tile
  if (oct && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p.m[(size_t)(q0 + r0 + 8 * h) * p.ts + cur] = mx[h];
      p.s[(size_t)(q0 + r0 + 8 * h) * p.ts + cur] = sm[h];
    }
  } else if (!oct && lane < 16) {
    p.m[(size_t)(q0 + wrow) * p.ts + cur] = mx[0];
    p.s[(size_t)(q0 + wrow) * p.ts + cur] = sm[0];
  }
}

template <bool LX3>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const Layout lay = layout(p.GC, p.gpt);
  constexpr int NG = ng_of(LX3);
  const uint32_t gfull = base + lay.bars, gempty = gfull + 8 * NSK_MAX;
  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.nsk; ++s) {
      mbar_init(gfull + 8 * s, 1);
      mbar_init(gempty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per step, the centroids' GC chunks (their hi
    // halves alone at bf16 logits)
    const uint32_t gbytes = (LX3 ? 2 : 1) * NG * 128;
    int ks = 0;
    uint32_t kph = 0;
    int e0, e1;
    segment(p.T, blockIdx.y, p.n_seg, e0, e1);
    const int g_lo = e0 * p.gpt, g_hi = e1 * p.gpt;
    for (int b = g_lo / NG; b < (g_hi + NG - 1) / NG; ++b)
      for (int c = 0; c < p.GC; ++c) {
        mbar_wait(gempty + 8 * ks, kph ^ 1);
        mbar_expect_tx(gfull + 8 * ks, gbytes);
        bulk_g2s(base + lay.gring + ks * STAGE,
                 p.gimg + ((size_t)b * p.GC + c) * (2 * NG * 32), gbytes, gfull + 8 * ks);
        next_stage(ks, kph, lay.nsk);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  consume<LX3>(p, lay, smem, base);
}

template <bool LX3>
int launch(const Params& p, cudaStream_t s) {
  const Layout lay = layout(p.GC, p.gpt);
  if (lay.total > MAX_SMEM || lay.nsk < 3) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(scan_kernel<LX3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<LX3><<<dim3(p.Bq / (2 * BM), p.n_seg), THREADS, lay.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of a block at GC chunks of logit columns and gpt
// groups a tile; -1 for what is not taken.
extern "C" int hier_scan_tf32_smem(int GC, int gpt) {
  if (GC < 1 || GC > GCMAX || gpt < 1) return -1;
  return (int)layout(GC, gpt).total;
}

// One family: its stats and, for the scan, D.  q [Bq, 32 GC] f32 (the
// family's columns, zero past them); gimg [nblk][GC][hi | lo][ng][32], the
// split image of `_scan_tf32_images` (ng groups a step: 64, 128 at bf16
// logits, lx3 = 0); m, s [Bq, ts] f32; d null (the stats scan) or the value
// pass's A tiles of D over KT tiles of 64 groups a 64-query block: dmode 1
// f32 split chunks (2 a tile), 2 bf16 boxes.  ints: Bq, GC, gpt, T, ts,
// n_seg, lx3, dmode, KT, sup, tbf16.  Returns a CUDA error code
// (cudaErrorInvalidValue for what it does not take, with nothing launched).
extern "C" int hier_scan_tf32_launch(const void* q, const void* gimg, void* m, void* s, void* d,
                                     const int* a, void* stream) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.gimg = static_cast<const float*>(gimg);
  p.m = static_cast<float*>(m);
  p.s = static_cast<float*>(s);
  p.d = static_cast<uint8_t*>(d);
  p.Bq = a[0], p.GC = a[1], p.gpt = a[2], p.T = a[3], p.ts = a[4], p.n_seg = a[5];
  const int lx3 = a[6];
  p.dmode = a[7], p.KT = a[8], p.sup = a[9], p.tbf16 = a[10];
  const int ng = ng_of(lx3 != 0);
  if (p.Bq <= 0 || p.Bq % (2 * BM) || p.GC < 1 || p.GC > GCMAX || p.gpt < 1 || p.T < 1 ||
      p.ts < p.T || p.n_seg < 1 || p.n_seg > p.T || !aligned16(q) || !aligned16(gimg) ||
      m == nullptr || s == nullptr || p.sup < 1 || p.sup > 32 || 32 % p.sup ||
      p.gpt % p.sup || (d == nullptr) != (p.dmode == 0) || p.dmode < 0 || p.dmode > 2 ||
      (d != nullptr && (p.KT * 64 < p.T * p.gpt || p.KT * 64 % ng || !aligned16(d))) ||
      (d == nullptr && (p.sup != 1 || p.tbf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lx3 ? launch<true>(p, st) : launch<false>(p, st);
}

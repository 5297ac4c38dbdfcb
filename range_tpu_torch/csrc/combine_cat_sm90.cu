// Hierarchical retrieval, stage 3, for Hopper (sm_90a): the combine +
// concat epilogue with its f32 products on the tensor cores, as three TF32
// products each (hi hi + hi lo + lo hi).
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_combine_cat_kernel` (reached
// via _combine_cat_call <- retrieve_hier) at the `fast` and `high` tiers,
// with the low-rank geo tail (rg > 0) and without it (rg = 0).  Per query
// row, for each family f (sem: parts ps, tail columns [0, Ws); geo: parts
// pg, tail columns [Ws, Ws + Wg)), with a low-rank tail (parts az | d | pad
// | alr):
//   corr_f = tails_f - parts_f[:, rrp + 128 :]        (all tiles - approx)
//   coef_f = [parts_f[:, :rrp] | corr_f[:, :r_f]],  d_f = parts_f[:, rrp] + corr_f[:, r_f]
// and with the full-width geo tail (rg = 0: parts acc | d | pad | az):
//   coef_g = parts_g[:, Dv + 128 :],  d_g = parts_g[:, Dv] + tails_g[:, Dv]
// then out[:, :Dv] = beta coef_s [w_s; u_s] / max(d_s, 1e-30) + (1 - beta)
// (coef_g [w_g; u_g] (+ parts_g[:, :Dv] + tails_g[:, :Dv] at rg = 0)) /
// max(d_g, 1e-30), and out[:, Dv:] = the (sorted) queries.  The `exact`
// tier keeps csrc/combine_cat.cu (f32 FMAs on the CUDA cores).
//
// Design.  Each row's coefficients are scaled by beta / max(d_s, 1e-30)
// and (1 - beta) / max(d_g, 1e-30) before the product, so one accumulator
// takes both families: A = [scaled coef_s | scaled coef_g] ([Bp, K], K =
// 2 rrp + r + rg, 896 at the flagship) against B = the stacked bases [K,
// Dv] (the same sum in another rounding order).  A and B are split into
// TF32 halves, x = hi + lo with hi = rna(x), lo = rna(x - hi); the three
// products hi hi, hi lo and lo hi (lo lo, ~2^-22 of a term, is dropped)
// carry each term to ~2^-21 relative.  The tensor cores add each step
// into their f32 accumulator with truncation, which over one chain of 336
// steps (K = 896) drifts past the f32 bar where terms cancel (a model of it:
// `_combine_cat_tf32x3(chain="rz")`); so each 32-deep chunk's twelve
// products sum in a fresh fragment, and the fragments add into the running
// sum in f32, rounded to nearest ("Tensor-core accumulation", ROADMAP).  The
// bases are split once per bank (ops/retrieval_hier `_combine_images`: [Dv
// / 128][K / 32][hi | lo][128][32] f32, each tile in the 128-byte swizzle
// wgmma reads); A is split per chunk as it is converted.
//
// What bounds it on an H100: the tensor cores.  2 Bp Dv K flops a product,
// three products at the TF32 rate (495 TFLOP/s): 55.7 GFLOP, ~0.11 ms at
// the flagship (B = 10,112, Dv = 1,024); ~110 MB of partials, bases and
// output move (~0.03 ms).  From L2, each block re-reads its column block's
// chunks of the bases (0.9 MB) and builds its rows' A anew: ~1 GB in all
// at the flagship.
//
// Layout.  A block owns 128 query rows x NB = 128 output columns: two
// consumer warpgroups of 64 rows each (wgmma m64n128k8, tf32, both operands
// K-major in shared memory; a fragment and the running sum, 64 registers
// each) and a producer warpgroup.  The
// producer's first lane streams two rings of two stages under full / empty
// mbarriers: each 32-deep chunk's sources for the block's rows (TMA boxes
// of [128 rows][32] from ps / pg / tails: the rr coefficients, or the tails
// and the approximation a corr chunk subtracts; rows past Bp zero-filled),
// and the chunk's bases (hi and lo: one bulk copy of 2 x 128 x 128 bytes).
// Each warpgroup converts its rows' sources into A (corr subtraction, row
// scale, split) in a double buffer, chunk c + 1's while chunk c's twelve
// wgmmas run.  (Its threads loading the sources themselves, even a chunk
// ahead into registers, took 0.335 ms at the flagship on the H100, against
// 0.268 through the ring.)  The epilogue adds rg = 0's additive geo terms,
// writes [Bp, Dv + Dq] once, and blocks of the first column block copy the
// queries.  K's segments (rrp, r, rg) are multiples of 32, so a chunk lies
// in one segment.
//
// A wait on a barrier that never completes traps after ~10 s.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;           // rows of a warpgroup: one wgmma M
constexpr int NB = 128;          // output columns of a block
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = 384;     // and the producer warpgroup
constexpr int KC = 32;           // f32 columns of a chunk: one 128-byte row
constexpr int NS = 2;            // stages of each ring

// d[64] (+)= A[64 x 8] B[8 x 128], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

struct Params {
  const float* ps;     // [Bp, psw]
  const float* pg;     // [Bp, pgw]
  const float* tails;  // [Bp, Ws + Wg]
  const float* q;      // [Bp, Dq]
  const float* img;    // [Dv / NB][c][2][NB][32] split bases
  float* out;          // [Bp, Dv + Dq]
  int Bp, Dq, Ws, Wg, r, rrp, rg, Dv, psw, pgw, tw;
  int cs, c;           // chunks of the sem family, of both
  float beta;
};

// Shared memory (offsets from a 1024-byte aligned base): NS stages of the
// bases' [hi | lo] chunk tiles [NB][32]; NS stages of a chunk's sources
// for the block's 128 rows, [x | y] [128][32] f32 (x the coefficients or
// the tails, y the approximation a corr chunk subtracts), as TMA lands them
// in the 128-byte swizzle; each warpgroup's two A buffers of [hi | lo]
// [64][32]; the barriers (full and empty of each bases stage, then of each
// source stage).
struct Layout {
  static constexpr uint32_t B_TILE = NB * 128;
  static constexpr uint32_t STAGE = 2 * B_TILE;
  static constexpr uint32_t X_TILE = 2 * BM * 128;
  static constexpr uint32_t X0 = NS * STAGE;  // [stage][x | y]
  static constexpr uint32_t A_TILE = BM * 128;
  static constexpr uint32_t A0 = X0 + NS * 2 * X_TILE;  // [wg][buf][hi | lo]
  static constexpr uint32_t BARS = A0 + 2 * 2 * 2 * A_TILE;
  static constexpr uint32_t TOTAL = BARS + 32 * NS + 1024;  // + slack to align the base
};

// A chunk's place in K: its family (sem first), whether it holds rr
// coefficients (else corr columns), the column of its source x, and (corr)
// of the approximation y it subtracts.
struct Chunk {
  bool sem, rr;
  int xcol, ycol;
};

__device__ __forceinline__ Chunk chunk_of(const Params& p, int c) {
  Chunk k;
  k.sem = c < p.cs;
  const int kf = KC * (k.sem ? c : c - p.cs);  // the family's K column
  k.rr = kf < p.rrp;
  const int kc = kf - p.rrp;
  const int aoff = k.sem || p.rg ? 0 : p.Dv + 128;  // rg = 0: the geo az columns
  k.xcol = k.rr ? aoff + kf : (k.sem ? 0 : p.Ws) + kc;
  k.ycol = p.rrp + 128 + kc;
  return k;
}

// This thread's share of chunk c's A: row `row` of its warpgroup (the
// block's row 64 wg + row), columns 16 half ..+16, from the source stage at
// `x` (generic pointer), scaled, split, into the A buffer at `a` (hi) and a
// + A_TILE (lo), both 128-byte swizzled.  Rows past Bp were zero-filled.
__device__ __forceinline__ void convert_a(const Params& p, int c, const uint8_t* x, uint32_t a,
                                          int wg, int row, int half, float ss, float sg) {
  const Chunk k = chunk_of(p, c);
  const float scale = k.sem ? ss : sg;
  const int xr = BM * wg + row;  // the row in the block's source tiles
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ch = 4 * half + u;
    const float4 xv = *reinterpret_cast<const float4*>(x + xr * 128 + ((ch ^ (xr & 7)) << 4));
    const float4 yv =
        *reinterpret_cast<const float4*>(x + Layout::X_TILE + xr * 128 + ((ch ^ (xr & 7)) << 4));
    const float v[4] = {(k.rr ? xv.x : xv.x - yv.x) * scale, (k.rr ? xv.y : xv.y - yv.y) * scale,
                        (k.rr ? xv.z : xv.z - yv.z) * scale, (k.rr ? xv.w : xv.w - yv.w) * scale};
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32_rna(v[e]);
      lo[e] = tf32_rna(v[e] - hi[e]);
    }
    const uint32_t off = row * 128 + ((ch ^ (row & 7)) << 4);
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a + off), "f"(hi[0]),
                 "f"(hi[1]), "f"(hi[2]), "f"(hi[3])
                 : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a + Layout::A_TILE + off),
                 "f"(lo[0]), "f"(lo[1]), "f"(lo[2]), "f"(lo[3])
                 : "memory");
  }
}

// Issue frag = the A chunk @ the B chunk in a fresh fragment: lo hi + hi lo
// + hi hi over its four k8 steps.
__device__ __forceinline__ void issue_chunk(float (&frag)[NB / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {  // k8 steps: 32 bytes each
    const uint64_t ahi = desc_k128(a + ks * 32), alo = desc_k128(a + Layout::A_TILE + ks * 32);
    const uint64_t bhi = desc_k128(b + ks * 32), blo = desc_k128(b + Layout::B_TILE + ks * 32);
    wgmma_tf32_n128(frag, alo, bhi, ks > 0 ? 1 : 0);
    wgmma_tf32_n128(frag, ahi, blo, 1);
    wgmma_tf32_n128(frag, ahi, bhi, 1);
  }
}

// beta / max(d_s, 1e-30) and (1 - beta) / max(d_g, 1e-30) of row q
__device__ __forceinline__ float2 row_scales(const Params& p, int q) {
  const float* ps = p.ps + (size_t)q * p.psw;
  const float* pg = p.pg + (size_t)q * p.pgw;
  const float* tq = p.tails + (size_t)q * p.tw;
  const float ds = fmaxf(ps[p.rrp] + (tq[p.r] - ps[p.rrp + 128 + p.r]), 1e-30f);
  const float dg = p.rg ? fmaxf(pg[p.rrp] + (tq[p.Ws + p.rg] - pg[p.rrp + 128 + p.rg]), 1e-30f)
                        : fmaxf(pg[p.Dv] + tq[p.Ws + p.Dv], 1e-30f);
  return make_float2(p.beta / ds, (1.0f - p.beta) / dg);
}

__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint32_t base) {
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t bfull = base + Layout::BARS, bempty = bfull + 8 * NS;
  const uint32_t xfull = bempty + 8 * NS, xempty = xfull + 8 * NS;
  const uint32_t abuf = base + Layout::A0 + wg * 4 * Layout::A_TILE;  // [buf][hi | lo]
  const int qb = blockIdx.x * 2 * BM + wg * BM;  // this warpgroup's first row
  // the A converter's row and its scales (0 past Bp)
  const int arow = wt >> 1, half = wt & 1;
  float2 sc = row_scales(p, min(qb + arow, p.Bp - 1));
  if (qb + arow >= p.Bp) sc = make_float2(0.f, 0.f);
  auto sync_wg = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  };
  auto arrive = [&](uint32_t bar) {  // this warp is done with a stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto next = [](int& s, uint32_t& ph) {
    s = s + 1 == NS ? 0 : s + 1;
    ph = s == 0 ? ph ^ 1 : ph;
  };

  float acc[NB / 2], frag[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // A is converted a chunk ahead of its products, from sources TMA loaded
  // a chunk before that (the producer loads chunk c - 1's sources once more
  // as the c-th: the last conversion goes to an unread buffer).  (Two
  // chunks in flight, in two fragments, spilled and made ptxas serialize
  // the wgmmas (C7515): 0.323 ms at the flagship on the H100, against
  // 0.268.)
  int bs = 0, xs = 0;
  uint32_t bph = 0, xph = 0;
  mbar_wait(xfull, 0);
  convert_a(p, 0, smem + Layout::X0, abuf, wg, arow, half, sc.x, sc.y);
  arrive(xempty);
  next(xs, xph);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
  sync_wg();
  for (int c = 0; c < p.c; ++c) {
    mbar_wait(bfull + 8 * bs, bph);
    mbar_wait(xfull + 8 * xs, xph);
    wgmma_fence();
    issue_chunk(frag, abuf + (c & 1) * 2 * Layout::A_TILE, base + bs * Layout::STAGE);
    wgmma_commit();
    convert_a(p, min(c + 1, p.c - 1), smem + Layout::X0 + xs * 2 * Layout::X_TILE,
              abuf + ((c + 1) & 1) * 2 * Layout::A_TILE, wg, arow, half, sc.x, sc.y);
    wgmma_wait0();
    fence_regs(frag);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] += frag[i];
    arrive(bempty + 8 * bs);
    arrive(xempty + 8 * xs);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_wg();
    next(bs, bph);
    next(xs, xph);
  }

  // ---- epilogue: accumulator element 4j + e is row g + 8 (e >> 1), column
  // 8j + 2t + (e & 1); rg = 0 adds its scaled full-width geo terms
  const int c0 = blockIdx.y * NB, ow = p.Dv + p.Dq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = qb + 16 * warp + g + 8 * e;
    if (q >= p.Bp) continue;
    float* row = p.out + (size_t)q * ow + c0;
    if (p.rg) {
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    } else {
      const float sg = row_scales(p, q).y;
      const float* pg = p.pg + (size_t)q * p.pgw + c0;
      const float* tg = p.tails + (size_t)q * p.tw + p.Ws + c0;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int cl = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(row + cl) =
            make_float2(acc[4 * j + 2 * e] + sg * (pg[cl] + tg[cl]),
                        acc[4 * j + 2 * e + 1] + sg * (pg[cl + 1] + tg[cl + 1]));
      }
    }
  }
  if (blockIdx.y == 0) {  // [retrieved | q]: the query part of this warpgroup's rows
    const int n4 = p.Dq / 4;
    for (int i = wt; i < BM * n4; i += 128) {
      const int q = qb + i / n4, c = 4 * (i % n4);
      if (q < p.Bp)
        *reinterpret_cast<float4*>(p.out + (size_t)q * ow + p.Dv + c) =
            *reinterpret_cast<const float4*>(p.q + (size_t)q * p.Dq + c);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    combine_cat_sm90_kernel(const __grid_constant__ CUtensorMap tps,
                            const __grid_constant__ CUtensorMap tpg,
                            const __grid_constant__ CUtensorMap ttl, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + Layout::BARS;  // [b full | b empty | x full | x empty][NS]
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NS + s), CONSUMERS / 32);
      mbar_init(bars + 8 * (2 * NS + s), 1);
      mbar_init(bars + 8 * (3 * NS + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: chunk c's sources (TMA boxes of the block's 128
    // rows; rows past Bp zero-filled) ahead of its bases ([hi | lo], one
    // bulk copy), and the last chunk's sources once more at the end
    const uint32_t bfull = bars, bempty = bars + 8 * NS;
    const uint32_t xfull = bars + 16 * NS, xempty = bars + 24 * NS;
    const float* img = p.img + (size_t)blockIdx.y * p.c * (Layout::STAGE / 4);
    const int row0 = blockIdx.x * 2 * BM;
    int bs = 0, xs = 0;
    uint32_t bph = 0, xph = 0;
    for (int c = 0; c <= p.c; ++c) {
      const Chunk k = chunk_of(p, min(c, p.c - 1));
      mbar_wait(xempty + 8 * xs, xph ^ 1);
      const uint32_t xst = base + Layout::X0 + xs * 2 * Layout::X_TILE, xb = xfull + 8 * xs;
      mbar_expect_tx(xb, k.rr ? Layout::X_TILE : 2 * Layout::X_TILE);
      const CUtensorMap* src = k.rr ? (k.sem ? &tps : &tpg) : &ttl;
      tma_2d(xst, src, k.xcol, row0, xb);
      if (!k.rr) tma_2d(xst + Layout::X_TILE, k.sem ? &tps : &tpg, k.ycol, row0, xb);
      xs = xs + 1 == NS ? 0 : xs + 1;
      xph = xs == 0 ? xph ^ 1 : xph;
      if (c == p.c) break;
      mbar_wait(bempty + 8 * bs, bph ^ 1);
      mbar_expect_tx(bfull + 8 * bs, Layout::STAGE);
      bulk_g2s(base + bs * Layout::STAGE, img + (size_t)c * (Layout::STAGE / 4), Layout::STAGE,
               bfull + 8 * bs);
      bs = bs + 1 == NS ? 0 : bs + 1;
      bph = bs == 0 ? bph ^ 1 : bph;
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  consume(p, smem, base);
}

// A row-major [rows, cols] f32 tensor read in 128-byte swizzled boxes of
// [box_rows, 32].
bool map_f32(CUtensorMap* m, const void* ptr, int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// A block's dynamic shared memory (bytes).
extern "C" int combine_cat_sm90_smem() { return (int)Layout::TOTAL; }

// ps [Bp, rrp + 128 + Ws], pg [Bp, rrp + 128 + Wg] (rg = 0: [Bp, Dv + 128 +
// rrp], Wg >= Dv + 1 the full-width geo tail), tails [Bp, Ws + Wg], q [Bp,
// Dq], img the split bases of `_combine_images` ([Dv / 128][K / 32][2][128]
// [32] f32, K = 2 rrp + r + rg), out [Bp, Dv + Dq]; all f32, contiguous,
// 16-byte aligned.  Dv a multiple of 128; rrp, r, rg multiples of 32.
// Returns a CUDA error code (cudaErrorInvalidValue for what it does not
// take, with nothing launched).
extern "C" int combine_cat_sm90_launch(const void* ps, const void* pg, const void* tails,
                                       const void* q, const void* img, void* out, int Bp,
                                       int Dq, int Ws, int r, int rrp, int Dv, int rg, int Wg,
                                       float beta, void* stream) {
  if (Bp < 0 || Dq < 0 || Dq % 4 || r <= 0 || r % KC || r >= Ws || rrp <= 0 || rrp % KC ||
      rg < 0 || rg % KC || (rg ? rg >= Wg : Wg < Dv + 1) || Dv <= 0 || Dv % NB || Ws % 4 ||
      Wg % 4 || !aligned16(ps) || !aligned16(pg) || !aligned16(tails) || !aligned16(q) ||
      !aligned16(img) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (Bp == 0) return 0;
  static_assert(Layout::TOTAL <= MAX_SMEM, "shared memory");
  Params p{};
  p.ps = static_cast<const float*>(ps);
  p.pg = static_cast<const float*>(pg);
  p.tails = static_cast<const float*>(tails);
  p.q = static_cast<const float*>(q);
  p.img = static_cast<const float*>(img);
  p.out = static_cast<float*>(out);
  p.Bp = Bp;
  p.Dq = Dq;
  p.Ws = Ws;
  p.Wg = Wg;
  p.r = r;
  p.rrp = rrp;
  p.rg = rg;
  p.Dv = Dv;
  p.psw = rrp + 128 + Ws;
  p.pgw = rg ? rrp + 128 + Wg : Dv + 128 + rrp;
  p.tw = Ws + Wg;
  p.cs = (rrp + r) / KC;
  p.c = p.cs + (rrp + rg) / KC;
  p.beta = beta;
  CUtensorMap tps, tpg, ttl;
  if (encoder() == nullptr || !map_f32(&tps, ps, p.psw, Bp, 2 * BM) ||
      !map_f32(&tpg, pg, p.pgw, Bp, 2 * BM) || !map_f32(&ttl, tails, p.tw, Bp, 2 * BM))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(combine_cat_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Layout::TOTAL);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bp + 2 * BM - 1) / (2 * BM), Dv / NB);
  combine_cat_sm90_kernel<<<grid, THREADS, Layout::TOTAL, static_cast<cudaStream_t>(stream)>>>(
      tps, tpg, ttl, p);
  return (int)cudaGetLastError();
}

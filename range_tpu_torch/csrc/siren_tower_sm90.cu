// The whole SatCLIP location tower in its bf16 mode, for Hopper (sm_90a):
// every product on the tensor cores (wgmma, bf16 operands, f32 sums).
//
// Replaces: range_tpu/ops/sh.py, `kern` inside `_siren_tower_impl`
// (siren_tower_pallas) with matmul_dtype=bfloat16: the Fourier synthesis
// P = ftabT @ fth, (P cos m phi) and (P sin m phi) rounded to bf16 times the
// folded first-layer weights wc / ws, sin(w0_initial (h + b0)), every
// hidden layer sin(w0 (x @ W + b)) and the output layer, with the TPU
// kernel's rounding points: each product takes bf16 operands and sums in
// f32.  A product of two bf16 values is exact in f32, so the tensor cores
// give the plain version's terms; only the order of the sums differs.  The
// f32 mode stays on csrc/siren_tower.cu (true f32 FMAs).
//
// What bounds it on an H100: the tensor cores.  Per query the kernel
// multiplies 2 Lq x Lq x 2 L (the synthesis, Lq = L rounded up to 16), 2 Lq
// x H x L (the first layer) and H x H a further layer: ~1.2 M multiply-adds
// at L = 40, H = 256, ~24 GFLOP at B = 10,000 (~25 us at 989 TFLOP/s).
// Every block streams the 2 Lq x H bf16 first-layer slab of each
// recurrence row (2.4 MB at L = 40) from L2.
//
// Layout.  A block owns 128 queries in two consumer warpgroups of 64 (64
// queries in one where their shared memory does not fit: Lq = 64 at H =
// 256), sharing its rings, and a producer warpgroup; setmaxnreg leaves the
// producer 40 registers a thread and gives each consumer 232 (248 alone; a
// launch of 288 threads compiles to 168, and spilled).  The producer's
// first lane streams two rings under full / empty mbarriers, two stages
// each: the Fourier ring, each recurrence row k's Fourier table rows [Lq x
// 2 Lq], and the weight ring, each row's first-layer slab [2 Lq x H] and
// then each further layer in chunks of KC weight rows.  Row k's first-layer
// product and row k + 1's synthesis run together, so one ring of both would
// hold two rows while they run and refill neither until they end: every
// row would wait out a copy's whole latency.  Apart, each copy is issued a row
// ahead of its use.  Every stage is one plain bulk copy of an image the
// wrapper laid out once (ops/sh.py `_tower_images`): bf16 tiles already in
// the 128-byte swizzle that wgmma's descriptors read, so no tensor map is
// needed.  Each consumer warpgroup:
//   * writes its queries' fth = [cos j theta | sin j theta] (bf16, K-major,
//     zero past L) and a table of cos / sin (m phi) (f32);
//   * per row k: P_k [64 x Lq] = fth @ Fourier slab (wgmma m64nLqk16, both
//     operands K-major in shared memory); in registers, P_k times cos and
//     sin (m phi), rounded to bf16, becomes the register A fragments of the
//     first layer (the accumulator's layout is the A fragment's); h [64 x
//     H] += amat @ slab (wgmma m64nHk16, A from registers, B MN-major).
//     Row k's first-layer product and row k + 1's synthesis are issued
//     together and waited for together; the last row is peeled, so no
//     wgmma is issued under a condition.  The other warpgroup's products
//     fill the tensor cores while one builds its fragments;
//   * x = bf16(sin(w0_initial (h + b0))) into a K-major tile that replaces
//     its fth and table, then each further layer x @ W (wgmma, both from
//     shared memory) chunk by chunk, its activation written back in place;
//     the last layer's f32 sums plus bias are the output.  The sine is
//     `sin_cw`, branch-free (sinf's slow-path call serialized them).
// The first layer's sum is one accumulator chain of 2 L Lq / 16 k16 steps
// (240 at L = 40), far below the chain length whose truncation drifts
// (ROADMAP, "Tensor-core accumulation").
//
// Ragged edges: queries past B compute on (0, 0) and are not written.  A
// wait on a barrier that never completes traps after ~10 s.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;          // queries of a consumer warpgroup: one wgmma M
constexpr int NS = 2;           // stages of each ring

// d[24] (+)= A[64 x 16] B[16 x 48], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

#define TOWER_D128                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),        \
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),        \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),        \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),        \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),        \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),        \
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),     \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),  \
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),  \
      "+f"(d[127])

#define TOWER_R128                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "   \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "   \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "     \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "    \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d[128] += A[64 x 16] B[16 x 256], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" TOWER_R128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TOWER_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[128] (+)= A[64 x 16] B[16 x 256], A K-major, B MN-major, both in shared memory
__device__ __forceinline__ void wgmma_ss_n256_t(float (&d)[128], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" TOWER_R128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : TOWER_D128
      : "l"(a), "l"(b), "r"(scale_d));
}

// The shapes and shared-memory layout of one instance: NQ k16 steps of P
// columns (Lq = 16 NQ >= L), H hidden columns.  Offsets from a 1024-byte
// aligned base; every 128-byte swizzled box starts on 1024 bytes.
template <int NQ, int H>
struct Shape {
  static constexpr int LQ = 16 * NQ;                    // P columns (m = 0 .. Lq-1)
  static constexpr int KS = 2 * LQ;                     // first-layer depth of a row: cos | sin
  static constexpr int KB2 = (KS + 63) / 64;            // 64-column boxes of fth and the table
  static constexpr int KC = (KS % 64 == 0 || KS == 32) ? KS : 64;  // rows of a further-layer chunk
  static constexpr int HB = H / 64;                     // 64-column boxes of H
  // float4s {cos m, cos m + 1, sin m, sin m + 1} of a table row (padded)
  static constexpr int TROW = LQ / 2 + 1;
  static constexpr uint32_t FT_BYTES = KB2 * LQ * 128;  // a row's Fourier slab [KB2][Lq][64]
  static constexpr uint32_t W1_BYTES = KS * H * 2;      // a row's first-layer slab [HB][KS][64]
  static constexpr uint32_t HC_BYTES = KC * H * 2;      // a further-layer chunk [HB][KC][64]
  static constexpr uint32_t W0 = NS * FT_BYTES;         // the weight ring, after the Fourier ring
  static constexpr uint32_t WG0 = W0 + NS * W1_BYTES;   // the consumer warpgroups' regions
  // a warpgroup's region: fth [KB2][64][64] bf16, then the cos / sin table
  // [64][TROW] float4; x [HB][64][64] bf16 over both once fth is dead
  static constexpr uint32_t TRIG = KB2 * BM * 128;
  static constexpr uint32_t WG_BYTES = round_up(
      TRIG + BM * TROW * 16 > HB * BM * 128 ? TRIG + BM * TROW * 16 : HB * BM * 128, 1024);
  // the rings, the barriers and the slack to align the base
  static constexpr uint32_t FIXED = WG0 + 32 * NS + 1024;
  // two consumer warpgroups (128 queries) where their regions fit
  static constexpr int WGS = FIXED + 2 * WG_BYTES <= MAX_SMEM ? 2 : 1;
  // and a producer warpgroup (its first lane issues every copy), whose
  // registers setmaxnreg hands to the consumers
  static constexpr int CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 128;
  // a consumer's registers: all the SM's 64 K with two (2 x 128 x 232 + 128
  // x 40), more with one (at Lq = 64, H = 256 it needs them: 232 spilled)
  static constexpr int MAXREG = WGS == 2 ? 232 : 248;
  // full, then empty, of each Fourier stage, then of each weight stage
  static constexpr uint32_t BARS = WG0 + WGS * WG_BYTES;
  static constexpr uint32_t TOTAL = FIXED + WGS * WG_BYTES;
};

struct Params {
  const float* lonlat;   // [B, 2]
  const uint8_t* ftab;   // [L][FT_BYTES]
  const uint8_t* w1;     // [L][W1_BYTES]
  const uint8_t* hid;    // [(n_deep + 1) * H / KC][HC_BYTES]
  const float* bpack;    // [n_deep + 2, H]
  float* out;            // [B, H]
  int B, L, n_deep;
  float w0_initial, w0;
};

// 8 bf16 (four packed pairs) into row r, 16-byte chunk c of a 128-byte
// swizzled box at `box`.
__device__ __forceinline__ void st_chunk(uint32_t box, int r, int c, uint32_t v0, uint32_t v1,
                                         uint32_t v2, uint32_t v3) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   box + r * 128 + ((c ^ (r & 7)) << 4)),
               "r"(v0), "r"(v1), "r"(v2), "r"(v3)
               : "memory");
}

template <int NQ>
__device__ __forceinline__ void synth_step(float (&P)[8 * NQ], uint64_t a, uint64_t b, int sd) {
  if constexpr (NQ == 1) {
    wgmma_ss_n16(P, a, b, sd);
  } else if constexpr (NQ == 2) {
    wgmma_ss_n32(P, a, b, sd);
  } else if constexpr (NQ == 3) {
    wgmma_ss_n48(P, a, b, sd);
  } else {
    wgmma_ss_n64(P, a, b, sd);
  }
}

// Issue P = fth [64 x KS] @ the row's Fourier slab (its LQ rows, K-major).
template <int NQ, int H>
__device__ __forceinline__ void issue_synth(float (&P)[8 * NQ], uint32_t fth, uint32_t ft) {
  using S = Shape<NQ, H>;
#pragma unroll
  for (int ks = 0; ks < 2 * NQ; ++ks) {
    const uint32_t off = (ks & 3) * 32;  // k16 step within the 128-byte row
    synth_step<NQ>(P, desc_k128(fth + (ks >> 2) * (BM * 128) + off),
                   desc_k128(ft + (ks >> 2) * (S::LQ * 128) + off), ks > 0 ? 1 : 0);
  }
}

// Issue h += amat [64 x KS] (register fragments) @ the row's slab (MN-major).
template <int NQ, int H>
__device__ __forceinline__ void issue_first(float (&h)[H / 2], const uint32_t (&a)[2 * NQ][4],
                                            uint32_t w1) {
  using S = Shape<NQ, H>;
#pragma unroll
  for (int kk = 0; kk < 2 * NQ; ++kk) {
    const uint64_t b = desc_v(w1 + kk * 16 * 128, S::KS);
    if constexpr (H == 256) {
      wgmma_rs_n256(h, a[kk], b);
    } else {
      wgmma_rs_n128(h, a[kk], b);
    }
  }
}

// amat's register A fragments from P (accumulator element 4j + e: row g + 8
// (e >> 1), column 8j + 2t + (e & 1)): k16 step kk < NQ takes P's columns
// 16kk.. times cos(m phi), step NQ + kk the same columns times sin(m phi),
// each product rounded to bf16.
template <int NQ>
__device__ __forceinline__ void make_amat(uint32_t (&a)[2 * NQ][4], const float (&P)[8 * NQ],
                                          const float4* tr0, const float4* tr1, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NQ; ++j) {
    const float4 c0 = tr0[4 * j + t], c1 = tr1[4 * j + t];  // rows g, g + 8
    const int kk = j >> 1, h = 2 * (j & 1);
    a[kk][h] = pack_bf16(P[4 * j] * c0.x, P[4 * j + 1] * c0.y);
    a[kk][h + 1] = pack_bf16(P[4 * j + 2] * c1.x, P[4 * j + 3] * c1.y);
    a[NQ + kk][h] = pack_bf16(P[4 * j] * c0.z, P[4 * j + 1] * c0.w);
    a[NQ + kk][h + 1] = pack_bf16(P[4 * j + 2] * c1.z, P[4 * j + 3] * c1.w);
  }
}

// sin(a) for |a| < 105615, branch-free: a 3-part Cody-Waite reduction by
// pi / 2 and polynomials of sin and cos on [-pi / 4, pi / 4] (within 1.4
// ulp of sin in a float32 model of these steps, over |a| < 1e5).
// sinf itself, whose rare slow path is a call with a stack frame, left a
// warpgroup's 128 activations a thread one after another: ~55,000 cycles
// a layer on the H100, against ~4,000 interleaved.
__device__ __forceinline__ float sin_cw(float a) {
  const float q = rintf(a * 0.636619772f);
  float r = fmaf(q, -1.57079601e+00f, a);
  r = fmaf(q, -3.13916473e-07f, r);
  r = fmaf(q, -5.39030253e-15f, r);
  const int i = (int)q;
  const float r2 = r * r;
  float s = fmaf(-1.95152959e-4f, r2, 8.33216087e-3f);
  s = fmaf(s, r2, -1.66666546e-1f);
  s = fmaf(s * r2, r, r);
  float c = fmaf(2.44331571e-5f, r2, -1.38873163e-3f);
  c = fmaf(c, r2, 4.16666457e-2f);
  c = fmaf(c, r2, -5.00000000e-1f);
  c = fmaf(c, r2, 1.0f);
  const float v = (i & 1) ? c : s;
  return (i & 2) ? -v : v;
}

// x = bf16(sin(w (h + bias))) into the K-major x tile at `xt` (a generic
// pointer to shared memory): accumulator element 4j + e of row r0 + 8 (e >>
// 1), columns 8j + 2t, + 1.  The activations first, in place, then the
// stores; an argument past sin_cw's range (never a trained tower's) takes
// sinf for the thread's whole row.
template <int H>
__device__ __forceinline__ void store_x(uint8_t* xt, float (&h)[H / 2],
                                        const float* __restrict__ bias, int r0, int t, float w) {
  float big = 0.f;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    h[4 * j] = w * (h[4 * j] + b.x);
    h[4 * j + 1] = w * (h[4 * j + 1] + b.y);
    h[4 * j + 2] = w * (h[4 * j + 2] + b.x);
    h[4 * j + 3] = w * (h[4 * j + 3] + b.y);
    big = fmaxf(big, fmaxf(fmaxf(fabsf(h[4 * j]), fabsf(h[4 * j + 1])),
                           fmaxf(fabsf(h[4 * j + 2]), fabsf(h[4 * j + 3]))));
  }
  if (big < 105615.0f) {
#pragma unroll
    for (int i = 0; i < H / 2; ++i) h[i] = sin_cw(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < H / 2; ++i) h[i] = sinf(h[i]);
  }
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      *reinterpret_cast<uint32_t*>(xt + (j >> 3) * (BM * 128) + r * 128 +
                                   (((j & 7) ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(h[4 * j + 2 * e], h[4 * j + 2 * e + 1]);
    }
}

// A barrier of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int NQ, int H>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint32_t base) {
  using S = Shape<NQ, H>;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM * S::WGS + BM * wg, L = p.L;
  const uint32_t region = S::WG0 + wg * S::WG_BYTES;  // this warpgroup's fth, table, x
  const uint32_t ft_full = base + S::BARS, ft_empty = ft_full + 8 * NS;
  const uint32_t w_full = ft_empty + 8 * NS, w_empty = w_full + 8 * NS;
  const float deg = 0.017453292519943295f;  // pi / 180

  // ---- fth (bf16, K-major, zero past L in each half and past KS) and the
  // cos / sin (m phi) table: a thread per (row, 16-byte chunk) of fth
  for (int i = tid; i < BM * S::KB2 * 8; i += 128) {
    const int r = i / (S::KB2 * 8), c = i % (S::KB2 * 8), q = q0 + r;
    const float lat = q < p.B ? p.lonlat[2 * q + 1] : 0.f;
    const float theta = (lat + 90.0f) * deg;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = 8 * c + u, j = k < S::LQ ? k : k - S::LQ;
      const float at = theta * (float)j;
      v[u] = (k >= S::KS || j >= L) ? 0.f : (k < S::LQ ? cosf(at) : sinf(at));
    }
    st_chunk(base + region + (c >> 3) * (BM * 128), r, c & 7, pack_bf16(v[0], v[1]),
             pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  float4* trig = reinterpret_cast<float4*>(smem + region + S::TRIG);
  for (int i = tid; i < BM * (S::LQ / 2); i += 128) {
    const int r = i / (S::LQ / 2), m = 2 * (i % (S::LQ / 2)), q = q0 + r;
    const float lon = q < p.B ? p.lonlat[2 * q] : 0.f;
    const float phi = (lon + 180.0f) * deg;
    const float a0 = phi * (float)m, a1 = phi * (float)(m + 1);
    trig[r * S::TROW + m / 2] = make_float4(cosf(a0), cosf(a1), sinf(a0), sinf(a1));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the tensor cores
  wg_sync(wg);

  const int r0 = 16 * warp + g;
  const float4* tr0 = trig + r0 * S::TROW;
  const float4* tr1 = trig + (r0 + 8) * S::TROW;
  auto arrive = [&](uint32_t bar) {  // this warp is done with a stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float h[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) h[i] = 0.f;
  float P[8 * NQ];
  uint32_t a[2 * NQ][4];

  // ---- the first layer, one recurrence row a Fourier and a weight stage;
  // f and w: the stages of row k + 1's Fourier slab and row k's weights
  mbar_wait(ft_full, 0);
  wgmma_fence();
  issue_synth<NQ, H>(P, base + region, base);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(P);
  arrive(ft_empty);
  make_amat<NQ>(a, P, tr0, tr1, t);
  int f = 1, w = 0;
  uint32_t fph = 0, wph = 0;
  auto next = [](int& s, uint32_t& ph) {
    s = s + 1 == NS ? 0 : s + 1;
    ph = s == 0 ? ph ^ 1 : ph;
  };
  for (int k = 0; k + 1 < L; ++k) {
    mbar_wait(w_full + 8 * w, wph);
    mbar_wait(ft_full + 8 * f, fph);
    wgmma_fence();
    issue_first<NQ, H>(h, a, base + S::W0 + w * S::W1_BYTES);
    issue_synth<NQ, H>(P, base + region, base + f * S::FT_BYTES);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(h);
    fence_regs(P);
    arrive(w_empty + 8 * w);
    arrive(ft_empty + 8 * f);
    make_amat<NQ>(a, P, tr0, tr1, t);
    next(w, wph);
    next(f, fph);
  }
  mbar_wait(w_full + 8 * w, wph);
  wgmma_fence();
  issue_first<NQ, H>(h, a, base + S::W0 + w * S::W1_BYTES);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(h);
  arrive(w_empty + 8 * w);
  next(w, wph);

  // ---- x0 = bf16(sin(w0_initial (h + b0))) over fth and the table
  wg_sync(wg);  // every warp's reads of fth and the table are done
  const uint32_t xt = base + region;
  uint8_t* xts = smem + region;
  const float w0i = p.w0_initial, w0 = p.w0;
  store_x<H>(xts, h, p.bpack, r0, t, w0i);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);

  // ---- the further layers: chunks of KC weight rows, the last layer last
  for (int l = 0; l <= p.n_deep; ++l) {
#pragma unroll
    for (int c = 0; c < H / S::KC; ++c) {
      mbar_wait(w_full + 8 * w, wph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::KC / 16; ++kk) {
        const int ks = c * (S::KC / 16) + kk;  // k16 step of x
        const uint64_t da = desc_k128(xt + (ks >> 2) * (BM * 128) + (ks & 3) * 32);
        const uint64_t db = desc_v(base + S::W0 + w * S::W1_BYTES + kk * 16 * 128, S::KC);
        if constexpr (H == 256) {
          wgmma_ss_n256_t(h, da, db, (c | kk) ? 1 : 0);
        } else {
          wgmma_ss_n128_t(h, da, db, (c | kk) ? 1 : 0);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(h);
      arrive(w_empty + 8 * w);
      next(w, wph);
    }
    const float* bias = p.bpack + (size_t)(l + 1) * H;
    if (l < p.n_deep) {
      wg_sync(wg);  // every warp's reads of x are done
      store_x<H>(xts, h, bias, r0, t, w0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + r0 + 8 * e;
        if (q >= p.B) continue;
        float* row = p.out + (size_t)q * H;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
          *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
              make_float2(h[4 * j + 2 * e] + b.x, h[4 * j + 2 * e + 1] + b.y);
        }
      }
    }
  }
}

template <int NQ, int H>
__global__ void __launch_bounds__(Shape<NQ, H>::THREADS, 1)
    siren_tower_sm90_kernel(const Params p) {
  using S = Shape<NQ, H>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + S::BARS;  // [ft full | ft empty | w full | w empty][NS]
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NS + s), S::CONSUMERS / 32);
      mbar_init(bars + 8 * (2 * NS + s), 1);
      mbar_init(bars + 8 * (3 * NS + s), S::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= S::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != S::CONSUMERS) return;
    // ---- the producer: each row's Fourier slab and first-layer slab, in
    // the order the consumers use them, then every further chunk
    const uint32_t ft_full = bars, ft_empty = bars + 8 * NS;
    const uint32_t w_full = bars + 16 * NS, w_empty = bars + 24 * NS;
    int f = 0, w = 0;
    uint32_t fph = 0, wph = 0;
    auto put = [&](uint32_t full, uint32_t empty, uint32_t dst, const uint8_t* src,
                   uint32_t bytes, int& s, uint32_t& ph) {
      mbar_wait(empty + 8 * s, ph ^ 1);
      mbar_expect_tx(full + 8 * s, bytes);
      bulk_g2s(dst, src, bytes, full + 8 * s);
      s = s + 1 == NS ? 0 : s + 1;
      ph = s == 0 ? ph ^ 1 : ph;
    };
    for (int k = 0; k < p.L; ++k) {
      put(ft_full, ft_empty, base + f * S::FT_BYTES, p.ftab + (size_t)k * S::FT_BYTES,
          S::FT_BYTES, f, fph);
      put(w_full, w_empty, base + S::W0 + w * S::W1_BYTES, p.w1 + (size_t)k * S::W1_BYTES,
          S::W1_BYTES, w, wph);
    }
    const int chunks = (p.n_deep + 1) * (H / S::KC);
    for (int c = 0; c < chunks; ++c)
      put(w_full, w_empty, base + S::W0 + w * S::W1_BYTES, p.hid + (size_t)c * S::HC_BYTES,
          S::HC_BYTES, w, wph);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::MAXREG) : "memory");
  consume<NQ, H>(p, smem, base);
}

template <int NQ, int H>
int launch(const Params& p, cudaStream_t stream) {
  using S = Shape<NQ, H>;
  static_assert(S::TOTAL <= MAX_SMEM, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(siren_tower_sm90_kernel<NQ, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::TOTAL);
  if (err != cudaSuccess) return (int)err;
  const int rows = BM * S::WGS;  // queries of a block
  siren_tower_sm90_kernel<NQ, H><<<(p.B + rows - 1) / rows, S::THREADS, S::TOTAL, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int H>
int launch_h(const Params& p, int nq, cudaStream_t s) {
  switch (nq) {
    case 1: return launch<1, H>(p, s);
    case 2: return launch<2, H>(p, s);
    case 3: return launch<3, H>(p, s);
    case 4: return launch<4, H>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H>
int smem_h(int nq) {
  switch (nq) {
    case 1: return (int)Shape<1, H>::TOTAL;
    case 2: return (int)Shape<2, H>::TOTAL;
    case 3: return (int)Shape<3, H>::TOTAL;
    case 4: return (int)Shape<4, H>::TOTAL;
    default: return -1;
  }
}

}  // namespace

// A block's dynamic shared memory (bytes) at (L, H), or -1 for a shape the
// kernel does not take.
extern "C" int siren_tower_sm90_smem(int L, int H) {
  if (L < 2 || L > 64) return -1;
  const int nq = (L + 15) / 16;
  return H == 256 ? smem_h<256>(nq) : H == 128 ? smem_h<128>(nq) : -1;
}

// lonlat [B, 2] f32; ftab, w1, hid the bf16 images of ops/sh.py
// `_tower_images` (L row stages of the Fourier and first-layer slabs, then
// (n_deep + 1) * H / KC chunks of the further layers' [in, out] weights);
// bpack [n_deep + 2, H] f32 biases; out [B, H] f32.  H is 128 or 256, 2 <=
// L <= 64; every pointer 16-byte aligned.  Returns a CUDA error code
// (cudaErrorInvalidValue for what it does not take, with nothing launched).
extern "C" int siren_tower_sm90_launch(const void* lonlat, const void* ftab, const void* w1,
                                       const void* hid, const void* bpack, void* out, int B,
                                       int L, int H, int n_deep, float w0_initial, float w0,
                                       void* stream) {
  if (B < 0 || L < 2 || L > 64 || n_deep < 0 || (H != 128 && H != 256) || !aligned16(ftab) ||
      !aligned16(w1) || !aligned16(hid) || !aligned16(bpack) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{static_cast<const float*>(lonlat), static_cast<const uint8_t*>(ftab),
           static_cast<const uint8_t*>(w1),   static_cast<const uint8_t*>(hid),
           static_cast<const float*>(bpack),  static_cast<float*>(out),
           B, L, n_deep, w0_initial, w0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nq = (L + 15) / 16;
  return H == 256 ? launch_h<256>(p, nq, s) : launch_h<128>(p, nq, s);
}

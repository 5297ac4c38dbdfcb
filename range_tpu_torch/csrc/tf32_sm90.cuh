// f32 products as three TF32 products on Hopper's tensor cores (sm_90a):
// the split of an f32 value into TF32 halves and the tf32 wgmma
// instructions of the kernels that take f32 operands (the tower's f32 mode,
// csrc/siren_tower_sm90.cu; kernel 14's rr shapes at the `exact` tier,
// csrc/hier_rr_tf32_sm90.cu; kernel 15 and kernel 14's value shapes there,
// csrc/hier_values_tf32_sm90.cu; kernels 8 and 9, csrc/hier_scan_tf32_sm90.cu),
// and the segments and fold they share.  Nothing here launches anything but
// the fold.
//
// x = hi + lo with hi = rna(x), lo = rna(x - hi) (x - hi is exact in f32);
// a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (lo lo, ~2^-22
// of a term, dropped), each term to ~2^-21 relative.  The tensor cores add
// each step into their f32 accumulator with truncation, which over a long
// chain drifts past the f32 bars where terms cancel; so a kernel sums each
// 32-deep chunk's twelve products in a fresh fragment and adds the
// fragments into its running sum in f32, rounded to nearest (ROADMAP,
// "Tensor-core accumulation"; the combine's csrc/combine_cat_sm90.cu).
//
// Register A fragments: in m64nNk8 a thread (lane g * 4 + t of its warp)
// holds A's rows g, g + 8 at k columns t and t + 4, where an accumulator,
// or one 8-byte load of an f32 row, holds columns 2t and 2t + 1.  So the
// images these kernels read lay each k8 block of K out as the physical
// columns (0 2 4 6 1 3 5 7): the thread's A columns t, t + 4 are then the
// physical 2t, 2t + 1, and a dot product's terms are the same (ops/_prep.py
// `tf32_k8_perm`).
#pragma once

#include "sm90_common.cuh"

namespace tf32 {

__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi and lo of x, as the bit patterns a tf32 operand register holds
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// A fragment (rows g, g + 8; physical columns 2t, 2t + 1) split into its
// hi and lo registers: v00 row g column 2t, v10 row g + 8 column 2t, v01
// row g column 2t + 1, v11 row g + 8 column 2t + 1.
__device__ __forceinline__ void split_frag(float v00, float v10, float v01, float v11,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(v00, hi[0], lo[0]);
  split(v10, hi[1], lo[1]);
  split(v01, hi[2], lo[2]);
  split(v11, hi[3], lo[3]);
}

// A chunk's A fragments from an f32 row-major tile in shared memory (rows
// r0, r0 + 8, row stride ld): physical columns 32 c + 8 s + 2t, + 1 of k8
// step s, split (`row` points at row r0, column 2t).
__device__ __forceinline__ void load_frags(const float* row, int ld, int c, uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 v0 = *reinterpret_cast<const float2*>(row + 32 * c + 8 * s);
    const float2 v1 = *reinterpret_cast<const float2*>(row + 8 * ld + 32 * c + 8 * s);
    split_frag(v0.x, v1.x, v0.y, v1.y, ah[s], al[s]);
  }
}

// Issue one 32-deep chunk into the fresh fragment d: per k8 step s, lo hi +
// hi lo + hi hi against the B tile pair at `tile` (hi, K-major [N][32] f32
// in the 128-byte swizzle) and `tile + lo_off`; `mma` is the shape's
// instruction.
template <int N, typename F>
__device__ __forceinline__ void issue_chunk(float (&d)[N], const uint32_t (&ah)[4][4],
                                            const uint32_t (&al)[4][4], uint32_t tile,
                                            uint32_t lo_off, F mma) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t bh = sm90::desc_k128(tile + 32 * s);
    const uint64_t bl = sm90::desc_k128(tile + lo_off + 32 * s);
    mma(d, al[s], bh, s > 0 ? 1 : 0);
    mma(d, ah[s], bl, 1);
    mma(d, ah[s], bh, 1);
  }
}

// d[4] (+)= A[64 x 8] B[8 x 8], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n8(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[12] (+)= A[64 x 8] B[8 x 24], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n24(float (&d)[12], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


// d[8] (+)= A[64 x 8] B[8 x 16], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[16] (+)= A[64 x 8] B[8 x 32], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[32] (+)= A[64 x 8] B[8 x 64], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64] (+)= A[64 x 8] B[8 x 128], tf32: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64] (+)= A[64 x 8] B[8 x 128], tf32: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
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

// A chunk's A fragments read from device memory, as load_frags reads a
// resident block: `row` points at query row r0's operand column 32 c + 2t,
// ld8 at row r0 + 8 from there, `rem` the operand's columns left from `row`
// (0 past them).
__device__ __forceinline__ void global_frags(const float* row, size_t ld8, int rem,
                                             uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = 8 * s;
    const float v00 = c < rem ? __ldg(row + c) : 0.f;
    const float v01 = c + 1 < rem ? __ldg(row + c + 1) : 0.f;
    const float v10 = c < rem ? __ldg(row + ld8 + c) : 0.f;
    const float v11 = c + 1 < rem ? __ldg(row + ld8 + c + 1) : 0.f;
    split_frag(v00, v10, v01, v11, ah[s], al[s]);
  }
}

// ---- the lists' segments (csrc/hier_rr_tf32_sm90.cu,
// csrc/hier_values_tf32_sm90.cu): where query blocks are few, each list is
// cut into n_seg segments of a block each (ops/retrieval_hier.py
// `_rr_tf32_segments`), whose partial sums are folded in segment order.

namespace {

__device__ __forceinline__ void next_stage(int& s, uint32_t& ph, int n) {
  s = s + 1 == n ? 0 : s + 1;
  ph = s == 0 ? ph ^ 1 : ph;
}

// The list entries [e0, e1) of segment `seg` of n_seg.
__device__ __forceinline__ void segment(int K, int seg, int n_seg, int& e0, int& e1) {
  e0 = (int)((long long)K * seg / n_seg);
  e1 = (int)((long long)K * (seg + 1) / n_seg);
}

// out[q, oc0 + c] (+)= sum over s in order of work[s, q, c], c < cols;
// column `lrr` at out column dcol where dcol >= 0
__global__ void fold_kernel(const float* __restrict__ work, float* __restrict__ out, int Bp,
                            int wc, int cols, int n_seg, int ow, int oc0, int accumulate,
                            int lrr, int dcol) {
  const size_t n = (size_t)Bp * cols;
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < n;
       u += (size_t)gridDim.x * blockDim.x) {
    const size_t q = u / cols, c = u % cols;
    float s = 0.f;
    for (int k = 0; k < n_seg; ++k) s += work[((size_t)k * Bp + q) * wc + c];
    float* o = out + q * ow + (dcol >= 0 && (int)c == lrr ? dcol : oc0 + c);
    *o = accumulate ? *o + s : s;
  }
}

inline int fold(const float* work, float* out, int Bp, int wc, int cols, int n_seg, int ow,
                int oc0, cudaStream_t s, int accumulate = 0, int lrr = 0, int dcol = -1) {
  const size_t n = (size_t)Bp * cols;
  const int blocks = n / 256 + 1 < 4096 ? (int)(n / 256 + 1) : 4096;
  fold_kernel<<<blocks, 256, 0, s>>>(work, out, Bp, wc, cols, n_seg, ow, oc0, accumulate, lrr,
                                     dcol);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tf32

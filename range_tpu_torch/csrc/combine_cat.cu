// Hierarchical retrieval, stage 3: the combine + concat epilogue.
//
// Replaces: range_tpu/ops/retrieval_hier.py, `_combine_cat_kernel`
// (reached via _combine_cat_call <- retrieve_hier), with the low-rank geo
// tail (rg > 0) and without it (rg = 0).  Per query row, for each family f
// (sem: parts ps, tail columns [0, Ws); geo: parts pg, tail columns
// [Ws, Ws + Wg)), with a low-rank tail (r_f > 0, parts az | d | pad | alr):
//   corr_f = tails_f - parts_f[:, rrp + 128 :]        (all tiles - approx)
//   acc_f  = [parts_f[:, :rrp] | corr_f[:, :r_f]] @ [w_f; u_f]
//   d_f    = parts_f[:, rrp] + corr_f[:, r_f]
// and with the full-width tail (r_f = 0, the geo family of rg = 0: parts
// acc | d | pad | az, the group approximation already subtracted):
//   acc_f  = parts_f[:, :Dv] + tails_f[:, :Dv] + parts_f[:, Dv + 128 :] @ w_f
//   d_f    = parts_f[:, Dv] + tails_f[:, Dv]
// then out[:, :Dv] = beta acc_s / max(d_s, 1e-30) + (1 - beta) acc_g /
// max(d_g, 1e-30) and out[:, Dv:] = the (sorted) queries.
//
// What bounds it on an H100: the two unprojection products, 2 x Dv x
// (rrp + r + rrp + rg) flops per query: at the flagship shape (B = 10,112,
// Dv = 1,024, rrp = 128, r = 256, rg = 384) ~18.5 GFLOP in f32, which runs
// on the CUDA cores (67 TFLOP/s) because the bases and coefficients are f32
// in the JAX kernel too; ~110 MB of partials, bases and output move.
// Compute-bound.
//
// Design: a block owns 64 query rows x 128 output columns and runs both
// products as an f32 register-tiled GEMM (4 rows x 8 columns per thread,
// 16-deep chunks staged in shared memory).  The A operand is assembled on
// the fly from the partials (the corr subtraction happens while loading),
// so no [Bp, rrp + r] coefficient matrix is written; the normalization,
// blend and the query copy are the epilogue, and the [Bp, Dv + Dq] output
// is written once.  The products use plain f32 FMAs (no TF32) so that the
// kernel agrees with its plain version to f32 summation order.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 128;       // output columns per block
constexpr int KC = 16;        // depth of one staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 rows x 8 columns each

struct Family {
  const float* parts;  // [Bp, pw]
  const float* w;      // [rrp + r, Dv] stacked [w; u]
  int pw;              // row width of parts: rrp + 128 + W, or Dv + 128 + rrp (r = 0)
  int toff;            // first tails column of the family
  int r;               // low-rank width; 0: the full-width tail
  int aoff;            // first parts column of the rr coefficients: 0, or Dv + 128
};

__global__ void __launch_bounds__(THREADS)
combine_cat_kernel(Family fs, Family fg, const float* __restrict__ tails, int tw,
                   const float* __restrict__ qsrc, float* __restrict__ out, int Bp, int Dq,
                   int rrp, int Dv, float beta) {
  __shared__ __align__(16) float As[KC][BM];
  __shared__ __align__(16) float Bs[KC][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[2][4][8];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[f][i][j] = 0.f;

#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const Family fam = f ? fg : fs;
    const int Kf = rrp + fam.r;
    for (int k0 = 0; k0 < Kf; k0 += KC) {
      // A chunk: [parts_f[:, :rrp] | tails_f - parts_f[:, rrp + 128:]]
      for (int i = tid; i < BM * KC; i += THREADS) {
        const int row = i / KC, kk = i % KC, k = k0 + kk, q = q0 + row;
        float v = 0.f;
        if (k < Kf && q < Bp) {
          const float* p = fam.parts + (size_t)q * fam.pw;
          v = k < rrp ? p[fam.aoff + k]
                      : tails[(size_t)q * tw + fam.toff + (k - rrp)] - p[rrp + 128 + (k - rrp)];
        }
        As[kk][row] = v;
      }
      // B chunk: rows k0 .. k0 + 15 of the stacked basis, this block's columns
      for (int i = tid; i < KC * BN / 4; i += THREADS) {
        const int kk = i / (BN / 4), c = (i % (BN / 4)) * 4, k = k0 + kk;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < Kf) v = *reinterpret_cast<const float4*>(fam.w + (size_t)k * Dv + col0 + c);
        *reinterpret_cast<float4*>(&Bs[kk][c]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[f][i][j] = fmaf(av[i], bv[j], acc[f][i][j]);
      }
      __syncthreads();
    }
  }

  // normalize each family, blend, store
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= Bp) continue;
    const float* ps = fs.parts + (size_t)q * fs.pw;
    const float* pg = fg.parts + (size_t)q * fg.pw;
    const float* tq = tails + (size_t)q * tw;
    const float ds = fmaxf(ps[rrp] + (tq[fs.toff + fs.r] - ps[rrp + 128 + fs.r]), 1e-30f);
    float dg;
    if (fg.r) {
      dg = fmaxf(pg[rrp] + (tq[fg.toff + fg.r] - pg[rrp + 128 + fg.r]), 1e-30f);
    } else {  // the full-width tail: the parts' and the tail's own columns
      dg = fmaxf(pg[Dv] + tq[fg.toff + Dv], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + tx * 8 + j;
        acc[1][i][j] = (pg[c] + tq[fg.toff + c]) + acc[1][i][j];
      }
    }
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = beta * (acc[0][i][j] / ds) + (1.0f - beta) * (acc[1][i][j] / dg);
    float* dst = out + (size_t)q * (Dv + Dq) + col0 + tx * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
  if (blockIdx.y == 0) {  // [retrieved | q]: the query part
    for (int i = tid; i < BM * Dq; i += THREADS) {
      const int row = i / Dq, c = i % Dq, q = q0 + row;
      if (q < Bp) out[(size_t)q * (Dv + Dq) + Dv + c] = qsrc[(size_t)q * Dq + c];
    }
  }
}

}  // namespace

// ps [Bp, rrp + 128 + Ws], pg [Bp, rrp + 128 + Wg] (rg = 0: [Bp, Dv + 128 +
// rrp], Wg >= Dv + 1 the full-width geo tail), tails [Bp, Ws + Wg], q
// [Bp, Dq], wsem [rrp + r, Dv], wgeo [rrp + rg, Dv], out [Bp, Dv + Dq]; all
// f32, contiguous, 16-byte aligned.
extern "C" int combine_cat_launch(const void* ps, const void* pg, const void* tails,
                                  const void* q, const void* wsem, const void* wgeo, void* out,
                                  int Bp, int Dq, int Ws, int r, int rrp, int Dv, int rg, int Wg,
                                  float beta, void* stream) {
  if (Bp <= 0) return 0;
  if (Dv % BN || Dq < 0 || Dq % 4 || r <= 0 || r >= Ws || rg < 0 || rrp <= 0 ||
      (rg ? rg >= Wg : Wg < Dv + 1))
    return (int)cudaErrorInvalidValue;
  const Family fs{static_cast<const float*>(ps), static_cast<const float*>(wsem),
                  rrp + 128 + Ws, 0, r, 0};
  const Family fg{static_cast<const float*>(pg), static_cast<const float*>(wgeo),
                  rg ? rrp + 128 + Wg : Dv + 128 + rrp, Ws, rg, rg ? 0 : Dv + 128};
  const dim3 grid((Bp + BM - 1) / BM, Dv / BN);
  combine_cat_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      fs, fg, static_cast<const float*>(tails), Ws + Wg, static_cast<const float*>(q),
      static_cast<float*>(out), Bp, Dq, rrp, Dv, beta);
  return (int)cudaGetLastError();
}

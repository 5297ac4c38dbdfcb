// Shared device code of the SH-times kernel (sh_times.cu) and the SIREN
// tower kernel (siren_tower.cu): the SatCLIP first layer, basis @ W0, for
// a block of BM queries, without the [BM, L^2] basis.
//
// The TPU kernels hold P [L^2, bm] and both folded weights (1.6 MB each at
// L=40) in VMEM; none of that fits in 227 KB of shared memory.  So a block
// walks the recurrence row k = 0..L-1, one L-row slab of P at a time:
// P_k = ftabT[kL:(k+1)L] @ fth (the Fourier synthesis), times cos/sin(m
// phi) (the same m = r for every slab), then
// h += (P_k cos)^T wc[kL:(k+1)L] + (P_k sin)^T ws[kL:(k+1)L], with the
// weight rows staged through shared memory WROWS at a time.  h [BM, 32*NC]
// lives in registers: warp w owns queries 8w..8w+7, lane x owns columns
// x + 32j.  With bf16 operands only the matmul inputs (ftabT, fth, P*trig,
// the folded weights) round to bf16, to nearest even; every sum stays f32,
// as the TPU kernels' preferred_element_type=f32 does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sh_synth {

constexpr int BM = 64;        // queries per block
constexpr int THREADS = 256;  // 8 warps
constexpr int WROWS = 32;     // weight rows staged in shared memory per step

__device__ __forceinline__ float op_round(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// acc[i][j] += sum_k at[k][8*ty + i] * bs[k][tx + 32*j]   (at: [K][lda], bs: [K][32*NC])
template <int NC>
__device__ __forceinline__ void fma_tile(float (&acc)[8][NC], const float* at, int lda,
                                         const float* bs, int K, int ty, int tx) {
  constexpr int N = 32 * NC;
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(at + k * lda + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(at + k * lda + ty * 8 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = bs[k * N + tx + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc += at[0:nrows] contracted with the global weight rows wg[0:nrows, 0:32*NC]
// (row stride ldw), staged WROWS rows at a time through wsm.  Starts and
// ends with a barrier so the caller may rewrite what `at` points to
// afterwards.
template <int NC>
__device__ __forceinline__ void stage_and_fma(float (&acc)[8][NC], const float* __restrict__ wg,
                                              int ldw, int nrows, const float* at, int lda,
                                              float* wsm, bool bf16, int tid, int ty, int tx) {
  constexpr int N = 32 * NC;
  for (int r0 = 0; r0 < nrows; r0 += WROWS) {
    const int rows = min(WROWS, nrows - r0);
    __syncthreads();
    for (int idx = tid; idx < rows * N; idx += THREADS)
      wsm[idx] = op_round(wg[(size_t)(r0 + idx / N) * ldw + idx % N], bf16);
    __syncthreads();
    fma_tile<NC>(acc, at + r0 * lda, lda, wsm, rows, ty, tx);
  }
  __syncthreads();
}

// Shared-memory floats of first_layer's operands (its weight staging
// buffer, WROWS * 32 * NC floats, is the caller's and comes separately).
__host__ __device__ inline int first_layer_floats(int L) { return 3 * 2 * L * BM + L * 2 * L; }

// acc[i][j] = (basis @ W0)[q0 + 8*ty + i][tx + 32*j] for the block's BM
// queries (zero for queries >= B), summed over the recurrence rows k0..k1-1
// (0..L for the whole product; a part of it when blocks split the rows).
// wc, ws point at the block's first column of the folded weights
// [L^2][ldw].  smem holds first_layer_floats(L) floats; wsm holds
// WROWS * 32 * NC.  Ends with a barrier: the caller may reuse smem
// afterwards.
template <int NC>
__device__ __forceinline__ void first_layer(float (&acc)[8][NC], const float* __restrict__ lonlat,
                                            const float* __restrict__ ftabT,
                                            const float* __restrict__ wc,
                                            const float* __restrict__ ws, int ldw, int B, int L,
                                            int k0, int k1, int q0, bool rb, float* smem,
                                            float* wsm, int tid, int ty, int tx) {
  const int L2 = 2 * L;
  float* fth = smem;             // [2L][BM]  cos(j th) | sin(j th): synthesis operand
  float* trig = fth + L2 * BM;   // [2L][BM]  cos(m phi) | sin(m phi)
  float* amat = trig + L2 * BM;  // [2L][BM]  P_k cos | P_k sin: folded-matmul operand
  float* fslab = amat + L2 * BM; // [L][2L]   rows kL..kL+L-1 of ftabT

  const float deg = 0.017453292519943295f;  // pi / 180
  for (int idx = tid; idx < L * BM; idx += THREADS) {
    const int j = idx / BM, b = idx % BM, q = q0 + b;
    float lon = 0.f, lat = 0.f;
    if (q < B) {
      lon = lonlat[2 * q];
      lat = lonlat[2 * q + 1];
    }
    const float phi = (lon + 180.0f) * deg;
    const float theta = (lat + 90.0f) * deg;
    const float at = theta * (float)j, ap = phi * (float)j;
    fth[j * BM + b] = op_round(cosf(at), rb);
    fth[(L + j) * BM + b] = op_round(sinf(at), rb);
    trig[j * BM + b] = cosf(ap);
    trig[(L + j) * BM + b] = sinf(ap);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int k = k0; k < k1; ++k) {
    __syncthreads();  // prologue writes done; previous slab's readers done
    for (int idx = tid; idx < L * L2; idx += THREADS)
      fslab[idx] = op_round(ftabT[(size_t)k * L * L2 + idx], rb);
    __syncthreads();
    // P_k[r][b] = sum_j ftabT[kL + r][j] * fth[j][b]; column p = kL + r has m = r
    for (int idx = tid; idx < L * BM; idx += THREADS) {
      const int r = idx / BM, b = idx % BM;
      float p = 0.f;
      for (int j = 0; j < L2; ++j) p = fmaf(fslab[r * L2 + j], fth[j * BM + b], p);
      amat[r * BM + b] = op_round(p * trig[r * BM + b], rb);
      amat[(L + r) * BM + b] = op_round(p * trig[(L + r) * BM + b], rb);
    }
    stage_and_fma<NC>(acc, wc + (size_t)k * L * ldw, ldw, L, amat, BM, wsm, rb, tid, ty, tx);
    stage_and_fma<NC>(acc, ws + (size_t)k * L * ldw, ldw, L, amat + L * BM, BM, wsm, rb, tid,
                      ty, tx);
  }
}

}  // namespace sh_synth

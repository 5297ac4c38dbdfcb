// basis @ W for the SatCLIP spherical-harmonics basis, without the basis.
//
// Replaces: range_tpu/ops/sh.py, `kern` inside `_sh_times_pallas_impl`
// (spherical_harmonics_times_pallas): per query, the Fourier synthesis
// P = ftab @ [cos j th | sin j th] of the normalized-Legendre block, then
// out = (P * cos-tile) @ Wc + (P * sin-tile) @ Ws with the two folded
// weights.  The [B, D] sum is written out as it is: no bias, no sine (the
// SIREN tower kernel, siren_tower.cu, continues from the same first layer).
//
// What bounds it on an H100: arithmetic.  Per query it does L^2 * 2L
// (synthesis) + 2 * L^2 * D (folded products) multiply-adds (~0.9 M at
// L=40, D=256) against 8 bytes of input and 4*D bytes of output; the
// folded weights (2 * L^2 * D * 4 bytes = 3.3 MB at L=40) stay in L2 for
// all blocks.  f32 mode: true f32 FMAs (the first SIREN activation,
// sin(30 h), multiplies any error in h by 30).  bf16 mode: the matmul
// operands round to bf16, the sums stay f32.
//
// Design: `sh_synth::first_layer` (sh_synthesis.cuh), one block per 64
// queries, 32*NC output columns and a run of the L recurrence rows.  A
// column slice would recompute its queries' synthesis, so NC is the widest
// (<= 8) that divides D/32.  The rows k = 0..L-1 split over KS blocks
// instead, each synthesizing only its own slabs: runs of at most 8 rows,
// more runs when the query blocks do not fill the card (B=512, the
// training micro-batch, has 8 query blocks for 132 SMs: KS = 20).  The KS
// partial sums go to a [KS, B, D] workspace and a second kernel adds them
// in a fixed order, so the result does not depend on the schedule.
// `sh_times_plan` chooses NC and KS; `sh_times_launch` runs a given plan.

#include "sh_synthesis.cuh"

namespace {

using namespace sh_synth;

constexpr int BLOCKS_PER_SM = 2;  // __launch_bounds__ below: 2 blocks of 256 threads

// out (or the split's slice of the workspace) = the block's part of basis @ W
template <int NC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
sh_times_kernel(const float* __restrict__ lonlat, const float* __restrict__ ftabT,
                const float* __restrict__ wc, const float* __restrict__ ws,
                float* __restrict__ out, int B, int L, int D, int kper, int bf16_ops) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int q0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * 32 * NC;
  const int k0 = blockIdx.z * kper, k1 = min(L, k0 + kper);
  float* dst = out + (size_t)blockIdx.z * B * D;

  float* wsm = smem + first_layer_floats(L);  // [WROWS][32*NC] staged weight rows
  float acc[8][NC];
  first_layer<NC>(acc, lonlat, ftabT, wc + col0, ws + col0, D, B, L, k0, k1, q0,
                  bf16_ops != 0, smem, wsm, tid, ty, tx);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + ty * 8 + i;
    if (q < B) {
#pragma unroll
      for (int j = 0; j < NC; ++j) dst[(size_t)q * D + col0 + tx + 32 * j] = acc[i][j];
    }
  }
}

// out[i] = sum over s = 0..ks-1, in that order, of work[s][i]; n4 float4s
__global__ void sh_times_reduce(const float4* __restrict__ work, float4* __restrict__ out,
                                size_t n4, int ks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = work[i];
    for (int z = 1; z < ks; ++z) {
      const float4 v = work[(size_t)z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

template <int NC>
int launch(const float* lonlat, const float* ftabT, const float* wc, const float* ws,
           float* dst, int B, int L, int D, int ks, int bf16_ops, cudaStream_t stream) {
  const size_t smem = (size_t)(first_layer_floats(L) + WROWS * 32 * NC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sh_times_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int kper = (L + ks - 1) / ks;
  const dim3 grid((B + BM - 1) / BM, D / (32 * NC), ks);
  sh_times_kernel<NC><<<grid, THREADS, smem, stream>>>(lonlat, ftabT, wc, ws, dst, B, L, D,
                                                       kper, bf16_ops);
  return (int)cudaGetLastError();
}

bool valid_shape(int L, int D) { return L >= 2 && L <= 64 && D > 0 && D % 32 == 0 && D <= 512; }

}  // namespace

// The plan for a [B, 2] x [L*L, D] call: plan[0] = NC (columns / 32 a
// block), plan[1] = KS (blocks over the L recurrence rows, each a run of
// ceil(L / KS) rows; KS > 1 needs a KS * B * D float workspace).
extern "C" int sh_times_plan(int B, int L, int D, void* plan) {
  if (B < 0 || !valid_shape(L, D)) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int slices32 = D / 32, qblocks = (B + BM - 1) / BM;
  int nc = 8;
  while (slices32 % nc) --nc;
  const int blocks = qblocks * (slices32 / nc);
  // runs of at most 8 rows, and enough runs to fill the card's resident
  // slots (chip_smoke.py times this plan beside others on the card)
  int ks = (L + 7) / 8;
  const int slots = BLOCKS_PER_SM * sms;
  if (blocks > 0 && blocks * ks < slots) ks = (slots + blocks - 1) / blocks;
  ks = min(ks, L);
  const int kper = (L + ks - 1) / ks;
  ks = (L + kper - 1) / kper;  // no empty run
  int* p = static_cast<int*>(plan);
  p[0] = nc;
  p[1] = ks;
  return 0;
}

// lonlat [B,2] f32; ftabT [L*L, 2L]; wc, ws [L*L, D] folded weights; out
// [B, D] f32; work [ks, B, D] f32 when ks > 1 (else unused).  All f32,
// contiguous.  2 <= L <= 64; D a multiple of 32, at most 512; nc in 1..8
// dividing D/32; ks in 1..L with no empty run of rows.
extern "C" int sh_times_launch(const void* lonlat, const void* ftabT, const void* wc,
                               const void* ws, void* out, void* work, int B, int L, int D,
                               int nc, int ks, int bf16_ops, void* stream) {
  if (B <= 0) return 0;
  if (!valid_shape(L, D) || nc < 1 || nc > 8 || (D / 32) % nc || ks < 1 || ks > L ||
      (ks - 1) * ((L + ks - 1) / ks) >= L || (ks > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* dst = static_cast<float*>(ks > 1 ? work : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (nc) {
    case 8: rc = launch<8>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 7: rc = launch<7>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 6: rc = launch<6>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 5: rc = launch<5>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 4: rc = launch<4>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 3: rc = launch<3>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    case 2: rc = launch<2>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s); break;
    default: rc = launch<1>(f(lonlat), f(ftabT), f(wc), f(ws), dst, B, L, D, ks, bf16_ops, s);
  }
  if (rc != 0 || ks == 1) return rc;
  const size_t n4 = (size_t)B * D / 4;
  const int blocks = (int)min((n4 + 255) / 256, (size_t)4096);
  sh_times_reduce<<<blocks, 256, 0, s>>>(static_cast<const float4*>(work),
                                         static_cast<float4*>(out), n4, ks);
  return (int)cudaGetLastError();
}

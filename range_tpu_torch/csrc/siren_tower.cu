// The whole SatCLIP location tower for a block of queries, in one kernel.
//
// Replaces: range_tpu/ops/sh.py, `kern` inside `_siren_tower_impl`
// (siren_tower_pallas): SH Fourier synthesis of the normalized-Legendre
// block, the cos/sin(m phi) tiles, the two folded basis@W0 matmuls,
// sin(w0_initial * (h + b0)), every hidden layer sin(w0 * (x @ W + b)), and
// the output layer.
//
// What bounds it on an H100: arithmetic.  Per query it does
// L^2 * 2L (synthesis) + 2 * L^2 * H (folded first layer) + n_deep * H^2 +
// H * D multiply-adds (~1.1 M at L=40, H=D=256) against 8 bytes of input
// and 4*D bytes of output; the weights (2 * L^2 * H * 4 bytes = 3.3 MB at
// L=40) stay in L2 for all blocks.  The first activation is sin(30 * h),
// which multiplies any error in h by 30, so the f32 mode uses true f32
// FMAs (no TF32, no bf16); the bf16 mode rounds only the matmul operands to
// bf16 (round to nearest even) and still accumulates in f32, as the TPU
// kernel's preferred_element_type=f32 does.
//
// Design: the first layer is `sh_synth::first_layer` (sh_synthesis.cuh,
// shared with the SH-times kernel): one L-row slab of P at a time, h [64, H]
// in registers (8 queries x H/32 columns per thread).  The hidden and output
// layers then stream their [H, H] weights through the same staging buffer,
// with the activations kept transposed in shared memory.  Shared memory is
// ~106 KB at L=40, H=256, so two blocks share an SM.

#include "sh_synthesis.cuh"

namespace {

using namespace sh_synth;

constexpr int LDX = BM + 4;     // row stride of the transposed activations (bank spread)

template <int NC>
__global__ void __launch_bounds__(THREADS, 2)
siren_tower_kernel(const float* __restrict__ lonlat, const float* __restrict__ ftabT,
                   const float* __restrict__ wc, const float* __restrict__ ws,
                   const float* __restrict__ bpack, const float* __restrict__ deep_w,
                   const float* __restrict__ last_w, float* __restrict__ out, int B, int L,
                   int n_deep, float w0_initial, float w0, int bf16_ops) {
  constexpr int H = 32 * NC;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int q0 = blockIdx.x * BM;
  const bool rb = bf16_ops != 0;

  float* wsm = smem + max(first_layer_floats(L), H * LDX);  // [WROWS][H] staged weight rows
  float acc[8][NC];
  first_layer<NC>(acc, lonlat, ftabT, wc, ws, H, B, L, 0, L, q0, rb, smem, wsm, tid, ty, tx);

  // phase 2: activations x^T [H][LDX] in shared memory (phase-1 region is dead)
  float* xt = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = tx + 32 * j;
      xt[n * LDX + ty * 8 + i] = op_round(sinf(w0_initial * (acc[i][j] + bpack[n])), rb);
    }

  for (int l = 0; l <= n_deep; ++l) {
    const float* W = (l < n_deep) ? deep_w + (size_t)l * H * H : last_w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    stage_and_fma<NC>(acc, W, H, H, xt, LDX, wsm, rb, tid, ty, tx);
    const float* bias = bpack + (size_t)(l + 1) * H;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = ty * 8 + i, q = q0 + b;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = tx + 32 * j;
        const float h = acc[i][j] + bias[n];
        if (l < n_deep)
          xt[n * LDX + b] = op_round(sinf(w0 * h), rb);
        else if (q < B)
          out[(size_t)q * H + n] = h;
      }
    }
  }
}

template <int NC>
int launch(const float* lonlat, const float* ftabT, const float* wc, const float* ws,
           const float* bpack, const float* deep_w, const float* last_w, float* out, int B,
           int L, int n_deep, float w0_initial, float w0, int bf16_ops, cudaStream_t stream) {
  constexpr int H = 32 * NC;
  const size_t smem = (size_t)(max(first_layer_floats(L), H * LDX) + WROWS * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      siren_tower_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM);
  siren_tower_kernel<NC><<<grid, THREADS, smem, stream>>>(
      lonlat, ftabT, wc, ws, bpack, deep_w, last_w, out, B, L, n_deep, w0_initial, w0,
      bf16_ops);
  return (int)cudaGetLastError();
}

}  // namespace

// lonlat [B,2] f32; ftabT [L*L, 2L]; wc, ws [L*L, H] folded first-layer
// weights; bpack [n_deep+2, H] biases; deep_w [n_deep, H, H] ([in, out]);
// last_w [H, H]; out [B, H] f32.  All f32, contiguous.  H is 128 or 256.
extern "C" int siren_tower_launch(const void* lonlat, const void* ftabT, const void* wc,
                                  const void* ws, const void* bpack, const void* deep_w,
                                  const void* last_w, void* out, int B, int L, int H,
                                  int n_deep, float w0_initial, float w0, int bf16_ops,
                                  void* stream) {
  if (B <= 0) return 0;
  if (L < 2 || L > 64 || n_deep < 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 256)
    return launch<8>(f(lonlat), f(ftabT), f(wc), f(ws), f(bpack), f(deep_w), f(last_w),
                     static_cast<float*>(out), B, L, n_deep, w0_initial, w0, bf16_ops, s);
  if (H == 128)
    return launch<4>(f(lonlat), f(ftabT), f(wc), f(ws), f(bpack), f(deep_w), f(last_w),
                     static_cast<float*>(out), B, L, n_deep, w0_initial, w0, bf16_ops, s);
  return (int)cudaErrorInvalidValue;
}

// Dense dual-softmax retrieval at f32 logits (the `exact` tier) for Hopper
// (sm_90a): the logits as three TF32 products a term on the tensor cores,
// a fresh fragment a 32-deep chunk (tf32_sm90.cuh), the value products bf16
// wgmma.
//
// Replaces, for f32 packed operands: range_tpu/ops/retrieval_pallas.py:123
// `_fused_kernel` (reached via retrieve_fused <- retrieve_pallas(tier=
// "exact") <- load_model("RANGE+" | "RANGE", db_path=..., tier="exact")),
// which the TPU takes at Precision.HIGHEST (:19-25).  Per (query, bank row),
// in order: the semantic logits over [0, sem_d) and the geo logits over
// the 16 columns from sem_d (3 real at `exact`), plus the row mask; p =
// exp2(min(l, 86)) for each family; the sums d_s, d_g of the unrounded p;
// acc_f += bf16(p_f) V in f32; at the end beta acc_s / max(d_s, 1e-30) +
// (1 - beta) acc_g / max(d_g, 1e-30).  These are the TPU kernel's rounding
// points.
//
// Layout.  A block owns 64 queries, a 256-column slice of the values and
// one segment of the bank's rows, walked in 64-row tiles.  Two consumer
// warpgroups share each tile: warpgroup w computes both families' logits
// of the tile's rows [32 w, 32 w + 32) (m64n32k8; A the block's resident
// f32 query rows split as read, past RES chunks and for the geo chunk read
// from device memory; B the keys' split image, made once a bank:
// ops/retrieval_fused.py `_tf32_keys`), writes bf16 p into the tile's two
// shared p boxes (one a family, double-buffered by the tile's parity), and
// after a barrier of the two runs its 128 value columns' products of both
// families over the whole tile (m64n128k16, A the p box, B the value tile).
// Why not p from the logit registers, as csrc/fused_retrieval_sm90.cu's
// flat form does: a warpgroup would then hold both families' accumulators
// of a 256-column slice (128 registers) beside a TF32 x3 chunk's fragments
// and split A registers, past the 168 ptxas allots a thread of a 384-thread
// block; with a 128-column
// slice each the TF32 x3 logits, which cost three times the bf16 ones,
// would be computed twice as often.  Here each tile's logits are computed
// once per 256 value columns, split between the two warpgroups.
// A producer warpgroup's first lane streams the keys' chunks by bulk
// copies (a 3-stage ring of [hi | lo][64 rows][32] chunks, the tile's sem
// chunks and one geo chunk) and each tile's values and mask by TMA (two
// stages), through full / empty mbarriers.
//
// Segments.  The value products add each k16 step into the running f32
// sum with truncation, so one chain over a 100k-row bank drifts: the rows
// are cut into n_seg segments of seg_rows (at most 3,200 rows: with the
// TF32 x3 logits' own error, 12,800-row chains put RANGE past the dense
// bars on the H100; and enough segments to give the card's SMs a block
// each), one block each along grid z, whose unnormalized partials [acc_s |
// acc_g | d_s | d_g] segment_reduce adds in segment order and blends
// (ops/retrieval_fused.py `_tf32_plan`).
//
// What bounds it on an H100: the logits' three TF32 products a term (495
// TFLOP/s), computed once per 256 value columns, and the value products
// (989 TFLOP/s bf16).
//
// A wait on a barrier that never completes traps after ~10 s.

#include "tf32_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;              // queries of a block
constexpr int BN = 64;              // bank rows of a tile
constexpr int DVS = 256;            // value columns of a block (128 a warpgroup)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
constexpr int KST = 3;              // stages of the key ring
constexpr int RES = 8;              // 32-column chunks of the resident query rows
constexpr int KCMAX = 48;           // sem chunks, at most (1,536 columns)
constexpr int GEO_D = 16;           // geo columns: two k8 steps of one chunk
constexpr uint32_t KCHUNK = 2 * BN * 128;         // [hi | lo][64 rows][32] f32
constexpr uint32_t VBOX = BN * 128;               // [64 rows][64] bf16
constexpr uint32_t VSTAGE = 4 * VBOX + 1024;      // four boxes, then the tile's mask
constexpr uint32_t PBOX = BM * 128;               // bf16 p of a family: [64 queries][64 rows]
constexpr float CLAMP2 = 86.0f;

struct Layout {
  int SQ;
  uint32_t k0, v0, p0, dx, bars, total;
};

__host__ __device__ inline Layout layout(int KC) {
  Layout l;
  l.SQ = 32 * (KC < RES ? KC : RES) + 8;
  l.k0 = round_up(BM * l.SQ * 4, 1024);
  l.v0 = l.k0 + KST * KCHUNK;
  l.p0 = l.v0 + 2 * VSTAGE;
  l.dx = l.p0 + 4 * PBOX;     // [2 buffers][sem | geo] p boxes
  l.bars = l.dx + 2 * BM * 2 * 4;  // each warpgroup's d_s, d_g of the 64 queries
  l.total = l.bars + 8 * (2 * KST + 4) + 1024;  // + slack to align the base
  return l;
}

struct Params {
  const float* q;     // [B, cat_d] f32
  const float* kimg;  // [tiles][KC + 1][hi | lo][64][32]: the sem chunks, then the geo one
  float* out;         // one segment: [B, Dv]; more: [n_seg, B, 2 Dv + 2] partials
  int B, N, cat_d, sem_d, Dv, KC, seg_rows, n_seg;
  float beta;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Issue the chunk's k8 steps (KS of 4) into the fresh fragment d, B at
// `tile` (hi) and `tile + lo_off`: every step's cross terms lo hi + hi lo
// first, then the hi hi products, so the accumulator's truncation acts on
// the small cross sums and on only KS additions of the large ones.
template <int KS>
__device__ __forceinline__ void issue_n32(float (&d)[16], const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4], uint32_t tile,
                                          uint32_t lo_off) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    tf32::wgmma_tf32_rs_n32(d, al[s], desc_k128(tile + 32 * s), s > 0 ? 1 : 0);
    tf32::wgmma_tf32_rs_n32(d, ah[s], desc_k128(tile + lo_off + 32 * s), 1);
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) tf32::wgmma_tf32_rs_n32(d, ah[s], desc_k128(tile + 32 * s), 1);
}

__device__ __forceinline__ void consume(const Params& p, const Layout& lay, uint8_t* smem,
                                        uint32_t base, int tiles, int n_rows) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, r0 = 16 * warp + g;
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * KST;
  const uint32_t vfull = kempty + 8 * KST, vempty = vfull + 16;
  float* qs = reinterpret_cast<float*>(smem);
  {
    // the query rows' first RES sem chunks, zero past sem_d and past B
    const int cols = 32 * (p.KC < RES ? p.KC : RES);
    for (int i = threadIdx.x; i < BM * cols; i += CONSUMERS) {
      const int r = i / cols, c = i % cols;
      qs[r * lay.SQ + c] =
          q0 + r < p.B && c < p.sem_d ? p.q[(size_t)(q0 + r) * p.cat_d + c] : 0.f;
    }
  }
  consumers_sync();
  const float* qrow = qs + r0 * lay.SQ + 2 * t;
  // rows past B read as row B - 1 (their outputs are not written)
  const int ra = min(q0 + r0, p.B - 1), rb = min(q0 + r0 + 8, p.B - 1);
  const float* qa = p.q + (size_t)ra * p.cat_d + 2 * t;
  const size_t ld8 = (size_t)(rb - ra) * p.cat_d;
  float acc_s[64], acc_g[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_s[i] = acc_g[i] = 0.f;
  float ds[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
  int ks = 0;
  uint32_t kph = 0;
  for (int it = 0; it < tiles; ++it) {
    // ---- this warpgroup's 32 rows of the tile: both families' logits
    float ls[16], lg[16];
    {
      uint32_t ah[4][4], al[4][4];
#pragma unroll 1
      for (int c = 0; c <= p.KC; ++c) {
        float lf[16];
        const bool geo = c == p.KC;
        if (!geo && c < RES)
          tf32::load_frags(qrow, lay.SQ, c, ah, al);
        else
          tf32::global_frags(qa + (geo ? p.sem_d : 32 * c), ld8,
                             geo ? GEO_D - 2 * t : p.sem_d - 32 * c - 2 * t, ah, al);
        mbar_wait(kfull + 8 * ks, kph);
        wgmma_fence();
        const uint32_t tile = base + lay.k0 + ks * KCHUNK + wg * 32 * 128;
        if (geo)
          issue_n32<GEO_D / 8>(lf, ah, al, tile, BN * 128);
        else
          issue_n32<4>(lf, ah, al, tile, BN * 128);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(lf);
        __syncwarp();
        if (lane == 0) mbar_arrive(kempty + 8 * ks);
        tf32::next_stage(ks, kph, KST);
        if (geo) {
#pragma unroll
          for (int j = 0; j < 16; ++j) lg[j] = lf[j];
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) ls[j] = c ? ls[j] + lf[j] : lf[j];
        }
      }
    }
    // ---- p of both families into the tile's p boxes (element 4j + 2h + e:
    // query row r0 + 8h, tile row 32 wg + 8j + 2t + e), 0 past the segment
    const int vs = it & 1;
    mbar_wait(vfull + 8 * vs, (it >> 1) & 1);
    const float* mk =
        reinterpret_cast<const float*>(smem + lay.v0 + vs * VSTAGE + 4 * VBOX) + 32 * wg;
    const uint32_t pb = lay.p0 + vs * 2 * PBOX;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ps[2], pg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const bool ok = it * BN + 32 * wg + c < n_rows;
          const float m = mk[c];
          ps[e] = ok ? exp2f(fminf(ls[4 * j + 2 * h + e] + m, CLAMP2)) : 0.f;
          pg[e] = ok ? exp2f(fminf(lg[4 * j + 2 * h + e] + m, CLAMP2)) : 0.f;
          ds[h] += ps[e];
          dg[h] += pg[e];
        }
        const int r = r0 + 8 * h;
        const uint32_t off = r * 128 + (((4 * wg + j) ^ (r & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(smem + pb + off) = pack_bf16(ps[0], ps[1]);
        *reinterpret_cast<uint32_t*>(smem + pb + PBOX + off) = pack_bf16(pg[0], pg[1]);
      }
    // visible to the tensor cores (the async proxy), then to the other warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    // ---- acc_f += bf16(p_f) [64 x 64] @ V [64 x this warpgroup's 128 columns]
    const uint32_t v = base + lay.v0 + vs * VSTAGE + wg * 2 * VBOX;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss_n128_t(acc_s, desc_k128(base + pb + 32 * k), desc_v(v + 2048 * k, BN), 1);
      wgmma_ss_n128_t(acc_g, desc_k128(base + pb + PBOX + 32 * k), desc_v(v + 2048 * k, BN), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_s);
    fence_regs(acc_g);
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty + 8 * vs);
  }

  // ---- d over each quad, then the two warpgroups' halves (warpgroup 0's + 1's)
  float* dx = reinterpret_cast<float*>(smem + lay.dx);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ds[h] += __shfl_xor_sync(0xffffffffu, ds[h], 1);
    ds[h] += __shfl_xor_sync(0xffffffffu, ds[h], 2);
    dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], 1);
    dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], 2);
    if (t == 0) {
      dx[(wg * BM + r0 + 8 * h) * 2] = ds[h];
      dx[(wg * BM + r0 + 8 * h) * 2 + 1] = dg[h];
    }
  }
  consumers_sync();
  const int c0 = blockIdx.y * DVS + 128 * wg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h, q = q0 + r;
    if (q >= p.B) continue;
    const float sd = dx[r * 2] + dx[(BM + r) * 2], gd = dx[r * 2 + 1] + dx[(BM + r) * 2 + 1];
    if (p.n_seg > 1) {
      const size_t ld = 2 * (size_t)p.Dv + 2;
      float* row = p.out + ((size_t)blockIdx.z * p.B + q) * ld;
      if (blockIdx.y == 0 && wg == 0 && t == 0) {
        row[2 * p.Dv] = sd;
        row[2 * p.Dv + 1] = gd;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c >= p.Dv) continue;
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc_s[4 * j + 2 * h], acc_s[4 * j + 2 * h + 1]);
        *reinterpret_cast<float2*>(row + p.Dv + c) =
            make_float2(acc_g[4 * j + 2 * h], acc_g[4 * j + 2 * h + 1]);
      }
    } else {
      const float ids = fmaxf(sd, 1e-30f), idg = fmaxf(gd, 1e-30f), beta = p.beta;
      float* row = p.out + (size_t)q * p.Dv;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c >= p.Dv) continue;
        *reinterpret_cast<float2*>(row + c) = make_float2(
            beta * (acc_s[4 * j + 2 * h] / ids) + (1.0f - beta) * (acc_g[4 * j + 2 * h] / idg),
            beta * (acc_s[4 * j + 2 * h + 1] / ids) +
                (1.0f - beta) * (acc_g[4 * j + 2 * h + 1] / idg));
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_tf32_kernel(const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tm,
                      const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const Layout lay = layout(p.KC);
  const uint32_t kfull = base + lay.bars, kempty = kfull + 8 * KST;
  const uint32_t vfull = kempty + 8 * KST, vempty = vfull + 16;
  const int n_begin = blockIdx.z * p.seg_rows;
  const int n_rows = min(p.N - n_begin, p.seg_rows);  // > 0: the plan has no empty segment
  const int tiles = (n_rows + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KST; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: per tile its key chunks, then its values and mask
    const int c0 = blockIdx.y * DVS;
    const int vboxes = min(4, (p.Dv - c0 + 63) / 64);  // boxes inside Dv
    const int t0 = n_begin / BN;
    int ks = 0;
    uint32_t kph = 0;
    for (int it = 0; it < tiles; ++it) {
      for (int c = 0; c <= p.KC; ++c) {
        mbar_wait(kempty + 8 * ks, kph ^ 1);
        mbar_expect_tx(kfull + 8 * ks, KCHUNK);
        bulk_g2s(base + lay.k0 + ks * KCHUNK,
                 p.kimg + ((size_t)(t0 + it) * (p.KC + 1) + c) * (KCHUNK / 4), KCHUNK,
                 kfull + 8 * ks);
        tf32::next_stage(ks, kph, KST);
      }
      const int s = it & 1, n0 = n_begin + it * BN;
      mbar_wait(vempty + 8 * s, ((it >> 1) & 1) ^ 1);
      const uint32_t st = base + lay.v0 + s * VSTAGE, full = vfull + 8 * s;
      mbar_expect_tx(full, vboxes * VBOX + BN * 4);
      for (int j = 0; j < vboxes; ++j) tma_2d(st + j * VBOX, &tv, c0 + 64 * j, n0, full);
      tma_1d(st + 4 * VBOX, &tm, n0, full);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  consume(p, lay, smem, base, tiles, n_rows);
}

// The segments' partials [n_seg, B, 2 Dv + 2] added in segment order, then
// each family divided by its sum and blended.
__global__ void segment_reduce(const float* __restrict__ part, float* __restrict__ out, int B,
                               int Dv, int n_seg, float beta) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * Dv) return;
  const int q = (int)(i / Dv), c = (int)(i % Dv);
  const size_t ld = 2 * (size_t)Dv + 2, plane = (size_t)B * ld;
  const float* row = part + (size_t)q * ld;
  float as = 0.f, ag = 0.f, ds = 0.f, dg = 0.f;
  for (int s = 0; s < n_seg; ++s, row += plane) {
    as += row[c];
    ag += row[Dv + c];
    ds += row[2 * Dv];
    dg += row[2 * Dv + 1];
  }
  out[i] = beta * (as / fmaxf(ds, 1e-30f)) + (1.0f - beta) * (ag / fmaxf(dg, 1e-30f));
}

}  // namespace

// Shared memory (bytes) of a block at KC sem chunks; -1 for what is not taken.
extern "C" int fused_tf32_sm90_smem(int KC) {
  if (KC < 1 || KC > KCMAX) return -1;
  return (int)layout(KC).total;
}

// q_cat [B, cat_d] f32 (pack_queries at `exact`: sem in [0, sem_d), the geo
// block's 16 columns from sem_d); kimg the keys' split image (`_tf32_keys`:
// [ceil(N / 64)][KC + 1][hi | lo][64][32], KC = ceil(sem_d / 32)); values
// [N, Dv] bf16; mask_neg [N] f32; out [B, Dv] f32; work [n_seg, B, 2 Dv +
// 2] f32 where n_seg > 1.  ints: B, N, cat_d, sem_d, Dv, KC, seg_rows, n_seg
// (n_seg = ceil(N / seg_rows), seg_rows a multiple of 64).  Returns a CUDA
// error code (cudaErrorInvalidValue for what it does not take, with
// nothing launched).
extern "C" int fused_tf32_sm90_launch(const void* q_cat, const void* kimg, const void* values,
                                      const void* mask_neg, void* out, void* work, const int* a,
                                      float beta, void* stream) {
  Params p{};
  p.q = static_cast<const float*>(q_cat);
  p.kimg = static_cast<const float*>(kimg);
  p.B = a[0], p.N = a[1], p.cat_d = a[2], p.sem_d = a[3], p.Dv = a[4], p.KC = a[5];
  p.seg_rows = a[6], p.n_seg = a[7];
  p.beta = beta;
  if (p.B < 0 || p.N < 0 || p.Dv <= 0 || p.Dv % 8 || p.sem_d <= 0 ||
      p.KC != (p.sem_d + 31) / 32 || p.KC > KCMAX || p.sem_d + GEO_D > p.cat_d ||
      p.seg_rows <= 0 || p.seg_rows % BN ||
      p.n_seg != (p.N > 0 ? (p.N + p.seg_rows - 1) / p.seg_rows : 1) ||
      (p.n_seg > 1 && work == nullptr) || !aligned16(kimg) || !aligned16(values) ||
      !aligned16(mask_neg) || !aligned16(out) || !aligned16(work))
    return (int)cudaErrorInvalidValue;
  if (p.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.N == 0) {  // no rows: every sum is 0, and so is the blend
    cudaMemsetAsync(out, 0, (size_t)p.B * p.Dv * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  CUtensorMap tv, tm;
  if (!map_2d(&tv, values, p.Dv, p.N, p.Dv, 64, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_1d(&tm, mask_neg, p.N, BN))
    return (int)cudaErrorInvalidValue;
  p.out = static_cast<float*>(p.n_seg > 1 ? work : out);
  const Layout lay = layout(p.KC);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  fused_tf32_kernel<<<dim3((p.B + BM - 1) / BM, (p.Dv + DVS - 1) / DVS, p.n_seg), THREADS,
                      lay.total, s>>>(tv, tm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_seg == 1) return (int)err;
  const size_t n = (size_t)p.B * p.Dv;
  segment_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(out), p.B, p.Dv, p.n_seg, beta);
  return (int)cudaGetLastError();
}

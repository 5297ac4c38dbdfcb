// Fused dense dual-softmax retrieval in one pass over the bank, and the
// three variants of it that serve sharded, pruned and hybrid retrieval.
//
// Replaces: range_tpu/ops/retrieval_pallas.py, `_fused_kernel` (reached via
// retrieve_fused <- retrieve_pallas) and, through its int8 entry point,
// `_fused_kernel_i8` (retrieve_fused_i8 <- retrieve_pallas on a bank with
// int8 values, bank.quantize_values); `_fused_parts_kernel` (:314,
// fused_parts_launch), `_family_pruned_kernel` (:441,
// family_pruned_launch) and `_hybrid_kernel` (:660, fused_hybrid_launch).  Per bank tile: semantic and geo
// logits against the packed keys plus the row mask, p = exp2(min(l, 86))
// (log2(e) and the temperatures are folded into the packed queries), the
// unnormalized sums d_s, d_g, and acc_s += p_s V, acc_g += p_g V with p cast
// to the value dtype (bf16) first; at the end each family is divided by its
// own sum (clamped at 1e-30) and the two are blended with beta.
//
// What bounds it on an H100: the exponentials (2 per query x bank row) and
// the two value products (2 x 2 x Dv flops per query x bank row, 4x the
// logit work at Dv=1024).  The design keeps every per-(query, row) quantity
// on chip, runs both logit matmuls (bf16 tiers) and both value products on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), takes the
// exponentials straight from the logit fragments in registers, and streams
// the next key/value tile with cp.async while the current one computes.
// The 'exact' tier computes its logits with true f32 FMAs on the CUDA cores
// (no TF32), as the TPU kernel's HIGHEST precision.
//
// Accumulator choice: the TPU kernel carries [bm=256, 2*Dv] f32 (2 MB) in
// VMEM across its sequential grid axis.  Here the sequential axis becomes a
// loop inside the block, and the accumulator must live in registers: a
// block owns BM=64 queries and one DVS=256-column slice of Dv (so
// 2 x 64 x 256 f32 = 128 registers per thread), and walks all bank tiles
// of BN=32 rows.  Splitting Dv (and recomputing the logits once per slice)
// was chosen over a smaller BM: BM=64 keeps the tensor-core tiles full
// (4 m16 tiles per warp share each V fragment), while the logits are only
// (Dk + 16) / (2 Dv) of the value work per slice, so recomputing them 4x at
// Dv=1024 costs ~0.5x of the value products but keeps 4x more blocks in
// flight.  No carry between blocks, no atomics.  Ragged bank and query
// edges are masked in the kernel (zero-filled tiles, p = 0 past N).
//
// int8 values (the I8 variant): each row's codes v8 and scale s stand for
// v = s * v8, and sum_j p_j v_j = sum_j (p_j s_j) v8_j, so the scale folds
// into the probability before its bf16 cast (the sums d keep the unscaled
// p, as the TPU kernel).  The raw int8 tile streams in by cp.async, half the
// bytes of the bf16 tile, and is converted to bf16 once in shared memory
// (|v8| <= 127 is exact in bf16) while the logits of the same tile compute;
// the value products then run exactly as in the bf16 kernel.  The value
// stream is half the bf16 kernel's (plus 4 bytes of scale a row), which
// matters where the kernel is memory-bound (small batches); at B = 10,000
// the exponentials and the value products bound both variants alike.
//
// The tensor cores sum one tile into a zeroed fragment and the tile sums
// join the accumulator with IEEE f32 adds: accumulating all N rows through
// the tensor cores' accumulator (a chain of N/16 steps) drifted by ~2e-4
// relative at N=102,400, where this order stays within ~1e-5.

// The variants are template parameters of the one kernel body:
//   * the epilogue (PARTS): each family divided by its sum and blended, or
//     the raw partials [acc_s | acc_g | d_s | d_g | 0 ...] of one bank
//     shard, [B, 2 Dv + 128], that add up across shards (kernel 5; only
//     the block of value slice 0 writes the sums and the pad);
//   * the families (TWO): both logit groups, or one group of C columns
//     (kernel 6: the semantic block, or the geo block, of the packed
//     operands, whose row strides are passed apart);
//   * the tile walk (WALK): every BN-row sub-tile (kernels 2, 3, 5, 7), or
//     a plan's active-first tile lists (kernel 6).  The plan has its own
//     granularity (query tiles of bm rows, bank tiles of bn rows; bm % 16
//     == 0, bn % 32 == 0), so each m16 row group of a 64-query block
//     belongs to one plan tile: the block walks the merged lists of its
//     (at most 4) plan tiles, each bank tile once, as bn / 32 sub-tiles,
//     and a row group whose list lacks the tile gets p = 0 there.  The
//     lists are read from device memory (the TPU's scalar prefetch) and
//     no host sync happens.  Kernel 7 walks every sub-tile and reads its
//     geo flags [nB, T] the same way: the geo logits, exponentials and
//     value product of a sub-tile run only for the flagged row groups,
//     and not at all where no group of the block is flagged.
// Bounds: kernel 5 does kernel 2's work; kernel 6 scales with the kept
// tiles (and streams the values once per family); kernel 7 is the
// semantic half of kernel 2 plus its flagged geo tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;          // queries per block
constexpr int BN = 32;          // bank rows per tile
constexpr int DVS = 256;        // value columns per block
constexpr int THREADS = 256;    // 8 warps
constexpr int LDV = DVS + 8;    // bf16 row stride of the value tile
constexpr int LDV8 = DVS + 16;  // byte row stride of the raw int8 value tile
constexpr int LDP = BN + 8;     // bf16 row stride of the probability tiles
constexpr int PAD = 128;        // the partials' columns past 2 Dv
constexpr float CLAMP2 = 86.0f;
constexpr size_t MAX_SMEM = 232448;  // per block, sm_90

enum Walk { ALL = 0, LIST = 1, FLAGS = 2 };

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; fills zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on load: the B fragments (k-pairs of
// one column n) of two n8 tiles from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float prob(float logit, float mask, bool valid) {
  return valid ? exp2f(fminf(logit + mask, CLAMP2)) : 0.f;
}

struct Params {
  const void* q;         // [B, ldq] packed queries (bf16, or f32 for the exact tier)
  const void* k;         // [N, ldk] packed keys, the same type
  const void* v;         // [N, Dv] bf16 values, or int8 codes (I8)
  const float* scale;    // [N] int8 dequantization scales (I8)
  const float* mask;     // [N] additive logit mask (0 valid / -1e30 pad)
  const int* idx;        // LIST: [nB, T] active-first bank tiles per plan query tile
  const int* cnt;        // LIST: [nB] active tiles per plan query tile
  const int* flags;      // FLAGS: [nB, T] geo flags
  float* out;            // [B, Dv], or [B, 2 Dv + PAD] partials
  int B, N, ldq, ldk, sem_d, geo_d, Dv;
  float beta;
  int bm, bn;            // the plan's query and bank tiles (LIST, FLAGS)
  int stages;
};

struct Layout {
  size_t q, k, v, vc, p, mask, scale, dpart, total;
  int stages;
};

// Shared memory: the query block, `stages` key/value tiles (2 = the next
// tile streams in while this one computes; int8 tiles are raw codes, plus
// one bf16 tile they are converted into), the bf16 probability tiles of
// both families, the mask (and int8 scale) tiles and the per-row sums.
__host__ __device__ inline Layout layout(int U, bool f32, bool i8, int stages) {
  const size_t es = f32 ? 4 : 2, lds = U + (f32 ? 4 : 8);
  Layout l;
  l.stages = stages;
  l.q = 0;
  l.k = l.q + BM * lds * es;
  l.v = l.k + stages * BN * lds * es;
  l.vc = l.v + stages * BN * (i8 ? LDV8 : LDV * 2);
  l.p = l.vc + (i8 ? BN * LDV * 2 : 0);
  l.mask = l.p + 2 * BM * LDP * 2;
  l.scale = l.mask + stages * BN * 4;
  l.dpart = l.scale + (i8 ? stages * BN * 4 : 0);
  l.total = l.dpart + 2 * 2 * BM * 4;
  return l;
}

// The BN-row sub-tiles a block visits, in order.  ALL: every one.  LIST:
// the merged active lists of the block's four m16 row groups' plan tiles
// (the smallest next entry of any list, taken by every list that holds
// it), each plan tile as bn / BN sub-tiles; `act` marks the groups whose
// list holds the current tile.  Entries outside [0, T) end the walk.
template <bool IS_LIST>
struct TileWalk {
  int n0 = -1;        // first bank row of the current sub-tile; -1 when done
  unsigned act = 0xF;
  int sub = 0, subs = 1, n_tiles = 0;
  int pt[4], cnt[4], ptr[4];

  __device__ void start(const Params& p, int q0) {
    if (!IS_LIST) {
      n0 = p.N > 0 ? 0 : -1;
      return;
    }
    n_tiles = p.N / p.bn;
    subs = p.bn / BN;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int r = q0 + 16 * g;
      pt[g] = r / p.bm;
      cnt[g] = r < p.B ? min(max(p.cnt[pt[g]], 0), n_tiles) : 0;
      ptr[g] = 0;
    }
    pick(p);
  }

  __device__ void pick(const Params& p) {
    int best = 0x7fffffff;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (ptr[g] < cnt[g]) best = min(best, p.idx[(size_t)pt[g] * n_tiles + ptr[g]]);
    if (best < 0 || best >= n_tiles) {
      n0 = -1;
      return;
    }
    act = 0;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (ptr[g] < cnt[g] && p.idx[(size_t)pt[g] * n_tiles + ptr[g]] == best) {
        act |= 1u << g;
        ++ptr[g];
      }
    sub = 0;
    n0 = best * p.bn;
  }

  __device__ void next(const Params& p) {
    if (!IS_LIST) {
      n0 = n0 + BN < p.N ? n0 + BN : -1;
    } else if (++sub < subs) {
      n0 += BN;
    } else {
      pick(p);
    }
  }
};

// F32: packed operands f32 (exact tier, CUDA-core FMAs) or bf16 (fast/high
// tiers, tensor cores).  I8: int8 value codes with f32 per-row scales.
// PARTS: write the unnormalized partials instead of the blend.  TWO: both
// logit families (else one, of sem_d columns).  WALK: ALL, LIST or FLAGS.
template <bool F32, bool I8, bool PARTS, bool TWO, int WALK>
__global__ void __launch_bounds__(THREADS, 1) fused_retrieval_kernel(const Params p) {
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  using V = typename std::conditional<I8, int8_t, __nv_bfloat16>::type;
  constexpr int E = 16 / sizeof(T);             // elements per 16-byte copy
  constexpr int EV = 16 / sizeof(V);            // value elements per 16-byte copy
  constexpr int NF = TWO ? 2 : 1;               // logit families
  const T* q_cat = static_cast<const T*>(p.q);
  const T* k_cat = static_cast<const T*>(p.k);
  const V* values = static_cast<const V*>(p.v);
  const int B = p.B, N = p.N, Dv = p.Dv, sem_d = p.sem_d;
  const int U = sem_d + (TWO ? p.geo_d : 0);    // packed columns read
  const int lds = U + (F32 ? 4 : 8);            // 16-byte rows, spread banks
  const int ldv = I8 ? LDV8 : LDV;              // row stride of the streamed value tile
  const Layout lay = layout(U, F32, I8, p.stages);

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* qs = reinterpret_cast<T*>(base + lay.q);
  T* ks0 = reinterpret_cast<T*>(base + lay.k);
  V* vs0 = reinterpret_cast<V*>(base + lay.v);
  __nv_bfloat16* vconv = reinterpret_cast<__nv_bfloat16*>(base + lay.vc);  // I8 only
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(base + lay.p);
  __nv_bfloat16* pg = ps + BM * LDP;
  float* mask0 = reinterpret_cast<float*>(base + lay.mask);
  float* scale0 = reinterpret_cast<float*>(base + lay.scale);  // I8 only
  float* dpart = reinterpret_cast<float*>(base + lay.dpart);  // [family][part][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * DVS;
  // the m16 row group of this warp's logits (both tiers: rows 8w..8w+7 or
  // tile w >> 1), whose plan decides the warp's p for the current tile
  const int my_group = warp >> 1;

  // copies of the sub-tile at bank row n0 into buffer `buf` (rows past N
  // become zeros)
  auto issue = [&](int buf, int n0) {
    const int cpr = U / E;
    T* ks = ks0 + buf * BN * lds;
    for (int idx = tid; idx < BN * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * E;
      const bool ok = n0 + r < N;
      cp_async16(ks + r * lds + c, k_cat + (ok ? (size_t)(n0 + r) * p.ldk + c : 0), ok);
    }
    V* vs = vs0 + buf * BN * ldv;
    for (int idx = tid; idx < BN * (DVS / EV); idx += THREADS) {
      const int r = idx / (DVS / EV), c = (idx % (DVS / EV)) * EV;
      const bool ok = n0 + r < N && col0 + c < Dv;
      cp_async16(vs + r * ldv + c, values + (ok ? (size_t)(n0 + r) * Dv + col0 + c : 0), ok);
    }
    if (tid < BN) {
      const bool ok = n0 + tid < N;
      cp_async4(mask0 + buf * BN + tid, p.mask + (ok ? n0 + tid : 0), ok);
    } else if (I8 && tid < 2 * BN) {
      const int r = tid - BN;
      const bool ok = n0 + r < N;
      cp_async4(scale0 + buf * BN + r, p.scale + (ok ? n0 + r : 0), ok);
    }
    cp_async_commit();
  };

  // the query block, once (rows past B are zeros)
  for (int idx = tid; idx < BM * (U / E); idx += THREADS) {
    const int r = idx / (U / E), c = (idx % (U / E)) * E;
    const bool ok = q0 + r < B;
    cp_async16(qs + r * lds + c, q_cat + (ok ? (size_t)(q0 + r) * p.ldq + c : 0), ok);
  }
  cp_async_commit();
  TileWalk<WALK == LIST> walk;
  walk.start(p, q0);
  if (p.stages == 2 && walk.n0 >= 0) issue(0, walk.n0);

  float acc[NF][4][4][4];  // [family][m16 tile][n8 tile][fragment]
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][mt][nt][e] = 0.f;
  // this thread's share of its rows' exp sums: bf16 tiers own rows
  // mt*16+g and mt*16+g+8 ([family][half]); the exact tier rows 8w..8w+7
  float dsum_s[8], dsum_g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dsum_s[i] = dsum_g[i] = 0.f;

  for (int it = 0; walk.n0 >= 0; ++it) {
    const int n0 = walk.n0;
    const unsigned s_act = walk.act;  // groups whose (first) family takes this tile
    walk.next(p);                     // look ahead: the sub-tile to stream next
    unsigned g_act = 0xF;             // groups whose geo family takes it
    if constexpr (WALK == FLAGS) {
      const int n_tiles = N / p.bn, j = n0 / p.bn;
      g_act = 0;
#pragma unroll
      for (int gr = 0; gr < 4; ++gr) {
        const int r = q0 + 16 * gr;
        if (r < B && p.flags[(size_t)(r / p.bm) * n_tiles + j] > 0) g_act |= 1u << gr;
      }
    }
    const bool s_on = (s_act >> my_group) & 1u;
    const bool g_on = TWO && ((g_act >> my_group) & 1u);
    __syncthreads();  // the previous tile is fully consumed
    int buf = 0;
    if (p.stages == 2) {
      buf = it & 1;
      if (walk.n0 >= 0) {
        issue(buf ^ 1, walk.n0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      issue(0, n0);
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and the queries) visible to all threads
    const T* ks = ks0 + buf * BN * lds;
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(vs0 + buf * BN * ldv);
    const float* mask_s = mask0 + buf * BN;
    const float* scale_s = scale0 + buf * BN;
    if constexpr (I8) {
      // the raw codes -> the bf16 tile the value products read (exact); the
      // previous tile's products finished before this iteration's first sync
      const int8_t* v8 = reinterpret_cast<const int8_t*>(vs0) + buf * BN * LDV8;
      for (int idx = tid; idx < BN * (DVS / 16); idx += THREADS) {
        const int r = idx / (DVS / 16), c = (idx % (DVS / 16)) * 16;
        const int4 raw = *reinterpret_cast<const int4*>(v8 + r * LDV8 + c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        __align__(16) __nv_bfloat162 h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          h[i] = __floats2bfloat162_rn(static_cast<float>(b[2 * i]),
                                       static_cast<float>(b[2 * i + 1]));
        int4* dst = reinterpret_cast<int4*>(vconv + r * LDV + c);
        dst[0] = reinterpret_cast<const int4*>(h)[0];
        dst[1] = reinterpret_cast<const int4*>(h)[1];
      }
      vs = vconv;
    }

    // ---- logits and p = exp2(min(logit + mask, 86)) -> ps, pg (bf16);
    // p = 0 for the row groups this tile is not active for
    if constexpr (F32) {
      // thread: bank row n = lane, queries 8w..8w+7
      const int n = lane, r0 = warp * 8;
      float sl[8], gl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) sl[i] = gl[i] = 0.f;
      const float* krow = ks + n * lds;
      auto dot4 = [&](float (&a)[8], int kk) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + i) * lds + kk);
          a[i] = fmaf(qv.x, kv.x, a[i]);
          a[i] = fmaf(qv.y, kv.y, a[i]);
          a[i] = fmaf(qv.z, kv.z, a[i]);
          a[i] = fmaf(qv.w, kv.w, a[i]);
        }
      };
      if (s_on)
        for (int kk = 0; kk < sem_d; kk += 4) dot4(sl, kk);
      if (g_on)
        for (int kk = sem_d; kk < U; kk += 4) dot4(gl, kk);
      const bool valid = n0 + n < N;
      const float m = mask_s[n];
      const float sc = I8 ? scale_s[n] : 1.f;  // I8: the row's scale joins p
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p_s = prob(sl[i], m, valid && s_on);
        dsum_s[i] += p_s;
        ps[(r0 + i) * LDP + n] = __float2bfloat16_rn(I8 ? p_s * sc : p_s);
        if constexpr (TWO) {
          const float p_g = prob(gl[i], m, valid && g_on);
          dsum_g[i] += p_g;
          pg[(r0 + i) * LDP + n] = __float2bfloat16_rn(I8 ? p_g * sc : p_g);
        }
      }
    } else {
      // warp w: m16 tile (w >> 1), n8 tiles 2*(w & 1) and 2*(w & 1) + 1
      const int mt = warp >> 1, nt0 = (warp & 1) * 2;
      float cs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float cg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const __nv_bfloat16* qr0 = qs + (mt * 16 + g) * lds + 2 * t;
      const __nv_bfloat16* qr1 = qr0 + 8 * lds;
      const __nv_bfloat16* kb = ks + 2 * t;
      auto step = [&](float (&c)[2][4], int kk) {
        const uint32_t a[4] = {ld32(qr0 + kk), ld32(qr1 + kk), ld32(qr0 + kk + 8),
                               ld32(qr1 + kk + 8)};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* kr = kb + ((nt0 + i) * 8 + g) * lds + kk;
          mma_bf16(c[i], a, ld32(kr), ld32(kr + 8));
        }
      };
      if (s_on)
        for (int kk = 0; kk < sem_d; kk += 16) step(cs, kk);
      if (g_on)
        for (int kk = sem_d; kk < U; kk += 16) step(cg, kk);
      // fragment e of n8 tile i: row mt*16 + g + 8*(e >> 1), column
      // (nt0 + i)*8 + 2t + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        float t_s = 0.f, t_g = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = (nt0 + i) * 8 + 2 * t;
          const bool v0 = n0 + c < N, v1 = n0 + c + 1 < N;
          const float c0 = I8 ? scale_s[c] : 1.f, c1 = I8 ? scale_s[c + 1] : 1.f;
          const float s0 = prob(cs[i][2 * h], mask_s[c], v0 && s_on);
          const float s1 = prob(cs[i][2 * h + 1], mask_s[c + 1], v1 && s_on);
          t_s += s0 + s1;
          // I8: the rows' scales join p before its bf16 cast
          *reinterpret_cast<__nv_bfloat162*>(ps + r * LDP + c) =
              I8 ? __floats2bfloat162_rn(s0 * c0, s1 * c1) : __floats2bfloat162_rn(s0, s1);
          if constexpr (TWO) {
            const float g0 = prob(cg[i][2 * h], mask_s[c], v0 && g_on);
            const float g1 = prob(cg[i][2 * h + 1], mask_s[c + 1], v1 && g_on);
            t_g += g0 + g1;
            *reinterpret_cast<__nv_bfloat162*>(pg + r * LDP + c) =
                I8 ? __floats2bfloat162_rn(g0 * c0, g1 * c1) : __floats2bfloat162_rn(g0, g1);
          }
        }
        dsum_s[h] += t_s;
        dsum_g[h] += t_g;
      }
    }
    __syncthreads();  // ps, pg complete

    // ---- acc_f[64 x 32 cols of warp] += P_f[64 x BN] @ V[BN x 32 cols of warp]
    // (a family with no active row group in this tile is skipped)
    {
      static_assert(BN == 32, "two k16 steps per tile");
      uint32_t b[2][4][2];  // [k16 step][n8 tile][fragment]
#pragma unroll
      for (int kstep = 0; kstep < 2; ++kstep)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mat = lane >> 3, rr = lane & 7;
          const __nv_bfloat16* pv = vs + (kstep * 16 + rr + (mat & 1) * 8) * LDV + warp * 32 +
                                    h * 16 + (mat >> 1) * 8;
          ldmatrix_x4_trans(b[kstep][2 * h][0], b[kstep][2 * h][1], b[kstep][2 * h + 1][0],
                            b[kstep][2 * h + 1][1], pv);
        }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if ((f ? g_act : s_act) == 0) continue;
        const __nv_bfloat16* P = f ? pg : ps;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* r0p = P + (mt * 16 + g) * LDP + 2 * t;
          const __nv_bfloat16* r1p = r0p + 8 * LDP;
          const uint32_t a0[4] = {ld32(r0p), ld32(r1p), ld32(r0p + 8), ld32(r1p + 8)};
          const uint32_t a1[4] = {ld32(r0p + 16), ld32(r1p + 16), ld32(r0p + 24),
                                  ld32(r1p + 24)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(c, a0, b[0][nt][0], b[0][nt][1]);
            mma_bf16(c, a1, b[1][nt][0], b[1][nt][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][mt][nt][e] += c[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit (the query copy when no tile is walked)

  // ---- per-row exp sums into dpart[family][part][row]
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dsum_s[i] += __shfl_xor_sync(0xffffffffu, dsum_s[i], off);
        dsum_g[i] += __shfl_xor_sync(0xffffffffu, dsum_g[i], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
        dpart[r] = dsum_s[i];
        dpart[BM + r] = 0.f;
        dpart[2 * BM + r] = dsum_g[i];
        dpart[3 * BM + r] = 0.f;
      }
    }
  } else {
    // the 4 lanes of a row share g; the two warps of an m16 tile split its columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dsum_s[h] += __shfl_xor_sync(0xffffffffu, dsum_s[h], off);
        dsum_g[h] += __shfl_xor_sync(0xffffffffu, dsum_g[h], off);
      }
      if (t == 0) {
        const int r = (warp >> 1) * 16 + g + 8 * h, part = warp & 1;
        dpart[part * BM + r] = dsum_s[h];
        dpart[(2 + part) * BM + r] = dsum_g[h];
      }
    }
  }
  __syncthreads();

  // ---- epilogue: the partials, or each family over its sum (blended)
  const size_t ldo = PARTS ? 2 * (size_t)Dv + PAD : Dv;
  if constexpr (PARTS) {
    // the sums and the zero pad: [d_s | d_g | 0 x 126], by value slice 0
    if (blockIdx.y == 0) {
      for (int idx = tid; idx < BM * PAD; idx += THREADS) {
        const int r = idx / PAD, c = idx % PAD, q = q0 + r;
        if (q >= B) continue;
        const float d = c == 0 ? dpart[r] + dpart[BM + r]
                      : c == 1 ? dpart[2 * BM + r] + dpart[3 * BM + r] : 0.f;
        p.out[q * ldo + 2 * Dv + c] = d;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + half * 8, q = q0 + r;
      if (q >= B) continue;
      const float ds = fmaxf(dpart[r] + dpart[BM + r], 1e-30f);
      const float dg = fmaxf(dpart[2 * BM + r] + dpart[3 * BM + r], 1e-30f);
      float* orow = p.out + (size_t)q * ldo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = col0 + warp * 32 + nt * 8 + 2 * t;
        if (c >= Dv) continue;
        const int e = 2 * half;
        if constexpr (PARTS) {
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[0][mt][nt][e], acc[0][mt][nt][e + 1]);
          *reinterpret_cast<float2*>(orow + Dv + c) =
              make_float2(acc[NF - 1][mt][nt][e], acc[NF - 1][mt][nt][e + 1]);
        } else if constexpr (TWO) {
          const float o0 = p.beta * (acc[0][mt][nt][e] / ds) +
                           (1.0f - p.beta) * (acc[NF - 1][mt][nt][e] / dg);
          const float o1 = p.beta * (acc[0][mt][nt][e + 1] / ds) +
                           (1.0f - p.beta) * (acc[NF - 1][mt][nt][e + 1] / dg);
          *reinterpret_cast<float2*>(orow + c) = make_float2(o0, o1);
        } else {
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[0][mt][nt][e] / ds, acc[0][mt][nt][e + 1] / ds);
        }
      }
    }
  }
}

template <bool F32, bool I8, bool PARTS, bool TWO, int WALK>
int launch(Params p, cudaStream_t stream) {
  if (p.B <= 0 || p.Dv <= 0) return 0;
  const int U = p.sem_d + (TWO ? p.geo_d : 0);
  Layout lay = layout(U, F32, I8, 2);
  if (lay.total > MAX_SMEM) lay = layout(U, F32, I8, 1);  // e.g. the 'high' tier's wide rows
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  p.stages = lay.stages;
  auto kernel = fused_retrieval_kernel<F32, I8, PARTS, TWO, WALK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.B + BM - 1) / BM, (p.Dv + DVS - 1) / DVS);
  kernel<<<grid, THREADS, lay.total, stream>>>(p);
  return (int)cudaGetLastError();
}

// the f32 / int8 forms of one variant, chosen at run time
template <bool PARTS, bool TWO, int WALK>
int launch_any(const Params& p, bool f32, bool i8, cudaStream_t s) {
  if (f32)
    return i8 ? launch<true, true, PARTS, TWO, WALK>(p, s)
              : launch<true, false, PARTS, TWO, WALK>(p, s);
  return i8 ? launch<false, true, PARTS, TWO, WALK>(p, s)
            : launch<false, false, PARTS, TWO, WALK>(p, s);
}

// Shape rules of every variant: the logit groups whole MMA steps, rows of
// whole 16-byte copies.
bool bad_shape(const Params& p, bool f32, bool i8, int C) {
  const int es = f32 ? 4 : 2;
  return p.sem_d % 16 || p.geo_d % 16 || C > p.ldq || C > p.ldk || (p.ldq * es) % 16 ||
         (p.ldk * es) % 16 || p.Dv % (i8 ? 16 : 8) || p.N < 0;
}

Params dense_params(const void* q_cat, const void* k_cat, const void* values,
                    const void* scale, const void* mask_neg, void* out, int B, int N, int cat_d,
                    int sem_d, int geo_d, int Dv, float beta) {
  Params p{};
  p.q = q_cat;
  p.k = k_cat;
  p.v = values;
  p.scale = static_cast<const float*>(scale);
  p.mask = static_cast<const float*>(mask_neg);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.N = N;
  p.ldq = p.ldk = cat_d;
  p.sem_d = sem_d;
  p.geo_d = geo_d;
  p.Dv = Dv;
  p.beta = beta;
  return p;
}

}  // namespace

// q_cat [B, cat_d], k_cat [N, cat_d] (bf16, or f32 when f32_logits); the
// kernel reads columns [0, sem_d) as the semantic group and
// [sem_d, sem_d + geo_d) as the geo group.  values [N, Dv] bf16;
// mask_neg [N] f32; out [B, Dv] f32.  All contiguous and 16-byte aligned.
extern "C" int fused_retrieval_launch(const void* q_cat, const void* k_cat, const void* values,
                                      const void* mask_neg, void* out, int B, int N,
                                      int cat_d, int sem_d, int geo_d, int Dv, float beta,
                                      int f32_logits, void* stream) {
  const Params p = dense_params(q_cat, k_cat, values, nullptr, mask_neg, out, B, N, cat_d,
                                sem_d, geo_d, Dv, beta);
  if (bad_shape(p, f32_logits, false, sem_d + geo_d)) return (int)cudaErrorInvalidValue;
  return launch_any<false, true, ALL>(p, f32_logits, false, static_cast<cudaStream_t>(stream));
}

// The int8-value entry point: values [N, Dv] int8 codes (Dv % 16 == 0) and
// scale [N] f32, row r standing for values[r] * scale[r]; the rest as
// fused_retrieval_launch.
extern "C" int fused_retrieval_i8_launch(const void* q_cat, const void* k_cat,
                                         const void* values, const void* scale,
                                         const void* mask_neg, void* out, int B, int N,
                                         int cat_d, int sem_d, int geo_d, int Dv, float beta,
                                         int f32_logits, void* stream) {
  const Params p = dense_params(q_cat, k_cat, values, scale, mask_neg, out, B, N, cat_d,
                                sem_d, geo_d, Dv, beta);
  if (bad_shape(p, f32_logits, true, sem_d + geo_d)) return (int)cudaErrorInvalidValue;
  return launch_any<false, true, ALL>(p, f32_logits, true, static_cast<cudaStream_t>(stream));
}

// Kernel 5: the unnormalized partials of one bank shard, out [B, 2 Dv + 128]
// f32 = [acc_s | acc_g | d_s | d_g | 0 x 126].  Operands as
// fused_retrieval_launch; scale [N] f32 selects int8 values (NULL: bf16).
extern "C" int fused_parts_launch(const void* q_cat, const void* k_cat, const void* values,
                                  const void* scale, const void* mask_neg, void* out, int B,
                                  int N, int cat_d, int sem_d, int geo_d, int Dv,
                                  int f32_logits, void* stream) {
  const Params p = dense_params(q_cat, k_cat, values, scale, mask_neg, out, B, N, cat_d, sem_d,
                                geo_d, Dv, 1.0f);
  const bool i8 = scale != nullptr;
  if (bad_shape(p, f32_logits, i8, sem_d + geo_d)) return (int)cudaErrorInvalidValue;
  return launch_any<true, true, ALL>(p, f32_logits, i8, static_cast<cudaStream_t>(stream));
}

// Kernel 6: one family's softmax-weighted values, out [B, Dv] f32, over the
// plan's active tiles.  q_fam [B, C] (row stride ldq) and k_fam [N, C] (row
// stride ldk), C % 16 == 0; idx [nB, T] int32 with T = N / bn, its entries in
// [0, T); counts [nB] int32; query tile i = rows [i bm, (i + 1) bm) walks
// bank tiles idx[i, 0:counts[i]] of bn rows each.  bm % 16 == 0, bn % 32 ==
// 0, N % bn == 0.  scale [N] f32 selects int8 values (NULL: bf16).
extern "C" int family_pruned_launch(const void* q_fam, const void* k_fam, const void* values,
                                    const void* scale, const void* mask_neg,
                                    const void* tile_idx, const void* tile_counts, void* out,
                                    int B, int N, int ldq, int ldk, int C, int Dv, int bm,
                                    int bn, int f32_logits, void* stream) {
  Params p = dense_params(q_fam, k_fam, values, scale, mask_neg, out, B, N, ldq, C, 0, Dv,
                          1.0f);
  p.ldk = ldk;
  p.idx = static_cast<const int*>(tile_idx);
  p.cnt = static_cast<const int*>(tile_counts);
  p.bm = bm;
  p.bn = bn;
  const bool i8 = scale != nullptr;
  if (bad_shape(p, f32_logits, i8, C) || C <= 0 || bm <= 0 || bm % 16 || bn <= 0 ||
      bn % BN || N % bn)
    return (int)cudaErrorInvalidValue;
  return launch_any<false, false, LIST>(p, f32_logits, i8, static_cast<cudaStream_t>(stream));
}

// Kernel 7: fused_retrieval_launch (bf16 values) with the geo family of
// bank tile j (bn rows) taken for query tile i (bm rows) only where
// geo_flags[i, j] > 0; geo_flags [nB, N / bn] int32.  bm % 16 == 0,
// bn % 32 == 0, N % bn == 0.
extern "C" int fused_hybrid_launch(const void* q_cat, const void* k_cat, const void* values,
                                   const void* mask_neg, const void* geo_flags, void* out,
                                   int B, int N, int cat_d, int sem_d, int geo_d, int Dv,
                                   float beta, int bm, int bn, int f32_logits, void* stream) {
  Params p = dense_params(q_cat, k_cat, values, nullptr, mask_neg, out, B, N, cat_d, sem_d,
                          geo_d, Dv, beta);
  p.flags = static_cast<const int*>(geo_flags);
  p.bm = bm;
  p.bn = bn;
  if (bad_shape(p, f32_logits, false, sem_d + geo_d) || bm <= 0 || bm % 16 || bn <= 0 ||
      bn % BN || N % bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32_logits ? launch<true, false, false, true, FLAGS>(p, s)
                    : launch<false, false, false, true, FLAGS>(p, s);
}

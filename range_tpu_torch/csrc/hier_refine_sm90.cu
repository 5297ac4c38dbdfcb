// Hierarchical retrieval, the two-level second stage (kernel 12, the
// refine) for Hopper (sm_90a), on the tensor cores, in every form: f32
// logits (the `exact` tier) as three TF32 products a term with a fresh
// fragment a 32-deep chunk (tf32_sm90.cuh), bf16 logits (the `fast` tier,
// and the `high` tier's 768 columns) as bf16 k16 wgmma with the
// accumulator carried over every column.
//
// Replaces: range_tpu/ops/retrieval_hier.py:2077 `_hier_refine_kernel`
// (reached via _hier_refine_call <- _hier_partials2 <- retrieve_hier, the
// two-level feature path, in its has_parts form; and <- hier_topk over a
// two-level bank, stats only).  Per query block of bm and each of its M
// listed tiles idx[i, j]:
//   l = q[:, :wf] . g_sem_cat[tile's gpt_f groups];
//   m_f[q, j] = max l, s_f[q, j] = sum of exp2(min(l, 86));
//   has_parts: parts[q] += e_f @ g_sem_vw[tile's groups]
//                          - e_sup @ g_sup_vw[tile's gpt_sup supergroups],
//   e = exp2(min(l, 86)) rounded to vw's dtype (none at f32), the
//   supergroups' logits over q[:, :ws]; the products and sums in f32.
//
// Design: the p-once layout of the scan (csrc/hier_scan_tf32_sm90.cu)
// over a list instead of every tile.  A tile's rows are its fine groups
// and then (has_parts) its supergroups, laid out once a bank as one
// centroid image of spt 64-row steps (ops/retrieval_hier.py
// `_refine_images`), so one walk computes both levels' logits.  A block
// owns 128 queries (64 a consumer warpgroup, both reading one ring of the
// image; 64 where bm is no multiple of 128 or the bf16 query boxes would
// not fit twice) and one segment of their list.  Per listed tile and step:
// the logits [64 x 64] chunk by chunk (f32: A the warpgroup's resident f32
// query rows, split as read, past RES chunks read from device memory, B a
// split [64][32] chunk, m64n64k8 in a fresh fragment added in f32; bf16: A
// and B 64-column boxes in shared memory, m64n64k16 into one accumulator,
// a box's group issued before the one ahead of it is waited for);
// the fine groups' max and exp2 sum per thread in column order, then over
// its quad; and with has_parts D = e (0 past the tile's rows) once into
// device memory as the A units of csrc/hier_values_tf32_sm90.cu's value
// pass, f32 split in [64 queries][32 rows] chunks or bf16 in [64][64]
// boxes, which then computes parts over the same list with the negated
// supergroup vw as the tile's last rows (the subtraction exact).  The
// scan's kernel walks every group of the bank as one flat sequence; the
// refine's tiles are a query block's own, its stats one per list entry and
// its D one unit set per entry, so it is a kernel of its own, and the
// value pass is the scan's (its units a tile counted, so 72 rows cost
// three 32-row chunks).  The other layout, e @ vw in the block of the
// logits, recomputes the logits for every pair of 128-column slices of vw
// (it measured 2.3x slower on the scan, PERF.md; not built here).
// A producer warpgroup's first lane streams the image by bulk copies
// through full / empty mbarriers (and, bf16, the query boxes once).
//
// What bounds it on an H100: the logits' tensor work (three TF32 products
// a term at 495 TFLOP/s; bf16 at 989) and the value pass's (f32 vw three
// products, bf16 one); D's bytes (8 a (query, row) at f32, 2 at bf16),
// written once and read once a pair of value slices.
//
// A wait on a barrier that never completes traps after ~10 s.

#include "tf32_sm90.cuh"

namespace {

using namespace sm90;
using tf32::next_stage;
using tf32::segment;

constexpr int BM = 64;             // queries of a consumer warpgroup
constexpr int CONSUMERS = 256;     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int NS = 4;              // stages of the image's ring
constexpr int GCMAX = 48;          // f32: 32-column chunks of the logits, at most (1,536 columns)
constexpr int KBMAX = 24;          // bf16: 64-column boxes of the logits, at most (1,536 columns)
constexpr int RES = 8;             // f32: chunks a warpgroup's resident query rows hold
constexpr uint32_t PCHUNK = 2 * BM * 32 * 4;  // f32 D of 32 rows: [hi | lo][64 queries][32]
constexpr uint32_t PBOX = BM * 64 * 2;        // bf16 D of 64 rows: [64 queries][64]
constexpr float CLAMP2 = 86.0f;
#define NEG_INF __int_as_float(0xff800000)

// A stage of the image: f32 [hi | lo][64 rows][32], bf16 [64 rows][64]
__host__ __device__ constexpr uint32_t stage_bytes(bool x3) { return x3 ? 16384u : 8192u; }

struct Params {
  const void* q;     // f32 [Bq, 32 C] (x3), or bf16 query boxes [Bq / 64][C][64][64]
  const void* cimg;  // f32 [T][spt][C][hi | lo][64][32], or bf16 [T][spt][C][64][64]
  const int* idx;    // [Bq / bm, K]
  float* m;          // [Bq, K]
  float* s;          // [Bq, K]
  uint8_t* d;        // the value pass's A units of D, or null (stats only)
  int Bq, C, bm, spt, K, gpt, R, nu, dmode, n_seg, nw;
};

struct Layout {
  int SQ;
  uint32_t ring, bars, total;
};

// The warpgroups' query rows (f32: their first RES chunks, row stride SQ
// floats; bf16: every box), the ring, the barriers (full, empty, query).
__host__ __device__ inline Layout layout(bool x3, int C, int nw) {
  Layout l;
  l.SQ = 32 * (C < RES ? C : RES) + 8;
  const uint32_t qbytes = x3 ? (uint32_t)(nw * BM * l.SQ * 4) : (uint32_t)(nw * C) * PBOX;
  l.ring = round_up(qbytes, 1024);
  l.bars = l.ring + NS * stage_bytes(x3);
  l.total = l.bars + 8 * (2 * NS + 1) + 1024;  // + slack to align the base
  return l;
}

__device__ __forceinline__ float pexp(float l) { return exp2f(fminf(l, CLAMP2)); }

template <bool X3>
__device__ __forceinline__ void consume(const Params& p, const Layout& lay, uint8_t* smem,
                                        uint32_t base) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qb = blockIdx.x * p.nw + wg;  // this warpgroup's 64-query block
  const int q0 = qb * BM, r0 = 16 * warp + g;
  const uint32_t full = base + lay.bars, empty = full + 8 * NS, qbar = empty + 8 * NS;
  constexpr uint32_t STAGE = stage_bytes(X3);
  const float* qrow = nullptr;
  const float* qg = nullptr;
  if constexpr (X3) {
    // the warpgroup's query rows, their first RES chunks (past them read
    // from device memory as the chunks come)
    const float* q = static_cast<const float*>(p.q);
    float* qs = reinterpret_cast<float*>(smem) + wg * BM * lay.SQ;
    const int QW = 32 * p.C, c4 = 8 * (p.C < RES ? p.C : RES);
    for (int i = tid; i < BM * c4; i += 128) {
      const int r = i / c4, c = i % c4;
      *reinterpret_cast<float4*>(qs + r * lay.SQ + 4 * c) =
          *reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * QW + 4 * c);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    qrow = qs + r0 * lay.SQ + 2 * t;
    qg = q + (size_t)(q0 + r0) * QW + 2 * t;
  } else {
    mbar_wait(qbar, 0);
  }
  auto n64 = [](float (&d)[32], const uint32_t (&a)[4], uint64_t b, int sd) {
    tf32::wgmma_tf32_rs_n64(d, a, b, sd);
  };
  int ks = 0;
  uint32_t kph = 0;
  int e0, e1;
  segment(p.K, blockIdx.y, p.n_seg, e0, e1);
  for (int i = e0; i < e1; ++i) {
    float mx[2] = {NEG_INF, NEG_INF}, sm[2] = {0.f, 0.f};
    for (int st = 0; st < p.spt; ++st) {
      // ---- the step's logits [64 queries x 64 rows]
      float ev[32];
      if constexpr (X3) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll 1
        for (int c = 0; c < p.C; ++c) {
          float ef[32];
          if (c < RES)
            tf32::load_frags(qrow, lay.SQ, c, ah, al);
          else
            tf32::global_frags(qg + 32 * c, (size_t)8 * 32 * p.C, 32, ah, al);
          mbar_wait(full + 8 * ks, kph);
          wgmma_fence();
          tf32::issue_chunk(ef, ah, al, base + lay.ring + ks * STAGE, BM * 128, n64);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(ef);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * ks);
          next_stage(ks, kph, NS);
#pragma unroll
          for (int j = 0; j < 32; ++j) ev[j] = c ? ev[j] + ef[j] : ef[j];
        }
      } else {
        // one box's k16 steps a group into the carried accumulator, the next
        // box issued before the last is waited for: a stage is freed once
        // the group after it is in flight
        const uint32_t qa = base + wg * p.C * PBOX;
        int prev = 0;
#pragma unroll 1
        for (int c = 0; c < p.C; ++c) {
          const uint32_t tile = base + lay.ring + ks * STAGE;
          mbar_wait(full + 8 * ks, kph);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_ss_n64(ev, desc_k128(qa + c * PBOX + 32 * k), desc_k128(tile + 32 * k),
                         (c | k) ? 1 : 0);
          wgmma_commit();
          wgmma_wait<1>();
          __syncwarp();
          if (c > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
          prev = ks;
          next_stage(ks, kph, NS);
        }
        wgmma_wait0();
        fence_regs(ev);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      // ---- the fine groups' stats: element 4j + 2h + e is query row r0 +
      // 8h, tile row 64 st + 8j + 2t + e; this thread's in column order
      const int rs = 64 * st;
      if (rs < p.gpt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (rs + 8 * j + 2 * t + e >= p.gpt) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = ev[4 * j + 2 * h + e];
              mx[h] = fmaxf(mx[h], v);
              sm[h] += pexp(v);
            }
          }
      }
      // ---- D: the value pass's A units of this entry (0 past the tile's R rows)
      if (p.d == nullptr) continue;
      const size_t unit0 = ((size_t)qb * p.K + i) * p.nu;
      if (p.dmode == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = 2 * st + (j >> 2);
          if (u >= p.nu) continue;
          uint8_t* chunk = p.d + (unit0 + u) * PCHUNK;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // tile row 8j + 2t + e: chunk j / 4, at its k8 block's column t + 4e
              const int row = r0 + 8 * h;
              const float x = rs + 8 * j + 2 * t + e < p.R ? pexp(ev[4 * j + 2 * h + e]) : 0.f;
              const uint32_t off = row * 128 + (((2 * (j & 3) + e) ^ (row & 7)) << 4) + 4 * t;
              uint32_t hi, lo;
              tf32::split(x, hi, lo);
              *reinterpret_cast<uint32_t*>(chunk + off) = hi;
              *reinterpret_cast<uint32_t*>(chunk + PCHUNK / 2 + off) = lo;
            }
        }
      } else {
        uint8_t* box = p.d + (unit0 + st) * PBOX;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h, c = rs + 8 * j + 2 * t;
            const float x0 = c < p.R ? pexp(ev[4 * j + 2 * h]) : 0.f;
            const float x1 = c + 1 < p.R ? pexp(ev[4 * j + 2 * h + 1]) : 0.f;
            *reinterpret_cast<uint32_t*>(box + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
                pack_bf16(x0, x1);
          }
      }
    }
    // ---- the entry's stats over each quad: max, and ((s0 + s1) + (s2 + s3))
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 1);
      sm[h] += __shfl_xor_sync(0xffffffffu, sm[h], 2);
      if (t == 0) {
        const size_t o = (size_t)(q0 + r0 + 8 * h) * p.K + i;
        p.m[o] = mx[h];
        p.s[o] = sm[h];
      }
    }
  }
}

template <bool X3>
__global__ void __launch_bounds__(THREADS, 1) refine_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const Layout lay = layout(X3, p.C, p.nw);
  constexpr uint32_t STAGE = stage_bytes(X3);
  const uint32_t full = base + lay.bars, empty = full + 8 * NS, qbar = empty + 8 * NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * p.nw);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != CONSUMERS) return;
    // ---- the producer: (bf16) the query boxes once, then per entry and
    // step the image's C stages
    if constexpr (!X3) {
      const uint32_t qbytes = (uint32_t)(p.nw * p.C) * PBOX;
      mbar_expect_tx(qbar, qbytes);
      bulk_g2s(base, static_cast<const uint8_t*>(p.q) + (size_t)blockIdx.x * qbytes, qbytes,
               qbar);
    }
    const int* list = p.idx + (size_t)(blockIdx.x * p.nw * BM / p.bm) * p.K;
    const uint8_t* img = static_cast<const uint8_t*>(p.cimg);
    int ks = 0;
    uint32_t kph = 0;
    int e0, e1;
    segment(p.K, blockIdx.y, p.n_seg, e0, e1);
    for (int i = e0; i < e1; ++i) {
      const size_t tile = (size_t)list[i];
      for (int st = 0; st < p.spt; ++st)
        for (int c = 0; c < p.C; ++c) {
          mbar_wait(empty + 8 * ks, kph ^ 1);
          mbar_expect_tx(full + 8 * ks, STAGE);
          bulk_g2s(base + lay.ring + ks * STAGE,
                   img + ((tile * p.spt + st) * p.C + c) * STAGE, STAGE, full + 8 * ks);
          next_stage(ks, kph, NS);
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (threadIdx.x >= 128 * p.nw) return;
  consume<X3>(p, lay, smem, base);
}

template <bool X3>
int launch(const Params& p, cudaStream_t s) {
  const Layout lay = layout(X3, p.C, p.nw);
  if (lay.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(refine_kernel<X3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<X3><<<dim3(p.Bq / (BM * p.nw), p.n_seg), THREADS, lay.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of a block: f32 logits (x3) in C chunks of 32
// columns or bf16 ones in C boxes of 64, nw query warpgroups; -1 for what
// is not taken.
extern "C" int hier_refine_sm90_smem(int x3, int C, int nw) {
  if (C < 1 || C > (x3 ? GCMAX : KBMAX) || nw < 1 || nw > 2) return -1;
  return (int)layout(x3 != 0, C, nw).total;
}

// The refine's list pass: q (f32 [Bq, 32 C] where x3, else the bf16 query
// boxes [Bq / 64][C][64][64]); cimg the tiles' image (`_refine_images`:
// f32 [T][spt][C][hi | lo][64][32] or bf16 [T][spt][C][64][64]); idx [Bq /
// bm, K] int32; m, s [Bq, K] f32; d null (stats only) or the value pass's
// A units of D, nu a list entry: dmode 1 f32 split [64 queries][32 rows]
// chunks, 2 bf16 [64][64] boxes.  ints: Bq, C, bm, spt, K, gpt (fine rows a
// tile: the stats'), R (rows a tile: D's, 0 past them), nu, dmode, n_seg,
// nw (64-query warpgroups a block), x3.  Returns a CUDA error code
// (cudaErrorInvalidValue for what it does not take, with nothing launched).
extern "C" int hier_refine_sm90_launch(const void* q, const void* cimg, const void* idx, void* m,
                                       void* s, void* d, const int* a, void* stream) {
  Params p{};
  p.q = q;
  p.cimg = cimg;
  p.idx = static_cast<const int*>(idx);
  p.m = static_cast<float*>(m);
  p.s = static_cast<float*>(s);
  p.d = static_cast<uint8_t*>(d);
  p.Bq = a[0], p.C = a[1], p.bm = a[2], p.spt = a[3], p.K = a[4], p.gpt = a[5], p.R = a[6];
  p.nu = a[7], p.dmode = a[8], p.n_seg = a[9], p.nw = a[10];
  const bool x3 = a[11] != 0;
  const int unit_rows = p.dmode == 1 ? 32 : 64;
  if (p.Bq <= 0 || p.nw < 1 || p.nw > 2 || p.bm % (BM * p.nw) || p.Bq % p.bm || p.C < 1 ||
      p.C > (x3 ? GCMAX : KBMAX) || p.K <= 0 || p.gpt < 1 || p.spt != (p.R + 63) / 64 ||
      p.gpt > p.R || p.n_seg < 1 || p.n_seg > p.K || !aligned16(q) || !aligned16(cimg) ||
      m == nullptr || s == nullptr || (d == nullptr) != (p.dmode == 0) || p.dmode < 0 ||
      p.dmode > 2 || (d != nullptr && (p.nu != (p.R + unit_rows - 1) / unit_rows ||
                                       !aligned16(d))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x3 ? launch<true>(p, st) : launch<false>(p, st);
}

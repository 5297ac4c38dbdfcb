// Hierarchical retrieval, the CUDA-core and mma.sync body: the deep form of
// the scan, the f32 and deep forms of the refine and corr kernels; its f32
// scan, stats scan and parts forms are chip_smoke.py's same-run yardsticks.
//
// Replaces, in the forms their Hopper and mma.sync bodies do not take:
//   range_tpu/ops/retrieval_hier.py:1443 `_hier_scan_kernel` (kernel 8,
//   its deep form), :2077 `_hier_refine_kernel` (12) and :2209
//   `_hier_corr_kernel` (13).  Its forms of :1443 at f32, :1582
//   `_hier_scan_stats_kernel` (9), :2282 `_hier_parts_family_kernel` (14)
//   and :2515 `_hier_parts_kernel` (15) are launched by no wrapper: kernels
//   8 (f32) and 9 run on csrc/hier_scan_tf32_sm90.cu, 14 and 15 on their
//   Hopper and TF32 x3 bodies.
// The forms: f32 operands (the `exact` tier: f32 queries, keys and group
// operands, f32 values with build_hier_bank(value_dtype=torch.float32)),
// whose products the TPU kernel takes at Precision.HIGHEST; and bf16
// operands deeper than the other bodies' 256 logit columns (the `high`
// tier's 3 x 256 hi/lo cross terms, keys wider than 256 at `fast`).
//
// A product of two f32 operands is an f32 FMA on the CUDA cores, summed in
// k order as a plain f32 dot product.  A product of two bf16 operands (the
// deep form's logits; a value product whose weight is rounded to bf16
// before it, against bf16 values or int8 codes, exact in bf16) runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulation): a product of two
// bf16 values is exact in f32, so only the order of the f32 sums differs.
// The rounding points are the TPU kernel's: p = exp2(min(l, 86)) rounded
// to the value operand's dtype before each value product (bf16 for bf16 or
// int8 operands, none for f32), int8 rows' weights bf16(p * scale).
//
// Two kernels carry the six functions (ops/retrieval_hier.py composes
// them, `_cores_groups` / `_cores_rows`):
//   * groups_kernel: per query and listed tile, the group logits l = q . g
//     over the tile's groups; per list entry their max and the sum of p
//     (the stats); the weight E = p (the tails and approximations), or
//     p - ps / cnt, or ps / cnt - p (kernel 14's rr shapes, with ps the row
//     kernel's segment sums and cnt the count column of vw), summed over
//     sup consecutive groups where sup > 1 (the tail_super segment sums),
//     rounded; then out (=, or += with a sign) E @ vw.  With no list (the
//     two scans) the entries are every tile.
//   * rows_kernel: per query and listed tile, the row logits l = q . k +
//     mask over the tile's rows, p; d = sum of p; the weight (p, p * scale
//     for int8 codes) rounded; out (=, or +=) weight @ x (values or the
//     residual-rank coefficients z); and the segment sums of the rounded
//     p over each gsz-row group (the rr shapes' ps).
//
// Layout.  A block (16 warps, one an SM) owns 64 queries (inside one
// selection block of bm queries, whose list it reads), one slice of up to
// 512 output columns and one segment of its list's entries (repeats of the
// entry before skipped with dedup; without a list, every tile), and walks
// the segment as one flat sequence of groups or rows, 32 a chunk.  The
// query block stays in shared memory over every column its logits read;
// the chunks' operand rows stream through a ring of 3 to 8 pieces of 64
// columns (as many as shared memory holds) by cp.async, all but one ahead
// across the chunks' ends, so that the next chunk's pieces land while one
// chunk's weights and product run.
// Each chunk: the logits [64 x 32] (bf16: each warp an m16 x n8 tile on
// mma.sync; f32: warps 0-7, each thread 4 queries x 2 rows); the weights, 4 threads a
// query, 8 columns each (an entry, a segment sum's group or a supergroup
// is whole units of 8 columns, or spans the 4 threads and is combined in
// column order by shuffles; where it is not, gpt or gsz not a multiple or
// divisor of 8, one thread a query walks the chunk); the value product
// (bf16: each warp 64 queries x 32 columns on mma.sync; f32: each thread 8
// queries x 8 columns), the chunk's value rows staged by cp.async in the
// product's dtype with its first piece, the columns past the slice's
// skipped.  Each column slice computes the chunk's logits again; its first
// slice writes the stats, d, the segment sums and the count column.  A
// group pass over more than one segment (the scans: every tile of the
// bank for each 64 queries, split so that the blocks fill the card)
// writes each segment's partial product to a work buffer, and
// `fold_kernel` adds them in segment order.  Every sum runs in a fixed
// order: the answer is deterministic.
//
// What bounds it on an H100: the f32 form's FMAs, fed from shared memory
// (each 16-byte load serves 4 to 8 FMAs, so the loads, not the FMA rate of
// 67 TFLOP/s, set their pace); the deep form's walk, its logits cheap on
// the tensor cores.  A tf32 split whose three or six products run into one
// accumulator misses the f32 bar where a row's value sums cancel, so the
// f32 products here stay FMAs.  The TF32 x3 bodies take three TF32
// products with a fresh fragment a 32-deep chunk, which holds that bar:
// kernel 14's rr shapes (csrc/hier_rr_tf32_sm90.cu), its value shapes and
// kernel 15 (csrc/hier_values_tf32_sm90.cu), the scan at f32 and the stats
// scan (csrc/hier_scan_tf32_sm90.cu); the refine and corr kernels at f32
// stay here (ROADMAP.md, Queue 2).

#include "mma_common.cuh"

using namespace hier;

namespace {

constexpr int BM = 64;        // queries a block
constexpr int CH = 32;        // groups or rows a chunk
constexpr int KP = 64;        // logit columns a piece
constexpr int RING_MIN = 3;   // ring slots of the operand pieces: the fewest,
constexpr int RING_MAX = 8;   // and the most (as many as shared memory holds)
constexpr int NC = 512;       // output columns a block
constexpr int THREADS = 512;  // 16 warps: one block an SM
constexpr int LDL = CH + 4;   // f32 row stride of the logit / weight tile
constexpr int LDP = CH + 8;   // bf16 row stride of the weight tile
constexpr int LDV = NC + 8;   // row stride of the value rows (bf16 or f32)

enum Dt { BF16 = 0, F32 = 1, I8 = 2 };

__device__ __forceinline__ float ld(const void* p, int dt, size_t i) {
  if (dt == F32) return static_cast<const float*>(p)[i];
  if (dt == BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return (float)static_cast<const int8_t*>(p)[i];
}

// the rounding point before a product with an operand of dtype dt
__device__ __forceinline__ float rnd(float v, int dt) {
  return dt == F32 ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// One block's shared memory: the query block (resident: every column its
// logits read), the ring of operand pieces, the chunk's logits and
// weights, its value rows, and the lists.  Offsets in bytes, each a
// multiple of 16; the same on the host (the launch's size) and the device.
struct Layout {
  int es, ldq, ldg;  // bytes of an operand element; row strides in elements
  size_t q, g, lg, wt, v, item, kept, total;
};

__host__ __device__ inline Layout layout(int depth, bool ltc, bool vtc, bool values, int K,
                                         int ring) {
  Layout l;
  l.es = ltc ? 2 : 4;
  const int dp = (depth + KP - 1) / KP * KP;
  // + 4 words a row: the fragment loads of 8 rows fall in distinct banks
  l.ldq = dp + (ltc ? 8 : 4);
  l.ldg = KP + (ltc ? 8 : 4);
  size_t o = 0;
  l.q = o;
  o += (size_t)BM * l.ldq * l.es;
  l.g = o;
  o += (size_t)ring * CH * l.ldg * l.es;
  l.lg = o;
  o += sizeof(float) * BM * LDL;
  l.wt = o;
  o += sizeof(float) * BM * LDL;
  l.v = o;
  o += values ? (size_t)CH * LDV * (vtc ? 2 : 4) : 0;
  l.item = o;
  o += sizeof(int) * CH;
  l.kept = o;
  o += sizeof(int) * 2 * (size_t)K;
  l.total = o;
  return l;
}

struct Shared {
  uint8_t* q;         // [BM][ldq] the query block, f32 or bf16
  uint8_t* g;         // [ring][CH][ldg] the ring of operand pieces
  int ldq, ldg;
  float* lg;          // [BM][LDL] the chunk's logits
  float* wt;          // [BM][LDL] the f32 weights
  __nv_bfloat16* pb;  // [BM][LDP] the bf16 weights (over wt)
  float* v;           // [CH][LDV] the chunk's value rows of the slice, f32
  __nv_bfloat16* vb;  // [CH][LDV] the same, bf16 (over v)
  int* item;          // [CH] the chunk's operand row of each group / row (-1: none)
  int* kept;          // [K] the kept entries' tiles (a listed launch)
  int* pos;           // [K] their list positions
};

__device__ inline Shared carve(uint8_t* base, const Layout& l, int K) {
  Shared s;
  s.q = base + l.q;
  s.g = base + l.g;
  s.ldq = l.ldq;
  s.ldg = l.ldg;
  s.lg = reinterpret_cast<float*>(base + l.lg);
  s.wt = reinterpret_cast<float*>(base + l.wt);
  s.pb = reinterpret_cast<__nv_bfloat16*>(s.wt);
  s.v = reinterpret_cast<float*>(base + l.v);
  s.vb = reinterpret_cast<__nv_bfloat16*>(s.v);
  s.item = reinterpret_cast<int*>(base + l.item);
  s.kept = reinterpret_cast<int*>(base + l.kept);
  s.pos = s.kept + K;
  return s;
}

// The block's kept entries: its list row's tiles (an entry equal to the one
// before it skipped with dedup), or, without a list, every tile 0 .. K - 1
// (not stored: `tile_of` / `pos_of` give them).
__device__ int kept_entries(const Shared& s, const int* idx, int K, int list_row, int dedup) {
  if (!idx) return K;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int j = 0; j < K; ++j) {
      const int t = idx[(size_t)list_row * K + j];
      if (dedup && j > 0 && t == idx[(size_t)list_row * K + j - 1]) continue;
      s.kept[n] = t;
      s.pos[n] = j;
      ++n;
    }
    s.item[0] = n;  // handed over through the first slot
  }
  __syncthreads();
  const int n = s.item[0];
  __syncthreads();
  return n;
}

__device__ __forceinline__ int tile_of(const Shared& s, bool list, int n) {
  return list ? s.kept[n] : n;
}

__device__ __forceinline__ int pos_of(const Shared& s, bool list, int n) {
  return list ? s.pos[n] : n;
}

// The logit operands: Q[q0 + q][qc0 + k] . A[item][ac0 + k] over k < depth.
struct Logit {
  const void* q;
  int q_dt, ldq, qc0, q0, Bp;
  const void* a;
  int a_dt, lda, ac0, depth;
  bool vec;  // 16-byte copies (the launch's check)
};

// n_rows rows of width columns [c0, c0 + width) of src (row r: row_of(r),
// < 0 for none) into a shared tile of row stride ldd, zeros past each row's
// width or for no row: 16-byte cp.async copies left in flight (the caller
// commits) where vec, else element copies (bf16 operands stay exact).
template <bool BF, class RowOf>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int ldd, int n_rows, int width,
                                           const void* src, int src_dt, int lds, int c0,
                                           int depth, bool vec, RowOf row_of) {
  constexpr int ES = BF ? 2 : 4, E = 16 / ES;
  if (vec) {
    const char* sc = static_cast<const char*>(src);
    for (int e = threadIdx.x; e < n_rows * (width / E); e += THREADS) {
      const int r = e / (width / E), k = e % (width / E) * E, row = row_of(r);
      const bool ok = row >= 0 && k < depth;
      cp_async16(dst + ((size_t)r * ldd + k) * ES,
                 ok ? sc + ((size_t)row * lds + c0 + k) * ES : sc, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < n_rows * width; e += THREADS) {
    const int r = e / width, k = e % width, row = row_of(r);
    const float v = row >= 0 && k < depth ? ld(src, src_dt, (size_t)row * lds + c0 + k) : 0.f;
    if constexpr (BF) {
      reinterpret_cast<__nv_bfloat16*>(dst)[(size_t)r * ldd + k] = __float2bfloat16_rn(v);
    } else {
      reinterpret_cast<float*>(dst)[(size_t)r * ldd + k] = v;
    }
  }
}

// The query block, every column its logits read (up to the last whole
// piece, zeros past depth and past Bp).
template <bool LTC>
__device__ void stage_queries(const Shared& s, const Logit& L) {
  const int dp = (L.depth + KP - 1) / KP * KP;
  stage_rows<LTC>(s.q, s.ldq, BM, dp, L.q, L.q_dt, L.ldq, L.qc0, L.depth, L.vec,
                  [&](int r) { return L.q0 + r < L.Bp ? L.q0 + r : -1; });
}

// The k-piece at k0 of the operand rows item_of(c), c < CH, into ring slot
// `slot`.
template <bool LTC, class ItemOf>
__device__ void stage_piece(const Shared& s, int slot, const Logit& L, int k0, ItemOf item_of) {
  const int es = LTC ? 2 : 4;
  stage_rows<LTC>(s.g + (size_t)slot * CH * s.ldg * es, s.ldg, CH, KP, L.a, L.a_dt, L.lda,
                  L.ac0 + k0, L.depth - k0, L.vec, item_of);
}

// c += the logits of the piece at k0 in ring slot `slot`.  bf16 operands
// (LTC) on mma.sync, one m16n8k16 product a k16 step into c[0..3], the
// warp's tile the m16 tile w / 4 of the queries and the n8 tile w % 4 of
// the chunk.  f32 operands as f32 FMAs in k order on warps 0-7, each thread
// the 4 queries 8 w + 4 (lane / 16) .. (16-byte broadcast loads) against
// the chunk's rows lane % 16 and + 16 (one 16-byte load each a 4 columns):
// 32 FMAs to 6 loads, a shared-memory load the scarce resource.
template <bool LTC>
__device__ __forceinline__ void piece(const Shared& s, int slot, int k0, int left, float (&c8)[8]) {
  float (&c)[4] = *reinterpret_cast<float (*)[4]>(&c8[0]);  // the mma.sync fragment
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if constexpr (LTC) {
    const int g = lane >> 2, tt = lane & 3, m0 = (w >> 2) * 16, n0 = (w & 3) * 8;
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(s.q);
    const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(s.g) + slot * CH * s.ldg;
#pragma unroll
    for (int kk = 0; kk < KP; kk += 16) {
      if (kk >= left) break;
      uint32_t af[4], b0, b1;
      load_a(af, qb, s.ldq, m0, k0 + kk, g, tt);
      load_bt(b0, b1, gb, s.ldg, n0, kk, g, tt);
      mma_bf16(c, af, b0, b1);
    }
  } else {
    if (w >= 8) return;
    const int qr0 = 8 * w + 4 * (lane >> 4), g0 = lane & 15;
    const float* qf = reinterpret_cast<const float*>(s.q) + qr0 * s.ldq + k0;
    const float* gf = reinterpret_cast<const float*>(s.g) + (slot * CH + g0) * s.ldg;
#pragma unroll 4
    for (int kk = 0; kk < KP; kk += 4) {
      if (kk >= left) break;
      const float4 ga = *reinterpret_cast<const float4*>(gf + kk);
      const float4 gb = *reinterpret_cast<const float4*>(gf + 16 * s.ldg + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qf + i * s.ldq + kk);
        c8[i] = fmaf(qv.x, ga.x, c8[i]);
        c8[i] = fmaf(qv.y, ga.y, c8[i]);
        c8[i] = fmaf(qv.z, ga.z, c8[i]);
        c8[i] = fmaf(qv.w, ga.w, c8[i]);
        c8[4 + i] = fmaf(qv.x, gb.x, c8[4 + i]);
        c8[4 + i] = fmaf(qv.y, gb.y, c8[4 + i]);
        c8[4 + i] = fmaf(qv.z, gb.z, c8[4 + i]);
        c8[4 + i] = fmaf(qv.w, gb.w, c8[4 + i]);
      }
    }
  }
}

// The thread's logits into s.lg (the layout of `piece`).
template <bool LTC>
__device__ __forceinline__ void store_logits(const Shared& s, const float (&c)[8]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if constexpr (LTC) {
    const int r = (w >> 2) * 16 + (lane >> 2), col = (w & 3) * 8 + 2 * (lane & 3);
    s.lg[r * LDL + col] = c[0];
    s.lg[r * LDL + col + 1] = c[1];
    s.lg[(r + 8) * LDL + col] = c[2];
    s.lg[(r + 8) * LDL + col + 1] = c[3];
  } else {
    if (w >= 8) return;
    const int r = 8 * w + 4 * (lane >> 4), col = lane & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.lg[(r + i) * LDL + col] = c[i];
      s.lg[(r + i) * LDL + col + 16] = c[4 + i];
    }
  }
}

// cp.async.wait_group n for a run-time n in [0, RING_MAX - 1].
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The walk of a block's chunks: the query block resident, every chunk's
// operand pieces streaming through the ring's slots, ring - 1 pieces ahead
// (across chunk ends), one cp.async group a piece.  chunk(f0, ng, c)
// receives each chunk's logits in c (every thread its fragment) after its
// last piece and stores them; start(f0, ng) runs before the chunk's first
// piece is issued (its values' copies join that piece's group, and are
// complete by the chunk's end).
template <bool LTC, class ItemOf, class Start, class Chunk>
__device__ void walk(const Shared& s, const Logit& L, int ring, int fb, int fe, ItemOf item_of,
                     Start start, Chunk chunk) {
  const int np = (L.depth + KP - 1) / KP, nch = (fe - fb + CH - 1) / CH;
  stage_queries<LTC>(s, L);
  cp_async_commit();
  int put = 0, put_c = 0, put_p = 0, use = 0;  // the next piece to issue: slot, chunk, piece
  auto issue = [&]() {
    if (put_c < nch) {
      const int f0 = fb + put_c * CH;
      stage_piece<LTC>(s, put, L, put_p * KP, [&](int c) {
        return f0 + c < fe ? item_of(f0 + c) : -1;
      });
    }
    cp_async_commit();
    if (++put == ring) put = 0;
    if (++put_p == np) {
      put_p = 0;
      ++put_c;
    }
  };
  for (int i = 0; i < ring - 1; ++i) issue();
  for (int ch = 0; ch < nch; ++ch) {
    const int f0 = fb + ch * CH, ng = min(CH, fe - f0);
    start(f0, ng);
    float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < np; ++p) {
      wait_pending(ring - 2);  // this piece (and the query block) landed
      __syncthreads();         // ... for every thread; the slot of piece p - 1 is free
      issue();                 // the piece ring - 1 ahead, into that slot
      piece<LTC>(s, use, p * KP, L.depth - p * KP, c);
      if (++use == ring) use = 0;
    }
    // the values' copies, in the group of the chunk's first issue: np - 1 newer
    if (np < ring) wait_pending(np - 1);
    chunk(f0, ng, c);
  }
}

// The chunk's value rows [n_rows][c0, c0 + nc) of x (row r: vrow_of(r))
// into shared memory, bf16 (int8 codes converted, exactly) or f32, the
// columns up to the product's last 32 (zeros past nc).
template <bool VTC, class RowOf>
__device__ __forceinline__ void stage_values(const Shared& s, const void* x, int x_dt, int ldx,
                                             int c0, int nc, int n_rows, bool vec,
                                             RowOf vrow_of) {
  stage_rows<VTC>(reinterpret_cast<uint8_t*>(s.v), LDV, CH, (nc + 31) & ~31, x, x_dt, ldx, c0,
                  nc, vec, [&](int r) { return r < n_rows ? vrow_of(r) : -1; });
}

// The weight of column c of query row r, into the product's tile (apart
// from the logits: a supergroup's weight lands in a column another thread
// of the quad still reads).
template <bool VTC>
__device__ __forceinline__ void put_weight(const Shared& s, int r, int c, float w) {
  if constexpr (VTC) {
    s.pb[r * LDP + c] = __float2bfloat16_rn(w);
  } else {
    s.wt[r * LDL + c] = w;
  }
}

// acc += weights @ values over the chunk's n_rows weight rows and the
// slice's first nc columns (none past them).  bf16 (VTC) on mma.sync: warp
// w owns the columns 32 w .. 32 w + 31, element e of the m16 tile mt and
// the n8 tile nt of them is acc[2 mt + nt / 2][4 (nt % 2) + e], a fresh
// fragment a chunk added in f32, the weight columns past n_rows meeting
// zero value rows.  f32 as f32 FMAs in row order: warp w owns the queries
// 8 (w % 8) .., acc[i][j] query i of them and column 256 (w / 8) + lane +
// 32 j.
template <bool VTC>
__device__ __forceinline__ void product(const Shared& s, float (&acc)[8][8], int n_rows, int nc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if constexpr (VTC) {
    if (32 * w >= nc) return;
    const int g = lane >> 2, tt = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[2][4];
      load_b_pair(b[0], s.vb, LDV, 0, 32 * w + 16 * h, lane);
      load_b_pair(b[1], s.vb, LDV, 16, 32 * w + 16 * h, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a0[4], a1[4];
        load_a(a0, s.pb, LDP, mt * 16, 0, g, tt);
        load_a(a1, s.pb, LDP, mt * 16, 16, g, tt);
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // the n8 tile nt = 2 h + j
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c, a0, b[0][2 * j], b[0][2 * j + 1]);
          mma_bf16(c, a1, b[1][2 * j], b[1][2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * mt + h][4 * j + e] += c[e];
        }
      }
    }
  } else {
    const int qb = 8 * (w & 7), cb = 256 * (w >> 3);
    if (cb >= nc) return;
    const int nj = (nc - cb + 31) >> 5;
#pragma unroll 2
    for (int r = 0; r < n_rows; ++r) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = s.wt[(qb + i) * LDL + r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) break;
        const float vv = s.v[r * LDV + cb + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
}

// out[q][oc0 + c] (=, or += with accumulate) sign * acc for the block's
// columns c < nc_total (c0 + the slice's column); acc as `product` lays it.
template <bool VTC>
__device__ __forceinline__ void write_out(const float (&acc)[8][8], float* out, int ldo, int oc0,
                                          int q0, int Bp, int c0, int nc_total, float sign,
                                          int accumulate) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int q, c;
      if constexpr (VTC) {  // (i, j) = (2 mt + nt / 2, 4 (nt % 2) + e)
        const int mt = i >> 1, nt = 2 * (i & 1) + (j >> 2), e = j & 3;
        q = q0 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
        c = c0 + 32 * w + nt * 8 + 2 * (lane & 3) + (e & 1);
      } else {
        q = q0 + 8 * (w & 7) + i;
        c = c0 + 256 * (w >> 3) + lane + 32 * j;
      }
      if (q >= Bp || c >= nc_total) continue;
      float* o = out + (size_t)q * ldo + oc0 + c;
      *o = accumulate ? *o + sign * acc[i][j] : sign * acc[i][j];
    }
}

// The sum over the 4 threads of a query (lanes 4 k .. 4 k + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct GroupsArgs {
  const void* q;      // [Bp, ldq] queries: the logits read columns [qc0, qc0 + wk)
  const void* g;      // [G, ldg] centroids, columns [0, wk)
  const int* idx;     // [Bp / bm, K] listed tiles, or null: every tile 0 .. K - 1
  float* m;           // [Bp, lds] max logit of each list entry, or null (no stats)
  float* s;           // [Bp, lds] sum of p of each list entry
  const void* vw;     // [G / sup, ldvw] value operand, or null (stats only)
  const float* ps;    // [Bp, ldps] the rows' segment sums (modes 1, 2)
  float* out;         // [Bp, ldo]
  float* work;        // [n_seg, Bp, nvc] the segments' partial products (n_seg > 1)
  int Bp, q_dt, ldq, qc0, wk, g_dt, ldg, K, bm, dedup, gpt, lds;
  int vw_dt, ldvw, sup, nvc, cntc, dcol, ldps, mode, lrr, accumulate, ldo, oc0, n_seg;
  int ring;  // ring slots (the launch's: as many as shared memory holds)
  float sign;
  bool vec_l, vec_v;  // 16-byte copies of the logit operands / of vw (the launch's check)
};

// A group's weight before rounding: E = p, p - ps / cnt or ps / cnt - p.
__device__ __forceinline__ float group_weight(const GroupsArgs& a, int q, int grp, int f,
                                              float p) {
  if (!a.mode) return p;
  const float cnt = fmaxf(ld(a.vw, a.vw_dt, (size_t)grp * a.ldvw + a.lrr), 1.0f);
  const float psn = q < a.Bp ? a.ps[(size_t)q * a.ldps + f] / cnt : 0.f;
  return a.mode == 1 ? p - psn : psn - p;
}

// Stats, weights and E @ vw of one query block over one segment of its
// list's entries (blockIdx.z of n_seg: the entries [z nk / n_seg, (z + 1)
// nk / n_seg)), whose partial product goes to work where n_seg > 1.
template <bool LTC, bool VTC>
__global__ void __launch_bounds__(THREADS, 1) groups_kernel(const GroupsArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const bool list = a.idx != nullptr;
  const Shared s = carve(smem, layout(a.wk, LTC, VTC, a.vw != nullptr, list ? a.K : 0, a.ring),
                         list ? a.K : 0);
  const int t = threadIdx.x;
  // weight columns past a chunk's rows meet zero value rows: no NaN there
  for (int i = t; i < BM * LDL; i += THREADS) s.wt[i] = 0.f;
  const int q0 = blockIdx.x * BM, slice = blockIdx.y, c0 = slice * NC, seg = blockIdx.z;
  const int nc = a.vw ? min(NC, a.nvc - c0) : 0;
  const int nk = kept_entries(s, a.idx, a.K, q0 / a.bm, a.dedup);
  const int fb = seg * nk / a.n_seg * a.gpt, fe = (seg + 1) * nk / a.n_seg * a.gpt;
  const bool first = slice == 0;
  const Logit L{a.q, a.q_dt, a.ldq, a.qc0, q0, a.Bp, a.g, a.g_dt, a.ldg, 0, a.wk, a.vec_l};
  // the weights: 4 threads a query, 8 columns each, where every entry and
  // supergroup is whole 8-column units; else one thread a query
  const bool quad = a.gpt % 8 == 0;
  const int qr = quad ? t >> 2 : t, part = quad ? t & 3 : 0;
  const bool walker = t < (quad ? 4 * BM : BM);      // takes part in the weights
  const bool holder = walker && (!quad || part == 0);  // holds the query's running state
  const int q = q0 + qr;
  const float NEG_INF = __int_as_float(0xff800000);
  float run_m = NEG_INF, run_s = 0.f, sup_acc = 0.f, dcnt = 0.f;
  int run_n = -1;  // the entry run_m / run_s belong to (the quad walk)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto flush = [&](int n) {
    if (a.m && first && q < a.Bp && n >= 0) {
      a.m[(size_t)q * a.lds + pos_of(s, list, n)] = run_m;
      a.s[(size_t)q * a.lds + pos_of(s, list, n)] = run_s;
    }
  };
  auto item_of = [&](int f) { return tile_of(s, list, f / a.gpt) * a.gpt + f % a.gpt; };
  auto start = [&](int f0, int ng) {
    if (t < CH) s.item[t] = t < ng ? item_of(f0 + t) : -1;
    if (nc > 0)  // weight row r: the (super)group of f0 + r sup
      stage_values<VTC>(s, a.vw, a.vw_dt, a.ldvw, c0, nc, (ng + a.sup - 1) / a.sup, a.vec_v,
                        [&](int r) { return item_of(f0 + r * a.sup) / a.sup; });
  };
  auto chunk = [&](int f0, int ng, const float (&frag)[8]) {
    const int nr = (ng + a.sup - 1) / a.sup;  // weight rows of the product
    store_logits<LTC>(s, frag);
    __syncthreads();
    if (quad && walker) {
      const int cb = 8 * part, n = (f0 + cb) / a.gpt;  // this unit's entry
      float pm = NEG_INF, psum = 0.f, unit = 0.f, dc = 0.f;
      if (cb < ng) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cb + k;
          if (c >= ng) break;
          const float l = s.lg[qr * LDL + c];
          const float p = exp2f(fminf(l, CLAMP2));
          pm = fmaxf(pm, l);
          psum += p;
          if (!a.vw) continue;
          const float e = group_weight(a, q, s.item[c], f0 + c, p);
          if (a.sup == 1) {
            const float w = rnd(e, a.vw_dt);
            put_weight<VTC>(s, qr, c, w);
            if (a.cntc >= 0)
              dc = fmaf(w, ld(a.vw, a.vw_dt, (size_t)s.item[c] * a.ldvw + a.cntc), dc);
          } else {
            unit += e;
            if (a.sup <= 8 && (k + 1) % a.sup == 0) {
              put_weight<VTC>(s, qr, c / a.sup, rnd(unit, a.vw_dt));
              unit = 0.f;
            }
          }
        }
      }
      if (a.vw && a.sup > 8) {  // supergroups of 16 or 32: across the quad's units
        unit += __shfl_xor_sync(0xffffffffu, unit, 1);
        if (a.sup == 32) unit += __shfl_xor_sync(0xffffffffu, unit, 2);
        if (cb < ng && cb % a.sup == 0) put_weight<VTC>(s, qr, cb / a.sup, rnd(unit, a.vw_dt));
      }
      dc = quad_sum(dc);
      // the quad's four units, in column order, into the running entry stats
      const int base = (t & 31) & ~3;
      float um[4], us[4];
      int un[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        um[i] = __shfl_sync(0xffffffffu, pm, base + i);
        us[i] = __shfl_sync(0xffffffffu, psum, base + i);
        un[i] = __shfl_sync(0xffffffffu, n, base + i);
      }
      if (holder) {
        dcnt += dc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (8 * i >= ng) break;
          if (un[i] != run_n) {
            flush(run_n);
            run_n = un[i];
            run_m = NEG_INF;
            run_s = 0.f;
          }
          run_m = fmaxf(run_m, um[i]);
          run_s += us[i];
        }
      }
    } else if (!quad && walker) {  // one thread a query walks the chunk in order
      int n = f0 / a.gpt, i = f0 % a.gpt;
      for (int c = 0; c < ng; ++c) {
        const float l = s.lg[t * LDL + c];
        const float p = exp2f(fminf(l, CLAMP2));
        run_m = fmaxf(run_m, l);
        run_s += p;
        if (a.vw) {
          const float e = group_weight(a, q, s.item[c], f0 + c, p);
          if (a.sup > 1) {
            sup_acc += e;
            if ((c + 1) % a.sup == 0) {
              put_weight<VTC>(s, t, c / a.sup, rnd(sup_acc, a.vw_dt));
              sup_acc = 0.f;
            }
          } else {
            const float w = rnd(e, a.vw_dt);
            put_weight<VTC>(s, t, c, w);
            if (a.cntc >= 0)
              dcnt = fmaf(w, ld(a.vw, a.vw_dt, (size_t)s.item[c] * a.ldvw + a.cntc), dcnt);
          }
        }
        if (++i == a.gpt) {  // the entry ends
          flush(n);
          run_m = NEG_INF;
          run_s = 0.f;
          i = 0;
          ++n;
        }
      }
    }
    __syncthreads();
    if (nc > 0) product<VTC>(s, acc, nr, nc);
    __syncthreads();
  };
  walk<LTC>(s, L, a.ring, fb, fe, item_of, start, chunk);
  if (quad && holder) flush(run_n);  // the last entry
  if (nc > 0 && a.n_seg > 1)
    write_out<VTC>(acc, a.work + (size_t)seg * a.Bp * a.nvc, a.nvc, 0, q0, a.Bp, c0, a.nvc, 1.0f,
              0);
  else if (nc > 0)
    write_out<VTC>(acc, a.out, a.ldo, a.oc0, q0, a.Bp, c0, a.nvc, a.sign, a.accumulate);
  if (a.vw && a.cntc >= 0 && first && holder && q < a.Bp) {
    float* o = a.out + (size_t)q * a.ldo + a.dcol;
    *o = a.accumulate ? *o + a.sign * dcnt : a.sign * dcnt;
  }
}

// out[q][oc0 + c] (=, or += with accumulate) sign * the sum of the n_seg
// partial products work[z][q][c], in z order.
__global__ void fold_kernel(const float* work, int n_seg, int Bp, int nvc, float* out, int ldo,
                            int oc0, float sign, int accumulate) {
  const size_t n = (size_t)Bp * nvc, stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = 0.f;
    for (int z = 0; z < n_seg; ++z) v += work[(size_t)z * n + i];
    float* o = out + i / nvc * ldo + oc0 + i % nvc;
    *o = accumulate ? *o + sign * v : sign * v;
  }
}

struct RowsArgs {
  const void* q;       // [Bp, ldq] queries: the logits read columns [qc0, qc0 + kf)
  const void* k;       // [N, ldk] keys, columns [kc0, kc0 + kf)
  const float* mask;   // [N] additive row mask
  const int* idx;      // [Bp / bm, K] listed tiles
  const void* x;       // [N, ldx] values or residual coefficients, columns [0, nx)
  const float* scale;  // [N] int8 row scales, or null
  float* ps;           // [Bp, ldps] segment sums of the rounded p, or null
  float* out;          // [Bp, ldo]
  int Bp, q_dt, ldq, qc0, kf, k_dt, ldk, kc0, K, bm, bn, dedup;
  int x_dt, ldx, nx, rr, ldps, gsz, accumulate, ldo, oc0, dcol;
  int ring;  // ring slots (the launch's: as many as shared memory holds)
  bool vec_l, vec_v;  // 16-byte copies of the logit operands / of x (the launch's check)
};

// d, the rounded weights' product with x and their segment sums, of one
// query block over its list's rows.
template <bool LTC, bool VTC>
__global__ void __launch_bounds__(THREADS, 1) rows_kernel(const RowsArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Shared s = carve(smem, layout(a.kf, LTC, VTC, true, a.K, a.ring), a.K);
  const int t = threadIdx.x;
  // weight columns past a chunk's rows meet zero value rows: no NaN there
  for (int i = t; i < BM * LDL; i += THREADS) s.wt[i] = 0.f;
  const int q0 = blockIdx.x * BM, slice = blockIdx.y, c0 = slice * NC;
  const int nc = min(NC, a.nx - c0);
  const int nk = kept_entries(s, a.idx, a.K, q0 / a.bm, a.dedup);
  const int total = nk * a.bn, gpt = a.bn / a.gsz;
  const bool first = slice == 0;
  // 4 threads a query where every tile and segment-sum group is whole
  // 8-row units or divides one; else one thread a query
  const bool quad = a.bn % 8 == 0 && (!a.rr || a.gsz % 8 == 0 || 8 % a.gsz == 0);
  const int qr = quad ? t >> 2 : t, part = quad ? t & 3 : 0;
  const bool walker = t < (quad ? 4 * BM : BM);
  const bool holder = walker && (!quad || part == 0);
  const int q = q0 + qr;
  float d = 0.f, seg = 0.f;
  int seg_id = -1;  // the segment-sum group seg belongs to (the quad walk, gsz > 8)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto put_seg = [&](int id, float v) {
    if (a.ps && first && q < a.Bp && id >= 0) a.ps[(size_t)q * a.ldps + id] = v;
  };
  auto item_of = [&](int f) { return s.kept[f / a.bn] * a.bn + f % a.bn; };
  const Logit L{a.q, a.q_dt, a.ldq, a.qc0, q0, a.Bp, a.k, a.k_dt, a.ldk, a.kc0, a.kf, a.vec_l};
  auto start = [&](int f0, int nr) {
    if (t < CH) s.item[t] = t < nr ? item_of(f0 + t) : -1;
    stage_values<VTC>(s, a.x, a.x_dt, a.ldx, c0, nc, nr, a.vec_v,
                      [&](int r) { return item_of(f0 + r); });
  };
  auto chunk = [&](int f0, int nr, const float (&frag)[8]) {
    store_logits<LTC>(s, frag);
    __syncthreads();
    if (quad && walker) {
      const int cb = 8 * part, f = f0 + cb, n = f / a.bn, r = f % a.bn;  // this unit
      float dp = 0.f, unit = 0.f;
      if (cb < nr) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cb + k;
          if (c >= nr) break;
          const int row = s.item[c];
          const float p = exp2f(fminf(s.lg[qr * LDL + c] + a.mask[row], CLAMP2));
          float w;
          if (a.rr) {  // p rounded first: the segment sums and the product
            w = rnd(p, a.x_dt);
            unit += w;
            if (a.gsz <= 8 && (k + 1) % a.gsz == 0) {
              put_seg(n * gpt + (r + k) / a.gsz, unit);
              unit = 0.f;
            }
          } else {
            dp += p;
            w = rnd(a.scale ? p * a.scale[row] : p, a.x_dt);
          }
          put_weight<VTC>(s, qr, c, w);
        }
      }
      dp = quad_sum(dp);
      if (a.rr && a.gsz > 8) {  // groups of whole units: the quad's four, in row order
        const int base = (t & 31) & ~3;
        const int id = cb < nr ? n * gpt + r / a.gsz : -1;
        float uv[4];
        int ui[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uv[i] = __shfl_sync(0xffffffffu, unit, base + i);
          ui[i] = __shfl_sync(0xffffffffu, id, base + i);
        }
        if (holder) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ui[i] < 0) break;
            if (ui[i] != seg_id) {
              put_seg(seg_id, seg);
              seg_id = ui[i];
              seg = 0.f;
            }
            seg += uv[i];
          }
        }
      }
      if (holder) d += dp;
    } else if (!quad && walker) {
      int n = f0 / a.bn, r = f0 % a.bn;
      for (int c = 0; c < nr; ++c) {
        const int row = s.item[c];
        const float p = exp2f(fminf(s.lg[t * LDL + c] + a.mask[row], CLAMP2));
        float w;
        if (a.rr) {
          w = rnd(p, a.x_dt);
          seg += w;
          if (r % a.gsz == a.gsz - 1) {
            put_seg(n * gpt + r / a.gsz, seg);
            seg = 0.f;
          }
        } else {
          d += p;
          w = rnd(a.scale ? p * a.scale[row] : p, a.x_dt);
        }
        put_weight<VTC>(s, t, c, w);
        if (++r == a.bn) {
          r = 0;
          ++n;
        }
      }
    }
    __syncthreads();
    product<VTC>(s, acc, nr, nc);
    __syncthreads();
  };
  walk<LTC>(s, L, a.ring, 0, total, item_of, start, chunk);
  if (quad && holder && a.rr && a.gsz > 8) put_seg(seg_id, seg);  // the last group
  write_out<VTC>(acc, a.out, a.ldo, a.oc0, q0, a.Bp, c0, a.nx, 1.0f, a.accumulate);
  if (a.dcol >= 0 && first && holder && q < a.Bp) {
    float* o = a.out + (size_t)q * a.ldo + a.dcol;
    *o = a.accumulate ? *o + d : d;
  }
}

bool dt_ok(int dt, bool int8) { return dt == BF16 || dt == F32 || (int8 && dt == I8); }

// Whole 16-byte vectors: a 16-byte aligned base and row stride, the column
// offset and the width multiples of one, in elements of dtype dt.
bool vec16(const void* p, int dt, int ld, int c0, int width) {
  const int e = dt == F32 ? 4 : dt == BF16 ? 8 : 16;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % e == 0 && c0 % e == 0 &&
         width % e == 0;
}

// The most ring slots (RING_MIN .. RING_MAX) whose shared memory, bytes(r),
// fits a block; 0 where not even RING_MIN do.
template <class Bytes>
int ring_slots(Bytes bytes) {
  for (int r = RING_MAX; r >= RING_MIN; --r)
    if (bytes(r) <= MAX_SMEM) return r;
  return 0;
}

// Launch fn on the grid with its shared memory.
template <class Args>
int launch(void (*fn)(Args), const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The group kernel.  ptrs: q, g, idx, m, s, vw, ps, out, work (idx, m / s,
// vw, ps may be null: every tile, no stats, no value product, mode 0; work
// [n_seg, Bp, nvc] f32 where n_seg > 1 and vw, and then the fold sums it
// into out).  ints: Bp, q_dt, ldq, qc0, wk, g_dt, ldg, K, bm, dedup, gpt,
// lds, vw_dt, ldvw, sup, nvc, cntc, dcol, ldps, mode, lrr, accumulate, ldo,
// oc0, n_seg (dtypes: 0 bf16, 1 f32; n_seg segments of each block's
// entries, a block each, at most K; more than one only without cntc).  The logits run on mma.sync where q and g are bf16, the
// product where vw is.  Returns a CUDA error code (cudaErrorInvalidValue
// for what it does not take, with nothing launched).
extern "C" int hier_groups_launch(const void* const* ptrs, const int* ints, float sign,
                                  void* stream) {
  GroupsArgs a;
  a.q = ptrs[0];
  a.g = ptrs[1];
  a.idx = static_cast<const int*>(ptrs[2]);
  a.m = static_cast<float*>(const_cast<void*>(ptrs[3]));
  a.s = static_cast<float*>(const_cast<void*>(ptrs[4]));
  a.vw = ptrs[5];
  a.ps = static_cast<const float*>(ptrs[6]);
  a.out = static_cast<float*>(const_cast<void*>(ptrs[7]));
  a.work = static_cast<float*>(const_cast<void*>(ptrs[8]));
  int* f[] = {&a.Bp,   &a.q_dt, &a.ldq,  &a.qc0, &a.wk,   &a.g_dt, &a.ldg,        &a.K,
              &a.bm,   &a.dedup, &a.gpt, &a.lds, &a.vw_dt, &a.ldvw, &a.sup,       &a.nvc,
              &a.cntc, &a.dcol, &a.ldps, &a.mode, &a.lrr,  &a.accumulate, &a.ldo, &a.oc0,
              &a.n_seg};
  for (int i = 0; i < 25; ++i) *f[i] = ints[i];
  a.sign = sign;
  if (a.Bp <= 0 || a.K <= 0) return 0;
  const bool bad =
      !a.q || !a.g || !dt_ok(a.q_dt, false) || !dt_ok(a.g_dt, false) || a.wk <= 0 ||
      a.qc0 < 0 || a.qc0 + a.wk > a.ldq || a.wk > a.ldg || a.bm <= 0 || a.bm % BM ||
      (a.idx && a.Bp % a.bm) || a.gpt <= 0 || (a.m && (!a.s || a.lds < a.K)) ||
      (a.vw && (!a.out || !dt_ok(a.vw_dt, false) || a.nvc <= 0 || a.nvc > a.ldvw ||
                a.sup < 1 || CH % a.sup || a.gpt % a.sup || a.cntc >= a.ldvw ||
                (a.cntc >= 0 && (a.dcol < 0 || a.dcol >= a.ldo || a.sup != 1)) || a.oc0 < 0 ||
                a.oc0 + a.nvc > a.ldo || a.mode < 0 || a.mode > 2 ||
                (a.mode && (!a.ps || a.sup != 1 || a.lrr < 0 || a.lrr >= a.ldvw ||
                            a.ldps < a.K * a.gpt)))) ||
      (!a.vw && !a.m) || (a.sup > 1 && a.idx) || a.n_seg < 1 || a.n_seg > a.K ||
      (a.n_seg > 1 && a.vw && (!a.work || a.cntc >= 0));
  if (bad) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Bp + BM - 1) / BM, a.vw ? (a.nvc + NC - 1) / NC : 1, a.n_seg);
  const bool ltc = a.q_dt == BF16 && a.g_dt == BF16, vtc = a.vw && a.vw_dt == BF16;
  a.ring = ring_slots([&](int r) {
    return layout(a.wk, ltc, vtc, a.vw != nullptr, a.idx ? a.K : 0, r).total;
  });
  if (!a.ring) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(a.wk, ltc, vtc, a.vw != nullptr, a.idx ? a.K : 0, a.ring).total;
  a.vec_l = (ltc || (a.q_dt == F32 && a.g_dt == F32)) && vec16(a.q, a.q_dt, a.ldq, a.qc0, a.wk) &&
            vec16(a.g, a.g_dt, a.ldg, 0, a.wk);
  a.vec_v = a.vw && vec16(a.vw, a.vw_dt, a.ldvw, 0, a.nvc);
  auto fn = ltc ? (vtc ? groups_kernel<true, true> : groups_kernel<true, false>)
                : (vtc ? groups_kernel<false, true> : groups_kernel<false, false>);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch(fn, a, grid, smem, st);
  if (rc || a.n_seg == 1 || !a.vw) return rc;
  const size_t n = (size_t)a.Bp * a.nvc;
  const int blocks = (int)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096);
  fold_kernel<<<blocks, 256, 0, st>>>(a.work, a.n_seg, a.Bp, a.nvc, a.out, a.ldo, a.oc0,
                                      a.sign, a.accumulate);
  return (int)cudaGetLastError();
}

// The row kernel.  ptrs: q, k, mask, idx, x, scale, ps, out (scale, ps may
// be null).  ints: Bp, q_dt, ldq, qc0, kf, k_dt, ldk, kc0, K, bm, bn,
// dedup, x_dt, ldx, nx, rr, ldps, gsz, accumulate, ldo, oc0, dcol (dtypes:
// 0 bf16, 1 f32, 2 int8 for x with scale).  The logits run on mma.sync
// where q and k are bf16, the product where x is bf16 or int8.  Returns a
// CUDA error code.
extern "C" int hier_rows_launch(const void* const* ptrs, const int* ints, void* stream) {
  RowsArgs a;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.mask = static_cast<const float*>(ptrs[2]);
  a.idx = static_cast<const int*>(ptrs[3]);
  a.x = ptrs[4];
  a.scale = static_cast<const float*>(ptrs[5]);
  a.ps = static_cast<float*>(const_cast<void*>(ptrs[6]));
  a.out = static_cast<float*>(const_cast<void*>(ptrs[7]));
  int* f[] = {&a.Bp, &a.q_dt, &a.ldq, &a.qc0, &a.kf, &a.k_dt, &a.ldk, &a.kc0,
              &a.K, &a.bm, &a.bn, &a.dedup, &a.x_dt, &a.ldx, &a.nx, &a.rr,
              &a.ldps, &a.gsz, &a.accumulate, &a.ldo, &a.oc0, &a.dcol};
  for (int i = 0; i < 22; ++i) *f[i] = ints[i];
  if (a.Bp <= 0 || a.K <= 0) return 0;
  const bool bad =
      !a.q || !a.k || !a.mask || !a.idx || !a.x || !a.out || !dt_ok(a.q_dt, false) ||
      !dt_ok(a.k_dt, false) || !dt_ok(a.x_dt, true) || (a.x_dt == I8) != (a.scale != nullptr) ||
      a.kf <= 0 || a.qc0 < 0 || a.qc0 + a.kf > a.ldq || a.kc0 < 0 || a.kc0 + a.kf > a.ldk ||
      a.bm <= 0 || a.bm % BM || a.Bp % a.bm || a.bn <= 0 || a.nx <= 0 || a.nx > a.ldx ||
      a.oc0 < 0 || a.oc0 + a.nx > a.ldo || a.dcol >= a.ldo || (a.rr && a.scale) ||
      (a.rr && (a.gsz <= 0 || a.bn % a.gsz || (a.ps && a.ldps < a.K * (a.bn / a.gsz))));
  if (bad) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Bp + BM - 1) / BM, (a.nx + NC - 1) / NC);
  const bool ltc = a.q_dt == BF16 && a.k_dt == BF16, vtc = a.x_dt != F32;
  a.ring = ring_slots([&](int r) { return layout(a.kf, ltc, vtc, true, a.K, r).total; });
  if (!a.ring) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(a.kf, ltc, vtc, true, a.K, a.ring).total;
  a.vec_l = (ltc || (a.q_dt == F32 && a.k_dt == F32)) && vec16(a.q, a.q_dt, a.ldq, a.qc0, a.kf) &&
            vec16(a.k, a.k_dt, a.ldk, a.kc0, a.kf);
  a.vec_v = a.x_dt != I8 && vec16(a.x, a.x_dt, a.ldx, 0, a.nx);
  auto fn = ltc ? (vtc ? rows_kernel<true, true> : rows_kernel<true, false>)
                : (vtc ? rows_kernel<false, true> : rows_kernel<false, false>);
  return launch(fn, a, grid, smem, static_cast<cudaStream_t>(stream));
}

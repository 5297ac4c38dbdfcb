// Shared device helpers of the hierarchical kernels: 16- and 4-byte
// cp.async copies, bf16 mma.sync m16n8k16 with f32 accumulation, and the
// transposed ldmatrix that loads B fragments from a row-major [k][n] tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hier {

constexpr float CLAMP2 = 86.0f;      // exp2 clamp of the packed logits
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory of one block, sm_90

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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

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

// A fragment of the m16 x k16 tile at (row0, k0) of a row-major bf16 tile
// with row stride ld (in elements); lane = 4 g + t.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int k0, int g, int t) {
  const __nv_bfloat16* r0 = tile + (row0 + g) * ld + k0 + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B fragment of the k16 x n8 tile whose column n is ROW n0 + g of a
// row-major [n][k] tile (B = tile^T): the logits q . k of a key tile.
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* tile,
                                        int ld, int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = tile + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragments of two n8 tiles (columns c0 .. c0 + 15) of the k16 step at
// row k0 of a row-major [k][n] tile: b[0..1] tile c0, b[2..3] tile c0 + 8.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                            int k0, int c0, int lane) {
  const int mat = lane >> 3, rr = lane & 7;
  const __nv_bfloat16* p = tile + (k0 + rr + (mat & 1) * 8) * ld + c0 + (mat >> 1) * 8;
  ldmatrix_x4_trans(b[0], b[1], b[2], b[3], p);
}

}  // namespace hier

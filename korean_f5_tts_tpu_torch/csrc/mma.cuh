// Warp-level bf16 tensor-core helpers shared by the hand-written kernels.
//
// Everything here is mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by
// ldmatrix from shared memory. Fragment layouts (PTX ISA, "Matrix fragments
// for mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A 16x16 row-major: a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 8+2t..)   a3 (g+8, 8+2t..)
//   B 16x8  "col":     b0 (k=2t..2t+1, n=g)               b1 (k=8+2t.., n=g)
//   C 16x8  fp32:      c0,c1 (g, 2t..2t+1)                c2,c3 (g+8, 2t..2t+1)
// Shared tiles use a row stride of (width + 8) bf16 so that the eight 16-byte
// row segments one ldmatrix phase reads fall into distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace f5 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16) * b (16x8)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Low half holds `lo` (the smaller column index of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address one lane passes to ldmatrix_x4 for the 16x16 A tile whose top-left
// element is `tile` in a row-major array of row stride `ld`.
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* tile, int ld, int lane) {
  return tile + (lane & 15) * ld + (lane >> 4) * 8;
}

// B operand stored [n][k] (k contiguous, the layout of a torch Linear weight
// and of K in q.k^T): ldmatrix_x4 at this address yields {b0, b1} of n-tile
// 0 in r[0], r[1] and of n-tile 1 (n + 8) in r[2], r[3].
__device__ __forceinline__ const bf16* b_nk_addr(const bf16* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}

// B operand stored [k][n] (n contiguous, the layout of V in p.V and of the
// [k, cg, c_out] conv weight): ldmatrix_x4_trans at this address yields the
// same register order as b_nk_addr.
__device__ __forceinline__ const bf16* b_kn_addr(const bf16* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

}  // namespace f5

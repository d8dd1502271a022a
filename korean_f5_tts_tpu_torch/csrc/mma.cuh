// Warp-level tensor-core helpers shared by the hand-written kernels: mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), m16n8k8 .tf32 and m16n8k32 .s8 below,
// fed by ldmatrix from shared memory. Fragment layouts (PTX ISA, "Matrix fragments
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

// sum and max over the four lanes of a quad (the lanes that share an
// accumulator row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
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

// ---------------------------------------------------------------------------
// TF32 (mma.sync m16n8k8 .tf32, fp32 accumulate) and the split "3xTF32"
// product that keeps fp32 accuracy: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (x - hi is exact in fp32), and
//   a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b,
// dropping lo_a.lo_b (about 2^-22 of |a||b|). Fragment layouts (PTX ISA,
// "Matrix fragments for mma.m16n8k8", .tf32), g = lane / 4, t = lane % 4:
//   A 16x8 row-major: a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B 8x8  "col":     b0 (k=t, n=g)             b1 (k=t+4, n=g)
//   C 16x8 fp32:      c0,c1 (g, 2t..2t+1)       c2,c3 (g+8, 2t..2t+1)
// A tile of 32-bit elements stored row-major with its contraction index
// contiguous is read by ldmatrix (b16) as 8 x 4 blocks: lane l receives
// element l % 4 of row l / 4, which is the A fragment's and, for a tile
// stored [n][k], the B fragment's layout. A C fragment serves as the A
// fragment of the next product over the same 8 columns when those columns
// are taken in the order 2t, 2t + 1 for t, t + 4: a0 = c0, a1 = c2,
// a2 = c1, a3 = c3, with the B rows read in the same order.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8) * b (8x8)
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32_1688(d, al, bh0, bh1);
  mma_tf32_1688(d, ah, bl0, bl1);
  mma_tf32_1688(d, ah, bh0, bh1);
}

// ---------------------------------------------------------------------------
// int8 (mma.sync m16n8k32 .s32.s8.s8, exact int32 accumulation). Fragment
// layouts (PTX ISA, "Matrix fragments for mma.m16n8k32", 8-bit), four bytes
// a register, g = lane / 4, t = lane % 4:
//   A 16x32 row: a0 (g, 4t..4t+3)  a1 (g+8, 4t..)  a2 (g, 16+4t..)  a3 (g+8, 16+4t..)
//   B 32x8 col:  b0 (k 4t..4t+3, n g)             b1 (k 16+4t.., n g)
//   C 16x8 s32:  c0,c1 (g, 2t..2t+1)              c2,c3 (g+8, 2t..2t+1)
// The accumulator has the .tf32 product's layout. A 16-byte row segment of
// int8 is eight b16 pairs, so ldmatrix (b16) on a tile stored [n][k] (k
// contiguous) gives B: i8_b_nk_addr's rows, as b_nk_addr's for bf16.
// ---------------------------------------------------------------------------

// d += a (16x32) * b (32x8)
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Address one lane passes to ldmatrix_x4 for the 32-deep int8 B fragments of
// keys [0, 16) (two n-tiles) of a [n][k] tile of row stride `ld` bytes: {b0,
// b1} of n-tile 0 in r[0], r[1] and of n-tile 1 in r[2], r[3]
__device__ __forceinline__ const int8_t* i8_b_nk_addr(const int8_t* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 16;
}

}  // namespace f5

// Int8 building blocks shared by the int8 TMA + wgmma core (gemm_int8.cuh:
// kernels 4, 5, 6, 9) and by kernel 14's mma.sync products
// (flash_prefix_int8.cu): the 16-byte row loads as fp32, the warp
// reductions, the tanh-GELU of the int8 epilogues, the segment pick of a
// three-weight product, and the int8 mma.sync fragment addressing.
//
// The quantization these kernels share is the TPU kernels'
// (korean_f5_tts_tpu/ops/ff_block.py:94-98, fused_linears.py:103-106,
// qmatmul.py:25-28). For each row r of fp32 values y:
//   s_r = max(max|y_r|, 1e-6) / 127           (fp32)
//   q   = clip(rint(y / s_r), -127, 127)       (IEEE division, ties to even)
//   out = acc * s_r * w_scale[c] + b[c]        (acc = exact int32 sum of q * w_int8)
// then any activation in fp32, and one rounding at the end.
//
// mma.sync m16n8k32 s8 x s8 -> s32 (IMMA) fragment layouts (PTX ISA,
// "Matrix fragments for mma.m16n8k32", 8-bit), g = lane / 4, t = lane % 4:
//   A 16x32 row: a0 (g, 4t..4t+3)  a1 (g+8, 4t..)  a2 (g, 16+4t..)  a3 (g+8, 16+4t..)
//   B 32x8 col:  b0 (k 4t..4t+3, n g)             b1 (k 16+4t.., n g)
//   C 16x8 s32:  c0,c1 (g, 2t..2t+1)              c2,c3 (g+8, 2t..2t+1)
// A 16-byte row segment of int8 is eight b16 pairs, so ldmatrix (b16) loads
// these fragments unchanged from rows padded to 80 bytes (the eight 16-byte
// segments of one ldmatrix phase then fall into distinct bank groups).
#pragma once

#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kMaxSegments = 3;

enum QuantSource { kSrcBf16 = 0, kSrcF32 = 1 };

__device__ __forceinline__ float i8_gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float i8_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float i8_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// eight consecutive values of row element offset `off`, as fp32
template <int SRC>
__device__ __forceinline__ void load8(const void* x, size_t off, float (&v)[8]) {
  if constexpr (SRC == kSrcF32) {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + off + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const int4 raw = *reinterpret_cast<const int4*>(static_cast<const bf16*>(x) + off);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  }
}

// d += a (16x32 s8) * b (32x8 s8), s32 accumulate
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix_x4 address for the 16x32 int8 A tile at `tile` (row stride ld bytes)
__device__ __forceinline__ const int8_t* i8_a_frag_addr(const int8_t* tile, int ld, int lane) {
  return tile + (lane & 15) * ld + (lane >> 4) * 16;
}

// ldmatrix_x4 address for two 8-column n-tiles of a B operand stored [n][k]
// (k contiguous): r[0], r[1] = {b0, b1} of n-tile 0, r[2], r[3] of n-tile 1
__device__ __forceinline__ const int8_t* i8_b_nk_addr(const int8_t* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 16;
}

template <typename T>
__device__ __forceinline__ T pick(const T (&arr)[kMaxSegments], int seg) {
  return seg == 0 ? arr[0] : (seg == 1 ? arr[1] : arr[2]);
}

}  // namespace
}  // namespace f5

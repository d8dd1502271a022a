// Int8 building blocks of the int8 TMA + wgmma core (gemm_int8.cuh: kernels
// 4, 5, 6, 9): the 16-byte row loads as fp32, the warp reductions, the
// tanh-GELU of the int8 epilogues and the segment pick of a three-weight
// product. (Kernel 14's 8-bit fragments are attn_wgmma.cuh's.)
//
// The quantization these kernels share is the TPU kernels'
// (korean_f5_tts_tpu/ops/ff_block.py:94-98, fused_linears.py:103-106,
// qmatmul.py:25-28). For each row r of fp32 values y:
//   s_r = max(max|y_r|, 1e-6) / 127           (fp32)
//   q   = clip(rint(y / s_r), -127, 127)       (IEEE division, ties to even)
//   out = acc * s_r * w_scale[c] + b[c]        (acc = exact int32 sum of q * w_int8)
// then any activation in fp32, and one rounding at the end.

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

template <typename T>
__device__ __forceinline__ T pick(const T (&arr)[kMaxSegments], int seg) {
  return seg == 0 ? arr[0] : (seg == 1 ? arr[1] : arr[2]);
}

}  // namespace
}  // namespace f5

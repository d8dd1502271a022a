// Prefix-masked flash attention with int8 scores on fp32 operands, "qk" mode,
// forward, for Hopper (sm_90a): kernel 14's fp32 form in "qk".
//
// Replaces, on fp32 inputs with pv_i8=False, the TPU kernel
// korean_f5_tts_tpu/ops/flash_prefix.py:_flash_prefix_folded_i8 ->
// _kernel_i8 (via flash_prefix_attention_i8, whose out_dtype is v's dtype,
// :939 and :944). Per folded head h:
//   s   = float(q8 . k8^T) * c[h]           exact integer product, base-2 domain
//   keys at or past kv_lens[h] masked; online max m and sum l in fp32 over
//   128-key tiles, l adding p = exp2(s - m)
//   acc = acc * alpha + p . v               fp32 p times fp32 v, as the JAX
//                                           kernel does on fp32 (:846)
//   out = acc * (1 / l), fp32
// The quantization pass (quant_heads.cu) reads the fp32 q, k, v as they
// are. "qkpv" on fp32 inputs runs on the attention core's int8 form with an
// fp32 output (flash_prefix_int8.cu, kAttnI8QkpvF32): its products are int8
// there, and this kernel exists for the fp32 p.v the core cannot do. The key
// tile is I8_KEY_TILE = 128, the core's, and the plain version
// (ops/flash_prefix.py:_i8_attention_plain at ck = 128) repeats it operation
// for operation: each product and sum of the update rounded once as torch
// rounds them.
//
// Exactness: |q8 . k8| over d = 64 is at most 127^2 * 64 = 1,032,256 < 2^24,
// so FFMA on the integer values (every partial sum an integer below 2^24)
// gives the integer scores exactly. No TF32 product anywhere: p . v is FFMA.
//
// What bounds it on the card: the FFMA products, 4 * H * n * kv * 64 flops
// (17.3 GFLOP at the main shape, H 32, n 1536, 1376 valid keys: 0.26 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores), against 3.1 MB of q8,
// k8, 12.6 MB of fp32 v in and 12.6 MB of fp32 out.
//
// Design: kernel A's fp32 form (flash_prefix.cu) with 128-key tiles. One
// 256-thread block per (head, 64 query rows); thread (ty, tx) of the 16 x
// 16 grid owns rows ty * 4 + i, keys tx * 4 + j and 64 + tx * 4 + j of the
// tile and output columns tx * 4 + j. q8 and k8 land transposed ([c][row])
// as floats, so the score loop reads float4; the v tile lands as [key][c];
// p goes through shared memory, over the K tile, whose readers are done.
// 86 KB of shared memory: two blocks an SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace f5 {
namespace {

constexpr int kI8F32Threads = 256;
constexpr int kI8F32Keys = 128;           // the key tile, I8_KEY_TILE
constexpr int kI8F32LdQ = 64 + 4;         // [c][row] q tile and [key][c] v tile
constexpr int kI8F32LdK = kI8F32Keys + 4;  // [c][key] k tile and [row][key] p tile
constexpr int kI8F32Smem =
    (64 * kI8F32LdQ + 64 * kI8F32LdK + kI8F32Keys * kI8F32LdQ) * (int)sizeof(float);

// rows [row0, row0 + rows) of an int8 [n, 64] head as floats, transposed into
// dst[c][row] of row stride ld; rows at or past n give zeros
__device__ __forceinline__ void load_i8_rows_t(float* dst, int ld, const int8_t* src, int row0,
                                               int rows, int n, int tid) {
  for (int i = tid; i < rows * 16; i += kI8F32Threads) {
    const int r = i % rows, c = (i / rows) * 4;
    char4 v = make_char4(0, 0, 0, 0);
    if (row0 + r < n) v = *reinterpret_cast<const char4*>(src + (size_t)(row0 + r) * 64 + c);
    dst[(c + 0) * ld + r] = (float)v.x;
    dst[(c + 1) * ld + r] = (float)v.y;
    dst[(c + 2) * ld + r] = (float)v.z;
    dst[(c + 3) * ld + r] = (float)v.w;
  }
}

__device__ __forceinline__ float row16_sum_i8(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row16_max_i8(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kI8F32Threads, 2)
flash_prefix_i8_f32_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                           const float* __restrict__ v, const float* __restrict__ cs,
                           const int* __restrict__ kv_lens, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [64 c][68]
  float* sKt = sQt + 64 * kI8F32LdQ;                // [64 c][132], then P [64 rows][132]
  float* sV = sKt + 64 * kI8F32LdK;                 // [128 keys][68]
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)head * n * 64;
  const int kv_len = min(kv_lens[head], n);
  const float c = cs[head];

  load_i8_rows_t(sQt, kI8F32LdQ, q8 + off, q0, 64, n, tid);

  float acc[4][4];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  const int n_tiles = kv_len > 0 ? (kv_len + kI8F32Keys - 1) / kI8F32Keys : 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kI8F32Keys;
    __syncthreads();  // the previous tile's readers are done
    load_i8_rows_t(sKt, kI8F32LdK, k8 + off, k0, kI8F32Keys, n, tid);
    const float* vf = v + off;
    for (int i = tid; i < kI8F32Keys * 16; i += kI8F32Threads) {
      const int r = i >> 4, cc = (i & 15) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n) val = *reinterpret_cast<const float4*>(vf + (size_t)(k0 + r) * 64 + cc);
      *reinterpret_cast<float4*>(sV + r * kI8F32LdQ + cc) = val;
    }
    __syncthreads();

    // integer scores, exact in fp32
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < 64; ++cc) {
      const float4 a = *reinterpret_cast<const float4*>(sQt + cc * kI8F32LdQ + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sKt + cc * kI8F32LdK + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sKt + cc * kI8F32LdK + 64 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    __syncthreads();  // every read of the K tile is done: P goes over it

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j >> 2) * 64 + tx * 4 + (j & 3);
        s[i][j] = key < kv_len ? __fmul_rn(s[i][j], c) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // tile 0 holds key 0 < kv_len: the running max is finite from then on
      const float m_new = fmaxf(m_run[i], row16_max_i8(mx));
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_run[i] = __fadd_rn(__fmul_rn(alpha[i], l_run[i]), row16_sum_i8(rs));
      float* prow = sKt + (ty * 4 + i) * kI8F32LdK + tx * 4;
      *reinterpret_cast<float4*>(prow) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(prow + 64) = make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncthreads();

    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
#pragma unroll 8
    for (int key = 0; key < kI8F32Keys; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sKt[(ty * 4 + i) * kI8F32LdK + key];
      const float4 b = *reinterpret_cast<const float4*>(sV + key * kI8F32LdQ + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[i][j] = fmaf(p[i], bv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha[i]), pv[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
    const float inv = l_run[i] == 0.f ? 1.f : __fdiv_rn(1.f, l_run[i]);  // kv_len 0: zeros
    *reinterpret_cast<float4*>(out + off + (size_t)row * 64 + tx * 4) =
        make_float4(__fmul_rn(acc[i][0], inv), __fmul_rn(acc[i][1], inv),
                    __fmul_rn(acc[i][2], inv), __fmul_rn(acc[i][3], inv));
  }
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 64] int8; v: fp32 [H, n, 64]; c: [H] fp32; kv_lens: [H]
// int32; out: [H, n, 64] fp32. All 16-byte aligned.
extern "C" int f5_flash_prefix_i8_qk_f32_fwd(const void* q8, const void* k8, const void* v,
                                             const void* c, const void* kv_lens, void* out,
                                             int H, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(f5::flash_prefix_i8_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, f5::kI8F32Smem);
  if (err != cudaSuccess) return (int)err;
  f5::flash_prefix_i8_f32_kernel<<<dim3((n + 63) / 64, H), f5::kI8F32Threads, f5::kI8F32Smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const float*>(v), static_cast<const float*>(c),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

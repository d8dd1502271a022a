// Dynamic-int8 building blocks of kernel 9 (qmatmul.cu) and of kernel 14's
// fragment addressing (flash_prefix_int8.cu): per-row activation
// quantization and an int8 mma.sync product with a fused fp32 epilogue.
// Kernels 4, 5 and 6 left this product for the TMA + wgmma core of
// gemm_int8.cuh, which still takes load8, the warp reductions, i8_gelu_tanh,
// pick and kMaxSegments from here; 9 follows it next, and then
// i8_gemm_kernel and quant_rows_kernel (whose LN and fp32 sources nothing
// instantiates any more) go.
//
// The function is the TPU kernels' (korean_f5_tts_tpu/ops/ff_block.py:94-98,
// fused_linears.py:103-106, qmatmul.py:25-28). For each row r of fp32 values y:
//   s_r = max(max|y_r|, 1e-6) / 127           (fp32)
//   q   = clip(rint(y / s_r), -127, 127)       (IEEE division, ties to even)
//   out = acc * s_r * w_scale[c] + b[c]        (acc = exact int32 sum of q * w_int8)
// then any activation in fp32, and one rounding at the end.
// The divisions and the epilogue use the _rn intrinsics: no reciprocal
// multiply, and no fused multiply-add that would round differently from the
// plain versions (nvcc contracts a * b + c by default).
//
// Why a separate quantization pass: the scale of a row needs the whole row
// before any product term, and a GEMM block owns only a 128-column slice of
// the output. One warp per row reads the row once (and, for the LN prologue,
// its statistics), writes q in int8 (half the bytes of bf16) and s in fp32;
// the product then reads int8 operands only. This is the TPU kernel's own
// rounding point, written to memory instead of kept in VMEM.
//
// Product: 64x128 output tiles on four warps (2 x 2, 32x64 each), k-steps of
// 64 int8 through shared memory, mma.sync m16n8k32 s8 x s8 -> s32 (IMMA).
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k32", 8-bit),
// g = lane / 4, t = lane % 4:
//   A 16x32 row: a0 (g, 4t..4t+3)  a1 (g+8, 4t..)  a2 (g, 16+4t..)  a3 (g+8, 16+4t..)
//   B 32x8 col:  b0 (k 4t..4t+3, n g)             b1 (k 16+4t.., n g)
//   C 16x8 s32:  c0,c1 (g, 2t..2t+1)              c2,c3 (g+8, 2t..2t+1)
// A 16-byte row segment of int8 is eight b16 pairs, so ldmatrix (b16) loads
// these fragments unchanged; rows are padded to 80 bytes so the eight 16-byte
// segments of one ldmatrix phase fall into distinct bank groups. Rows past M
// are zero-filled and never stored. Simple first: synchronous loads, no
// cp.async ring and no wgmma; those are later work.
#pragma once

#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kQuantWarps = 4;  // rows per quantization block, one warp each
constexpr int kGBM = 64;        // product tile rows
constexpr int kGBN = 128;       // product tile columns
constexpr int kGBK = 64;        // k per step (int8 elements = bytes)
constexpr int kGLDS = kGBK + 16;
constexpr int kGThreads = 128;
constexpr int kMaxSegments = 3;

enum QuantSource { kSrcBf16 = 0, kSrcLnMod = 1, kSrcF32 = 2 };

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

// the values to quantize: x itself, or LN(x) * (1 + sc) + sh at columns c..c+7
template <int SRC>
__device__ __forceinline__ void values8(const void* x, size_t off, int c, const bf16* sc,
                                        const bf16* sh, float mu, float rstd, float (&v)[8]) {
  load8<SRC>(x, off, v);
  if constexpr (SRC == kSrcLnMod) {
    const int4 scr = *reinterpret_cast<const int4*>(sc + c);
    const int4 shr = *reinterpret_cast<const int4*>(sh + c);
    const bf16* sce = reinterpret_cast<const bf16*>(&scr);
    const bf16* she = reinterpret_cast<const bf16*>(&shr);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xn = __fmul_rn(__fsub_rn(v[i], mu), rstd);
      v[i] = __fadd_rn(__fmul_rn(xn, __fadd_rn(1.f, __bfloat162float(sce[i]))),
                       __bfloat162float(she[i]));
    }
  }
}

// One warp per row: q [M, K] int8 and s [M] fp32 from x [M, K] (bf16 or fp32),
// optionally through the LN + modulation prologue. K % 8 == 0.
template <int SRC>
__global__ void __launch_bounds__(kQuantWarps * 32)
quant_rows_kernel(const void* __restrict__ x, const bf16* __restrict__ sc,
                  const bf16* __restrict__ sh, int8_t* __restrict__ q, float* __restrict__ s,
                  int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = (size_t)row * K;
  float mu = 0.f, rstd = 0.f;
  if constexpr (SRC == kSrcLnMod) {  // two-pass fp32 statistics
    float sum = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      load8<SRC>(x, base + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[i];
    }
    mu = i8_warp_sum(sum) / K;
    float var = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      load8<SRC>(x, base + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dlt = v[i] - mu;
        var += dlt * dlt;
      }
    }
    rstd = 1.f / sqrtf(i8_warp_sum(var) / K + eps);
  }
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    values8<SRC>(x, base + c, c, sc, sh, mu, rstd, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  const float scale = __fdiv_rn(fmaxf(i8_warp_max(amax), 1e-6f), 127.f);
  for (int c = lane * 8; c < K; c += 256) {
    float v[8];
    values8<SRC>(x, base + c, c, sc, sh, mu, rstd, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = min(max(__float2int_rn(__fdiv_rn(v[i], scale)), -127), 127);
      packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)qi << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(q + base + c) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) s[row] = scale;
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

struct GemmArgs {
  const int8_t* a;                 // [M, K] quantized activations
  const float* a_scale;            // [M]
  const int8_t* w[kMaxSegments];   // weight segments, each [seg_n, K] (torch layout)
  const float* w_scale[kMaxSegments];
  const bf16* bias[kMaxSegments];  // null: no bias
  int seg_n;                       // columns per segment; N = segments * seg_n
  bf16* out;                       // [M, N]
  int M, N, K;
  int gelu;                        // tanh-GELU after the bias
};

template <typename T>
__device__ __forceinline__ T pick(const T (&arr)[kMaxSegments], int seg) {
  return seg == 0 ? arr[0] : (seg == 1 ? arr[1] : arr[2]);
}

__global__ void __launch_bounds__(kGThreads) i8_gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) int8_t sA[kGBM * kGLDS];
  __shared__ __align__(16) int8_t sB[kGBN * kGLDS];
  const int n0 = blockIdx.x * kGBN;
  const int m0 = blockIdx.y * kGBM;
  const int seg = n0 / p.seg_n;
  const int sn0 = n0 - seg * p.seg_n;  // first column inside the segment
  const int8_t* __restrict__ w = pick(p.w, seg);
  const float* __restrict__ w_scale = pick(p.w_scale, seg);
  const bf16* __restrict__ bias = pick(p.bias, seg);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 1, warp_n = warp >> 1;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kGBK) {
    for (int i = tid; i < kGBM * (kGBK / 16); i += kGThreads) {
      const int r = i / (kGBK / 16);
      const int c = (i % (kGBK / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const int4*>(p.a + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(sA + r * kGLDS + c) = v;
    }
    for (int i = tid; i < kGBN * (kGBK / 16); i += kGThreads) {
      const int r = i / (kGBK / 16);
      const int c = (i % (kGBK / 16)) * 16;
      *reinterpret_cast<int4*>(sB + r * kGLDS + c) =
          *reinterpret_cast<const int4*>(w + (size_t)(sn0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], i8_a_frag_addr(sA + (warp_m * 32 + mi * 16) * kGLDS + kk, kGLDS, lane));
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, i8_b_nk_addr(sB + (warp_n * 64 + ni * 8) * kGLDS + kk, kGLDS, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8_16832(acc[mi][ni], a[mi], b[0], b[1]);
          mma_s8_16832(acc[mi][ni + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int scol = sn0 + warp_n * 64 + ni * 8 + 2 * t;  // column inside the segment
    const int col = n0 + warp_n * 64 + ni * 8 + 2 * t;
    const float ws0 = w_scale[scol], ws1 = w_scale[scol + 1];
    const float bb0 = bias ? __bfloat162float(bias[scol]) : 0.f;
    const float bb1 = bias ? __bfloat162float(bias[scol + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        const float as = p.a_scale[row];
        float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half]), as), ws0);
        float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), as), ws1);
        if (bias) {
          v0 = __fadd_rn(v0, bb0);
          v1 = __fadd_rn(v1, bb1);
        }
        if (p.gelu) {
          v0 = i8_gelu_tanh(v0);
          v1 = i8_gelu_tanh(v1);
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)row * N + col) = pack_bf16x2(v0, v1);
      }
    }
  }
}

// Row quantization of x [M, K] into q, s. K % 8 == 0 (callers check K % 64).
template <int SRC>
cudaError_t launch_quant_rows(const void* x, const bf16* sc, const bf16* sh, int8_t* q, float* s,
                              int M, int K, float eps, cudaStream_t stream) {
  quant_rows_kernel<SRC><<<(M + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, stream>>>(
      x, sc, sh, q, s, M, K, eps);
  return cudaGetLastError();
}

inline cudaError_t launch_i8_gemm(const GemmArgs& p, cudaStream_t stream) {
  const int m_tiles = (p.M + kGBM - 1) / kGBM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  i8_gemm_kernel<<<dim3(p.N / kGBN, m_tiles), kGThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Shapes every int8 product takes: M > 0 rows, K % 64, segment width % 128.
inline bool i8_shapes_ok(int M, int K, int seg_n) {
  return M > 0 && K > 0 && seg_n > 0 && K % kGBK == 0 && seg_n % kGBN == 0;
}

// GemmArgs for one weight (one segment)
inline GemmArgs i8_args(const int8_t* a, const float* a_scale, const void* w, const void* w_scale,
                        const void* bias, void* out, int M, int N, int K) {
  GemmArgs p{};
  p.a = a;
  p.a_scale = a_scale;
  p.w[0] = static_cast<const int8_t*>(w);
  p.w_scale[0] = static_cast<const float*>(w_scale);
  p.bias[0] = static_cast<const bf16*>(bias);
  p.seg_n = N;
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  return p;
}

}  // namespace
}  // namespace f5

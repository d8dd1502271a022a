// fp32 form of the FF half-block's two products (ff_block.cu: kernel B on
// fp32 operands) and of kernels 7 and 8 (fused_linears.cu: the qkv product
// after LN and the modulation, over up to three weight segments, and the
// out-projection folded into the gated residual), for the offline entry
// points, which keep fp32 weights unless told otherwise.
//
// Products: plain FFMA on shared-memory tiles. Hopper's tensor cores have no
// fp32 product: a single TF32 mma keeps 10 mantissa bits and does not hold
// fp32 parity, and a split 3xTF32 design triples the tensor work and still
// needs care at the low bits. FFMA is exact fp32, bounded by the card's 67
// TFLOP/s outside the tensor cores, and simple; speed is not the point of
// this form.
//
// Both kernels compute a 128 x 128 output tile with 256 threads, 8 x 8
// outputs a thread (two 4-wide groups 64 apart in each direction, so every
// shared-memory read is one conflict-free float4), k steps of 16. Tiles are
// stored k-major ([k][row]) so that the inner loop reads rows and columns as
// float4. ln_mod_gemm_f32_kernel forms y = LN(h) * (1 + sc) + sh on the way
// into shared memory from the row statistics of ln_stats_kernel
// (gemm_bf16.cuh); nothing is rounded below fp32. Rows past M are zero-filled
// and never stored; N % 128 == 0 and K % 16 == 0.
#pragma once

#include "gemm_bf16.cuh"

namespace f5 {
namespace {

constexpr int kFT = 128;        // tile rows and columns
constexpr int kFK = 16;         // k step
constexpr int kFLD = kFT + 4;   // row stride of a [k][row] tile: keeps float4 alignment
constexpr int kFThreads = 256;

__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// rows [r0, r0 + 128) x cols [k0, k0 + 16) of a row-major [rows, ld] array,
// transposed into dst[k][row]; rows at or past `rows` give zeros. kLnMod
// applies (x - mu) * rstd * (1 + sc[k]) + sh[k] on the way.
template <bool kLnMod>
__device__ __forceinline__ void load_tile_t(float* dst, const float* __restrict__ src, int ld,
                                            int r0, int rows, int k0, int tid,
                                            const float* __restrict__ stats, int M,
                                            const float* __restrict__ sc,
                                            const float* __restrict__ sh) {
#pragma unroll
  for (int it = 0; it < kFT * (kFK / 4) / kFThreads; ++it) {
    const int i = tid + it * kFThreads;
    const int r = i / (kFK / 4);
    const int kq = (i % (kFK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld + k0 + kq);
      if (kLnMod) {
        const float mu = stats[r0 + r], rstd = stats[M + r0 + r];
        const float4 s = *reinterpret_cast<const float4*>(sc + k0 + kq);
        const float4 b = *reinterpret_cast<const float4*>(sh + k0 + kq);
        v.x = (v.x - mu) * rstd * (1.f + s.x) + b.x;
        v.y = (v.y - mu) * rstd * (1.f + s.y) + b.y;
        v.z = (v.z - mu) * rstd * (1.f + s.z) + b.z;
        v.w = (v.w - mu) * rstd * (1.f + s.w) + b.w;
      }
    }
    dst[(kq + 0) * kFLD + r] = v.x;
    dst[(kq + 1) * kFLD + r] = v.y;
    dst[(kq + 2) * kFLD + r] = v.z;
    dst[(kq + 3) * kFLD + r] = v.w;
  }
}

// acc[i][j] += sum_k sA[k][rows of this thread] * sB[k][cols of this thread]
__device__ __forceinline__ void ffma_step(const float* sA, const float* sB, float (&acc)[8][8],
                                          int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kFK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sA + k * kFLD + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(sA + k * kFLD + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sB + k * kFLD + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(sB + k * kFLD + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the product loop of both kernels: a [M, K] (through LN and the modulation
// when kLnMod), w [N, K], this block's tile at (m0, n0)
template <bool kLnMod>
__device__ __forceinline__ void gemm_f32_tile(float (&acc)[8][8], float* sA, float* sB,
                                              const float* a, const float* w, int M, int N, int K,
                                              int m0, int n0, const float* stats, const float* sc,
                                              const float* sh) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    load_tile_t<kLnMod>(sA, a, K, m0, M, k0, tid, stats, M, sc, sh);
    load_tile_t<false>(sB, w, K, n0, N, k0, tid, nullptr, 0, nullptr, nullptr);
    __syncthreads();
    ffma_step(sA, sB, acc, ty, tx);
    __syncthreads();
  }
}

// out[M, nseg * seg_n] = act(LN(h) * (1 + sc) + sh) @ [W0; W1; W2]^T + [b0; b1; b2]),
// all fp32: up to three weights [seg_n, d] read as segments of the output's
// columns (seg_n % 128 == 0, so a column tile lies in one segment)
template <bool kGelu>
__global__ void __launch_bounds__(kFThreads)
ln_mod_gemm_f32_kernel(const float* __restrict__ h, const float* __restrict__ stats,
                       const float* __restrict__ sc, const float* __restrict__ sh,
                       const float* __restrict__ w0, const float* __restrict__ w1,
                       const float* __restrict__ w2, const float* __restrict__ b0,
                       const float* __restrict__ b1, const float* __restrict__ b2,
                       float* __restrict__ out, int M, int seg_n, int nseg, int d) {
  __shared__ __align__(16) float sA[kFK * kFLD];
  __shared__ __align__(16) float sB[kFK * kFLD];
  const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
  const int seg = n0 / seg_n, nl = n0 - seg * seg_n, N = nseg * seg_n;
  const float* w = seg == 0 ? w0 : (seg == 1 ? w1 : w2);
  const float* b = seg == 0 ? b0 : (seg == 1 ? b1 : b2);
  float acc[8][8];
  gemm_f32_tile<true>(acc, sA, sB, h, w, M, seg_n, d, m0, nl, stats, sc, sh);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = jh * 64 + tx * 4;
      const float4 bb = *reinterpret_cast<const float4*>(b + nl + col);
      float4 o = make_float4(acc[i][jh * 4] + bb.x, acc[i][jh * 4 + 1] + bb.y,
                             acc[i][jh * 4 + 2] + bb.z, acc[i][jh * 4 + 3] + bb.w);
      if (kGelu) {
        o.x = gelu_tanh_f32(o.x);
        o.y = gelu_tanh_f32(o.y);
        o.z = gelu_tanh_f32(o.z);
        o.w = gelu_tanh_f32(o.w);
      }
      *reinterpret_cast<float4*>(out + (size_t)row * N + n0 + col) = o;
    }
  }
}

// out[M, N] = h + gate * (a[M, K] @ W[N, K]^T + b), all fp32
__global__ void __launch_bounds__(kFThreads)
gated_residual_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                               const float* __restrict__ b, const float* __restrict__ h,
                               const float* __restrict__ gate, float* __restrict__ out, int M,
                               int N, int K) {
  __shared__ __align__(16) float sA[kFK * kFLD];
  __shared__ __align__(16) float sB[kFK * kFLD];
  const int n0 = blockIdx.x * kFT, m0 = blockIdx.y * kFT;
  float acc[8][8];
  gemm_f32_tile<false>(acc, sA, sB, a, w, M, N, K, m0, n0, nullptr, nullptr, nullptr);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int col = n0 + jh * 64 + tx * 4;
      const float4 bb = *reinterpret_cast<const float4*>(b + col);
      const float4 gg = *reinterpret_cast<const float4*>(gate + col);
      const float4 hv = *reinterpret_cast<const float4*>(h + (size_t)row * N + col);
      *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
          make_float4(hv.x + gg.x * (acc[i][jh * 4] + bb.x), hv.y + gg.y * (acc[i][jh * 4 + 1] + bb.y),
                      hv.z + gg.z * (acc[i][jh * 4 + 2] + bb.z),
                      hv.w + gg.w * (acc[i][jh * 4 + 3] + bb.w));
    }
  }
}

// the row statistics, then ln_mod_gemm_f32_kernel; d % 16 == 0, seg_n % 128 == 0
template <bool kGelu>
cudaError_t launch_ln_mod_gemm_f32(const void* h, const void* sc, const void* sh,
                                   const void* const (&w)[3], const void* const (&b)[3],
                                   void* stats, void* out, int M, int d, int seg_n, int nseg,
                                   float eps, cudaStream_t stream) {
  const int m_tiles = (M + kFT - 1) / kFT;
  if (M <= 0 || d <= 0 || d % kFK != 0 || seg_n <= 0 || seg_n % kFT != 0 || nseg < 1 ||
      nseg > 3 || m_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_ln_stats<float>(h, stats, M, d, eps, stream);
  if (err != cudaSuccess) return err;
  typedef const float* P;
  ln_mod_gemm_f32_kernel<kGelu><<<dim3(nseg * seg_n / kFT, m_tiles), kFThreads, 0, stream>>>(
      static_cast<P>(h), static_cast<P>(stats), static_cast<P>(sc), static_cast<P>(sh),
      static_cast<P>(w[0]), static_cast<P>(w[1]), static_cast<P>(w[2]), static_cast<P>(b[0]),
      static_cast<P>(b[1]), static_cast<P>(b[2]), static_cast<float*>(out), M, seg_n, nseg, d);
  return cudaGetLastError();
}

// out = h + gate * (a @ W^T + b); K % 16 == 0, N % 128 == 0
inline cudaError_t launch_gated_residual_gemm_f32(const void* a, const void* w, const void* b,
                                                  const void* h, const void* gate, void* out,
                                                  int M, int N, int K, cudaStream_t stream) {
  const int m_tiles = (M + kFT - 1) / kFT;
  if (M <= 0 || K <= 0 || K % kFK != 0 || N <= 0 || N % kFT != 0 || m_tiles > 65535)
    return cudaErrorInvalidValue;
  typedef const float* P;
  gated_residual_gemm_f32_kernel<<<dim3(N / kFT, m_tiles), kFThreads, 0, stream>>>(
      static_cast<P>(a), static_cast<P>(w), static_cast<P>(b), static_cast<P>(h),
      static_cast<P>(gate), static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

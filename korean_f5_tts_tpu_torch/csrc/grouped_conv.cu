// Grouped conv1d (SAME padding) + bias + optional Mish for Hopper (sm_90a):
// ConvPositionEmbedding's two convolutions (k = 31, 16 groups of 64).
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/grouped_conv.py:_gc_kernel
// (via grouped_conv1d_mish). x, out: [B, N, C] bf16 channels-last;
// w: [k, cg, C] bf16 in the JAX layout (group-major output channels, so
// out[.., g*cg + o] = sum_t sum_i x[.. + t - k/2, g*cg + i] * w[t, i, g*cg + o]);
// b: [C] bf16 or null. Accumulation, bias and Mish in fp32, one cast.
//
// What bounds it on the card: at the main-path shape (B = 2, N = 1536,
// C = 1024, k = 31) a call is 12.5 GFLOP against 6 MB of activations and
// 2 MB of weights: the tensor cores bound it, provided the 31-fold reuse of
// each input row stays on chip instead of being unfolded in device memory.
//
// Design: implicit GEMM, one 256-thread block per (128 output rows, group,
// batch item). The block loads its input window (128 + k - 1 rows x 64
// channels) into shared memory once; each tap t is then an [128 x 64] x
// [64 x 64] product whose A operand is the window shifted by t rows (just an
// ldmatrix address offset). One group's weights, 31 x 64 x 64 x 2 B = 254 KB,
// exceed the 227 KB of shared memory, so they are split by taps: the block
// streams one tap's [64 x 64] weight tile at a time. Eight warps as 4 x 2
// tiles of 32 x 32, mma.sync m16n8k16, fp32 accumulation. The TPU kernel's
// 128-lane block-diagonal group packing (grouped_conv.py:53-63) is a lane
// trade for the TPU's MXU and is not carried over.
#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kCG = 64;        // channels per group (the only width taken)
constexpr int kBM = 128;       // output rows per block
constexpr int kMaxTaps = 33;   // window rows = kBM + k - 1
constexpr int kLD = kCG + 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float mish(float x) {
  // softplus as logaddexp(x, 0), the form jax.nn.softplus computes
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

__global__ void __launch_bounds__(kThreads)
grouped_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, bf16* __restrict__ out, int N, int C,
                    int taps, int fuse_mish) {
  __shared__ __align__(16) bf16 sX[(kBM + kMaxTaps - 1) * kLD];
  __shared__ __align__(16) bf16 sW[kCG * kLD];
  const int n0 = blockIdx.x * kBM;
  const int grp = blockIdx.y;
  const int item = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int pad = taps / 2;
  const int c0 = grp * kCG;
  const bf16* xb = x + (size_t)item * N * C;

  // input window: positions [n0 - pad, n0 + kBM + pad), zero outside [0, N)
  const int rows = kBM + taps - 1;
  for (int i = tid; i < rows * (kCG / 8); i += kThreads) {
    const int r = i / (kCG / 8);
    const int c = (i % (kCG / 8)) * 8;
    const int pos = n0 - pad + r;
    int4 val = make_int4(0, 0, 0, 0);
    if (pos >= 0 && pos < N) val = *reinterpret_cast<const int4*>(xb + (size_t)pos * C + c0 + c);
    *reinterpret_cast<int4*>(sX + r * kLD + c) = val;
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int t = 0; t < taps; ++t) {
    // this tap's weights w[t, :, c0:c0+64] as a [k = in][n = out] tile
    for (int i = tid; i < kCG * (kCG / 8); i += kThreads) {
      const int r = i / (kCG / 8);
      const int c = (i % (kCG / 8)) * 8;
      *reinterpret_cast<int4*>(sW + r * kLD + c) =
          *reinterpret_cast<const int4*>(w + ((size_t)t * kCG + r) * C + c0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCG; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], a_frag_addr(sX + (t + warp_m * 32 + mi * 16) * kLD + kk, kLD, lane));
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_kn_addr(sW + kk * kLD + warp_n * 32 + ni * 8, kLD, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][ni], a[mi], b[0], b[1]);
          mma_bf16_16816(acc[mi][ni + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // sW is rewritten by the next tap
  }

  const int g = lane >> 2, tq = lane & 3;
  bf16* ob = out + (size_t)item * N * C;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = c0 + warp_n * 32 + ni * 8 + 2 * tq;
    const float bb0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float bb1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = n0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (row < N) {
          float v0 = acc[mi][ni][2 * half] + bb0;
          float v1 = acc[mi][ni][2 * half + 1] + bb1;
          if (fuse_mish) {
            v0 = mish(v0);
            v1 = mish(v1);
          }
          *reinterpret_cast<uint32_t*>(ob + (size_t)row * C + col) = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

}  // namespace
}  // namespace f5

// C / groups must be 64; taps odd and at most 33.
extern "C" int f5_grouped_conv_fwd(const void* x, const void* w, const void* b, void* out, int B,
                                   int N, int C, int groups, int taps, int fuse_mish, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || N <= 0 || groups <= 0 || C != groups * f5::kCG || taps % 2 == 0 ||
      taps > f5::kMaxTaps || B > 65535 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + f5::kBM - 1) / f5::kBM, groups, B);
  typedef f5::bf16 T;
  f5::grouped_conv_kernel<<<grid, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), N, C, taps, fuse_mish);
  return (int)cudaGetLastError();
}

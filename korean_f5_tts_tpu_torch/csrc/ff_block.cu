// Fused DiT FF half-block for Hopper (sm_90a):
//   out = h + gate * (gelu_tanh((LN(h) * (1 + sc) + sh) @ W1^T + b1) @ W2^T + b2)
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/ff_block.py:_kernel (via
// ff_block_fused). h, out: [M, d] bf16; sc, sh, gate: [d]; W1: [dff, d] and
// W2: [d, dff] (torch Linear layout, k contiguous); b1: [dff]; b2: [d].
// Rounding points follow the TPU kernel: LN and modulation in fp32, y cast to
// bf16 before GEMM1, +b1 and GELU-tanh in fp32, z cast to bf16, +b2 and the
// gated residual in fp32, one cast at the end.
//
// What bounds it on the card: at the main-path shape (M = 3072, d = 1024,
// dff = 2048) a call is 25.8 GFLOP against ~22 MB of h/W/out, so the two
// products bound it. The TPU kernel keeps the whole [rows, dff] GELU tile in
// VMEM; here a 64-row tile of z is 64 * 2048 * 2 B = 256 KB, more than the
// 227 KB of shared memory a block can have.
//
// Design: two kernels with z written once to device memory between them
// (12.6 MB at the main-path shape, read back from L2 in part):
//   gemm1: LN statistics per row, then y = bf16(LN(h)*(1+sc)+sh) is formed
//          tile by tile straight into shared memory as the A operand (y never
//          reaches device memory), z = bf16(gelu_tanh(y @ W1^T + b1));
//   gemm2: out = bf16(h + gate * (z @ W2^T + b2)).
// Both are 64x128 output tiles on four warps (2 x 2, 32x64 each), k-steps of
// 32 through shared memory, mma.sync m16n8k16 with fp32 accumulation. Rows
// past M are zero-filled and never stored. Simple first: no cp.async ring,
// no wgmma; those are later work.
#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLDS = kBK + 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [n0, n0 + 128) x cols [k0, k0 + 32) of a [N, K] weight (N % 128 == 0)
__device__ __forceinline__ void load_b_tile(bf16* sB, const bf16* w, int n0, int k0, int K, int tid) {
  for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    *reinterpret_cast<int4*>(sB + r * kLDS + c) =
        *reinterpret_cast<const int4*>(w + (size_t)(n0 + r) * K + k0 + c);
  }
}

// acc[mi][ni] += sA[warp rows] . sB[warp cols]^T over one kBK step
__device__ __forceinline__ void mma_step(const bf16* sA, const bf16* sB, float (&acc)[2][8][4],
                                         int warp_m, int warp_n, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], a_frag_addr(sA + (warp_m * 32 + mi * 16) * kLDS + kk, kLDS, lane));
#pragma unroll
    for (int ni = 0; ni < 8; ni += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_nk_addr(sB + (warp_n * 64 + ni * 8) * kLDS + kk, kLDS, lane));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16_16816(acc[mi][ni], a[mi], b[0], b[1]);
        mma_bf16_16816(acc[mi][ni + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
ff_gemm1_kernel(const bf16* __restrict__ h, const bf16* __restrict__ sc,
                const bf16* __restrict__ sh, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, bf16* __restrict__ z, int M, int d, int dff,
                float eps) {
  __shared__ __align__(16) bf16 sA[kBM * kLDS];
  __shared__ __align__(16) bf16 sB[kBN * kLDS];
  __shared__ float sMu[kBM];
  __shared__ float sRstd[kBM];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 1, warp_n = warp >> 1;

  // LN statistics (two-pass, fp32), one warp per row
  for (int r = warp; r < kBM; r += kThreads / 32) {
    float mu = 0.f, rstd = 0.f;
    if (m0 + r < M) {
      const bf16* row = h + (size_t)(m0 + r) * d;
      float s = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        const int4 raw = *reinterpret_cast<const int4*>(row + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
      }
      mu = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane * 8; c < d; c += 256) {
        const int4 raw = *reinterpret_cast<const int4*>(row + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = __bfloat162float(e[i]) - mu;
          v += x * x;
        }
      }
      rstd = 1.f / sqrtf(warp_sum(v) / d + eps);
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  float acc[2][8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    // A tile = bf16(LN(h) * (1 + sc) + sh), formed in registers
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      int4 packed = make_int4(0, 0, 0, 0);
      if (m0 + r < M) {
        const int4 xr = *reinterpret_cast<const int4*>(h + (size_t)(m0 + r) * d + k0 + c);
        const int4 scr = *reinterpret_cast<const int4*>(sc + k0 + c);
        const int4 shr = *reinterpret_cast<const int4*>(sh + k0 + c);
        const bf16* xe = reinterpret_cast<const bf16*>(&xr);
        const bf16* sce = reinterpret_cast<const bf16*>(&scr);
        const bf16* she = reinterpret_cast<const bf16*>(&shr);
        uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
        const float mu = sMu[r], rstd = sRstd[r];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float y0 = (__bfloat162float(xe[e]) - mu) * rstd * (1.f + __bfloat162float(sce[e])) +
                           __bfloat162float(she[e]);
          const float y1 = (__bfloat162float(xe[e + 1]) - mu) * rstd *
                               (1.f + __bfloat162float(sce[e + 1])) +
                           __bfloat162float(she[e + 1]);
          pw[e / 2] = pack_bf16x2(y0, y1);
        }
      }
      *reinterpret_cast<int4*>(sA + r * kLDS + c) = packed;
    }
    load_b_tile(sB, w1, n0, k0, d, tid);
    __syncthreads();
    mma_step(sA, sB, acc, warp_m, warp_n, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + warp_n * 64 + ni * 8 + 2 * t;
      const float bb0 = __bfloat162float(b1[col]), bb1 = __bfloat162float(b1[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (row < M)
          *reinterpret_cast<uint32_t*>(z + (size_t)row * dff + col) =
              pack_bf16x2(gelu_tanh(acc[mi][ni][2 * half] + bb0),
                          gelu_tanh(acc[mi][ni][2 * half + 1] + bb1));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ff_gemm2_kernel(const bf16* __restrict__ z, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, const bf16* __restrict__ h,
                const bf16* __restrict__ gate, bf16* __restrict__ out, int M, int d, int dff) {
  __shared__ __align__(16) bf16 sA[kBM * kLDS];
  __shared__ __align__(16) bf16 sB[kBN * kLDS];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 1, warp_n = warp >> 1;

  float acc[2][8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < dff; k0 += kBK) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M) val = *reinterpret_cast<const int4*>(z + (size_t)(m0 + r) * dff + k0 + c);
      *reinterpret_cast<int4*>(sA + r * kLDS + c) = val;
    }
    load_b_tile(sB, w2, n0, k0, dff, tid);
    __syncthreads();
    mma_step(sA, sB, acc, warp_m, warp_n, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + warp_n * 64 + ni * 8 + 2 * t;
      const float bb0 = __bfloat162float(b2[col]), bb1 = __bfloat162float(b2[col + 1]);
      const float gg0 = __bfloat162float(gate[col]), gg1 = __bfloat162float(gate[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (row < M) {
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(h + (size_t)row * d + col);
          const float o0 = __bfloat162float(hv.x) + gg0 * (acc[mi][ni][2 * half] + bb0);
          const float o1 = __bfloat162float(hv.y) + gg1 * (acc[mi][ni][2 * half + 1] + bb1);
          *reinterpret_cast<uint32_t*>(out + (size_t)row * d + col) = pack_bf16x2(o0, o1);
        }
      }
    }
  }
}

}  // namespace
}  // namespace f5

// z: [M, dff] bf16 scratch the caller allocates; d and dff multiples of 128.
extern "C" int f5_ff_block_fwd(const void* h, const void* sc, const void* sh, const void* gate,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* z, void* out, int M, int d, int dff, float eps, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || d % f5::kBN != 0 || dff % f5::kBN != 0) return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + f5::kBM - 1) / f5::kBM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef f5::bf16 T;
  f5::ff_gemm1_kernel<<<dim3(dff / f5::kBN, m_tiles), f5::kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(sc), static_cast<const T*>(sh),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<T*>(z), M, d, dff, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f5::ff_gemm2_kernel<<<dim3(d / f5::kBN, m_tiles), f5::kThreads, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(h), static_cast<const T*>(gate), static_cast<T*>(out), M, d, dff);
  return (int)cudaGetLastError();
}

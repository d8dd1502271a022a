// Probes of the three idioms kernel 19 (flash_prefix_rope.cu) rests on, one
// tiny kernel each, run by scripts/probe_hopper.py against two lines of
// torch. Counterpart of the TPU package's scripts/probe_mosaic.py, which
// probes the Mosaic lowering of the same three idioms (a half-slice product,
// two halves written side by side, the half swap) for _kernel_qkv.
// Each launch is one 128-thread block on 64 rows.
#include "flash_prefix.cuh"

namespace f5 {
namespace {

// (1) a 64-column slice of a wider row-major array as an mma operand:
// out[64, 64] fp32 = x[:, cx : cx + 64] . y[:, cy : cy + 64]^T
__global__ void __launch_bounds__(kThreads)
probe_slice_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                       float* __restrict__ out, int ld, int cx, int cy) {
  __shared__ __align__(16) bf16 sX[64 * kLD];
  __shared__ __align__(16) bf16 sY[64 * kLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_rows_strided(sX, x + cx, ld, 0, 64, tid);
  load_rows_strided(sY, y + cy, ld, 0, 64, tid);
  __syncthreads();
  uint32_t a[kD / 16][4];
  load_a_frags<kD>(a, sX, warp, lane);
  float s[kNS][4];
  mma_abt<kD>(s, a, sY, lane);
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    const int col = nt * 8 + 2 * t;
    out[row * 64 + col] = s[nt][0];
    out[row * 64 + col + 1] = s[nt][1];
    out[(row + 8) * 64 + col] = s[nt][2];
    out[(row + 8) * 64 + col + 1] = s[nt][3];
  }
}

// (2) two heads' results stored side by side into one merged row:
// out[64, 128] bf16, out[:, g * 64 : (g + 1) * 64] = q[g] . k[g]^T for the
// two heads g of q, k [2, 64, 64]
__global__ void __launch_bounds__(kThreads)
probe_pair_store_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 sQ[64 * kLD];
  __shared__ __align__(16) bf16 sK[64 * kLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float one[2] = {1.f, 1.f};
  for (int g = 0; g < 2; ++g) {
    __syncthreads();
    load_rows_strided(sQ, q + g * 64 * kD, kD, 0, 64, tid);
    load_rows_strided(sK, k + g * 64 * kD, kD, 0, 64, tid);
    __syncthreads();
    uint32_t a[kD / 16][4];
    load_a_frags<kD>(a, sQ, warp, lane);
    float s[kNS][4];
    mma_abt<kD>(s, a, sK, lane);
    store_output_rows<kNS>(out + g * 64, 128, s, one, warp * 16 + (lane >> 2), 64, lane & 3);
  }
}

// (3) the half swap inside a 64-wide head: out[64, 64] bf16 = rope(x) with
// cos, sin [64, 32], through the loader kernels 18 and 19 stage rows with
__global__ void __launch_bounds__(kThreads)
probe_half_swap_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cos,
                       const bf16* __restrict__ sin, bf16* __restrict__ out, int ld) {
  __shared__ __align__(16) bf16 sX[64 * kLD];
  const int tid = threadIdx.x;
  load_rows_rope(sX, x, ld, 0, 64, cos, sin, tid);
  __syncthreads();
  for (int i = tid; i < 64 * kD; i += kThreads) out[i] = sX[(i / kD) * kLD + i % kD];
}

}  // namespace
}  // namespace f5

// x, y: [64, ld] bf16; out: [64, 64] fp32; cx, cy: first columns, multiples of 8
extern "C" int f5_probe_slice_mma(const void* x, const void* y, void* out, int ld, int cx, int cy,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cx % 8 || cy % 8 || ld % 8 || cx + 64 > ld || cy + 64 > ld)
    return (int)cudaErrorInvalidValue;
  f5::probe_slice_mma_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(x), static_cast<const f5::bf16*>(y),
      static_cast<float*>(out), ld, cx, cy);
  return (int)cudaGetLastError();
}

// q, k: [2, 64, 64] bf16; out: [64, 128] bf16
extern "C" int f5_probe_pair_store(const void* q, const void* k, void* out, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  f5::probe_pair_store_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(q), static_cast<const f5::bf16*>(k),
      static_cast<f5::bf16*>(out));
  return (int)cudaGetLastError();
}

// x: [64, ld] bf16 (the head is its first 64 columns); cos, sin: [64, 32] bf16;
// out: [64, 64] bf16
extern "C" int f5_probe_half_swap(const void* x, const void* cos, const void* sin, void* out,
                                  int ld, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ld % 8 || ld < 64) return (int)cudaErrorInvalidValue;
  f5::probe_half_swap_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(x), static_cast<const f5::bf16*>(cos),
      static_cast<const f5::bf16*>(sin), static_cast<f5::bf16*>(out), ld);
  return (int)cudaGetLastError();
}

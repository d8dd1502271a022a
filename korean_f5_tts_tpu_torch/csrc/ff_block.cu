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
// Design: two kernels (gemm_bf16.cuh) with z written once to device memory
// between them (12.6 MB at the main-path shape, read back from L2 in part):
//   ln_mod_gemm_kernel<gelu>: z = bf16(gelu_tanh(bf16(LN(h)*(1+sc)+sh) @ W1^T + b1)),
//          y formed straight into shared memory, never in device memory;
//   gated_residual_gemm_kernel: out = bf16(h + gate * (z @ W2^T + b2)).
#include "gemm_bf16.cuh"

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
  const T* w1t = static_cast<const T*>(w1);
  const T* b1t = static_cast<const T*>(b1);
  f5::ln_mod_gemm_kernel<true><<<dim3(dff / f5::kBN, m_tiles), f5::kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(sc), static_cast<const T*>(sh), w1t, w1t,
      w1t, b1t, b1t, b1t, static_cast<T*>(z), M, d, dff, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f5::gated_residual_gemm_kernel<<<dim3(d / f5::kBN, m_tiles), f5::kThreads, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(h), static_cast<const T*>(gate), static_cast<T*>(out), M, d, dff);
  return (int)cudaGetLastError();
}

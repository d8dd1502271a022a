// Fused DiT FF half-block for Hopper (sm_90a):
//   out = h + gate * (gelu_tanh((LN(h) * (1 + sc) + sh) @ W1^T + b1) @ W2^T + b2)
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/ff_block.py:_kernel (via
// ff_block_fused). h, out: [M, d]; sc, sh, gate: [d]; W1: [dff, d] and
// W2: [d, dff] (torch Linear layout, k contiguous); b1: [dff]; b2: [d]; all
// bf16 (f5_ff_block_fwd) or all fp32 (f5_ff_block_f32_fwd): like the TPU
// kernel, the result has the operands' dtype.
// Rounding points follow the TPU kernel: LN and modulation in fp32, y cast to
// the operands' dtype before the first product, fp32 accumulation, +b1 and
// GELU-tanh in fp32, z cast, +b2 and the gated residual in fp32, one cast at
// the end. With fp32 operands no cast rounds anything.
//
// What bounds it on the card: at the main-path shape (M = 3072, d = 1024,
// dff = 2048) a call is 25.8 GFLOP against ~22 MB of h/W/out in bf16, so the
// two products bound it: 0.026 ms at the bf16 tensor-core peak; on fp32
// operands 0.156 ms as fp32-accurate products at the TF32 rate taken three
// times (0.385 ms at the 67 TFLOP/s of FFMA). The TPU kernel keeps the
// whole [rows, dff] GELU tile in VMEM; here a 64-row tile of z is
// 64 * 2048 * 2 B = 256 KB, more than the 227 KB of shared memory a block
// can have.
//
// Design: row statistics, then two product kernels with z written once to
// device memory between them (12.6 MB in bf16 at the main-path shape; the
// second product is launched right behind the first on the same stream and
// reads z while most of it is still in the 50 MB L2):
//   ln_stats: mean and 1/std of each row, [2, M] fp32;
//   ln_mod_gemm<gelu>: z = gelu_tanh((LN(h)*(1+sc)+sh) @ W1^T + b1), y formed
//          in registers (bf16) or on the way into shared memory (fp32), never
//          in device memory;
//   gated_residual_gemm: out = h + gate * (z @ W2^T + b2).
// bf16: the TMA + wgmma core of gemm_bf16.cuh, whose note has the tile
// shapes, stages and tile counts per wave. fp32: the split 3xTF32 core of
// gemm_f32.cuh on the same skeleton (wgmma .tf32, the weight tile split
// into hi and lo in shared memory, y split in registers).
#include "gemm_f32.cuh"

// z: [M, dff] bf16 and stats: [2, M] fp32, scratch the caller allocates; d, dff
// multiples of 128, d <= 4096. Each product's tile width is gemm_tile_n()'s.
extern "C" int f5_ff_block_fwd(const void* h, const void* sc, const void* sh, const void* gate,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* z, void* stats, void* out, int M, int d, int dff, float eps,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::gemm_dims_ok(M, dff, d) || !f5::gemm_dims_ok(M, d, dff) || d > f5::kMaxLnDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const ws[3] = {w1, w1, w1};
  const void* const bs[3] = {b1, b1, b1};
  err = f5::gemm_tile_n(M, dff, dff) == 256
            ? f5::launch_ln_mod_gemm<256, true>(h, sc, sh, ws, bs, stats, z, M, d, dff, 1, eps, s)
            : f5::launch_ln_mod_gemm<128, true>(h, sc, sh, ws, bs, stats, z, M, d, dff, 1, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = f5::gemm_tile_n(M, d, d) == 256
            ? f5::launch_gated_residual_gemm<256>(z, w2, b2, h, gate, out, M, d, dff, s)
            : f5::launch_gated_residual_gemm<128>(z, w2, b2, h, gate, out, M, d, dff, s);
  return (int)err;
}

// the same on fp32 operands; z: [M, dff] fp32; d, dff multiples of 128, d <= 4096
extern "C" int f5_ff_block_f32_fwd(const void* h, const void* sc, const void* sh,
                                   const void* gate, const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* z, void* stats, void* out,
                                   int M, int d, int dff, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::tf_dims_ok(M, d, dff)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const ws[3] = {w1, w1, w1};
  const void* const bs[3] = {b1, b1, b1};
  err = f5::launch_ln_mod_gemm_f32<true>(h, sc, sh, ws, bs, stats, z, M, d, dff, 1, eps, s);
  if (err != cudaSuccess) return (int)err;
  return (int)f5::launch_gated_residual_gemm_f32(z, w2, b2, h, gate, out, M, d, dff, s);
}

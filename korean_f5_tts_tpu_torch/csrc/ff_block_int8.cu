// Fused int8 DiT FF half-block for Hopper (sm_90a), kernel 4:
//   y   = LN(h) * (1 + sc) + sh                              (fp32)
//   z   = gelu_tanh(q(y) @ W1^T * ys * w1s + b1)             (fp32)
//   out = bf16(h + gate * (q(z) @ W2^T * zs * w2s + b2))
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/ff_block.py:_kernel_int8 (via
// ff_block_fused_int8). h, out: [M, d] bf16 or fp32 (the TPU kernel reads its
// rows as fp32 and writes the input's dtype); sc, sh, gate: [d], b1, b2 of
// the rows' type; W1: [dff, d] and W2: [d, dff] int8 (torch layout); w1s
// [dff], w2s [d] fp32. On fp32 rows out = h + gate * (...) is not rounded.
//
// What bounds it on the card: at the main-path shape (M = 3072, d = 1024,
// dff = 2048) a call is 25.8 GOP of int8 products (0.013 ms at the 1,979
// TOP/s dense int8 peak) against ~15 MB of h, weights and out (0.0046 ms at
// 3.35 TB/s), so the products bound it; z's round trip (25 MB written in
// fp32, read back, 6 MB of zq) comes on top and mostly stays in the 50 MB L2.
// The hard part is the second quantization: z is quantized per row over all
// of dff from fp32 (the TPU kernel never rounds z to bf16,
// ff_block.py:118-120), and a 64-row tile of fp32 z is 512 KB, more than a
// block's 227 KB of shared memory: a row's scale needs every column tile of
// the first product first.
//
// Design: four launches behind one entry point, on the int8 core of
// gemm_int8.cuh (TMA ring, wgmma .s32.s8.s8, warp specialisation):
//   1. row pass with the LN prologue: h's row in registers (32 bf16 a lane),
//      statistics, y, yq int8 + ys, one read of h;
//   2. product with W1, epilogue rescale + b1 + GELU -> z in fp32;
//   3. row pass over z (64 fp32 a lane at dff = 2048): zq int8 + zs, one read
//      of z (the TPU kernel's own rounding point, so its own pass);
//   4. product with W2, epilogue rescale + b2 + gated residual.
// Each product's tile width is gemm_tile_n()'s (at M = 3072: 128 for the
// first, 256 for the second).
//
// Measured at M = 3072 on an NVIDIA H100 80GB HBM3, 700.00 W, with both
// products 256 wide, parent and change under one timer (chip_smoke.py
// --ab): 0.0790-0.0792 ms, 326 TOP/s, a sixth of the int8 peak, where the
// mma.sync core this replaces took 0.1782-0.1783. Per launch inside an
// utterance: LN pass 0.0071, first product 0.0280, z pass 0.0106 (near the
// memory rate), second product 0.0297. The first product 128 wide: 0.0772
// (chip_smoke.py's tile-width table), which gemm_int8.cuh's tile cost now
// picks. What holds the products: wave quantization (the second is 96
// tiles on 132 SMs, the first 384 = 2.9 waves), and a tile's prologue and
// epilogue overlap nothing, as in the bf16 core.
#include "gemm_int8.cuh"

namespace {

// the four launches on rows of type T (bf16 or float)
template <typename T>
cudaError_t ff_block_int8(const void* h, const void* sc, const void* sh, const void* gate,
                          const void* w1, const void* w1s, const void* b1, const void* w2,
                          const void* w2s, const void* b2, void* yq, void* ys, void* z, void* zq,
                          void* zs, void* out, int M, int d, int dff, float eps, int bn1, int bn2,
                          cudaStream_t s) {
  cudaError_t err = f5::launch_quant_rows_reg<T, true>(h, sc, sh, yq, ys, M, d, eps, s);
  if (err != cudaSuccess) return err;
  f5::WgArgs p1{};
  p1.a_scale = static_cast<const float*>(ys);
  p1.w_scale[0] = p1.w_scale[1] = p1.w_scale[2] = static_cast<const float*>(w1s);
  p1.bias[0] = p1.bias[1] = p1.bias[2] = b1;
  p1.out = z;
  p1.M = M;
  p1.K = d;
  p1.seg_n = dff;
  const void* const w1x[3] = {w1, w1, w1};
  err = f5::launch_i8_product<f5::kWgGeluF32, T>(yq, w1x, p1, 1, bn1, s);
  if (err != cudaSuccess) return err;
  err = f5::launch_quant_rows_reg<float, false>(z, nullptr, nullptr, zq, zs, M, dff, 0.f, s);
  if (err != cudaSuccess) return err;
  f5::WgArgs p2{};
  p2.a_scale = static_cast<const float*>(zs);
  p2.w_scale[0] = p2.w_scale[1] = p2.w_scale[2] = static_cast<const float*>(w2s);
  p2.bias[0] = p2.bias[1] = p2.bias[2] = b2;
  p2.h = h;
  p2.gate = gate;
  p2.out = out;
  p2.M = M;
  p2.K = dff;
  p2.seg_n = d;
  const void* const w2x[3] = {w2, w2, w2};
  return f5::launch_i8_product<f5::kWgGatedResidual, T>(zq, w2x, p2, 1, bn2, s);
}

}  // namespace

// yq [M, d], zq [M, dff] int8, ys, zs [M] and z [M, dff] fp32: scratch the
// caller allocates. d, dff multiples of 128, at most 4096. f32: h, sc, sh,
// gate, b1, b2 and out are fp32 (else bf16). bn1, bn2: the tile widths of
// the two products (128 or 256), or 0 for gemm_tile_n()'s pick:
// f5_ff_block_int8_fwd passes 0, chip_smoke.py times each width.
extern "C" int f5_ff_block_int8_widths(const void* h, const void* sc, const void* sh,
                                       const void* gate, const void* w1, const void* w1s,
                                       const void* b1, const void* w2, const void* w2s,
                                       const void* b2, void* yq, void* ys, void* z, void* zq,
                                       void* zs, void* out, int M, int d, int dff, float eps,
                                       int f32, int bn1, int bn2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_wgmma_dims_ok(M, dff, d) || !f5::i8_wgmma_dims_ok(M, d, dff))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)ff_block_int8<float>(h, sc, sh, gate, w1, w1s, b1, w2, w2s, b2, yq, ys, z, zq, zs,
                                     out, M, d, dff, eps, bn1, bn2, s);
  return (int)ff_block_int8<f5::bf16>(h, sc, sh, gate, w1, w1s, b1, w2, w2s, b2, yq, ys, z, zq,
                                      zs, out, M, d, dff, eps, bn1, bn2, s);
}

extern "C" int f5_ff_block_int8_fwd(const void* h, const void* sc, const void* sh,
                                    const void* gate, const void* w1, const void* w1s,
                                    const void* b1, const void* w2, const void* w2s,
                                    const void* b2, void* yq, void* ys, void* z, void* zq,
                                    void* zs, void* out, int M, int d, int dff, float eps, int f32,
                                    int device, void* stream) {
  return f5_ff_block_int8_widths(h, sc, sh, gate, w1, w1s, b1, w2, w2s, b2, yq, ys, z, zq, zs,
                                 out, M, d, dff, eps, f32, 0, 0, device, stream);
}

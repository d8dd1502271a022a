// Fused int8 attention-side linears for Hopper (sm_90a), kernels 5 and 6:
//   kernel 5: out = bf16(q(LN(h) * (1 + sc) + sh) @ Wqkv^T * ys * ws + b)
//   kernel 6: out = bf16(h + gate * (q(a) @ Wo^T * as * ws + b))
//
// Replace the TPU kernels korean_f5_tts_tpu/ops/fused_linears.py:
// _ln_mod_matmul_int8_kernel (via ln_mod_matmul_int8) and
// _proj_gated_int8_kernel (via proj_gated_residual_int8): the attention half
// of an int8 DiT block at batch 1 (dit.py:424-463). h, a, out: bf16 rows;
// W: int8 [n, k] (torch layout), ws: fp32 [n], b, sc, sh, gate: bf16.
//
// Rounding points: kernel 5 quantizes the modulated norm y straight from
// fp32 (no bf16 rounding after the modulation, fused_linears.py:111-117);
// kernel 6 quantizes its bf16 input a.
//
// What bounds them on the card, at the main-path shape (M = 3072 rows, d =
// 1024): kernel 5 is 19.3 GOP (n = 3 x 1024; 0.0098 ms at the 1,979 TOP/s
// dense int8 peak) against ~34 MB moved (0.010 ms at 3.35 TB/s), kernel 6 is
// 6.4 GOP (0.0032 ms) against ~25 MB (0.0075 ms): by the roofline 5 is
// balanced and 6 memory-bound.
//
// Kernel 5 (f5_ln_mod_matmul_int8_fwd) runs on the int8 core of
// gemm_int8.cuh: one row pass holds h's row in registers (one read for the
// LN statistics, the modulation, the amax and the quantization), then the
// TMA + wgmma .s32.s8.s8 product with the rescale and bias in its epilogue.
// It takes the q, k and v weights as three segments of its output columns,
// each with its own tensor map picked by the column tile, so the fused qkv
// weight is never concatenated. Measured at M = 3072 on an NVIDIA H100 80GB
// HBM3, 700.00 W, parent and change under one timer (chip_smoke.py --ab):
// 0.0380-0.0409 ms (~500 TOP/s, a quarter of the int8 peak; its product
// alone 0.0301, the LN pass 0.0071), where the mma.sync core this replaces
// took 0.1126-0.1189.
//
// Kernel 6 (f5_proj_gated_int8_fwd) stays on int8_gemm.cuh's quantization
// pass and mma.sync product until it moves onto the same core.
#include "gemm_int8.cuh"

// w*/ws*/b*: segments 0..nseg-1 (q, k, v), each [seg_n, d]; out [M, nseg * seg_n];
// yq [M, d] int8 and ys [M] fp32 scratch. d % 16 == 0, d <= 4096, seg_n % 128 == 0.
// bn: the product's tile width (128 or 256), or 0 for gemm_tile_n()'s pick:
// f5_ln_mod_matmul_int8_fwd passes 0, chip_smoke.py times each width.
extern "C" int f5_ln_mod_matmul_int8_width(const void* h, const void* sc, const void* sh,
                                           const void* w0, const void* w1, const void* w2,
                                           const void* ws0, const void* ws1, const void* ws2,
                                           const void* b0, const void* b1, const void* b2,
                                           void* yq, void* ys, void* out, int M, int d, int seg_n,
                                           int nseg, float eps, int bn, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_wgmma_dims_ok(M, seg_n, d) || nseg < 1 || nseg > f5::kMaxSegments)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = f5::launch_quant_rows_reg<f5::bf16, true>(h, sc, sh, yq, ys, M, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  f5::WgArgs p{};
  p.a_scale = static_cast<const float*>(ys);
  p.w_scale[0] = static_cast<const float*>(ws0);
  p.w_scale[1] = static_cast<const float*>(ws1);
  p.w_scale[2] = static_cast<const float*>(ws2);
  p.bias[0] = static_cast<const f5::bf16*>(b0);
  p.bias[1] = static_cast<const f5::bf16*>(b1);
  p.bias[2] = static_cast<const f5::bf16*>(b2);
  p.out = out;
  p.M = M;
  p.K = d;
  p.seg_n = seg_n;
  const void* const w[3] = {w0, w1, w2};
  return (int)f5::launch_i8_product<f5::kWgOut>(yq, w, p, nseg, bn, s);
}

extern "C" int f5_ln_mod_matmul_int8_fwd(const void* h, const void* sc, const void* sh,
                                         const void* w0, const void* w1, const void* w2,
                                         const void* ws0, const void* ws1, const void* ws2,
                                         const void* b0, const void* b1, const void* b2,
                                         void* yq, void* ys, void* out, int M, int d, int seg_n,
                                         int nseg, float eps, int device, void* stream) {
  return f5_ln_mod_matmul_int8_width(h, sc, sh, w0, w1, w2, ws0, ws1, ws2, b0, b1, b2, yq, ys,
                                     out, M, d, seg_n, nseg, eps, 0, device, stream);
}

// a [M, din], h/out [M, d], w [d, din]
extern "C" int f5_proj_gated_int8_fwd(const void* a, const void* h, const void* gate,
                                      const void* w, const void* ws, const void* b, void* aq,
                                      void* as, void* out, int M, int din, int d, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_shapes_ok(M, din, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(aq);
  float* qs = static_cast<float*>(as);
  err = f5::launch_quant_rows<f5::kSrcBf16>(a, nullptr, nullptr, q, qs, M, din, 0.f, s);
  if (err != cudaSuccess) return (int)err;
  f5::GemmArgs p = f5::i8_args(q, qs, w, ws, b, out, M, d, din);
  p.h = static_cast<const f5::bf16*>(h);
  p.gate = static_cast<const f5::bf16*>(gate);
  return (int)f5::launch_i8_gemm<f5::kEpiGatedResidual>(p, s);
}

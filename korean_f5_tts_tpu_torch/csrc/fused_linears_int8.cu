// Fused int8 attention-side linears for Hopper (sm_90a), kernels 5 and 6:
//   kernel 5: out = bf16(q(LN(h) * (1 + sc) + sh) @ Wqkv^T * ys * ws + b)
//   kernel 6: out = bf16(h + gate * (q(a) @ Wo^T * as * ws + b))
//
// Replace the TPU kernels korean_f5_tts_tpu/ops/fused_linears.py:
// _ln_mod_matmul_int8_kernel (via ln_mod_matmul_int8) and
// _proj_gated_int8_kernel (via proj_gated_residual_int8): the attention half
// of an int8 DiT block at batch 1 (dit.py:424-463). h, a, out: bf16 or fp32
// rows (the TPU kernels read their rows as fp32 and write the input's
// dtype); b, sc, sh, gate: of the rows' type; W: int8 [n, k] (torch layout),
// ws: fp32 [n].
//
// Rounding points: kernel 5 quantizes the modulated norm y straight from
// fp32 (no bf16 rounding after the modulation, fused_linears.py:111-117);
// kernel 6 quantizes its bf16 input a.
//
// What bounds them on the card, at the main-path shape (M = 3072 rows, d =
// 1024): kernel 5 is 19.3 GOP (n = 3 x 1024; 0.0098 ms at the 1,979 TOP/s
// dense int8 peak) against ~34 MB moved (0.010 ms at 3.35 TB/s), kernel 6 is
// 6.4 GOP (0.0032 ms) against ~20 MB (a, h, W, out: 0.0059 ms): by the
// roofline 5 is balanced and 6 memory-bound.
//
// Both run on the int8 core of gemm_int8.cuh: one row pass holds a row in
// registers and writes its int8 copy and scale, then the TMA + wgmma
// .s32.s8.s8 product applies the rescale and bias (and, for 6, the gated
// residual) in its epilogue.
//   Kernel 5 (f5_ln_mod_matmul_int8_fwd): the row pass reads h once for the
//   LN statistics, the modulation, the amax and the quantization; the
//   product takes the q, k and v weights as three segments of its output
//   columns, each with its own tensor map picked by the column tile, so the
//   fused qkv weight is never concatenated. Measured at M = 3072 on an
//   NVIDIA H100 80GB HBM3, 700.00 W, parent and change under one timer
//   (chip_smoke.py --ab): 0.0380-0.0409 ms (~500 TOP/s, a quarter of the
//   int8 peak; its product alone 0.0301, the LN pass 0.0071), where the
//   mma.sync core it left took 0.1126-0.1189.
//   Kernel 6 (f5_proj_gated_int8_fwd): the row pass quantizes a as it is
//   (quant_rows_reg_kernel<T, 1024 .. 4096, false>: the amax is a max,
//   exact in any order, and the division IEEE), the product's epilogue is
//   kWgGatedResidual, the one kernel 4's second product runs. Its output is
//   the plain version's bit for bit. d = 1024 columns are 96 tiles at 256
//   wide, 192 at 128 (gemm_tile_n's pick by waves); f5_proj_gated_int8_width
//   forces either, and chip_smoke.py times both.
#include "gemm_int8.cuh"

namespace {

template <typename T>
cudaError_t ln_mod_matmul_int8(const void* h, const void* sc, const void* sh,
                               const void* const (&w)[3], const void* const (&ws)[3],
                               const void* const (&b)[3], void* yq, void* ys, void* out, int M,
                               int d, int seg_n, int nseg, float eps, int bn, cudaStream_t s) {
  cudaError_t err = f5::launch_quant_rows_reg<T, true>(h, sc, sh, yq, ys, M, d, eps, s);
  if (err != cudaSuccess) return err;
  f5::WgArgs p{};
  p.a_scale = static_cast<const float*>(ys);
  for (int i = 0; i < 3; ++i) {
    p.w_scale[i] = static_cast<const float*>(ws[i]);
    p.bias[i] = b[i];
  }
  p.out = out;
  p.M = M;
  p.K = d;
  p.seg_n = seg_n;
  return f5::launch_i8_product<f5::kWgOut, T>(yq, w, p, nseg, bn, s);
}

template <typename T>
cudaError_t proj_gated_int8(const void* a, const void* h, const void* gate, const void* w,
                            const void* ws, const void* b, void* aq, void* as, void* out, int M,
                            int din, int d, int bn, cudaStream_t s) {
  cudaError_t err = f5::launch_quant_rows_reg<T, false>(a, nullptr, nullptr, aq, as, M, din, 0.f, s);
  if (err != cudaSuccess) return err;
  f5::WgArgs p{};
  p.a_scale = static_cast<const float*>(as);
  p.w_scale[0] = p.w_scale[1] = p.w_scale[2] = static_cast<const float*>(ws);
  p.bias[0] = p.bias[1] = p.bias[2] = b;
  p.h = h;
  p.gate = gate;
  p.out = out;
  p.M = M;
  p.K = din;
  p.seg_n = d;
  const void* const wseg[3] = {w, w, w};
  return f5::launch_i8_product<f5::kWgGatedResidual, T>(aq, wseg, p, 1, bn, s);
}

}  // namespace

// w*/ws*/b*: segments 0..nseg-1 (q, k, v), each [seg_n, d]; out [M, nseg * seg_n];
// yq [M, d] int8 and ys [M] fp32 scratch. d % 16 == 0, d <= 4096, seg_n % 128 == 0.
// f32: h, sc, sh, b* and out are fp32 (else bf16). bn: the product's tile
// width (128 or 256), or 0 for gemm_tile_n()'s pick: f5_ln_mod_matmul_int8_fwd
// passes 0, chip_smoke.py times each width.
extern "C" int f5_ln_mod_matmul_int8_width(const void* h, const void* sc, const void* sh,
                                           const void* w0, const void* w1, const void* w2,
                                           const void* ws0, const void* ws1, const void* ws2,
                                           const void* b0, const void* b1, const void* b2,
                                           void* yq, void* ys, void* out, int M, int d, int seg_n,
                                           int nseg, float eps, int f32, int bn, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_wgmma_dims_ok(M, seg_n, d) || nseg < 1 || nseg > f5::kMaxSegments)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const w[3] = {w0, w1, w2};
  const void* const ws[3] = {ws0, ws1, ws2};
  const void* const b[3] = {b0, b1, b2};
  if (f32)
    return (int)ln_mod_matmul_int8<float>(h, sc, sh, w, ws, b, yq, ys, out, M, d, seg_n, nseg,
                                          eps, bn, s);
  return (int)ln_mod_matmul_int8<f5::bf16>(h, sc, sh, w, ws, b, yq, ys, out, M, d, seg_n, nseg,
                                           eps, bn, s);
}

extern "C" int f5_ln_mod_matmul_int8_fwd(const void* h, const void* sc, const void* sh,
                                         const void* w0, const void* w1, const void* w2,
                                         const void* ws0, const void* ws1, const void* ws2,
                                         const void* b0, const void* b1, const void* b2,
                                         void* yq, void* ys, void* out, int M, int d, int seg_n,
                                         int nseg, float eps, int f32, int device, void* stream) {
  return f5_ln_mod_matmul_int8_width(h, sc, sh, w0, w1, w2, ws0, ws1, ws2, b0, b1, b2, yq, ys,
                                     out, M, d, seg_n, nseg, eps, f32, 0, device, stream);
}

// a [M, din], h/out [M, d], w [d, din]; aq [M, din] int8 and as [M] fp32
// scratch. din % 16 == 0, din <= 4096, d % 128 == 0. f32: a, h, gate, b and
// out are fp32 (else bf16). bn: the product's tile width (128 or 256), or 0
// for gemm_tile_n()'s pick: f5_proj_gated_int8_fwd passes 0, chip_smoke.py
// times each width.
extern "C" int f5_proj_gated_int8_width(const void* a, const void* h, const void* gate,
                                        const void* w, const void* ws, const void* b, void* aq,
                                        void* as, void* out, int M, int din, int d, int f32,
                                        int bn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_wgmma_dims_ok(M, d, din)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return (int)proj_gated_int8<float>(a, h, gate, w, ws, b, aq, as, out, M, din, d, bn, s);
  return (int)proj_gated_int8<f5::bf16>(a, h, gate, w, ws, b, aq, as, out, M, din, d, bn, s);
}

extern "C" int f5_proj_gated_int8_fwd(const void* a, const void* h, const void* gate,
                                      const void* w, const void* ws, const void* b, void* aq,
                                      void* as, void* out, int M, int din, int d, int f32,
                                      int device, void* stream) {
  return f5_proj_gated_int8_width(a, h, gate, w, ws, b, aq, as, out, M, din, d, f32, 0, device,
                                  stream);
}

// Dynamic-int8 matmul for Hopper (sm_90a), kernel 9:
//   out = bf16([gelu_tanh](q(x) @ W^T * x_scale * w_scale [+ b]))
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/qmatmul.py:_qmm_kernel (via
// qmatmul; on the JAX serving path through models/quant.py:qlinear). x, out:
// [M, K] / [M, N] bf16 or fp32 (the TPU kernel reads x as fp32 and writes
// its dtype); W: [N, K] int8 (torch layout, k contiguous); w_scale: [N]
// fp32; b: [N] of x's type, or null. On the main path it runs the four attention
// projections of the masked (batch > 1) branch: M = 2 * b * 1536 (6144 for a
// batch of 2 with CFG), K = N = 1024.
//
// What bounds it on the card: at M = 3072, K = N = 1024 a call is 6.4 GOP
// (0.0033 ms at the 1,979 TOP/s dense int8 peak) against ~14 MB of x, W,
// scales and out (0.0041 ms at 3.35 TB/s): memory by the roofline, with
// the int8 copy of x (3 MB written and read again) on top.
//
// Design: two launches on the int8 TMA + wgmma core (gemm_int8.cuh), as
// kernel 6 runs there without its gated residual:
//   1. the row pass without LN (quant_rows_reg_kernel<T, kMaxK, false>):
//      one warp per row holds the row in registers, so x is read once for
//      its amax and its quantization; writes q [M, K] int8 and s [M] fp32.
//      The TPU kernel keeps the whole K of a 256-row tile in VMEM and
//      quantizes there; a GEMM block here owns a 128-column slice of the
//      output and cannot see the whole row, so the row pass writes q to
//      memory (half the bytes of x) and the product reads int8 operands only.
//   2. the product over one weight segment: TMA tiles of q and W into a ring
//      of 128-byte-swizzled stages, wgmma .s32.s8.s8 (exact s32 sums), and
//      the epilogue kWgOut (rescale + optional bias, one bf16 rounding) or,
//      with activation "gelu_tanh", kWgGeluOut (rescale + bias + tanh-GELU in
//      fp32, one bf16 rounding). The _rn arithmetic makes the output without
//      GELU equal the plain version to the bit.
// Shapes: any M, K % 16 == 0 (TMA's 16-byte rows) and K <= 4096 (the row
// pass's registers: the TPU kernel too holds the whole K, "K <= 4096 at
// these model sizes"), N % 128 == 0. The tile width (128 or 256 columns)
// comes from gemm_tile_n() by waves on the card's SMs;
// f5_qmatmul_width forces either for chip_smoke.py. Measured: PERF.md
// section 6.
#include "gemm_int8.cuh"

namespace {

template <typename T>
cudaError_t qmatmul(const void* x, const void* w, const void* w_scale, const void* b, void* xq,
                    void* xs, void* out, int M, int K, int N, int gelu, int bn,
                    cudaStream_t s) {
  cudaError_t err = f5::launch_quant_rows_reg<T, false>(x, nullptr, nullptr, xq, xs, M, K, 0.f, s);
  if (err != cudaSuccess) return err;
  f5::WgArgs p{};
  p.a_scale = static_cast<const float*>(xs);
  p.w_scale[0] = p.w_scale[1] = p.w_scale[2] = static_cast<const float*>(w_scale);
  p.bias[0] = p.bias[1] = p.bias[2] = b;
  p.out = out;
  p.M = M;
  p.K = K;
  p.seg_n = N;
  const void* const wseg[3] = {w, w, w};
  if (gelu) return f5::launch_i8_product<f5::kWgGeluOut, T>(xq, wseg, p, 1, bn, s);
  return f5::launch_i8_product<f5::kWgOut, T>(xq, wseg, p, 1, bn, s);
}

}  // namespace

// xq [M, K] int8 and xs [M] fp32: scratch. f32: x, b and out are fp32 (else
// bf16). bn: the product's tile width (128 or 256), or 0 for gemm_tile_n()'s
// pick: f5_qmatmul_fwd passes 0.
extern "C" int f5_qmatmul_width(const void* x, const void* w, const void* w_scale, const void* b,
                                void* xq, void* xs, void* out, int M, int K, int N, int gelu,
                                int f32, int bn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_wgmma_dims_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return (int)qmatmul<float>(x, w, w_scale, b, xq, xs, out, M, K, N, gelu, bn, s);
  return (int)qmatmul<f5::bf16>(x, w, w_scale, b, xq, xs, out, M, K, N, gelu, bn, s);
}

extern "C" int f5_qmatmul_fwd(const void* x, const void* w, const void* w_scale, const void* b,
                              void* xq, void* xs, void* out, int M, int K, int N, int gelu,
                              int f32, int device, void* stream) {
  return f5_qmatmul_width(x, w, w_scale, b, xq, xs, out, M, K, N, gelu, f32, 0, device, stream);
}

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
// balanced and 6 memory-bound, but this simple product (mma.sync,
// synchronous loads) is far from both peaks and its tensor-core instruction
// throughput bounds both in practice.
// Design (int8_gemm.cuh): one pass quantizes the rows (kernel 5 also takes
// the LN statistics there: one warp per row), then the int8 product with
// the rescale, bias, gate and residual in its epilogue. Kernel 5 takes the
// q, k and v weights as three segments of its output columns, so the fused
// qkv weight is never concatenated: each 128-column tile reads its own
// segment's weight, scale and bias.
#include "int8_gemm.cuh"

// w*/ws*/b*: segments 0..nseg-1 (q, k, v), each [seg_n, d]; out [M, nseg * seg_n]
extern "C" int f5_ln_mod_matmul_int8_fwd(const void* h, const void* sc, const void* sh,
                                         const void* w0, const void* w1, const void* w2,
                                         const void* ws0, const void* ws1, const void* ws2,
                                         const void* b0, const void* b1, const void* b2,
                                         void* yq, void* ys, void* out, int M, int d, int seg_n,
                                         int nseg, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_shapes_ok(M, d, seg_n) || nseg < 1 || nseg > f5::kMaxSegments)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(yq);
  float* qs = static_cast<float*>(ys);
  err = f5::launch_quant_rows<f5::kSrcLnMod>(h, static_cast<const f5::bf16*>(sc),
                                             static_cast<const f5::bf16*>(sh), q, qs, M, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  f5::GemmArgs p = f5::i8_args(q, qs, w0, ws0, b0, out, M, nseg * seg_n, d);
  p.seg_n = seg_n;
  p.w[1] = static_cast<const int8_t*>(w1);
  p.w[2] = static_cast<const int8_t*>(w2);
  p.w_scale[1] = static_cast<const float*>(ws1);
  p.w_scale[2] = static_cast<const float*>(ws2);
  p.bias[1] = static_cast<const f5::bf16*>(b1);
  p.bias[2] = static_cast<const f5::bf16*>(b2);
  return (int)f5::launch_i8_gemm<f5::kEpiOut>(p, s);
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

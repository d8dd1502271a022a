// Dynamic-int8 matmul for Hopper (sm_90a), kernel 9:
//   out = bf16([gelu_tanh](q(x) @ W^T * x_scale * w_scale + b))
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/qmatmul.py:_qmm_kernel (via
// qmatmul; on the JAX serving path through models/quant.py:qlinear). x, out:
// [M, K] / [M, N] bf16; W: [N, K] int8 (torch layout, k contiguous); w_scale:
// [N] fp32; b: [N] bf16 or null. On the main path it runs the four attention
// projections of the masked (batch > 1) branch: M = 2 * b * 1536, K = N = 1024.
//
// What bounds it on the card: at b = 1 a call is 6.4 GOP (0.0032 ms at the
// 1,979 TOP/s dense int8 peak) against ~19 MB moved (x, its int8 copy written
// and read, W, out: 0.0057 ms at 3.35 TB/s), so memory by the roofline; this
// simple product (mma.sync, synchronous loads) is far from both peaks and
// its tensor-core instruction throughput bounds it in practice. The TPU
// kernel quantizes a 256-row tile in VMEM with the whole K resident; here the
// rows are quantized once by their own pass (int8_gemm.cuh:
// quant_rows_kernel, one warp per row), and the product reads int8 operands
// only (int8_gemm.cuh: i8_gemm_kernel).
#include "int8_gemm.cuh"

extern "C" int f5_qmatmul_fwd(const void* x, const void* w, const void* w_scale, const void* b,
                              void* xq, void* xs, void* out, int M, int K, int N, int gelu,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* qs = static_cast<float*>(xs);
  err = f5::launch_quant_rows<f5::kSrcBf16>(x, nullptr, nullptr, q, qs, M, K, 0.f, s);
  if (err != cudaSuccess) return (int)err;
  f5::GemmArgs p = f5::i8_args(q, qs, w, w_scale, b, out, M, N, K);
  p.gelu = gelu;
  return (int)f5::launch_i8_gemm(p, s);
}

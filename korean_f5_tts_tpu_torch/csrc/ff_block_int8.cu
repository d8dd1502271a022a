// Fused int8 DiT FF half-block for Hopper (sm_90a), kernel 4:
//   y   = LN(h) * (1 + sc) + sh                              (fp32)
//   z   = gelu_tanh(q(y) @ W1^T * ys * w1s + b1)             (fp32)
//   out = bf16(h + gate * (q(z) @ W2^T * zs * w2s + b2))
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/ff_block.py:_kernel_int8 (via
// ff_block_fused_int8). h, out: [M, d] bf16; sc, sh, gate: [d] bf16; W1:
// [dff, d] and W2: [d, dff] int8 (torch layout); w1s [dff], w2s [d] fp32; b1,
// b2 bf16.
//
// What bounds it on the card: at the main-path shape (M = 3072, d = 1024,
// dff = 2048) a call is 25.8 GOP of int8 products (0.013 ms at the 1,979
// TOP/s dense int8 peak) and, with the fp32 z below, ~75 MB of traffic
// (0.022 ms at 3.35 TB/s, less where z stays in L2): the two are close, and
// this simple product (mma.sync, synchronous loads) is far from either peak,
// so its tensor-core instruction throughput bounds it. The hard part is the
// second quantization: z is quantized per row over all of dff from fp32 (the
// TPU kernel never rounds z to bf16, ff_block.py:118-120), and
// a 64-row tile of fp32 z is 512 KB, more than a block's 227 KB of shared
// memory. Kernel B's bf16 z would be the wrong function here.
//
// Design: four launches behind one entry point (int8_gemm.cuh):
//   1. quant_rows (LN prologue): LN statistics and y per row, yq int8 + ys;
//   2. int8 product with W1, epilogue rescale + b1 + GELU -> z in fp32
//      (25 MB at the main shape, about half of the 50 MB L2);
//   3. quant_rows over z: zq int8 + zs (the TPU's own rounding point);
//   4. int8 product with W2, epilogue rescale + b2 + gated residual.
// z is written once in fp32 and read once; a single sweep of dff per row
// tile with a running max would avoid that round trip and is later work.
#include "int8_gemm.cuh"

extern "C" int f5_ff_block_int8_fwd(const void* h, const void* sc, const void* sh,
                                    const void* gate, const void* w1, const void* w1s,
                                    const void* b1, const void* w2, const void* w2s,
                                    const void* b2, void* yq, void* ys, void* z, void* zq,
                                    void* zs, void* out, int M, int d, int dff, float eps,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::i8_shapes_ok(M, d, dff) || !f5::i8_shapes_ok(M, dff, d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef f5::bf16 T;
  int8_t* q1 = static_cast<int8_t*>(yq);
  float* s1 = static_cast<float*>(ys);
  int8_t* q2 = static_cast<int8_t*>(zq);
  float* s2 = static_cast<float*>(zs);
  err = f5::launch_quant_rows<f5::kSrcLnMod>(h, static_cast<const T*>(sc),
                                             static_cast<const T*>(sh), q1, s1, M, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = f5::launch_i8_gemm<f5::kEpiGeluF32>(f5::i8_args(q1, s1, w1, w1s, b1, z, M, dff, d), s);
  if (err != cudaSuccess) return (int)err;
  err = f5::launch_quant_rows<f5::kSrcF32>(z, nullptr, nullptr, q2, s2, M, dff, 0.f, s);
  if (err != cudaSuccess) return (int)err;
  f5::GemmArgs p = f5::i8_args(q2, s2, w2, w2s, b2, out, M, d, dff);
  p.h = static_cast<const T*>(h);
  p.gate = static_cast<const T*>(gate);
  return (int)f5::launch_i8_gemm<f5::kEpiGatedResidual>(p, s);
}

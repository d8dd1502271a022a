// Fused bf16 attention-side linears of the DiT block for Hopper (sm_90a).
//
// Kernel 7, f5_ln_mod_matmul_fwd:
//   out = bf16(LN(h) * (1 + sc) + sh) @ [Wq; Wk; Wv]^T + [bq; bk; bv]
// replaces the TPU kernel korean_f5_tts_tpu/ops/fused_linears.py:
// _ln_mod_matmul_kernel (via ln_mod_matmul). Rounding points follow it: LN
// and modulation in fp32, y rounded to bf16 before the product, fp32
// accumulation, + b in fp32, one cast. h: [M, d] bf16; sc, sh: [d]; one to
// three weights [seg_n, d] (torch Linear layout) with biases [seg_n], read
// as segments of the output's columns, so no [3 * seg_n, d] weight is
// concatenated per call; out: [M, nseg * seg_n].
//
// Kernel 8, f5_proj_gated_fwd:
//   out = h + gate * (a @ W^T + b)
// replaces _proj_gated_kernel (via proj_gated_residual): product, + b and
// the gated residual in fp32, one cast. a: [M, din]; h, out: [M, d];
// W: [d, din]; b, gate: [d].
//
// What bounds them on the card: at the main-path shape (M = 3072, d = 1024)
// kernel 7 is 19.3 GFLOP against 31.5 MB (h, three weights, the [M, 3072]
// output) and kernel 8 is 6.4 GFLOP against 21 MB (a, h, W, out): the
// products bound kernel 7 (0.0195 ms at 989 TFLOP/s against 0.0094 ms of
// memory traffic), and kernel 8 sits where the two meet (0.0065 ms against
// 0.0063 ms). What the fusion saves is the plain path's passes over [M, d]:
// LN, the modulation and the cast before the product (kernel 7), the
// product's own output and the gated add after it (kernel 8).
//
// Design: the two product kernels of gemm_bf16.cuh that the FF half-block
// also runs (TMA-fed ring, wgmma, 128 x 128 or 128 x 256 tiles; its note has
// the stages and the tile counts per wave): kernel 7 is its first product
// without the GELU, over three weight segments, each with its own tensor
// map picked by the column tile; kernel 8 its second at K = din. Rows past M
// read as zeros and are never stored, so M needs no multiple.
//
// fp32 forms (f5_ln_mod_matmul_f32_fwd, f5_proj_gated_f32_fwd; the offline
// entry points keep fp32 weights, and the JAX kernels compute at the
// input's dtype, fused_linears.py:34-43 and :198-202): the split 3xTF32
// products of gemm_f32.cuh that kernel B's fp32 form runs (wgmma .tf32, hi
// and lo of each operand, fp32-accurate; one TF32 pass keeps 10 mantissa
// bits, ~1e-3, which the 1e-4 bound of the fp32 forms tells apart). Kernel 7
// forms LN(h) * (1 + sc) + sh in fp32 in registers from the row statistics,
// multiplies and adds b; kernel 8 multiplies, adds b, then h + gate * (.);
// nothing is rounded below fp32 and both write fp32. Bound at the main
// shape: the TF32 rate taken three times (19.3 GFLOP, 0.117 ms for 7; 6.4
// GFLOP, 0.039 ms for 8).
#include "gemm_f32.cuh"

// stats: [2, M] fp32 scratch; d % 8 == 0, d <= 4096, seg_n % 128 == 0,
// 1 <= nseg <= 3. The tile width is gemm_tile_n()'s.
extern "C" int f5_ln_mod_matmul_fwd(const void* h, const void* sc, const void* sh,
                                    const void* w0, const void* w1, const void* w2,
                                    const void* b0, const void* b1, const void* b2, void* stats,
                                    void* out, int M, int d, int seg_n, int nseg, float eps,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::gemm_dims_ok(M, seg_n, d) || d > f5::kMaxLnDim || nseg < 1 || nseg > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const ws[3] = {w0, w1, w2};
  const void* const bs[3] = {b0, b1, b2};
  return (int)(f5::gemm_tile_n(M, nseg * seg_n, seg_n) == 256
                   ? f5::launch_ln_mod_gemm<256, false>(h, sc, sh, ws, bs, stats, out, M, d,
                                                        seg_n, nseg, eps, s)
                   : f5::launch_ln_mod_gemm<128, false>(h, sc, sh, ws, bs, stats, out, M, d,
                                                        seg_n, nseg, eps, s));
}

// din % 8 == 0, d % 128 == 0
extern "C" int f5_proj_gated_fwd(const void* a, const void* h, const void* gate, const void* w,
                                 const void* b, void* out, int M, int din, int d, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::gemm_dims_ok(M, d, din)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(f5::gemm_tile_n(M, d, d) == 256
                   ? f5::launch_gated_residual_gemm<256>(a, w, b, h, gate, out, M, d, din, s)
                   : f5::launch_gated_residual_gemm<128>(a, w, b, h, gate, out, M, d, din, s));
}

// kernel 7's fp32 form: h [M, d], sc, sh [d], up to three weights [seg_n, d]
// and biases [seg_n], out [M, nseg * seg_n], stats [2, M] scratch, all fp32;
// d % 4 == 0, d <= 4096, seg_n % 128 == 0
extern "C" int f5_ln_mod_matmul_f32_fwd(const void* h, const void* sc, const void* sh,
                                        const void* w0, const void* w1, const void* w2,
                                        const void* b0, const void* b1, const void* b2,
                                        void* stats, void* out, int M, int d, int seg_n, int nseg,
                                        float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* const ws[3] = {w0, w1, w2};
  const void* const bs[3] = {b0, b1, b2};
  return (int)f5::launch_ln_mod_gemm_f32<false>(h, sc, sh, ws, bs, stats, out, M, d, seg_n, nseg,
                                                eps, static_cast<cudaStream_t>(stream));
}

// kernel 8's fp32 form: a [M, din], h, out [M, d], W [d, din], b, gate [d], all
// fp32; din % 4 == 0, d % 128 == 0
extern "C" int f5_proj_gated_f32_fwd(const void* a, const void* h, const void* gate,
                                     const void* w, const void* b, void* out, int M, int din,
                                     int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)f5::launch_gated_residual_gemm_f32(a, w, b, h, gate, out, M, d, din,
                                                 static_cast<cudaStream_t>(stream));
}

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
// Design: the two kernels of gemm_bf16.cuh that the FF half-block also runs
// (64x128 tiles, four warps, mma.sync m16n8k16): kernel 7 is its first
// product without the GELU, over three weight segments; kernel 8 its second
// at K = din. Rows past M are zero-filled and never stored, so M needs no
// multiple.
#include "gemm_bf16.cuh"

// d % 32 == 0, seg_n % 128 == 0, 1 <= nseg <= 3
extern "C" int f5_ln_mod_matmul_fwd(const void* h, const void* sc, const void* sh,
                                    const void* w0, const void* w1, const void* w2,
                                    const void* b0, const void* b1, const void* b2, void* out,
                                    int M, int d, int seg_n, int nseg, float eps, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || d % f5::kBK != 0 || seg_n % f5::kBN != 0 || nseg < 1 || nseg > 3)
    return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + f5::kBM - 1) / f5::kBM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  typedef f5::bf16 T;
  f5::ln_mod_gemm_kernel<false>
      <<<dim3(nseg * seg_n / f5::kBN, m_tiles), f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(h), static_cast<const T*>(sc), static_cast<const T*>(sh),
          static_cast<const T*>(w0), static_cast<const T*>(w1), static_cast<const T*>(w2),
          static_cast<const T*>(b0), static_cast<const T*>(b1), static_cast<const T*>(b2),
          static_cast<T*>(out), M, d, seg_n, eps);
  return (int)cudaGetLastError();
}

// din % 32 == 0, d % 128 == 0
extern "C" int f5_proj_gated_fwd(const void* a, const void* h, const void* gate, const void* w,
                                 const void* b, void* out, int M, int din, int d, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || din % f5::kBK != 0 || d % f5::kBN != 0) return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + f5::kBM - 1) / f5::kBM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  typedef f5::bf16 T;
  f5::gated_residual_gemm_kernel
      <<<dim3(d / f5::kBN, m_tiles), f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(w), static_cast<const T*>(b),
          static_cast<const T*>(h), static_cast<const T*>(gate), static_cast<T*>(out), M, d, din);
  return (int)cudaGetLastError();
}

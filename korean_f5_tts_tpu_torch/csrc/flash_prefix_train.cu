// Prefix-masked flash attention for training, for Hopper (sm_90a): the
// forward with its logsumexp and the backward sweeps.
//
// Replaces the TPU kernels of korean_f5_tts_tpu/ops/flash_prefix.py:
//   10  _flash_prefix_folded_lse -> _kernel_lse      (o and lse)
//   11  _flash_prefix_dq_lsein   -> _kernel_dq_lsein (dq from the forward's lse)
//   12  _flash_prefix_dq         -> _kernel_dq       (dq, recomputing the lse)
//   13  _flash_prefix_dkv        -> _kernel_dkv      (dk and dv)
// q, k, v, dO, o, dq, dk, dv: [H, n, D] bf16 (batch folded into heads);
// kv_lens: [H] int32; lse and D = rowsum(dO * o): [H, n] fp32. Folded head h
// attends keys [0, kv_lens[h]). lse is the JAX convention: base 2, of the
// scores pre-scaled by scale_log2 = log2(e) / sqrt(D).
//
// What bounds them on the card: at the training shape (b = 8 x 16 heads =
// H = 128, n = 1280, D = 64) kernel 10 is 4*n*n*D*H = 53.7 GFLOP, 11 and 12
// are 6*n*n*D*H = 80.5 and 13 is 8*n*n*D*H = 107 GFLOP, against 84-126 MB of
// [H, n, D] operands each: tensor-core bound, and the n x n scores must stay
// out of device memory (the plain versions write a 839 MB fp32 [H, n, n]
// tensor per product).
//
// Where each runs:
//   - 10: on the attention core of kernel A (attn_wgmma.cuh, TMA + wgmma,
//     192 query rows a block), whose lse form also writes lse = m + log2(l)
//     per row (0 for a row with no valid key, with zero output).
//   - 11, 12, 13: on the attention backward core (attn_bwd_wgmma.cuh, TMA +
//     wgmma). 13: one block per (head, 128 keys), K and V resident in shared
//     memory, 64-query tiles of Q, dO, lse and D streamed through an mbarrier
//     ring, S^T, dP^T, dV += P^T.dO and dK += dS^T.q on wgmma. 11: one block
//     per (head, 128 queries), Q and dO resident, 128-key tiles of K and V
//     streamed, S, dP and dq += dS.K on wgmma. No atomics in either. 12: 11's
//     kernel with a running max and denominator in place of the lse
//     (kLseOut): the accumulator is rescaled on each max update once the
//     previous tile's product has landed, divided by l at the end (dS is
//     linear in P), dq *= 1/sqrt(D), and the lse it ends with is written out.
//   - fp32 operands: flash_prefix_train_f32.cu (11, 12, 13) and kernel A's
//     fp32 kernel with an lse output (flash_prefix.cu, 10), split 3xTF32
//     products on the tensor cores.
//   - D = 128: 10 in bf16 on the attention core's D = 128 form
//     (attn_wgmma.cuh: attn_fwd_d128_wgmma_kernel<true, false>, through
//     flash_prefix_core_d128.cu); 13 in bf16 on the backward core's D = 128
//     form (flash_prefix_bwd_core_d128.cu: attn_dkv_d128_wgmma_kernel, built
//     from attn_bwd_wgmma.cuh's pieces), 11 and 12 in bf16 on its dq form
//     (the same file: attn_dq_d128_wgmma_kernel<kLseOut>, 128 queries a
//     block, 64-key K/V tiles, the D = 64 dq core's cross-tile overlap);
//     10-13 in fp32 on split 3xTF32 (flash_prefix_tf32_d128.cu,
//     flash_prefix_train_tf32_d128.cu, through flash_prefix.cu and
//     flash_prefix_train_f32.cu); the entry points below hand a d = 128
//     call there.
// Rows past n are zero-filled on load and never stored; a row with no valid
// key gets lse 0 and zero gradients.
//
// Numerics: the scale meets the fp32 product (S * scale_log2) in all four
// kernels; the TPU dq kernels scale q in its own dtype first (:987, :1047)
// and its dk/dv kernel the fp32 product (:1173), so the bf16 bounds of the
// comparisons cover that one rounding.
#include "attn_bwd_wgmma.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace {

// the training kernels take D = 64 (the DiT's head dim; the wgmma cores) and
// D = 128 (their D = 128 forms, flash_prefix_d128.cuh)
int check_args(int device, int H, int n, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
}  // namespace f5

// kernel 10, on the attention core
extern "C" int f5_flash_prefix_fwd_lse(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, void* lse, int H, int n,
                                       int d, float scale_log2, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::core(q, k, v, kv_lens, nullptr, nullptr, out, lse, H, 1, n, 0,
                               scale_log2, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_attn_fwd_wgmma<true>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                              static_cast<cudaStream_t>(stream));
}

// kernel 11, on the attention backward core
extern "C" int f5_flash_prefix_dq_lsein(const void* q, const void* k, const void* v,
                                        const void* dout, const void* dvec, const void* lse,
                                        const void* kv_lens, void* dq, int H, int n, int d,
                                        float scale_log2, float sm_scale, int device,
                                        void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::core_dq(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H, n,
                                  scale_log2, sm_scale, false, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_attn_dq_wgmma<false>(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H,
                                              n, scale_log2, sm_scale,
                                              static_cast<cudaStream_t>(stream));
}

// kernel 12, on the attention backward core (11's kernel recomputing the lse)
extern "C" int f5_flash_prefix_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* dvec, const void* kv_lens,
                                  void* dq, void* lse_out, int H, int n, int d, float scale_log2,
                                  float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::core_dq(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                  scale_log2, sm_scale, true, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_attn_dq_wgmma<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out,
                                             H, n, scale_log2, sm_scale,
                                             static_cast<cudaStream_t>(stream));
}

// kernel 13, on the attention backward core
extern "C" int f5_flash_prefix_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* dvec, const void* lse,
                                   const void* kv_lens, void* dk, void* dv, int H, int n, int d,
                                   float scale_log2, float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::core_dkv(q, k, v, dout, dvec, lse, kv_lens, dk, dv, H, n, scale_log2,
                                   sm_scale, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_attn_dkv_wgmma(q, k, v, dout, dvec, lse, kv_lens, dk, dv, H, n,
                                        scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// Kernel 14 at head dim 128 in "qkpv" (bf16 or fp32 output) and in "qk" on
// bf16 v, on the int8 kernel of the attention core's D = 128 form
// (attn_wgmma.cuh: attn_i8_d128_wgmma_kernel, whose note gives the design and
// what bounds it). It replaces, in those three forms, the TPU kernel
// korean_f5_tts_tpu/ops/flash_prefix.py:_flash_prefix_folded_i8 -> _kernel_i8,
// which the JAX dispatch takes at d in (64, 128) (ops/attention.py:296-330).
// Its entry point is f5_flash_prefix_i8_d128_fwd (flash_prefix_int8_d128.cu),
// which routes the fp32 "qk" form to that file's split 3xTF32 kernel. A
// source of its own, so that nvcc builds the three instantiations beside the
// others.
#include "attn_wgmma.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace d128 {

cudaError_t i8_core(const void* q8, const void* k8, const void* v, const void* c,
                    const void* sv, const void* kv_lens, void* out, int H, int n, int n_pad,
                    bool pv_i8, bool out_f32, cudaStream_t stream) {
  if (!pv_i8)
    return out_f32 ? cudaErrorInvalidValue
                   : launch_attn_i8_d128<kAttnI8Qk>(q8, k8, v, c, sv, kv_lens, out, H, n, n_pad,
                                                    stream);
  return out_f32 ? launch_attn_i8_d128<kAttnI8QkpvF32>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                       n_pad, stream)
                 : launch_attn_i8_d128<kAttnI8Qkpv>(q8, k8, v, c, sv, kv_lens, out, H, n, n_pad,
                                                    stream);
}

}  // namespace d128
}  // namespace f5

// Kernels A, 10 and 18 at head dim 128 in bf16, on the TMA + wgmma
// attention core (attn_wgmma.cuh: attn_fwd_d128_wgmma_kernel, whose note
// gives the design and what bounds it). They replace the TPU kernels
// korean_f5_tts_tpu/ops/flash_prefix.py:_flash_prefix_folded ->
// _kernel_nomax_hn (A), _flash_prefix_folded_lse -> _kernel_lse (10) and
// _flash_prefix_rope_call -> _kernel_rope (18) at d = 128, which the JAX
// dispatch takes at d in (64, 128) (ops/attention.py:260, :296). Their entry
// points are f5_flash_prefix_fwd (flash_prefix.cu), f5_flash_prefix_fwd_lse
// (flash_prefix_train.cu) at d = 128 and f5_flash_prefix_rope_d128_fwd
// (flash_prefix_d128.cu) on bf16 operands; the fp32 forms of A, 10 and 18
// run on the split 3xTF32 kernel of flash_prefix_tf32_d128.cu, and
// f5_flash_prefix_d128_fwd_mma runs A, 10 and 18 on the mma.sync loop this
// core replaced. A source of its own, so
// that nvcc builds the core's three instantiations beside the others.
//
// The key tile: 18 must equal A on roped inputs to the bit, so both run one.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2 of a build that had
// both, its rotation then on three warps; PERF.md section 6) at the serving
// shape, 128-key tiles (A three stages, 18 two: its stage also holds the
// tables) took A 0.0405 ms and 18 0.0647 ms, 64-key tiles (A six stages, 18
// four) A 0.0447 ms and 18 0.0699 ms: 128-key tiles are kept.
#include "attn_wgmma.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace d128 {

cudaError_t core(const void* q, const void* k, const void* v, const void* kv_lens,
                 const void* cos, const void* sin, void* out, void* lse, int H, int heads,
                 int n, int n_rope, float scale_log2, cudaStream_t stream) {
  if (cos != nullptr)
    return lse ? cudaErrorInvalidValue
               : launch_attn_fwd_d128<false, true>(q, k, v, kv_lens, cos, sin, out, nullptr, H,
                                                   heads, n, n_rope, scale_log2, stream);
  if (lse != nullptr)
    return launch_attn_fwd_d128<true, false>(q, k, v, kv_lens, nullptr, nullptr, out, lse, H, 1,
                                             n, 0, scale_log2, stream);
  return launch_attn_fwd_d128<false, false>(q, k, v, kv_lens, nullptr, nullptr, out, nullptr, H,
                                            1, n, 0, scale_log2, stream);
}

}  // namespace d128
}  // namespace f5

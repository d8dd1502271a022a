// The attention kernels at head dim 128 (flash_prefix_d128.cu, and A and 18
// in bf16 on the attention core, flash_prefix_core_d128.cu), as host
// launchers that the d = 64 entry points of flash_prefix.cu,
// flash_prefix_train.cu and flash_prefix_train_f32.cu hand a d = 128 call
// to. Operands are folded [H, n, 128] heads, bf16 (f32 == false) or fp32;
// kv_lens [H] int32; lse and D = rowsum(dO * o) [H, n] fp32.
#pragma once

#include <cuda_runtime.h>

namespace f5 {
namespace d128 {

// kernels A (cos == nullptr: heads 1, kv_lens [H]) and 18 (kv_lens [H /
// heads] per item, cos, sin [n, 64] bf16, heads g < n_rope rotate) in bf16 on
// the TMA + wgmma attention core (attn_wgmma.cuh, flash_prefix_core_d128.cu)
cudaError_t core(const void* q, const void* k, const void* v, const void* kv_lens,
                 const void* cos, const void* sin, void* out, int H, int heads, int n,
                 int n_rope, float scale_log2, cudaStream_t stream);

// kernels A (lse == nullptr) and 10 (lse written) on the mma.sync loop (bf16;
// A's serving forward runs on core(), this loop is kept for 10 and for
// timing the two designs) or FFMA (fp32)
cudaError_t fwd(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                void* lse, int H, int n, float scale_log2, bool f32, cudaStream_t stream);

// kernels 11 (online == false: lse_in read) and 12 (online: lse_out written)
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
               const void* lse_in, const void* kv_lens, void* dq, void* lse_out, int H, int n,
               float scale_log2, float sm_scale, bool online, bool f32, cudaStream_t stream);

// kernel 13
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
                const void* lse, const void* kv_lens, void* dk, void* dv, int H, int n,
                float scale_log2, float sm_scale, bool f32, cudaStream_t stream);

}  // namespace d128
}  // namespace f5

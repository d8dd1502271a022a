// The attention kernels at head dim 128 (flash_prefix_d128.cu: the designs
// kept for timing; A, 10 and 18 in bf16 on the attention core,
// flash_prefix_core_d128.cu; 14 but its fp32 "qk" form on the core's int8
// kernel, flash_prefix_int8_core_d128.cu; 11, 12 and 13 in bf16 on the
// attention backward core, flash_prefix_bwd_core_d128.cu; A, 10 and 18
// in fp32 on split 3xTF32, flash_prefix_tf32_d128.cu; 11-13 in fp32 on split
// 3xTF32, flash_prefix_train_tf32_d128.cu), as host
// launchers that the d = 64 entry points of flash_prefix.cu,
// flash_prefix_train.cu and flash_prefix_train_f32.cu hand a d = 128 call
// to. Operands are folded [H, n, 128] heads, bf16 (f32 == false) or fp32;
// kv_lens [H] int32; lse and D = rowsum(dO * o) [H, n] fp32.
#pragma once

#include <cuda_runtime.h>

namespace f5 {
namespace d128 {

// kernels A (cos == nullptr, lse == nullptr: heads 1, kv_lens [H]), 10 (cos
// == nullptr, lse [H, n] fp32 written) and 18 (lse == nullptr; kv_lens [H /
// heads] per item, cos, sin [n, 64] bf16, heads g < n_rope rotate) in bf16 on
// the TMA + wgmma attention core (attn_wgmma.cuh, flash_prefix_core_d128.cu)
cudaError_t core(const void* q, const void* k, const void* v, const void* kv_lens,
                 const void* cos, const void* sin, void* out, void* lse, int H, int heads,
                 int n, int n_rope, float scale_log2, cudaStream_t stream);

// kernels A (cos == nullptr, lse == nullptr: heads 1, kv_lens [H]), 10 (cos
// == nullptr, lse [H, n] fp32 written) and 18 (lse == nullptr; as core()'s,
// cos, sin [n, 64] fp32) in fp32 on split 3xTF32 products
// (flash_prefix_tf32_d128.cu)
cudaError_t tf32(const void* q, const void* k, const void* v, const void* kv_lens,
                 const void* cos, const void* sin, void* out, void* lse, int H, int heads,
                 int n, int n_rope, float scale_log2, cudaStream_t stream);

// kernel 14 in "qkpv" (pv_i8; bf16, or fp32 with out_f32) and in "qk" on
// bf16 v (pv_i8 and out_f32 false) on the int8 kernel of the attention
// core's D = 128 form (attn_wgmma.cuh, flash_prefix_int8_core_d128.cu): q8,
// k8 [H, n, 128] int8, v the pass's v8 [H, 128, n_pad] or bf16 [H, n, 128],
// c, sv [H] fp32, kv_lens [H]
cudaError_t i8_core(const void* q8, const void* k8, const void* v, const void* c,
                    const void* sv, const void* kv_lens, void* out, int H, int n, int n_pad,
                    bool pv_i8, bool out_f32, cudaStream_t stream);

// kernel 13 in bf16 on the D = 128 form of the TMA + wgmma attention
// backward core (flash_prefix_bwd_core_d128.cu, on attn_bwd_wgmma.cuh)
cudaError_t core_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* dvec, const void* lse, const void* kv_lens, void* dk, void* dv,
                     int H, int n, float scale_log2, float sm_scale, cudaStream_t stream);

// kernels 11 (online == false: lse_in read) and 12 (online: lse_out written)
// in bf16 on the D = 128 form of the backward core's dq kernel
// (flash_prefix_bwd_core_d128.cu, on attn_bwd_wgmma.cuh)
cudaError_t core_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                    void* lse_out, int H, int n, float scale_log2, float sm_scale, bool online,
                    cudaStream_t stream);

// kernels A (lse == nullptr) and 10 (lse written) on the mma.sync loop (bf16)
// or FFMA (fp32): they serve no path (core() and tf32() do), and are kept to
// time the designs that replaced them (f5_flash_prefix_d128_fwd_mma,
// f5_flash_prefix_f32_d128_fwd_ffma)
cudaError_t fwd(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                void* lse, int H, int n, float scale_log2, bool f32, cudaStream_t stream);

// kernel 18 on the mma.sync loop (bf16) or FFMA (fp32), kept for timing: q, k,
// v, out [B * heads, n, 128], kv_lens [B], cos, sin [n, 64] of the operands'
// dtype
cudaError_t rope_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                     const void* cos, const void* sin, void* out, int B, int heads, int n,
                     int n_rope, float scale_log2, bool f32, cudaStream_t stream);

// kernels 11 (online == false: lse_in read) and 12 (online: lse_out written)
// and 13 in fp32 on split 3xTF32 products (flash_prefix_train_tf32_d128.cu)
cudaError_t tf32_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                    void* lse_out, int H, int n, float scale_log2, float sm_scale, bool online,
                    cudaStream_t stream);

cudaError_t tf32_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* dvec, const void* lse, const void* kv_lens, void* dk, void* dv,
                     int H, int n, float scale_log2, float sm_scale, cudaStream_t stream);

// kernels 11 (online == false: lse_in read) and 12 (online: lse_out written)
// on mma.sync (bf16) or FFMA (fp32): both serve no path (core_dq() and
// tf32_dq() do) and are kept to time the designs that replaced them
// (f5_flash_prefix_d128_bwd_mma, f5_flash_prefix_f32_d128_bwd_ffma)
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
               const void* lse_in, const void* kv_lens, void* dq, void* lse_out, int H, int n,
               float scale_log2, float sm_scale, bool online, bool f32, cudaStream_t stream);

// kernel 13 on mma.sync (bf16) or FFMA (fp32): both serve no path
// (core_dkv() and tf32_dkv() do) and are kept to time the designs that
// replaced them (f5_flash_prefix_d128_bwd_mma, f5_flash_prefix_f32_d128_bwd_ffma)
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
                const void* lse, const void* kv_lens, void* dk, void* dv, int H, int n,
                float scale_log2, float sm_scale, bool f32, cudaStream_t stream);

}  // namespace d128
}  // namespace f5

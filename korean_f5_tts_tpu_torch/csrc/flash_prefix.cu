// Prefix-masked flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded -> _kernel_nomax_hn / _kernel_nomax / _kernel.
// q, k, v, out: [H, n, D] bf16 (batch folded into heads); kv_lens: [H] int32.
// Folded head h attends keys [0, kv_lens[h]); every query row, padded ones
// included, gets a well-defined softmax over those keys.
//
// What bounds it on the card: at the main-path shape (H = 32, n = 1536,
// D = 64) one call is 4*n*n*D*H = 19.3 GFLOP against 25 MB of q/k/v/out, so
// it is tensor-core bound, and the n x n logits must never reach device
// memory (the plain version writes 302 MB of fp32 logits per call).
//
// Design: one 128-thread block per (folded head, 64-row query tile); each
// warp owns 16 query rows and keeps them in registers as mma A fragments.
// The block walks 64-key K/V tiles through shared memory; S = q.k^T and
// O += P.V run on mma.sync m16n8k16 with fp32 accumulation, and P never
// leaves registers (the S accumulator is re-packed in place as the A operand
// of P.V). The KV loop stops at ceil(kv_len / 64) tiles: that is the TPU
// kernel's `prune` semantics, and on a GPU it costs no predication. The
// partial last tile is masked per column, and rows past n are zero-filled on
// load and never stored, so n needs no tile multiple.
//
// Numerics: online-max softmax (running max and denominator in fp32) with
// log2(e) folded into the scale, so exp is exp2. The TPU default's static
// max (flash_prefix.py:147 STATIC_MAX_C) is a VPU trade that only holds for
// logits in range; it is not carried over. P is rounded to bf16 for the P.V
// product (the row sums use fp32 P), as in FlashAttention-2.
//
// The loop is flash_prefix_fwd_kernel in flash_prefix.cuh, which kernel 10
// (flash_prefix_train.cu) instantiates with its logsumexp output.
#include "flash_prefix.cuh"

extern "C" int f5_flash_prefix_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int H, int n, int d,
                                   float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)f5::launch_fwd<64, false>(q, k, v, kv_lens, out, nullptr, H, n, scale_log2, s);
  if (d == 128)
    return (int)f5::launch_fwd<128, false>(q, k, v, kv_lens, out, nullptr, H, n, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* f5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

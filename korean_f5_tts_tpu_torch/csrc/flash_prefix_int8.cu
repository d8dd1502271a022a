// Prefix-masked flash attention with int8 products, forward, for Hopper
// (sm_90a): kernel 14.
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded_i8 -> _kernel_i8. The function, per folded head h with
// c = aq*ak/127^2 * log2(e)/sqrt(d) and sv = av/127^2 (written by the
// quantization pass, quant_heads.cu, in the JAX wrapper's order):
//   s   = float(q8 . k8^T) * c[h]            exact int32 product, base-2 domain
//   keys at or past kv_lens[h] are masked; online max m and sum l in fp32,
//   l adds the unquantized p = exp2(s - m), m taken per chunk of 512 keys
//   from key 0 (the JAX kernel's _chunk_plan at its default bkv)
//   "qkpv": p8 = rint(127 * p) (ties to even), acc = acc*alpha + float(p8 . v8) * sv[h]
//           once a chunk
//   "qk":   acc = acc*alpha + bf16(p) . v     (v unquantized bf16)
//   out = acc / l, rounded once to bf16; in "qkpv" on the quantized operands
//   of fp32 inputs (kernel 14's fp32 form), stored as fp32 (kAttnI8QkpvF32)
// p8 depends on the running max at the time a chunk is visited, so the chunk
// (512 keys) is part of the arithmetic: the plain version
// (ops/flash_prefix.py:flash_prefix_i8_reference) repeats it with its
// default ck = I8_KEY_CHUNK, the JAX kernel's chunking at its default bkv.
//
// What bounds it on the card: at the main shape (H = 32, n = 1536, d = 64,
// 1376 valid keys) 17.3 GOP of int8 products (0.0087 ms at the 1,979 TOP/s
// int8 peak) against 9.4 MB of int8 in and 6.3 MB of bf16 out, and 67.6 M
// exponentials that take the SFUs (16 a clock per SM) ~0.018 ms: the
// exponentials set the floor, as they nearly do for kernel A.
//
// Design: the int8 form of kernel A's TMA + wgmma attention core
// (attn_wgmma.cuh, kI8; its header has the details): 192 query rows a
// block on three consumer warpgroups, a TMA producer warpgroup streaming
// 128-key tiles of k8 (and v8, or bf16 v) through a six-stage ring that
// keeps a chunk's four tiles resident across its two sweeps (the first for
// the chunk's max, the second recomputing S for p and P.V), S on
// wgmma m64n128k32 .s32.s8.s8, p8 packed in registers into the 8-bit A
// fragment, P.V on wgmma m64n64k32 .s32.s8.s8 with A from registers (or A's
// bf16 P.V under "qk"). The q8 and k8 rows are 64 bytes: their 3-D maps take
// the core's 128-byte boxes, which TMA fills past the row with zeros, so the
// tiles are the core's swizzled [rows][128 bytes] and S reads their first
// half in two k32 steps. v8 arrives in the layout the pass writes, [H, 64,
// n_pad] with n_pad a multiple of 128, keys contiguous (the k-major B of
// P.V) and permuted in groups of 32 so that p8 packs as the accumulator
// holds it. It replaces an mma.sync m16n8k32 loop of 64-row query tiles and
// 64-key tiles through shared memory, whose quantization pass ran in torch
// ops at twice the kernel's time. Measured: PERF.md section 6.
#include "attn_wgmma.cuh"

namespace f5 {
namespace {

template <int kI8>
cudaError_t launch_attn_i8_wgmma(const void* q8, const void* k8, const void* v, const void* c,
                                 const void* sv, const void* kv_lens, void* out, int H, int n,
                                 int n_pad, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  const bool v_ok = attn_i8_pv8(kI8)
                        ? tensor_map_3d(&map_v, v, H, kAttnD, n_pad, kAttnD, kMapInt8)
                        : tensor_map_3d(&map_v, v, H, n, kAttnD, kAttnBK, kMapBf16);
  if (!tensor_map_3d(&map_q, q8, H, n, kAttnD, kAttnRows, kMapInt8) ||
      !tensor_map_3d(&map_k, k8, H, n, kAttnD, kAttnBK, kMapInt8) || !v_ok)
    return cudaErrorInvalidValue;
  constexpr int smem = attn_smem_bytes<false, kI8>();
  static_assert(smem <= 232448, "the ring must fit a block's shared memory");
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<false, false, kI8>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kAttnRows - 1) / kAttnRows, H);
  attn_fwd_wgmma_kernel<false, false, kI8><<<grid, 128 * (kAttnWgs + 1), smem, stream>>>(
      // out is fp32 under kAttnI8QkpvF32, whose epilogue casts it back
      map_q, map_k, map_v, static_cast<const int*>(kv_lens), static_cast<bf16*>(out), nullptr, n,
      0.f, AttnRope{}, static_cast<const float*>(c), static_cast<const float*>(sv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 64] int8. pv_i8 != 0: v is int8 [H, 64, n_pad] with the key
// slots of every group of 32 in the order above (n_pad % 128 == 0, zero past
// n); else v is bf16 [H, n, 64] and sv is not read. c, sv: [H] fp32; kv_lens:
// [H] int32; out: [H, n, 64] bf16, or fp32 with out_f32 (pv_i8 only: an fp32
// "qk" is flash_prefix_int8_f32.cu's). All 16-byte aligned.
extern "C" int f5_flash_prefix_i8_fwd(const void* q8, const void* k8, const void* v,
                                      const void* c, const void* sv, const void* kv_lens,
                                      void* out, int H, int n, int n_pad, int pv_i8, int out_f32,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || (out_f32 && !pv_i8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pv_i8) {
    if (n_pad < n || n_pad % f5::kAttnBK != 0) return (int)cudaErrorInvalidValue;
    if (out_f32)
      return (int)f5::launch_attn_i8_wgmma<f5::kAttnI8QkpvF32>(q8, k8, v, c, sv, kv_lens, out, H,
                                                               n, n_pad, s);
    return (int)f5::launch_attn_i8_wgmma<f5::kAttnI8Qkpv>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                          n_pad, s);
  }
  return (int)f5::launch_attn_i8_wgmma<f5::kAttnI8Qk>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                      n_pad, s);
}

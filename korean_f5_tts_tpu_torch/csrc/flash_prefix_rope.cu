// Prefix-masked flash attention with the rotary embedding applied inside the
// kernel, for Hopper (sm_90a), head dim 64: kernel 18.
//
// f5_flash_prefix_rope_fwd replaces the TPU kernel
// korean_f5_tts_tpu/ops/flash_prefix.py:_kernel_rope (via
// flash_prefix_rope_attention): q, k arrive PRE-rope as [B, heads, n, 64]
// bf16, and the separate rope passes over q and k never reach device memory.
// Item b attends keys [0, kv_lens[b]); heads at or past n_rope skip the
// rotation (pe_attn_head). The rotation is the half-split form on a row x of
// one head at position r, for column c < 32:
//   out[c]      = x[c]      * cos[r, c] - x[c + 32] * sin[r, c]
//   out[c + 32] = x[c + 32] * cos[r, c] + x[c]      * sin[r, c]
// Rounding: the TPU kernel multiplies in bf16 with tables cast to bf16; here
// the tables are the same bf16 values, the arithmetic is fp32 and the result
// rounds to bf16 once (ops/flash_prefix.py:rope_reference to the bit). The
// TPU's permutation product for the half swap is a workaround for a lane
// roll Mosaic lacks, and its head pairs and whole-region blocks exist for its
// 128-lane tiles: none is part of the function.
//
// What bounds it on the card: at the main-path shape (B = 2, 16 heads,
// n = 1536, 1376 valid keys) a call is 4 * 32 * 1536 * 1376 * 64 = 17.3
// GFLOP against 25 MB of q/k/v/out, so the tensor cores bound it (0.0175 ms
// at 989 TFLOP/s); the rotation adds ~1.5% of the products' flops and no
// device-memory traffic beyond the tables (n * 32 * 2 B each, L2-resident).
//
// Design: kernel 19's function from the split-head layout, so it is the rope
// form of kernel A's TMA + wgmma core (attn_wgmma.cuh, kRope; kernel 19,
// flash_prefix_qkv.cu, is the same instantiation): three strided 4-D tensor
// maps (hopper.cuh:tensor_map_4d), one each over q, k and v, whose slots are
// the heads (slot stride n * 64), rows the positions (row stride 64) and
// items the batch (item stride heads * n * 64), so that a box is one head's
// rows of one item and stops at row n with zeros; the output rows are stored
// back into [B, heads, n, 64]. Each head's rows are contiguous 128-byte rows
// here, where 19 reads 128-byte slices of 6 KB rows. 192 query rows a block
// on three consumer warpgroups, 128-key K/V tiles through a four-stage TMA
// ring, S and P.V on wgmma with P in registers, ping-pong; q rotated in
// shared memory by its consumer warpgroup, each K tile by three otherwise
// idle producer warps from the tile's rows of the tables, which TMA lands
// beside it. On the same values 18 and 19 compute the same thing in the same
// order: their outputs agree to the bit. It replaces flash_prefix.cuh's
// mma.sync loop (64-row query tiles streaming the whole K/V prefix each),
// which 18 ran on until 19's redesign reached it. Measured: PERF.md
// section 6.
#include "attn_wgmma.cuh"

namespace f5 {
namespace {

// q, k, v, out: [B, heads, n, 64] bf16 (q and k before the rotation),
// kv_lens [B] int32, cos and sin [n, 32] bf16; heads g < n_rope rotate. All
// 16-byte aligned.
cudaError_t launch_attn_rope_wgmma(const void* q, const void* k, const void* v,
                                   const void* kv_lens, const void* cos, const void* sin,
                                   void* out, int B, int heads, int n, int n_rope,
                                   float scale_log2, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || n <= 0 || (long long)B * heads > 65535)
    return cudaErrorInvalidValue;
  const uint64_t hs = (uint64_t)n * kAttnD, bs = (uint64_t)heads * hs;
  CUtensorMap map_q, map_k, map_v;
  AttnRope rope{};
  if (!tensor_map_4d(&map_q, q, heads, n, B, hs, kAttnD, bs, kAttnRows, kMapBf16) ||
      !tensor_map_4d(&map_k, k, heads, n, B, hs, kAttnD, bs, kAttnBK, kMapBf16) ||
      !tensor_map_4d(&map_v, v, heads, n, B, hs, kAttnD, bs, kAttnBK, kMapBf16) ||
      !tensor_map_table(&rope.map_cos, cos, n, 32, kAttnBK) ||
      !tensor_map_table(&rope.map_sin, sin, n, 32, kAttnBK))
    return cudaErrorInvalidValue;
  rope.cos = static_cast<const bf16*>(cos);
  rope.sin = static_cast<const bf16*>(sin);
  rope.heads = heads;
  rope.n_rope = n_rope;
  rope.slot_k = 0;  // each map holds one tensor: head g is slot g of all three
  rope.slot_v = 0;
  rope.out_bs = bs;
  rope.out_hs = hs;
  rope.out_ld = kAttnD;
  constexpr int smem = attn_smem_bytes<true>();
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<false, true>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kAttnRows - 1) / kAttnRows, B * heads);
  attn_fwd_wgmma_kernel<false, true><<<grid, 128 * (kAttnWgs + 1), smem, stream>>>(
      map_q, map_k, map_v, static_cast<const int*>(kv_lens), static_cast<bf16*>(out), nullptr,
      n, scale_log2, rope, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// q, k, v, out: [B, heads, n, 64] bf16; kv_lens: [B] int32; cos, sin: [n, 32] bf16
extern "C" int f5_flash_prefix_rope_fwd(const void* q, const void* k, const void* v,
                                        const void* kv_lens, const void* cos, const void* sin,
                                        void* out, int B, int heads, int n, int n_rope,
                                        float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)f5::launch_attn_rope_wgmma(q, k, v, kv_lens, cos, sin, out, B, heads, n, n_rope,
                                         scale_log2, static_cast<cudaStream_t>(stream));
}

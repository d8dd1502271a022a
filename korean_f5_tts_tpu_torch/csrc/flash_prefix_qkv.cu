// Prefix-masked attention straight from the fused qkv projection output, with
// the rotary embedding applied inside the kernel, for Hopper (sm_90a), head
// dim 64: kernel 19.
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:_kernel_qkv
// (via flash_prefix_qkv_attention): q | k | v are read from qkv [B, n, 3 *
// heads * 64] (heads-major inside each part, q and k before the rotation),
// the half-split rope is applied to q and k of the first n_rope heads, item b
// attends keys [0, kv_lens[b]), and the output is written merged as [B, n,
// heads * 64], so the head split, the rope passes and the head merge never
// reach device memory. The TPU kernel's head pairs, whole-region blocks and
// permutation product for the half swap exist for its 128-lane tiles and a
// lane roll Mosaic lacks; they are not carried over.
//
// Numerics: the rotation in fp32 from the bf16 tables, rounded once to bf16
// (ops/flash_prefix.py:rope_reference to the bit; the TPU kernel multiplies
// in bf16); then kernel A's attention (online softmax in fp32, P rounded to
// bf16 for P.V); an item with kv_len 0 gives zeros.
//
// What bounds it on the card: at the main-path shape (B 2, 16 heads, n 1536,
// 1376 valid keys) 4 * 32 * 1536 * 1376 * 64 = 17.3 GFLOP (0.0175 ms at 989
// TFLOP/s) against 25 MB of qkv, tables and output: the tensor cores. The
// rotation adds ~1.5% of the products' flops and no device-memory traffic
// beyond the tables (n * 64 bytes each, L2-resident).
//
// Design: the rope form of kernel A's TMA + wgmma core (attn_wgmma.cuh,
// kRope; kernel 18, flash_prefix_rope.cu, is the same instantiation over
// split heads): strided 4-D tensor maps over qkv, 192 query rows a block on three
// consumer warpgroups, 128-key K/V tiles through a four-stage TMA ring, S
// and P.V on wgmma with P in registers, ping-pong; q rotated in shared memory
// by its consumer warpgroup from the tables in L2, each K tile by three
// otherwise idle producer warps from the tile's rows of the tables, which
// TMA lands beside it in the stage, before the consumers read it. Measured:
// PERF.md section 6.
#include "attn_wgmma.cuh"

namespace f5 {
namespace {

// qkv [B, n, 3 * heads * 64] bf16 (q | k | v, heads-major inside each, q and
// k before the rotation), out [B, n, heads * 64], kv_lens [B] int32, cos and
// sin [n, 32] bf16; heads g < n_rope rotate. All 16-byte aligned.
cudaError_t launch_attn_qkv_wgmma(const void* qkv, const void* kv_lens, const void* cos,
                                  const void* sin, void* out, int B, int heads, int n, int n_rope,
                                  float scale_log2, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || n <= 0 || (long long)B * heads > 65535)
    return cudaErrorInvalidValue;
  const uint64_t slots = 3 * (uint64_t)heads, ld = slots * kAttnD;
  CUtensorMap map_q, map_kv;
  AttnRope rope{};
  if (!tensor_map_4d(&map_q, qkv, slots, n, B, kAttnD, ld, n * ld, kAttnRows, kMapBf16) ||
      !tensor_map_4d(&map_kv, qkv, slots, n, B, kAttnD, ld, n * ld, kAttnBK, kMapBf16) ||
      !tensor_map_table(&rope.map_cos, cos, n, 32, kAttnBK) ||
      !tensor_map_table(&rope.map_sin, sin, n, 32, kAttnBK))
    return cudaErrorInvalidValue;
  const size_t inner = (size_t)heads * kAttnD;
  rope.cos = static_cast<const bf16*>(cos);
  rope.sin = static_cast<const bf16*>(sin);
  rope.heads = heads;
  rope.n_rope = n_rope;
  rope.slot_k = heads;
  rope.slot_v = 2 * heads;
  rope.out_bs = (size_t)n * inner;
  rope.out_hs = kAttnD;
  rope.out_ld = inner;
  constexpr int smem = attn_smem_bytes<true>();
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<false, true>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kAttnRows - 1) / kAttnRows, B * heads);
  attn_fwd_wgmma_kernel<false, true><<<grid, 128 * (kAttnWgs + 1), smem, stream>>>(
      map_q, map_kv, map_kv, static_cast<const int*>(kv_lens), static_cast<bf16*>(out), nullptr,
      n, scale_log2, rope, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// qkv: [B, n, 3 * heads * 64] bf16; out: [B, n, heads * 64]; kv_lens: [B]
// int32; cos, sin: [n, 32] bf16
extern "C" int f5_flash_prefix_qkv_fwd(const void* qkv, const void* kv_lens, const void* cos,
                                       const void* sin, void* out, int B, int heads, int n,
                                       int n_rope, float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)f5::launch_attn_qkv_wgmma(qkv, kv_lens, cos, sin, out, B, heads, n, n_rope,
                                        scale_log2, static_cast<cudaStream_t>(stream));
}

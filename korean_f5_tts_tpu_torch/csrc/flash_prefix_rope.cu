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
// rounds to bf16 once. The TPU's permutation product for the half swap is a
// workaround for a lane roll Mosaic lacks, not part of the function: here a
// thread loads the two 16-byte halves of a row segment (columns c .. c + 7
// and c + 32 .. c + 39) and has both partners in registers.
//
// What bounds it on the card: at the main-path shape (B = 2, 16 heads,
// n = 1536, 1376 valid keys) a call is 4 * 32 * 1536 * 1376 * 64 = 17.3
// GFLOP against 25 MB of q/k/v/out, so the tensor cores bound it (0.0175 ms
// at 989 TFLOP/s); the rope costs 6 flops per element of a K tile that each
// query tile re-ropes, ~1.5 % of the products' work, and no device-memory
// traffic beyond the tables (n * 32 * 2 B each, L2-resident).
//
// Design: flash_prefix.cuh's forward loop (one 128-thread block per (item,
// head, 64-row query tile), 64-key tiles through shared memory, mma.sync
// m16n8k16, online softmax) with a loader that ropes rows as it stages them,
// addressing row r of head g of item b at base + b * bs + g * hs + r * ld.
// It streams the whole K/V prefix once per 64 query rows. Kernel 19, the same
// function from the fused qkv layout, runs on the rope form of kernel A's
// TMA + wgmma core (attn_wgmma.cuh, flash_prefix_qkv.cu), whose 4-D maps take
// this layout too (tensor_map_4d with slot stride n * 64). The TPU kernel's
// head pairs and whole-region blocks exist for its 128-lane tiles and are not
// carried over.
#include "flash_prefix.cuh"

namespace f5 {
namespace {

// One block per (64-row query tile, head, item). q, k, v: row r of head g of
// item b at ptr + b * in_bs + g * in_hs + r * in_ld; out likewise with the
// out_ strides (f5_flash_prefix_rope_fwd passes those of [B, heads, n, 64]).
__global__ void __launch_bounds__(kThreads)
flash_prefix_rope_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ kv_lens,
                             const bf16* __restrict__ cos, const bf16* __restrict__ sin,
                             bf16* __restrict__ out, int n, int n_rope, size_t in_bs,
                             size_t in_hs, size_t in_ld, size_t out_bs, size_t out_hs,
                             size_t out_ld, float scale_log2) {
  constexpr int ND = kD / 8;
  __shared__ __align__(16) bf16 sQ[kBQ * kLD];
  __shared__ __align__(16) bf16 sK[kBKV * kLD];
  __shared__ __align__(16) bf16 sV[kBKV * kLD];

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int item = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const size_t off = (size_t)item * in_bs + (size_t)head * in_hs;
  const int kv_len = min(kv_lens[item], n);
  const bool rope_on = head < n_rope;

  if (rope_on)
    load_rows_rope(sQ, q + off, in_ld, q0, n, cos, sin, tid);
  else
    load_rows_strided(sQ, q + off, in_ld, q0, n, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4];
  load_a_frags<kD>(qf, sQ, warp, lane);

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    if (rope_on)
      load_rows_rope(sK, k + off, in_ld, k0, n, cos, sin, tid);
    else
      load_rows_strided(sK, k + off, in_ld, k0, n, tid);
    load_rows_strided(sV, v + off, in_ld, k0, n, tid);
    __syncthreads();

    float s[kNS][4];
    mma_abt<kD>(s, qf, sK, lane);
    online_softmax_tile<ND>(s, o, m_run, l_run, k0, kv_len, scale_log2, t);
    mma_pb<kD>(o, s, sV, lane);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros, as the TPU kernel
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);
  store_output_rows<ND>(out + (size_t)item * out_bs + (size_t)head * out_hs, (int)out_ld, o, inv,
                        row0, n, t);
}

cudaError_t launch_rope(const void* q, const void* k, const void* v, const void* kv_lens,
                        const void* cos, const void* sin, void* out, int B, int heads, int n,
                        int n_rope, size_t in_bs, size_t in_hs, size_t in_ld, size_t out_bs,
                        size_t out_hs, size_t out_ld, float scale_log2, cudaStream_t stream) {
  if (B <= 0 || heads <= 0 || n <= 0 || heads > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((n + kBQ - 1) / kBQ, heads, B);
  flash_prefix_rope_fwd_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lens), static_cast<const bf16*>(cos),
      static_cast<const bf16*>(sin), static_cast<bf16*>(out), n, n_rope, in_bs, in_hs, in_ld,
      out_bs, out_hs, out_ld, scale_log2);
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
  const size_t hs = (size_t)n * f5::kD, bs = (size_t)heads * hs;
  return (int)f5::launch_rope(q, k, v, kv_lens, cos, sin, out, B, heads, n, n_rope, bs, hs, f5::kD,
                              bs, hs, f5::kD, scale_log2, static_cast<cudaStream_t>(stream));
}

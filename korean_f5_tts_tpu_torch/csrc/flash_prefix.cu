// Prefix-masked flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded -> _kernel_nomax_hn / _kernel_nomax / _kernel.
// q, k, v, out: [H, n, D] bf16 (batch folded into heads); kv_lens: [H] int32.
// Folded head h attends keys [0, kv_lens[h]); every query row, padded ones
// included, gets a well-defined softmax over those keys.
//
// What bounds it on the card: at the main-path shape (H = 32, n = 1536,
// D = 64, 1376 valid keys) one call is 4 * 32 * 1536 * 1376 * 64 = 17.3
// GFLOP against 25 MB of q/k/v/out, so it is tensor-core bound, and the
// n x n logits must never reach device memory (the plain version writes
// 302 MB of fp32 logits per call).
//
// bf16 at D = 64 (the DiT's heads, every serving and inference path) runs on
// the TMA + wgmma attention core of attn_wgmma.cuh: 192 query rows a block
// on three consumer warpgroups, 128-key K/V tiles through a TMA ring, S and
// P.V on wgmma with P in registers, the next tile's S product overlapping
// this tile's softmax, the warpgroups' products in turns.
//
// bf16 at D = 128 runs on the same core's D = 128 form (attn_wgmma.cuh:
// attn_fwd_d128_wgmma_kernel, through flash_prefix_core_d128.cu): 128 query
// rows a block on two consumer warpgroups, every tile two 128-byte swizzle
// spans wide. fp32 at D = 128 runs on split 3xTF32 products
// (flash_prefix_tf32_d128.cu). The first port's mma.sync loop
// (flash_prefix_fwd_kernel in flash_prefix.cuh: one 128-thread block per
// (folded head, 64-row query tile), each warp 16 query rows held as mma A
// fragments, 64-key K/V tiles loaded synchronously into shared memory, S =
// q.k^T and O += P.V on mma.sync m16n8k16 with P re-packed in registers; the
// KV loop stops at ceil(kv_len / 64) tiles (the TPU kernel's `prune`), the
// partial last tile is masked per column, rows past n are zero-filled and
// never stored) serves no path: f5_flash_prefix_fwd_mma runs it at D = 64
// and f5_flash_prefix_d128_fwd_mma (flash_prefix_d128.cu) at D = 128 (A, 10
// and 18), so that chip_smoke.py can time the designs in one process.
//
// Numerics (both bf16 designs): online-max softmax (running max and
// denominator in fp32) with log2(e) folded into the scale, so exp is exp2.
// The TPU default's static max (flash_prefix.py:147 STATIC_MAX_C) is a VPU
// trade that only holds for logits in range; it is not carried over. P is
// rounded to bf16 for the P.V product (the row sums use fp32 P), as in
// FlashAttention-2.
//
// fp32 operands (f5_flash_prefix_f32_fwd; the offline entry points keep fp32
// weights unless told otherwise). Like the TPU kernel on fp32 inputs the fp32
// forms keep "the exact f32 dot": scores, softmax, p.v and the output are
// fp32-accurate and p is not rounded. What bounds them: the same 17.3 GFLOP
// at the main shape, 53.7 GFLOP at the training shape (H 128, n 1280, d 64),
// of fp32-accurate products: 0.105 and 0.326 ms at the tensor cores' TF32
// rate taken three times (494.7 / 3 TFLOP/s), 0.26 and 0.80 ms at the 67
// TFLOP/s of fp32 outside them.
//
// d = 64 (flash_prefix_fwd_tf32_kernel): split 3xTF32 products on the tensor
// cores (attn_tf32.cuh, mma.cuh: x = hi + lo, a.b ~ hi.hi + hi.lo + lo.hi
// in mma.sync m16n8k8 .tf32 with fp32 accumulation; a single TF32 product
// keeps 10 mantissa bits and fails the fp32 bounds), as the backward of
// flash_prefix_train_f32.cu: 256 threads, eight warps of 16 queries, 128
// queries a block; q split into hi and lo tiles in shared memory once for
// the whole sweep; each 64-key K/V tile split as it is stored, the next
// tile's fp32 rows loaded into registers while this tile's products run;
// S = q.K^T by mm_rows, its accumulator masked, scaled by scale_log2 and
// turned into P = exp2(S - m) in place, which mm_acc takes as the A
// fragment of P.V with its columns in the order 2t, 2t + 1, split once in
// registers. Each tile's P.V goes into an accumulator of its own, zeroed per
// tile, and o = o * alpha + that (fp32 FMA): the tensor cores' fp32
// accumulation drops the low bits of a sum where fp32 would round them
// (probe_hopper.cu's accumulation probe), and a chain over every key of a
// long sweep would carry that bias into o; a tile's chain is 24 products
// deep. The running max and denominator are fp32, as in the bf16 forms; the
// sweep stops at ceil(kv_len / 64) tiles, keys past kv_len get P = 0, rows
// past n are zero-filled and never stored, and a head with kv_len 0 gets
// zeros (and lse 0). 136 KB of shared memory: one block an SM. mma.sync and
// not wgmma .tf32: both operands of a .tf32 wgmma must be k-major in shared
// memory, and for P.V that is V transposed; the mma.sync form is the one
// the backward proved, at 0.40-0.47 of this bound.
// kLse (kernel 10's fp32 form, f5_flash_prefix_f32_fwd_lse): each row's
// base-2 logsumexp lse = m + log2(l) of the scaled scores (0 for a row with
// no valid key); kernel A's instantiation has no lse code. kRope (the fp32
// forms of kernels 18 and 19, f5_flash_prefix_rope_f32_fwd,
// f5_flash_prefix_qkv_f32_fwd; the JAX kernels rotate and attend in x's
// dtype, flash_prefix.py:1413-1424 and :1550): the block's head is read at
// strides (the split-head [B, heads, n, 64] tensors, or the fused qkv rows
// [B, n, 3 * heads * 64] with the output merged as [B, n, heads * 64]), and
// q and k of the heads g < n_rope are rotated in fp32 by the fp32 tables
// before the split (each product and the sum rounded once,
// ops/flash_prefix.py:rope_reference on fp32 to the bit), so that 18, 19
// and A's form on torch-roped inputs agree to the bit.
//
// d = 128: kernels A, 10 and 18 (f5_flash_prefix_f32_fwd,
// f5_flash_prefix_f32_fwd_lse, f5_flash_prefix_rope_d128_fwd) on this design
// carried to twice the width (flash_prefix_tf32_d128.cu: the d = 64 layout's
// hi and lo tiles would take 270 KB at 128 queries; its note gives the
// tiling that fits and the one it was timed against), 10 as its kLse
// instantiation. The FFMA kernel they replaced (flash_prefix_d128.cu:
// flash_prefix_f32_kernel, bounded by the 67 TFLOP/s of fp32 outside the
// tensor cores) serves no path: f5_flash_prefix_f32_d128_fwd_ffma keeps it
// for timing.
#include "attn_tf32.cuh"
#include "attn_wgmma.cuh"
#include "flash_prefix.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace {

// ---------------------------------------------------------------------------
// d = 64: split 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;  // queries a block
constexpr int kFwdTile = 64;   // keys a tile
constexpr int kFwdTfSmem = (2 * kFwdRows + 4 * kFwdTile) * kLD32 * (int)sizeof(uint32_t);

// Where a block's head lies: folded head blockIdx.y = item * heads + g reads
// q, k, v at item * s_item + g * s_head + row * s_row (elements; k and v as
// their own pointers, with q's strides) and writes out with the out_ strides;
// item b attends keys [0, kv_lens[b]). Kernels A and 10 do not read it
// (their heads are contiguous [H, n, 64] blocks); kernels 18 and 19 pass the
// strides of the split-head [B, heads, n, 64] tensors or of the fused qkv
// rows [B, n, 3 * heads * 64] (out [B, n, heads * 64]). Heads g < n_rope
// rotate q and k by the fp32 tables cos, sin [n, 32].
struct F32Heads {
  long long s_item, s_head, s_row;
  long long out_item, out_head, out_row;
  int heads, n_rope;
  const float* cos;
  const float* sin;
};

// warp w owns queries q0 + 16w .. + 15; lane (g, t) holds rows 16w + g and
// 16w + g + 8, columns 8j + 2t, 8j + 2t + 1 of S and of o
template <bool kLse, bool kRope>
__global__ void __launch_bounds__(kT32, 1)
flash_prefix_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const int* __restrict__ kv_lens,
                             float* __restrict__ out, float* __restrict__ lse, int n,
                             float scale_log2, F32Heads hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQh = reinterpret_cast<uint32_t*>(smem_raw);  // [128][68] each
  uint32_t* sQl = sQh + kFwdRows * kLD32;
  uint32_t* sKh = sQl + kFwdRows * kLD32;  // [64][68] each
  uint32_t* sKl = sKh + kFwdTile * kLD32;
  uint32_t* sVh = sKl + kFwdTile * kLD32;
  uint32_t* sVl = sVh + kFwdTile * kLD32;
  // kernel A's and 10's heads are contiguous [n, 64] blocks: their offsets
  // are compile-time
  const int item = kRope ? blockIdx.y / hd.heads : blockIdx.y;
  const int head = kRope ? blockIdx.y - item * hd.heads : 0;
  const int q0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const long long off =
      kRope ? item * hd.s_item + head * hd.s_head : (long long)blockIdx.y * n * kD32;
  const long long ld = kRope ? hd.s_row : kD32;
  const int kv_len = min(kv_lens[item], n);
  const bool rot = kRope && head < hd.n_rope;  // block-uniform
  {
    HeadRows<kFwdRows, kRope> r;
    head_load(r, q + off, ld, q0, n, tid, rot, hd.cos, hd.sin);
    head_split(sQh, sQl, r, tid, rot);
  }
  float o[8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  zero84(o);

  const int n_tiles = kv_len > 0 ? (kv_len + kFwdTile - 1) / kFwdTile : 0;
  HeadRows<kFwdTile, kRope> kr;
  HeadRows<kFwdTile, false> vr;
  if (n_tiles > 0) {
    head_load(kr, k + off, ld, 0, n, tid, rot, hd.cos, hd.sin);
    head_load(vr, v + off, ld, 0, n, tid);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kFwdTile;
    __syncthreads();  // the previous tile's readers (and the q stores) are done
    head_split(sKh, sKl, kr, tid, rot);
    head_split(sVh, sVl, vr, tid);
    __syncthreads();
    if (jt + 1 < n_tiles) {  // the next tile's rows load while this one's products run
      head_load(kr, k + off, ld, k0 + kFwdTile, n, tid, rot, hd.cos, hd.sin);
      head_load(vr, v + off, ld, k0 + kFwdTile, n, tid);
    }
    float s[8][4];
    zero84(s);
    mm_rows(s, sQh, sQl, sKh, sKl, wr, lane);
    // online softmax of this tile; tile 0 holds key 0 < kv_len, so the
    // running max is finite from then on
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kv_len ? s[j][e] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[j][e]);
        }
      const float m_new = fmaxf(m_run[h], quad_max(mx));
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          rs += s[j][e];
        }
      l_run[h] = l_run[h] * alpha[h] + quad_sum(rs);
    }
    float pv[8][4];  // this tile's P.V, a chain of its own
    zero84(pv);
    mm_acc(pv, s, sVh, sVl, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
  }

  float* dst = out + (kRope ? item * hd.out_item + head * hd.out_head : off);
  const long long out_ld = kRope ? hd.out_row : kD32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= n) continue;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;  // kv_len == 0: zeros
    // m_run is in the base-2 domain of the scaled scores, l_run the whole row's sum
    if (kLse && t == 0)
      lse[(size_t)blockIdx.y * n + row] = l_run[h] > 0.f ? m_run[h] + log2f(l_run[h]) : 0.f;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<float2*>(dst + row * out_ld + nd * 8 + 2 * t) =
          make_float2(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
  }
}

template <bool kLse, bool kRope>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* v, const void* kv_lens,
                            void* out, void* lse, int blocks_y, int n, float scale_log2,
                            const F32Heads& hd, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err =
      allow_smem(flash_prefix_fwd_tf32_kernel<kLse, kRope>, kFwdTfSmem, ready);
  if (err != cudaSuccess) return err;
  flash_prefix_fwd_tf32_kernel<kLse, kRope>
      <<<dim3((n + kFwdRows - 1) / kFwdRows, blocks_y), kT32, kFwdTfSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const int*>(kv_lens),
          static_cast<float*>(out), static_cast<float*>(lse), n, scale_log2, hd);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

namespace {

bool attn_dims_ok(int H, int n) { return H > 0 && n > 0 && H <= 65535; }

}  // namespace

// kernel A on bf16 q, k, v, out [H, n, d]: d 64 and d 128 on the attention
// core (attn_wgmma.cuh; d 128 through flash_prefix_core_d128.cu)
extern "C" int f5_flash_prefix_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int H, int n, int d,
                                   float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!attn_dims_ok(H, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)f5::launch_attn_fwd_wgmma<false>(q, k, v, kv_lens, out, nullptr, H, n,
                                                 scale_log2, s);
  if (d == 128)
    return (int)f5::d128::core(q, k, v, kv_lens, nullptr, nullptr, out, nullptr, H, 1, n, 0,
                               scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// d = 64 on the mma.sync loop that the attention core replaced (chip_smoke.py
// times the two designs against each other)
extern "C" int f5_flash_prefix_fwd_mma(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, int H, int n,
                                       float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!attn_dims_ok(H, n)) return (int)cudaErrorInvalidValue;
  return (int)f5::launch_fwd<64>(q, k, v, kv_lens, out, H, n, scale_log2,
                                 static_cast<cudaStream_t>(stream));
}

// the same on fp32 q, k, v, out
extern "C" int f5_flash_prefix_f32_fwd(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, int H, int n, int d,
                                       float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!attn_dims_ok(H, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)f5::launch_fwd_tf32<false, false>(q, k, v, kv_lens, out, nullptr, H, n,
                                                  scale_log2, f5::F32Heads{}, s);
  if (d == 128)
    return (int)f5::d128::tf32(q, k, v, kv_lens, nullptr, nullptr, out, nullptr, H, 1, n, 0,
                               scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// kernel 10's fp32 form: the same with lse [H, n] fp32 (d 64 or 128)
extern "C" int f5_flash_prefix_f32_fwd_lse(const void* q, const void* k, const void* v,
                                           const void* kv_lens, void* out, void* lse, int H,
                                           int n, int d, float scale_log2, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!attn_dims_ok(H, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return (int)f5::d128::tf32(q, k, v, kv_lens, nullptr, nullptr, out, lse, H, 1, n, 0,
                               scale_log2, s);
  if (d != 64) return (int)cudaErrorInvalidValue;
  return (int)f5::launch_fwd_tf32<true, false>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                               f5::F32Heads{}, s);
}

// kernel 18's fp32 form: q, k, v, out [B, heads, n, 64] fp32 (q and k before
// the rotation), kv_lens [B] int32, cos, sin [n, 32] fp32; heads g < n_rope
// rotate
extern "C" int f5_flash_prefix_rope_f32_fwd(const void* q, const void* k, const void* v,
                                            const void* kv_lens, const void* cos,
                                            const void* sin, void* out, int B, int heads, int n,
                                            int n_rope, float scale_log2, int device,
                                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || heads <= 0 || n <= 0 || (long long)B * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long hs = (long long)n * 64, bs = heads * hs;
  const f5::F32Heads hd{bs, hs, 64, bs, hs, 64, heads, n_rope,
                        static_cast<const float*>(cos), static_cast<const float*>(sin)};
  return (int)f5::launch_fwd_tf32<false, true>(q, k, v, kv_lens, out, nullptr, B * heads, n,
                                                scale_log2, hd, static_cast<cudaStream_t>(stream));
}

// kernel 19's fp32 form: qkv [B, n, 3 * heads * 64] fp32 (q | k | v, heads-major
// inside each, q and k before the rotation), out [B, n, heads * 64], kv_lens
// [B] int32, cos, sin [n, 32] fp32
extern "C" int f5_flash_prefix_qkv_f32_fwd(const void* qkv, const void* kv_lens, const void* cos,
                                           const void* sin, void* out, int B, int heads, int n,
                                           int n_rope, float scale_log2, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || heads <= 0 || n <= 0 || (long long)B * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long inner = (long long)heads * 64;
  const f5::F32Heads hd{n * 3 * inner, 64, 3 * inner, n * inner, 64, inner, heads, n_rope,
                        static_cast<const float*>(cos), static_cast<const float*>(sin)};
  const float* x = static_cast<const float*>(qkv);
  return (int)f5::launch_fwd_tf32<false, true>(x, x + inner, x + 2 * inner, kv_lens, out,
                                                nullptr, B * heads, n, scale_log2, hd,
                                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* f5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

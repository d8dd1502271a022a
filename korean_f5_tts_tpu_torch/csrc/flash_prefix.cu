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
// bf16 at D = 128 stays on the first port's mma.sync loop
// (flash_prefix_fwd_kernel in flash_prefix.cuh): one
// 128-thread block per (folded head, 64-row query tile), each warp 16 query
// rows held as mma A fragments, 64-key K/V tiles loaded synchronously into
// shared memory, S = q.k^T and O += P.V on mma.sync m16n8k16 with P
// re-packed in registers; the KV loop stops at ceil(kv_len / 64) tiles (the
// TPU kernel's `prune`), the partial last tile is masked per column, rows
// past n are zero-filled and never stored. f5_flash_prefix_fwd_mma runs that
// loop at D = 64 too, so that chip_smoke.py can time the two designs in one
// process; no serving or inference path calls it.
//
// Numerics (both bf16 designs): online-max softmax (running max and
// denominator in fp32) with log2(e) folded into the scale, so exp is exp2.
// The TPU default's static max (flash_prefix.py:147 STATIC_MAX_C) is a VPU
// trade that only holds for logits in range; it is not carried over. P is
// rounded to bf16 for the P.V product (the row sums use fp32 P), as in
// FlashAttention-2.
//
// fp32 operands (f5_flash_prefix_f32_fwd; the offline entry points keep fp32
// weights unless told otherwise): flash_prefix_f32_kernel below. Like the
// TPU kernel on fp32 inputs it keeps "the exact f32 dot": scores, softmax,
// p.v and the output are fp32 and p is not rounded. Products are plain FFMA
// on shared-memory tiles: the tensor cores have no fp32 product, a single
// TF32 mma keeps 10 mantissa bits and does not hold fp32 parity, and a split
// 3xTF32 design is more machinery than this form is worth; its bound is the
// 67 TFLOP/s of fp32 outside the tensor cores (0.26 ms at the main shape).
// One 256-thread block per (head, 64-row query tile), 4 x 4 scores a thread;
// q and k tiles sit transposed ([c][row]) so the inner loop reads float4; p
// goes through shared memory between the two products; the same online
// softmax, pruning and masking as the bf16 loop. Kernel 10's fp32 form (the
// training forward, f5_flash_prefix_f32_fwd_lse) is this kernel's kLse
// instantiation: it also writes each row's base-2 logsumexp lse = m +
// log2(l) of the scaled scores (0 for a row with no valid key, whose output
// is zero); kernel A's instantiation has no lse code. Its bound at the
// training shape (H 128, n 1280, d 64): 53.7 GFLOP at 67 TFLOP/s, 0.80 ms.
// The fp32 forms of kernels 18 and 19 (f5_flash_prefix_rope_f32_fwd,
// f5_flash_prefix_qkv_f32_fwd; the JAX kernels rotate and attend in x's
// dtype, flash_prefix.py:1413-1424 and :1550) are its kRope instantiation:
// the block's head is read at strides (the split-head [B, heads, n, 64]
// tensors, or the fused qkv rows [B, n, 3 * heads * 64] with the output
// merged as [B, n, heads * 64]), and q and k of the heads g < n_rope are
// rotated in fp32 by the fp32 tables as their rows land in shared memory
// (each product and the sum rounded once, ops/flash_prefix.py:rope_reference
// on fp32 to the bit). Same bound as A's fp32 form at the same shape.
#include "attn_wgmma.cuh"
#include "flash_prefix.cuh"

namespace f5 {
namespace {

constexpr int kF32Threads = 256;
constexpr int kF32LD = 64 + 4;  // row stride of the [c][row] and [row][key] tiles

// Where a block's head lies: folded head blockIdx.y = item * heads + g reads
// q, k, v at item * s_item + g * s_head + row * s_row (elements; k and v as
// their own pointers, with q's strides) and writes out with the out_ strides;
// item b attends keys [0, kv_lens[b]). Kernels A and 10 do not read it
// (their heads are contiguous [H, n, D] blocks); kernels 18 and 19 pass the
// strides of the split-head [B, heads, n, 64] tensors or of the fused qkv
// rows [B, n, 3 * heads * 64] (out [B, n, heads * 64]). Heads g < n_rope
// rotate q and k by the fp32 tables cos, sin [n, 32] as their rows land in
// shared memory.
struct F32Heads {
  long long s_item, s_head, s_row;
  long long out_item, out_head, out_row;
  int heads, n_rope;
  const float* cos;
  const float* sin;
};

// rows [row0, row0 + 64) of a head whose rows are ld elements apart,
// transposed into dst[c][row]; rows at or past n give zeros. Consecutive
// threads take consecutive rows: the shared-memory stores are conflict-free.
// kRot (D = 64): the half-split rotation of the row at its position r,
//   out[c] = x[c] cos[r, c] - x[c + 32] sin[r, c],
//   out[c + 32] = x[c + 32] cos[r, c] + x[c] sin[r, c],
// each product and the sum rounded once, as the plain version's torch ops.
template <int D, bool kRot>
__device__ __forceinline__ void load_rows_t_f32(float* dst, const float* src, long long ld,
                                                int row0, int n, int tid, const float* cos,
                                                const float* sin) {
  constexpr int kCols = kRot ? 32 : D;  // columns a thread's float4 starts at
  for (int i = tid; i < 64 * (kCols / 4); i += kF32Threads) {
    const int r = i & 63;
    const int c = (i >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
    if (row0 + r < n) {
      const float* p = src + (long long)(row0 + r) * ld + c;
      v = *reinterpret_cast<const float4*>(p);
      if (kRot) {
        w = *reinterpret_cast<const float4*>(p + 32);
        const float4 cs = *reinterpret_cast<const float4*>(cos + (size_t)(row0 + r) * 32 + c);
        const float4 sn = *reinterpret_cast<const float4*>(sin + (size_t)(row0 + r) * 32 + c);
        const float4 x1 = v, x2 = w;
        v = make_float4(__fsub_rn(__fmul_rn(x1.x, cs.x), __fmul_rn(x2.x, sn.x)),
                        __fsub_rn(__fmul_rn(x1.y, cs.y), __fmul_rn(x2.y, sn.y)),
                        __fsub_rn(__fmul_rn(x1.z, cs.z), __fmul_rn(x2.z, sn.z)),
                        __fsub_rn(__fmul_rn(x1.w, cs.w), __fmul_rn(x2.w, sn.w)));
        w = make_float4(__fadd_rn(__fmul_rn(x2.x, cs.x), __fmul_rn(x1.x, sn.x)),
                        __fadd_rn(__fmul_rn(x2.y, cs.y), __fmul_rn(x1.y, sn.y)),
                        __fadd_rn(__fmul_rn(x2.z, cs.z), __fmul_rn(x1.z, sn.z)),
                        __fadd_rn(__fmul_rn(x2.w, cs.w), __fmul_rn(x1.w, sn.w)));
      }
    }
    dst[(c + 0) * kF32LD + r] = v.x;
    dst[(c + 1) * kF32LD + r] = v.y;
    dst[(c + 2) * kF32LD + r] = v.z;
    dst[(c + 3) * kF32LD + r] = v.w;
    if (kRot) {
      dst[(c + 32) * kF32LD + r] = w.x;
      dst[(c + 33) * kF32LD + r] = w.y;
      dst[(c + 34) * kF32LD + r] = w.z;
      dst[(c + 35) * kF32LD + r] = w.w;
    }
  }
}

// sum / max over the 16 lanes that share a query row
__device__ __forceinline__ float row16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Thread (ty, tx) of the 16 x 16 block owns query rows ty * 4 + i, score
// columns tx * 4 + j and output columns tx * 4 + j (+ 64 for D = 128).
// kLse: also write lse [H, n] (kernel 10's fp32 form). kRope: the fp32 forms
// of kernels 18 and 19 (D = 64), heads at the strides of hd, q and k rotated.
template <int D, bool kLse, bool kRope = false>
__global__ void __launch_bounds__(kF32Threads)
flash_prefix_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ kv_lens,
                        float* __restrict__ out, float* __restrict__ lse, int n,
                        float scale_log2, F32Heads hd) {
  static_assert(!kRope || D == 64, "the rotation is written for 64-wide heads");
  constexpr int NO = D / 64;  // 4-wide output column groups of a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [D][68]
  float* sKt = sQt + D * kF32LD;                    // [D][68]
  float* sV = sKt + D * kF32LD;                     // [64][D]
  float* sP = sV + 64 * D;                          // [64][68]
  // kernel A's and 10's heads are contiguous [n, D] blocks: their offsets are
  // compile-time (the strided form cost them 2-3% of their time)
  const int item = kRope ? blockIdx.y / hd.heads : blockIdx.y;
  const int g = kRope ? blockIdx.y - item * hd.heads : 0;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long off = kRope ? item * hd.s_item + g * hd.s_head : (long long)blockIdx.y * n * D;
  const long long ld = kRope ? hd.s_row : D;
  const int kv_len = min(kv_lens[item], n);
  const bool rot = kRope && g < hd.n_rope;  // block-uniform

  if (rot)
    load_rows_t_f32<D, kRope>(sQt, q + off, ld, q0, n, tid, hd.cos, hd.sin);
  else
    load_rows_t_f32<D, false>(sQt, q + off, ld, q0, n, tid, nullptr, nullptr);

  float o[4][NO * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NO * 4; ++c) o[i][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  const int n_tiles = kv_len > 0 ? (kv_len + 63) / 64 : 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * 64;
    __syncthreads();  // the previous tile's readers are done
    if (rot)
      load_rows_t_f32<D, kRope>(sKt, k + off, ld, k0, n, tid, hd.cos, hd.sin);
    else
      load_rows_t_f32<D, false>(sKt, k + off, ld, k0, n, tid, nullptr, nullptr);
    for (int i = tid; i < 64 * (D / 4); i += kF32Threads) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n)
        val = *reinterpret_cast<const float4*>(v + off + (long long)(k0 + r) * ld + c);
      *reinterpret_cast<float4*>(sV + r * D + c) = val;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(sQt + c * kF32LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sKt + c * kF32LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax of this tile; tile 0 holds key 0 < kv_len, so the
    // running max is finite from then on
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx * 4 + j < kv_len ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row16_max(mx));
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_run[i] = l_run[i] * alpha + row16_sum(rs);
#pragma unroll
      for (int c = 0; c < NO * 4; ++c) o[i][c] *= alpha;
      *reinterpret_cast<float4*>(sP + (ty * 4 + i) * kF32LD + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 8
    for (int key = 0; key < 64; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * kF32LD + key];
#pragma unroll
      for (int gg = 0; gg < NO; ++gg) {
        const float4 b = *reinterpret_cast<const float4*>(sV + key * D + gg * 64 + tx * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][gg * 4 + j] = fmaf(p[i], bv[j], o[i][gg * 4 + j]);
      }
    }
  }

  float* dst = out + (kRope ? item * hd.out_item + g * hd.out_head : off);
  const long long out_ld = kRope ? hd.out_row : D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;  // kv_len == 0: zeros
    // m_run is in the base-2 domain of the scaled scores, l_run the whole row's sum
    if (kLse && tx == 0)
      lse[(size_t)blockIdx.y * n + row] = l_run[i] > 0.f ? m_run[i] + log2f(l_run[i]) : 0.f;
#pragma unroll
    for (int gg = 0; gg < NO; ++gg)
      *reinterpret_cast<float4*>(dst + (long long)row * out_ld + gg * 64 + tx * 4) =
          make_float4(o[i][gg * 4] * inv, o[i][gg * 4 + 1] * inv, o[i][gg * 4 + 2] * inv,
                      o[i][gg * 4 + 3] * inv);
  }
}

template <int D, bool kLse, bool kRope>
cudaError_t launch_f32_heads(const void* q, const void* k, const void* v, const void* kv_lens,
                             void* out, void* lse, int blocks_y, int n, float scale_log2,
                             const F32Heads& hd, cudaStream_t stream) {
  const int smem = (2 * D * kF32LD + 64 * D + 64 * kF32LD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_f32_kernel<D, kLse, kRope>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_prefix_f32_kernel<D, kLse, kRope>
      <<<dim3((n + 63) / 64, blocks_y), kF32Threads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const int*>(kv_lens),
          static_cast<float*>(out), static_cast<float*>(lse), n, scale_log2, hd);
  return cudaGetLastError();
}

// kernels A and 10: folded [H, n, D] heads, one length each
template <int D, bool kLse = false>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, const void* kv_lens,
                           void* out, void* lse, int H, int n, float scale_log2,
                           cudaStream_t stream) {
  return launch_f32_heads<D, kLse, false>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                          F32Heads{}, stream);
}

}  // namespace
}  // namespace f5

namespace {

bool attn_dims_ok(int H, int n) { return H > 0 && n > 0 && H <= 65535; }

}  // namespace

// kernel A on bf16 q, k, v, out [H, n, d]: d 64 on the attention core, d 128
// on the mma.sync loop
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
    return (int)f5::launch_fwd<128>(q, k, v, kv_lens, out, H, n, scale_log2, s);
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
    return (int)f5::launch_fwd_f32<64>(q, k, v, kv_lens, out, nullptr, H, n, scale_log2, s);
  if (d == 128)
    return (int)f5::launch_fwd_f32<128>(q, k, v, kv_lens, out, nullptr, H, n, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// kernel 10's fp32 form: the same with lse [H, n] fp32 (d = 64, as the
// other training kernels)
extern "C" int f5_flash_prefix_f32_fwd_lse(const void* q, const void* k, const void* v,
                                           const void* kv_lens, void* out, void* lse, int H,
                                           int n, int d, float scale_log2, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!attn_dims_ok(H, n) || d != 64) return (int)cudaErrorInvalidValue;
  return (int)f5::launch_fwd_f32<64, true>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                           static_cast<cudaStream_t>(stream));
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
  return (int)f5::launch_f32_heads<64, false, true>(q, k, v, kv_lens, out, nullptr, B * heads,
                                                    n, scale_log2, hd,
                                                    static_cast<cudaStream_t>(stream));
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
  return (int)f5::launch_f32_heads<64, false, true>(x, x + inner, x + 2 * inner, kv_lens, out,
                                                    nullptr, B * heads, n, scale_log2, hd,
                                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* f5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

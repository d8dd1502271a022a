// Prefix-masked flash attention with int8 scores at head dim 128, forward,
// for Hopper (sm_90a): kernel 14 at d = 128. The entry point of its four
// forms, and the kernel of its fp32 "qk" form (fp32 p times fp32 v, split
// 3xTF32); "qkpv" (bf16 or fp32 output) and "qk" on bf16 v run on the int8
// kernel of the attention core's D = 128 form (attn_wgmma.cuh:
// attn_i8_d128_wgmma_kernel, flash_prefix_int8_core_d128.cu).
//
// Replaces, at d = 128, the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded_i8 -> _kernel_i8, which the JAX dispatch takes at d in
// (64, 128) (ops/attention.py:296-330). The function, per folded head h with
// c = aq*ak/127^2 * log2(e)/sqrt(128) from the quantization pass
// (quant_heads.cu):
//   s   = float(q8 . k8^T) * c[h]        exact int32 product, base-2 domain
//   keys at or past kv_lens[h] masked; online max m and sum l in fp32, m
//   taken once per chunk of 512 keys from key 0 (I8_KEY_CHUNK, the JAX
//   kernel's default bkv)
//   acc = acc * alpha + p . v            fp32 p times fp32 v (the JAX kernel's
//                                        product on fp32, :846)
//   out = acc / l, fp32; a head with kv_len 0 gives zeros.
//
// What bounds it on the card: at the serving shape (16 folded heads, n 1536,
// 1376 valid keys) S is 2 * 16 * 1536 * 1376 * 128 = 8.7 GOP of int8
// products (0.0044 ms at 1,979 TOP/s) and P.V as many fp32-accurate flops
// (0.053 ms at the tensor cores' TF32 rate taken three times, 494.7 / 3
// TFLOP/s): 0.0569 ms, against 6.3 MB of q8, k8, 12.6 MB of fp32 v in and
// 12.6 MB of fp32 out (0.0094 ms). It replaces the first port's loop,
// whose P.V was an FFMA chain through a shared p tile: 0.13 ms of FFMA for
// P.V alone at 67 TFLOP/s.
//
// Design: kernel A fp32 d128's split 3xTF32 P.V (flash_prefix_tf32_d128.cu,
// tf32_d128.cuh) behind the first port's exact int8 S, the d = 64 fp32 "qk"
// kernel's combination (flash_prefix_int8_f32.cu) at twice the width. 256
// threads, eight warps of 16 queries, 128 queries a block; grid (ceil(n /
// 128), H), 12 x 16 = 192 blocks at the serving shape, one an SM.
//   S      mma.sync m16n8k32 .s32.s8.s8 (mma.cuh), exact: a warp's q8 A
//          fragments (16 rows x 128 bytes, four k32 steps) are read once
//          from device memory into registers for the whole sweep; the
//          chunk's K rows (at most 512 keys x 128 bytes, at a 144-byte row
//          stride, 72 KB) land in shared memory once a chunk; a first sweep
//          of 64-key S tiles takes the chunk's max, one alpha a chunk
//          rescales o and l, a second recomputes S a 32-key tile at a time
//          for p (S is exact, so both sweeps see the same scores).
//   P.V    split 3xTF32 (tf32_d128.cuh:t128_pv): p straight from the score
//          accumulator as the A fragment with its columns in the order 2t,
//          2t + 1, split in registers; V lands as hi and lo tf32 tiles of 32
//          keys at a 132-word stride, double-buffered (two 32 KB pairs), the
//          next tile's rows loaded into registers while this tile's products
//          run, one barrier a tile. Each tile's P.V goes into an accumulator
//          of its own, a 64-column half at a time, and is added to o in
//          fp32: the tensor cores' fp32 accumulation truncates
//          (probe_hopper.cu's accumulation probe).
//   edges  the sweeps stop at the chunk's last valid key (rounded up to the
//          tile); keys past kv_len get P = 0, so +-1e4 there never reaches
//          o; K, V and q rows past n are zero-filled, rows past n never
//          stored; a head with kv_len 0 gives zeros.
// 141,312 bytes of dynamic shared memory (the K chunk 73,728, V hi and lo
// twice 67,584). Measured against the FFMA loop under one timer
// (chip_smoke.py --ab): PERF.md section 6.
#include <atomic>

#include "gemm_bf16.cuh"  // allow_smem, kMaxDevices
#include "flash_prefix_d128.cuh"
#include "tf32_d128.cuh"  // t128_pv, t128_load, t128_split, kTD, kTLd, kTThreads

namespace f5 {
namespace {

constexpr int kI8Rows = 128;        // queries a block: eight warps of 16
constexpr int kI8Chunk = 512;       // keys a chunk (ops/flash_prefix.py:I8_KEY_CHUNK)
constexpr int kI8STile = 64;        // keys an S tile of sweep 1
constexpr int kI8VKeys = 32;        // keys a V tile (and an S tile of sweep 2)
constexpr int kK8Ld = kTD + 16;     // bytes a row of the K chunk
constexpr int kVWords = kI8VKeys * kTLd;  // words of one V tile (hi or lo)
constexpr int kI8Smem = kI8Chunk * kK8Ld + 4 * kVWords * (int)sizeof(uint32_t);
static_assert(kI8Smem == 141312 && kI8Smem <= kTSmemMax, "the tiles do not fit a block");

// one 32-bit word of a q8 A fragment: row `row` (zero at or past n), bytes
// byte .. byte + 3
__device__ __forceinline__ uint32_t q8_word(const int8_t* q8, int row, int byte, int n) {
  return row < n ? *reinterpret_cast<const uint32_t*>(q8 + (size_t)row * kTD + byte) : 0u;
}

// si = q8 . k8^T for this warp's 16 rows against the 8 NT keys of a tile
// whose first row is `tile` ([key][kK8Ld bytes])
template <int NT>
__device__ __forceinline__ void i8_scores(int (&si)[NT][4], const uint32_t (&qa)[4][4],
                                          const int8_t* tile, int lane) {
#pragma unroll
  for (int i = 0; i < NT; ++i) si[i][0] = si[i][1] = si[i][2] = si[i][3] = 0;
#pragma unroll
  for (int ks = 0; ks < kTD / 32; ++ks)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, i8_b_nk_addr(tile + np * 16 * kK8Ld + ks * 32, kK8Ld, lane));
      mma_s8_16832(si[2 * np], qa[ks], b[0], b[1]);
      mma_s8_16832(si[2 * np + 1], qa[ks], b[2], b[3]);
    }
}

// warp w owns queries q0 + 16w .. + 15; lane (g, t) holds rows 16w + g and
// 16w + g + 8, columns 8j + 2t, 8j + 2t + 1 of S and of o
__global__ void __launch_bounds__(kTThreads, 1)
flash_prefix_i8_qk_tf32_d128_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                                    const float* __restrict__ v, const float* __restrict__ cs,
                                    const int* __restrict__ kv_lens, float* __restrict__ out,
                                    int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sK8 = reinterpret_cast<int8_t*>(smem_raw);  // [512][144]
  uint32_t* sV = reinterpret_cast<uint32_t*>(smem_raw + kI8Chunk * kK8Ld);  // [2][hi, lo][32][132]
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kI8Rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows row0, row0 + 8
  const size_t off = (size_t)head * n * kTD;
  const int kv_len = min(kv_lens[head], n);
  const float c = cs[head];

  uint32_t qa[4][4];  // this warp's q8 rows as the A fragments of the four k32 steps
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = q8_word(q8 + off, row0, ks * 32 + 4 * t, n);
    qa[ks][1] = q8_word(q8 + off, row0 + 8, ks * 32 + 4 * t, n);
    qa[ks][2] = q8_word(q8 + off, row0, ks * 32 + 16 + 4 * t, n);
    qa[ks][3] = q8_word(q8 + off, row0 + 8, ks * 32 + 16 + 4 * t, n);
  }
  float o[16][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int v_all = (kv_len + kI8VKeys - 1) / kI8VKeys;  // V tiles of the whole sweep
  Rows128<kI8VKeys, false> vr;  // the next V tile's rows
  if (v_all > 0) t128_load(vr, v + off, 0, n, tid, false, nullptr, nullptr);
  int jv = 0;  // V tiles stored so far: buffer jv & 1 is next
  for (int c0 = 0; c0 < kv_len; c0 += kI8Chunk) {
    const int keys = min(c0 + kI8Chunk, kv_len) - c0;
    const int s_tiles = (keys + kI8STile - 1) / kI8STile;
    __syncthreads();  // the previous chunk's S readers are done
    for (int i = tid; i < s_tiles * kI8STile * (kTD / 16); i += kTThreads) {
      const int r = i >> 3, seg = i & 7, key = c0 + r;
      const int4 val = key < n ? *reinterpret_cast<const int4*>(k8 + off + (size_t)key * kTD +
                                                                seg * 16)
                               : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(sK8 + r * kK8Ld + seg * 16) = val;
    }
    __syncthreads();
    // sweep 1: the chunk's max (the first chunk holds key 0 < kv_len, so m
    // is finite from then on)
    float mx[2] = {-INFINITY, -INFINITY};
    for (int tt = 0; tt < s_tiles; ++tt) {
      int si[kI8STile / 8][4];
      i8_scores(si, qa, sK8 + tt * kI8STile * kK8Ld, lane);
#pragma unroll
      for (int nt = 0; nt < kI8STile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + tt * kI8STile + nt * 8 + 2 * t + (e & 1) < kv_len)
            mx[e >> 1] = fmaxf(mx[e >> 1], __fmul_rn((float)si[nt][e], c));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      const float alpha = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j][2 * h] = __fmul_rn(o[j][2 * h], alpha);
        o[j][2 * h + 1] = __fmul_rn(o[j][2 * h + 1], alpha);
      }
    }
    // sweep 2: S again a 32-key tile at a time, p and P.V
    const int v_tiles = (keys + kI8VKeys - 1) / kI8VKeys;
    for (int tt = 0; tt < v_tiles; ++tt, ++jv) {
      const int k0 = c0 + tt * kI8VKeys;
      uint32_t* vh = sV + (jv & 1) * 2 * kVWords;
      uint32_t* vl = vh + kVWords;
      // buffer jv & 1 was last read by P.V(jv - 2), which every thread
      // finished before the barrier of tile jv - 1
      t128_split(vh, vl, vr, tid, false);
      if (jv + 1 < v_all) t128_load(vr, v + off, k0 + kI8VKeys, n, tid, false, nullptr, nullptr);
      __syncthreads();  // V(jv) is stored
      int si[kI8VKeys / 8][4];
      i8_scores(si, qa, sK8 + tt * kI8VKeys * kK8Ld, lane);
      float p[kI8VKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kI8VKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + nt * 8 + 2 * t + (e & 1) < kv_len;
          p[nt][e] = ok ? exp2f(__fmul_rn((float)si[nt][e], c) - m_run[e >> 1]) : 0.f;
          l_run[e >> 1] += p[nt][e];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // this tile's P.V, a chain of its own a half
        float pv[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
        t128_pv<kI8VKeys / 8>(pv, p, vh, vl, 64 * half, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[8 * half + j][e] += pv[j][e];
      }
    }
  }

  float* dst = out + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    const int row = row0 + 8 * h;
    if (row >= n) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros
#pragma unroll
    for (int nd = 0; nd < 16; ++nd)
      *reinterpret_cast<float2*>(dst + (size_t)row * kTD + nd * 8 + 2 * t) =
          make_float2(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
  }
}

cudaError_t launch_i8_qk_tf32_d128(const void* q8, const void* k8, const void* v, const void* c,
                                   const void* kv_lens, void* out, int H, int n,
                                   cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(flash_prefix_i8_qk_tf32_d128_kernel, kI8Smem, ready);
  if (err != cudaSuccess) return err;
  flash_prefix_i8_qk_tf32_d128_kernel<<<dim3((n + kI8Rows - 1) / kI8Rows, H), kTThreads, kI8Smem,
                                        stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const float*>(v), static_cast<const float*>(c),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 128] int8. pv_i8 != 0: v is int8 [H, 128, n_pad] in the
// pass's layout (n_pad % 128 == 0, zero past n); else v is [H, n, 128] of the
// output's dtype (bf16, or fp32 with out_f32) and sv is not read. c, sv: [H]
// fp32; kv_lens: [H] int32; out: [H, n, 128] bf16, or fp32 with out_f32. All
// 16-byte aligned. The fp32 "qk" form runs here, the others on the attention
// core's int8 kernel.
extern "C" int f5_flash_prefix_i8_d128_fwd(const void* q8, const void* k8, const void* v,
                                           const void* c, const void* sv, const void* kv_lens,
                                           void* out, int H, int n, int n_pad, int pv_i8,
                                           int out_f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  if (pv_i8 && (n_pad < n || n_pad % 128 != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pv_i8 && out_f32)
    return (int)f5::launch_i8_qk_tf32_d128(q8, k8, v, c, kv_lens, out, H, n, s);
  return (int)f5::d128::i8_core(q8, k8, v, c, sv, kv_lens, out, H, n, n_pad, pv_i8 != 0,
                                out_f32 != 0, s);
}

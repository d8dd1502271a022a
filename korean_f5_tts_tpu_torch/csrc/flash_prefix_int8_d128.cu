// Prefix-masked flash attention with int8 products at head dim 128, forward,
// for Hopper (sm_90a): kernel 14 at d = 128, in "qkpv" and "qk", with a bf16
// or an fp32 output.
//
// Replaces, at d = 128, the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded_i8 -> _kernel_i8, which the JAX dispatch takes at d in
// (64, 128) (ops/attention.py:296-330). The function is the d = 64 form's
// (flash_prefix_int8.cu), per folded head h with c = aq*ak/127^2 *
// log2(e)/sqrt(128) and sv = av/127^2 from the quantization pass
// (quant_heads.cu):
//   s   = float(q8 . k8^T) * c[h]        exact int32 product, base-2 domain
//   keys at or past kv_lens[h] masked; online max m and sum l in fp32, l
//   adding the unquantized p = exp2(s - m), m taken once per chunk of 512
//   keys from key 0 (I8_KEY_CHUNK, the JAX kernel's default bkv)
//   "qkpv": p8 = rint(127 p), acc = acc*alpha + float(p8 . v8) * sv[h] once a
//           chunk (each product and the sum rounded once, as the plain version)
//   "qk":   acc = acc*alpha + bf16(p) . v on bf16 v; fp32 p times fp32 v on
//           fp32 v (the JAX kernel's product on fp32)
//   out = acc / l, bf16 or fp32 (the "qkpv" fp32 output: kernel 14's fp32
//   form on the quantized operands of fp32 inputs); a head with kv_len 0
//   gives zeros.
//
// What bounds it on the card: at the main shape (16 heads, n 1536, 1376
// valid keys) S and P.V are each 2 * 16 * 1536 * 1376 * 128 = 8.7 GOP: in
// int8 (0.0087 ms at 1,979 TOP/s for both) under "qkpv", P.V in bf16 under
// "qk" (0.0088 ms at 989 TFLOP/s) or fp32 (0.13 ms at the 67 TFLOP/s of
// FFMA), against 6.3 MB of int8 q8, k8, v8 and 6.3 MB of bf16 out.
//
// Design: the first port's mma.sync loop (flash_prefix.cuh) with S on the
// int8 tensor cores. 128 threads, four warps of 16 queries, 64 queries a
// block; grid (ceil(n / 64), H).
//   chunk  a chunk's K rows (at most 512 keys x 128 bytes, 72 KB with a
//          16-byte pad a row) land in shared memory once; a first sweep
//          of S over its 64-key tiles takes the chunk's max, a second
//          recomputes S for p and P.V, the schedule of attn_wgmma.cuh's kI8
//          (S is exact, so both sweeps see the same scores).
//   S      mma.sync m16n8k32 .s32.s8.s8: a warp's q8 A fragments (16 rows x
//          128 bytes, four k32 steps) read once from device memory for the
//          whole sweep, K as the [n][k] B operand by ldmatrix.
//   P.V    "qkpv": the v8 tile [128 d][64 slots] (the pass's layout, keys
//          contiguous and slot-permuted) lands in shared memory; p8 packs
//          from the score accumulator straight into the 8-bit A fragment of
//          mma.sync m16n8k32 .s8 (slot 16h + 4t + 2j + e holds the key the
//          accumulator holds at n-tile 2h + j, column 2t + e), into an int32
//          accumulator for the chunk (exact: 127 * 127 * 512 < 2^31). "qk"
//          on bf16 v: the V tile [64][136] and mma_pb (p rounded to bf16 in
//          registers). "qk" on fp32 v: p through a [64][68] fp32 tile of the
//          warp's rows, o += p * v as FFMA chains over the tile's keys.
//   edges  the sweeps stop at ceil(kv_len / 64) tiles; keys past kv_len get
//          P = 0; K, V rows past n are zero-filled, rows past n never stored.
// 82-122 KB of dynamic shared memory.
#include "flash_prefix.cuh"

namespace f5 {
namespace {

constexpr int kI8D = 128;
constexpr int kI8Tile = 64;          // keys a tile
constexpr int kI8Chunk = 512;        // keys a chunk (ops/flash_prefix.py:I8_KEY_CHUNK)
constexpr int kK8Ld = kI8D + 16;     // bytes a row of the K chunk
constexpr int kV8Ld = kI8Tile + 16;  // bytes a row (one d) of the v8 tile
constexpr int kVfLd = kI8D + 4;      // floats a row of the fp32 V tile
constexpr int kPLd = kI8Tile + 4;    // floats a row of the fp32 p tile

// the four forms: "qkpv" with a bf16 or fp32 output, "qk" on bf16 or fp32 v
enum { kQkpv = 0, kQkpvF32 = 1, kQkBf16 = 2, kQkF32 = 3 };

template <int kMode>
constexpr int i8_smem_bytes() {
  return kI8Chunk * kK8Ld +
         (kMode <= kQkpvF32 ? kI8D * kV8Ld
          : kMode == kQkBf16 ? kI8Tile * (kI8D + 8) * (int)sizeof(bf16)
                             : (kI8Tile * kVfLd + kI8Tile * kPLd) * (int)sizeof(float));
}

// one 32-bit word of a q8 A fragment: row `row` (zero at or past n), bytes
// byte .. byte + 3
__device__ __forceinline__ uint32_t q8_word(const int8_t* q8, int row, int byte, int n) {
  return row < n ? *reinterpret_cast<const uint32_t*>(q8 + (size_t)row * kI8D + byte) : 0u;
}

// si = q8 . k8^T for this warp's 16 rows against the 64 keys of a tile whose
// first row is `tile` ([key][kK8Ld bytes])
__device__ __forceinline__ void i8_scores(int (&si)[kNS][4], const uint32_t (&qa)[4][4],
                                          const int8_t* tile, int lane) {
#pragma unroll
  for (int i = 0; i < kNS; ++i) si[i][0] = si[i][1] = si[i][2] = si[i][3] = 0;
#pragma unroll
  for (int ks = 0; ks < kI8D / 32; ++ks)
#pragma unroll
    for (int np = 0; np < kNS / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, i8_b_nk_addr(tile + np * 16 * kK8Ld + ks * 32, kK8Ld, lane));
      mma_s8_16832(si[2 * np], qa[ks], b[0], b[1]);
      mma_s8_16832(si[2 * np + 1], qa[ks], b[2], b[3]);
    }
}

__device__ __forceinline__ uint32_t pack_s8x4(float a, float b, float c, float d) {
  // p in [0, 1]: rint(127 p) in [0, 127], no clip
  const int ia = __float2int_rn(__fmul_rn(a, 127.f)), ib = __float2int_rn(__fmul_rn(b, 127.f));
  const int ic = __float2int_rn(__fmul_rn(c, 127.f)), id = __float2int_rn(__fmul_rn(d, 127.f));
  return (uint32_t)ia | ((uint32_t)ib << 8) | ((uint32_t)ic << 16) | ((uint32_t)id << 24);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefix_i8_d128_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                            const void* __restrict__ v, const float* __restrict__ cs,
                            const float* __restrict__ svs, const int* __restrict__ kv_lens,
                            void* __restrict__ out, int n, int n_pad) {
  constexpr bool kPv8 = kMode == kQkpv || kMode == kQkpvF32;
  constexpr bool kOutF32 = kMode == kQkpvF32 || kMode == kQkF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sK8 = reinterpret_cast<int8_t*>(smem_raw);  // [512][144]
  unsigned char* sVt = smem_raw + kI8Chunk * kK8Ld;   // this tile's V in the mode's layout
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows row0, row0 + 8
  const size_t off = (size_t)head * n * kI8D;
  const int kv_len = min(kv_lens[head], n);
  const float c = cs[head];
  const float sv = kPv8 ? svs[head] : 0.f;

  uint32_t qa[4][4];  // this warp's q8 rows as the A fragments of the four k32 steps
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = q8_word(q8 + off, row0, ks * 32 + 4 * t, n);
    qa[ks][1] = q8_word(q8 + off, row0 + 8, ks * 32 + 4 * t, n);
    qa[ks][2] = q8_word(q8 + off, row0, ks * 32 + 16 + 4 * t, n);
    qa[ks][3] = q8_word(q8 + off, row0 + 8, ks * 32 + 16 + 4 * t, n);
  }
  float o[kI8D / 8][4];
#pragma unroll
  for (int i = 0; i < kI8D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int c0 = 0; c0 < kv_len; c0 += kI8Chunk) {
    const int tiles = (min(c0 + kI8Chunk, kv_len) - c0 + kI8Tile - 1) / kI8Tile;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < tiles * kI8Tile * (kI8D / 16); i += kThreads) {
      const int r = i >> 3, seg = i & 7, key = c0 + r;
      const int4 val = key < n ? *reinterpret_cast<const int4*>(k8 + off + (size_t)key * kI8D +
                                                                seg * 16)
                               : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(sK8 + r * kK8Ld + seg * 16) = val;
    }
    __syncthreads();
    // sweep 1: the chunk's max
    float mx[2] = {-INFINITY, -INFINITY};
    for (int tt = 0; tt < tiles; ++tt) {
      int si[kNS][4];
      i8_scores(si, qa, sK8 + tt * kI8Tile * kK8Ld, lane);
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + tt * kI8Tile + nt * 8 + 2 * t + (e & 1) < kv_len)
            mx[e >> 1] = fmaxf(mx[e >> 1], __fmul_rn((float)si[nt][e], c));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the first chunk holds key 0 < kv_len: m is finite from then on
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      const float alpha = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha;
#pragma unroll
      for (int i = 0; i < kI8D / 8; ++i) {
        o[i][2 * h] = __fmul_rn(o[i][2 * h], alpha);
        o[i][2 * h + 1] = __fmul_rn(o[i][2 * h + 1], alpha);
      }
    }
    // sweep 2: p and P.V
    int pv[kPv8 ? kI8D / 8 : 1][4];
    if constexpr (kPv8) {
#pragma unroll
      for (int i = 0; i < kI8D / 8; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0;
    }
    for (int tt = 0; tt < tiles; ++tt) {
      const int k0 = c0 + tt * kI8Tile;
      __syncthreads();  // the previous tile's readers are done
      if constexpr (kPv8) {  // v8 [128 d][n_pad slots]: this tile's 64 slots of each d row
        const int8_t* vh = static_cast<const int8_t*>(v) + (size_t)head * kI8D * n_pad;
        for (int i = tid; i < kI8D * (kI8Tile / 16); i += kThreads) {
          const int d = i >> 2, seg = i & 3;
          *reinterpret_cast<int4*>(sVt + d * kV8Ld + seg * 16) =
              *reinterpret_cast<const int4*>(vh + (size_t)d * n_pad + k0 + seg * 16);
        }
      } else if constexpr (kMode == kQkBf16) {
        load_rows<kI8D>(reinterpret_cast<bf16*>(sVt), static_cast<const bf16*>(v) + off, k0, n,
                        tid);
      } else {
        const float* vh = static_cast<const float*>(v) + off;
        float* sV = reinterpret_cast<float*>(sVt);
        for (int i = tid; i < kI8Tile * (kI8D / 4); i += kThreads) {
          const int r = i >> 5, cc = (i & 31) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + r < n) val = *reinterpret_cast<const float4*>(vh + (size_t)(k0 + r) * kI8D + cc);
          *reinterpret_cast<float4*>(sV + r * kVfLd + cc) = val;
        }
      }
      __syncthreads();
      int si[kNS][4];
      i8_scores(si, qa, sK8 + tt * kI8Tile * kK8Ld, lane);
      float p[kNS][4];
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k0 + nt * 8 + 2 * t + (e & 1) < kv_len;
          p[nt][e] = ok ? exp2f(__fmul_rn((float)si[nt][e], c) - m_run[e >> 1]) : 0.f;
          l_run[e >> 1] += p[nt][e];
        }
      if constexpr (kPv8) {
        const int8_t* sV8 = reinterpret_cast<const int8_t*>(sVt);
#pragma unroll
        for (int ks = 0; ks < kI8Tile / 32; ++ks) {
          const int j = 4 * ks;  // n-tiles j .. j + 3 hold the step's 32 keys
          uint32_t a[4];
          a[0] = pack_s8x4(p[j][0], p[j][1], p[j + 1][0], p[j + 1][1]);
          a[1] = pack_s8x4(p[j][2], p[j][3], p[j + 1][2], p[j + 1][3]);
          a[2] = pack_s8x4(p[j + 2][0], p[j + 2][1], p[j + 3][0], p[j + 3][1]);
          a[3] = pack_s8x4(p[j + 2][2], p[j + 2][3], p[j + 3][2], p[j + 3][3]);
#pragma unroll
          for (int np = 0; np < kI8D / 16; ++np) {
            uint32_t b[4];
            ldmatrix_x4(b, i8_b_nk_addr(sV8 + np * 16 * kV8Ld + ks * 32, kV8Ld, lane));
            mma_s8_16832(pv[2 * np], a, b[0], b[1]);
            mma_s8_16832(pv[2 * np + 1], a, b[2], b[3]);
          }
        }
      } else if constexpr (kMode == kQkBf16) {
        mma_pb<kI8D>(o, p, reinterpret_cast<const bf16*>(sVt), lane);
      } else {
        const float* sV = reinterpret_cast<const float*>(sVt);
        float* sP = reinterpret_cast<float*>(sVt) + kI8Tile * kVfLd;
        const int r = warp * 16 + (lane >> 2);  // this lane's rows of the block
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) {
          *reinterpret_cast<float2*>(sP + r * kPLd + nt * 8 + 2 * t) =
              make_float2(p[nt][0], p[nt][1]);
          *reinterpret_cast<float2*>(sP + (r + 8) * kPLd + nt * 8 + 2 * t) =
              make_float2(p[nt][2], p[nt][3]);
        }
        __syncwarp();  // the p rows of this warp are its own
#pragma unroll 4
        for (int key = 0; key < kI8Tile; ++key) {
          const float p0 = sP[r * kPLd + key], p1 = sP[(r + 8) * kPLd + key];
#pragma unroll
          for (int j = 0; j < kI8D / 8; ++j) {
            const float2 vv = *reinterpret_cast<const float2*>(sV + key * kVfLd + j * 8 + 2 * t);
            o[j][0] = fmaf(p0, vv.x, o[j][0]);
            o[j][1] = fmaf(p0, vv.y, o[j][1]);
            o[j][2] = fmaf(p1, vv.x, o[j][2]);
            o[j][3] = fmaf(p1, vv.y, o[j][3]);
          }
        }
        __syncwarp();
      }
    }
    if constexpr (kPv8) {
#pragma unroll
      for (int i = 0; i < kI8D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = __fadd_rn(o[i][e], __fmul_rn((float)pv[i][e], sv));
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = quad_sum(l_run[h]);
    inv[h] = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros
  }
  if constexpr (kOutF32) {
    float* dst = static_cast<float*>(out) + off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + 8 * h >= n) continue;
#pragma unroll
      for (int j = 0; j < kI8D / 8; ++j)
        *reinterpret_cast<float2*>(dst + (size_t)(row0 + 8 * h) * kI8D + j * 8 + 2 * t) =
            make_float2(o[j][2 * h] * inv[h], o[j][2 * h + 1] * inv[h]);
    }
  } else {
    store_output_rows<kI8D / 8>(static_cast<bf16*>(out) + off, kI8D, o, inv, row0, n, t);
  }
}

template <int kMode>
cudaError_t launch_i8_d128(const void* q8, const void* k8, const void* v, const void* c,
                           const void* sv, const void* kv_lens, void* out, int H, int n,
                           int n_pad, cudaStream_t stream) {
  constexpr int smem = i8_smem_bytes<kMode>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_i8_d128_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_prefix_i8_d128_kernel<kMode><<<dim3((n + kBQ - 1) / kBQ, H), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v,
      static_cast<const float*>(c), static_cast<const float*>(sv),
      static_cast<const int*>(kv_lens), out, n, n_pad);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 128] int8. pv_i8 != 0: v is int8 [H, 128, n_pad] in the
// pass's layout (n_pad % 128 == 0, zero past n); else v is [H, n, 128] of the
// output's dtype (bf16, or fp32 with out_f32) and sv is not read. c, sv: [H]
// fp32; kv_lens: [H] int32; out: [H, n, 128] bf16, or fp32 with out_f32. All
// 16-byte aligned.
extern "C" int f5_flash_prefix_i8_d128_fwd(const void* q8, const void* k8, const void* v,
                                           const void* c, const void* sv, const void* kv_lens,
                                           void* out, int H, int n, int n_pad, int pv_i8,
                                           int out_f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  if (pv_i8 && (n_pad < n || n_pad % 128 != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pv_i8)
    return (int)(out_f32 ? f5::launch_i8_d128<f5::kQkpvF32>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                            n_pad, s)
                         : f5::launch_i8_d128<f5::kQkpv>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                         n_pad, s));
  return (int)(out_f32 ? f5::launch_i8_d128<f5::kQkF32>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                        n_pad, s)
                       : f5::launch_i8_d128<f5::kQkBf16>(q8, k8, v, c, sv, kv_lens, out, H, n,
                                                         n_pad, s));
}

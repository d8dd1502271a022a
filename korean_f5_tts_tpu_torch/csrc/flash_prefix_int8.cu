// Prefix-masked flash attention with int8 products, forward, for Hopper
// (sm_90a): kernel 14.
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_folded_i8 -> _kernel_i8. The function, per folded head h with
// c = aq*ak/127^2 * log2(e)/sqrt(d) and sv = av/127^2 (computed by the
// wrapper, ops/flash_prefix.py:flash_prefix_attention_i8):
//   s   = float(q8 . k8^T) * c[h]            exact int32 product, base-2 domain
//   keys at or past kv_lens[h] are masked; online max m and sum l in fp32,
//   l adds the unquantized p = exp2(s - m)
//   kPvI8:  p8 = rint(127 * p) (ties to even), acc = acc*alpha + float(p8 . v8) * sv[h]
//   else:   acc = acc*alpha + bf16(p) . v     (v unquantized bf16)
//   out = acc / l, rounded once to bf16
// p8 depends on the running max at the time a key tile is visited, so the key
// tile (64) is part of the arithmetic: the plain version
// (flash_prefix_i8_reference) repeats it with ck = 64.
//
// What bounds it on the card: at the main shape (H = 32, n = 1536, d = 64,
// 1376 valid keys) 17.3 GOP of int8 products against 9.4 MB of int8 in and
// 6.3 MB of bf16 out, so it is operation bound; the n x n scores never reach
// device memory.
//
// Design: kernel A's loop (flash_prefix.cuh): one 128-thread block per
// (folded head, 64-row query tile), each warp 16 query rows whose q8
// fragments stay in registers, 64-key tiles through shared memory, the KV
// loop cut at ceil(kv_len / 64) (kv_len == 0 gives zeros, as kernels A, 18
// and 19). Both products are IMMA mma.sync m16n8k32 s8 x s8 -> s32.
//   - q8.k8^T wants B "col-major", which is k8 as [n, d] row-major: untouched.
//   - p8.v8 wants B contiguous along the keys, and ldmatrix.trans moves
//     16-bit elements, not bytes: the quantization pass writes v8 transposed,
//     [H, d, n_pad] (n_pad a multiple of 64, zero-filled).
//   - The s32 accumulator of score n-tiles 4s..4s+3 gives a thread keys
//     8j + 2t, 8j + 2t + 1 (j = 0..3) of a row, but the s8 A fragment of key
//     step s wants bytes 4t..4t+3 and 16+4t..16+4t+3. A contraction does not
//     care about the order of its index as long as both operands agree, so the
//     wrapper stores v8's keys in that order inside every group of 32: key
//     32b + 16h + 8j + 2t + e lies at slot 32b + 16h + 4t + 2j + e. p8 is
//     packed in registers as it stands and never goes through shared memory.
//   - Without kPvI8, Hopper has no fp32 tensor-core product: p is rounded to
//     bf16 for an m16n8k16 product on the bf16 v tile, as kernel A does.
// The scale, the accumulator update and rint use the _rn intrinsics, so nvcc
// fuses no multiply-add that would round differently from the plain version.
// Simple first: synchronous loads, no cp.async ring, no wgmma, no fp8 product.
#include "flash_prefix.cuh"
#include "int8_gemm.cuh"

namespace f5 {
namespace {

constexpr int kI8LD = 64 + 16;  // bytes per shared int8 row (64 + pad, as int8_gemm.cuh)

// rows [row0, row0 + 64) of an [n, 64] int8 head into a [64][80] shared tile;
// rows at or past n are zero-filled
__device__ __forceinline__ void load_rows_i8(int8_t* dst, const int8_t* src, size_t ld, int row0,
                                             int n, int tid) {
  for (int i = tid; i < 64 * 4; i += kThreads) {
    const int r = i >> 2;
    const int c = (i & 3) * 16;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<int4*>(dst + r * kI8LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

template <bool kPvI8>
__global__ void __launch_bounds__(kThreads)
flash_prefix_i8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                       const void* __restrict__ v_any, const float* __restrict__ c_scale,
                       const float* __restrict__ sv_scale, const int* __restrict__ kv_lens,
                       bf16* __restrict__ out, int n, int n_pad) {
  constexpr int D = 64;
  constexpr int ND = D / 8;
  __shared__ __align__(16) int8_t sQ[kBQ * kI8LD];
  __shared__ __align__(16) int8_t sK[kBKV * kI8LD];
  // kPvI8: [64 d][80] int8 (keys contiguous); else [64 keys][72] bf16
  __shared__ __align__(16) unsigned char sVraw[kPvI8 ? D * kI8LD : kBKV * (D + 8) * 2];

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const size_t off = (size_t)head * n * D;
  const int kv_len = min(kv_lens[head], n);
  const float c = c_scale[head];
  const float sv = sv_scale[head];

  load_rows_i8(sQ, q8 + off, D, q0, n, tid);
  __syncthreads();
  uint32_t qf[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    ldmatrix_x4(qf[kk], i8_a_frag_addr(sQ + (warp * 16) * kI8LD + kk * 32, kI8LD, lane));

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    load_rows_i8(sK, k8 + off, D, k0, n, tid);
    if constexpr (kPvI8) {
      // v8: [H, 64, n_pad]; every row of the tile is in range (n_pad % 64 == 0)
      const int8_t* v8 = static_cast<const int8_t*>(v_any) + (size_t)head * D * n_pad + k0;
      load_rows_i8(reinterpret_cast<int8_t*>(sVraw), v8, (size_t)n_pad, 0, D, tid);
    } else {
      load_rows<D>(reinterpret_cast<bf16*>(sVraw), static_cast<const bf16*>(v_any) + off, k0, n,
                   tid);
    }
    __syncthreads();

    // s32 = q8 . k8^T for this warp's 16 rows and the tile's 64 keys
    int s32[kNS][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) s32[i][0] = s32[i][1] = s32[i][2] = s32[i][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNS; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, i8_b_nk_addr(sK + (nt * 8) * kI8LD + kk * 32, kI8LD, lane));
        mma_s8_16832(s32[nt], qf[kk], b[0], b[1]);
        mma_s8_16832(s32[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax in the base-2 domain
    float p[kNS][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < kv_len ? __fmul_rn(__int2float_rn(s32[nt][e]), c) : -INFINITY;
        p[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // tile 0 always holds key 0 < kv_len, so m_new is finite from then on
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = exp2f(__fsub_rn(m_run[r], m_new));
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(__fsub_rn(p[nt][e], m_run[e >> 1]));
        p[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = __fadd_rn(__fmul_rn(l_run[r], alpha[r]), rs[r]);

    if constexpr (kPvI8) {
      const int8_t* sV = reinterpret_cast<const int8_t*>(sVraw);
      int pv[ND][4];
#pragma unroll
      for (int i = 0; i < ND; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0;
#pragma unroll
      for (int ks = 0; ks < kBKV / 32; ++ks) {
        // p8 = rint(127 p) in [0, 127]; score n-tiles 4ks..4ks+3 are this key
        // step's A fragment in the slot order the wrapper gave v8
        int p8[4][4];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p8[jn][e] = __float2int_rn(__fmul_rn(p[4 * ks + jn][e], 127.f));
        uint32_t a[4];
        a[0] = pack_s8x4(p8[0][0], p8[0][1], p8[1][0], p8[1][1]);  // row g, slots 4t..4t+3
        a[1] = pack_s8x4(p8[0][2], p8[0][3], p8[1][2], p8[1][3]);  // row g + 8
        a[2] = pack_s8x4(p8[2][0], p8[2][1], p8[3][0], p8[3][1]);  // row g, slots 16+4t..
        a[3] = pack_s8x4(p8[2][2], p8[2][3], p8[3][2], p8[3][3]);  // row g + 8
#pragma unroll
        for (int dt = 0; dt < ND; dt += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, i8_b_nk_addr(sV + (dt * 8) * kI8LD + ks * 32, kI8LD, lane));
          mma_s8_16832(pv[dt], a, b[0], b[1]);
          mma_s8_16832(pv[dt + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[dt][e] = __fadd_rn(__fmul_rn(o[dt][e], alpha[e >> 1]),
                               __fmul_rn(__int2float_rn(pv[dt][e]), sv));
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = __fmul_rn(o[dt][e], alpha[e >> 1]);
      }
      mma_pb<D>(o, p, reinterpret_cast<const bf16*>(sVraw), lane);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l > 0.f ? __fdiv_rn(1.f, l) : 0.f;  // kv_len == 0: zeros
  }
  const int row0 = q0 + warp * 16 + (lane >> 2);
  store_output_rows<ND>(out + off, D, o, inv, row0, n, t);
}

template <bool kPvI8>
cudaError_t launch_i8(const void* q8, const void* k8, const void* v, const void* c,
                      const void* sv, const void* kv_lens, void* out, int H, int n, int n_pad,
                      cudaStream_t stream) {
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_i8_kernel<kPvI8><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v,
      static_cast<const float*>(c), static_cast<const float*>(sv),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out), n, n_pad);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 64] int8. pv_i8 != 0: v is int8 [H, 64, n_pad] with the key
// slots of every group of 32 in the order above (n_pad % 64 == 0, zero past
// n); else v is bf16 [H, n, 64] and sv is not read. c, sv: [H] fp32; kv_lens:
// [H] int32; out: [H, n, 64] bf16.
extern "C" int f5_flash_prefix_i8_fwd(const void* q8, const void* k8, const void* v,
                                      const void* c, const void* sv, const void* kv_lens,
                                      void* out, int H, int n, int n_pad, int pv_i8, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pv_i8) {
    if (n_pad < n || n_pad % 64 != 0) return (int)cudaErrorInvalidValue;
    return (int)f5::launch_i8<true>(q8, k8, v, c, sv, kv_lens, out, H, n, n_pad, s);
  }
  return (int)f5::launch_i8<false>(q8, k8, v, c, sv, kv_lens, out, H, n, n_pad, s);
}

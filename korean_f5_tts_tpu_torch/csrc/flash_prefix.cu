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
#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 128;

// rows [row0, row0 + 64) of a [n, D] head into a [64][D + 8] shared tile;
// rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n, int tid) {
  constexpr int LD = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<int4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefix_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ kv_lens,
                        bf16* __restrict__ out, int n, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;  // k-steps of q.k^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NS = kBKV / 8;  // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBKV * LD;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t off = (size_t)head * n * D;
  const int kv_len = min(kv_lens[head], n);

  load_rows<D>(sQ, q + off, q0, n, tid);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], a_frag_addr(sQ + (warp * 16) * LD + kk * 16, LD, lane));

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sK, k + off, k0, n, tid);
    load_rows<D>(sV, v + off, k0, n, tid);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, b_nk_addr(sK + (nt * 8) * LD + kk * 16, LD, lane));
        mma_bf16_16816(s[nt], qf[kk], b[0], b[1]);
        mma_bf16_16816(s[nt + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale into the base-2 domain, mask keys at or past kv_len, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < kv_len ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // tile 0 always holds key 0 < kv_len, so m_new is finite from then on
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P.V: score n-tiles (2kt, 2kt + 1) are the A fragment of key step kt
#pragma unroll
    for (int kt = 0; kt < kBKV / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16x2(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < ND; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_kn_addr(sV + (kt * 16) * LD + dt * 8, LD, lane));
        mma_bf16_16816(o[dt], a, b[0], b[1]);
        mma_bf16_16816(o[dt + 1], a, b[2], b[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros, as the TPU kernel
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out + off + (size_t)row0 * D + col) =
          pack_bf16x2(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (row0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + off + (size_t)(row0 + 8) * D + col) =
          pack_bf16x2(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                   int H, int n, float scale_log2, cudaStream_t stream) {
  const int smem = 3 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out), n, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

extern "C" int f5_flash_prefix_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_lens, void* out, int H, int n, int d,
                                   float scale_log2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return (int)f5::launch<64>(q, k, v, kv_lens, out, H, n, scale_log2, s);
  if (d == 128) return (int)f5::launch<128>(q, k, v, kv_lens, out, H, n, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* f5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

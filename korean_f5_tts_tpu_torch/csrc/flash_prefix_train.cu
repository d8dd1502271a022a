// Prefix-masked flash attention for training, for Hopper (sm_90a): the
// forward with its logsumexp and the backward sweeps.
//
// Replaces the TPU kernels of korean_f5_tts_tpu/ops/flash_prefix.py:
//   10  _flash_prefix_folded_lse -> _kernel_lse      (o and lse)
//   11  _flash_prefix_dq_lsein   -> _kernel_dq_lsein (dq from the forward's lse)
//   12  _flash_prefix_dq         -> _kernel_dq       (dq, recomputing the lse)
//   13  _flash_prefix_dkv        -> _kernel_dkv      (dk and dv)
// q, k, v, dO, o, dq, dk, dv: [H, n, D] bf16 (batch folded into heads);
// kv_lens: [H] int32; lse and D = rowsum(dO * o): [H, n] fp32. Folded head h
// attends keys [0, kv_lens[h]). lse is the JAX convention: base 2, of the
// scores pre-scaled by scale_log2 = log2(e) / sqrt(D).
//
// What bounds them on the card: at the training shape (b = 8 x 16 heads =
// H = 128, n = 1280, D = 64) kernel 10 is 4*n*n*D*H = 53.7 GFLOP, 11 and 12
// are 6*n*n*D*H = 80.5 and 13 is 8*n*n*D*H = 107 GFLOP, against 84-126 MB of
// [H, n, D] operands each: tensor-core bound, and the n x n scores must stay
// out of device memory (the plain versions write a 839 MB fp32 [H, n, n]
// tensor per product).
//
// Where each runs:
//   - 10: on the attention core of kernel A (attn_wgmma.cuh, TMA + wgmma,
//     192 query rows a block), whose lse form also writes lse = m + log2(l)
//     per row (0 for a row with no valid key, with zero output).
//   - 11, 13: on the attention backward core (attn_bwd_wgmma.cuh, TMA +
//     wgmma). 13: one block per (head, 128 keys), K and V resident in shared
//     memory, 64-query tiles of Q, dO, lse and D streamed through an mbarrier
//     ring, S^T, dP^T, dV += P^T.dO and dK += dS^T.q on wgmma. 11: one block
//     per (head, 128 queries), Q and dO resident, 128-key tiles of K and V
//     streamed, S, dP and dq += dS.K on wgmma. No atomics in either.
//   - 12: the first port's mma.sync design below (kernel A's old tiling,
//     flash_prefix.cuh): one 128-thread block per (head, 64-query tile); q
//     and dO stay in registers as mma A fragments and the block walks
//     ceil(kv_len / 64) key tiles loaded synchronously into shared memory:
//     S = q.k^T, dP = dO.v^T, dq += dS.k on mma.sync m16n8k16 with dS
//     rounded to bf16 in registers (the TPU default F5_TTS_BWD_CAST=1,
//     :1063); it carries a running max and denominator instead of the lse:
//     the accumulator is rescaled on each max update and divided by l at the
//     end (dS is linear in P), finally dq *= 1/sqrt(D), and the lse it ends
//     with is written out.
//   - fp32 operands: flash_prefix_train_f32.cu (11, 12, 13) and kernel A's
//     fp32 kernel with an lse output (flash_prefix.cu, 10), split 3xTF32
//     products on the tensor cores.
// Rows past n are zero-filled on load and never stored; a row with no valid
// key gets lse 0 and zero gradients.
//
// Numerics: the scale meets the fp32 product (S * scale_log2) in all four
// kernels; the TPU dq kernels scale q in its own dtype first (:987, :1047)
// and its dk/dv kernel the fp32 product (:1173), so the bf16 bounds of the
// comparisons cover that one rounding.
#include "attn_bwd_wgmma.cuh"
#include "flash_prefix.cuh"

namespace f5 {
namespace {

// kernel 12's dq for one (head, 64-query tile), the lse recomputed and
// written to lse_out
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefix_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ dvec, const int* __restrict__ kv_lens,
                       bf16* __restrict__ dq, float* __restrict__ lse_out, int n,
                       float scale_log2, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kBQ * LD;
  bf16* sK = sDO + kBQ * LD;
  bf16* sV = sK + kBKV * LD;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const size_t off = (size_t)head * n * D;
  const int kv_len = min(kv_lens[head], n);
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8

  load_rows<D>(sQ, q + off, q0, n, tid);
  load_rows<D>(sDO, dout + off, q0, n, tid);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(qf, sQ, warp, lane);
  load_a_frags<D>(df, sDO, warp, lane);

  float dr[2], m_run[2], l_run[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    dr[r] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();
    load_rows<D>(sK, k + off, k0, n, tid);
    load_rows<D>(sV, v + off, k0, n, tid);
    __syncthreads();

    float s[kNS][4], dp[kNS][4];
    mma_abt<D>(s, qf, sK, lane);
    mma_abt<D>(dp, df, sV, lane);
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < kv_len ? s[nt][e] * scale_log2 : -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));  // finite from tile 0 on
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(s[nt][e] - m_run[r]);  // relative to the running max
        l_run[r] += p;
        s[nt][e] = p * (dp[nt][e] - dr[r]);  // dS
      }
    }
    mma_pb<D>(acc, s, sK, lane);
  }

  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    scale[r] = l > 0.f ? sm_scale / l : 0.f;
    const int row = row0 + 8 * r;
    if (t == 0 && row < n)
      lse_out[(size_t)head * n + row] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(dq + off + (size_t)row0 * D + col) =
          pack_bf16x2(acc[dt][0] * scale[0], acc[dt][1] * scale[0]);
    if (row0 + 8 < n)
      *reinterpret_cast<uint32_t*>(dq + off + (size_t)(row0 + 8) * D + col) =
          pack_bf16x2(acc[dt][2] * scale[1], acc[dt][3] * scale[1]);
  }
}

cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* dvec, const void* kv_lens, void* dq, void* lse_out, int H,
                      int n, float scale_log2, float sm_scale, cudaStream_t stream) {
  constexpr int D = 64;
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(dvec),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(dq), static_cast<float*>(lse_out),
      n, scale_log2, sm_scale);
  return cudaGetLastError();
}

// the training kernels take D = 64 (the DiT's head dim) only
int check_args(int device, int H, int n, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || d != 64) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
}  // namespace f5

// kernel 10, on the attention core
extern "C" int f5_flash_prefix_fwd_lse(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, void* lse, int H, int n,
                                       int d, float scale_log2, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_attn_fwd_wgmma<true>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                              static_cast<cudaStream_t>(stream));
}

// kernel 11, on the attention backward core
extern "C" int f5_flash_prefix_dq_lsein(const void* q, const void* k, const void* v,
                                        const void* dout, const void* dvec, const void* lse,
                                        const void* kv_lens, void* dq, int H, int n, int d,
                                        float scale_log2, float sm_scale, int device,
                                        void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_attn_dq_wgmma(q, k, v, dout, dvec, lse, kv_lens, dq, H, n, scale_log2,
                                       sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 12
extern "C" int f5_flash_prefix_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* dvec, const void* kv_lens,
                                  void* dq, void* lse_out, int H, int n, int d, float scale_log2,
                                  float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_dq(q, k, v, dout, dvec, kv_lens, dq, lse_out, H, n, scale_log2,
                            sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 13, on the attention backward core
extern "C" int f5_flash_prefix_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* dvec, const void* lse,
                                   const void* kv_lens, void* dk, void* dv, int H, int n, int d,
                                   float scale_log2, float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_attn_dkv_wgmma(q, k, v, dout, dvec, lse, kv_lens, dk, dv, H, n,
                                        scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

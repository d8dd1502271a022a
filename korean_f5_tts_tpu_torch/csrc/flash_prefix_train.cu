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
// Design: kernel A's tiling (flash_prefix.cuh). 128 threads per block, a
// 64-row tile per block and 16 rows per warp, held in registers as mma A
// fragments; the other operand streams through shared memory in 64-row tiles,
// every product is mma.sync m16n8k16 bf16 with fp32 accumulation, and a
// score tile goes from the accumulator straight into the next product's A
// fragment, rounded to bf16 (the TPU default F5_TTS_BWD_CAST=1, :1063).
//   - 10: kernel A's loop, which also writes lse = m + log2(l) per row.
//   - 11, 12: one block per (head, 64-query tile); q and dO stay in
//     registers and the block walks ceil(kv_len / 64) key tiles:
//     S = q.k^T, P = exp2(S * scale_log2 - lse), dP = dO.v^T,
//     dS = P * (dP - D), dq += dS.k; finally dq *= 1/sqrt(D). 12 carries a
//     running max and denominator instead of the lse: the accumulator is
//     rescaled on each max update and divided by l at the end (dS is linear
//     in P), and the lse it ends with is written out.
//   - 13: one block per (head, 64-key tile); k and v stay in registers and the
//     block walks all query tiles, each with its lse and D rows:
//     S^T = k.q^T, P^T = exp2(S^T * scale_log2 - lse), dv += P^T.dO,
//     dP^T = v.dO^T, dS^T = P^T * (dP^T - D), dk += dS^T.q; finally
//     dk *= 1/sqrt(D). Each block owns its dk and dv rows: no atomics, so the
//     result does not depend on the order blocks run in. A key tile at or
//     past kv_len has P = 0 and writes zeros without walking the queries.
// Rows past n are zero-filled on load and never stored; a row with no valid
// key gets lse 0 and zero gradients.
//
// Numerics: the scale meets the fp32 product (S * scale_log2) in all four
// kernels; the TPU dq kernels scale q in its own dtype first (:987, :1047)
// and its dk/dv kernel the fp32 product (:1173), so the bf16 bounds of the
// comparisons cover that one rounding.
#include "flash_prefix.cuh"

namespace f5 {
namespace {

// dq for one (head, 64-query tile); kOnline: kernel 12 (lse recomputed and
// written to lse_out), otherwise kernel 11 (lse_in given)
template <int D, bool kOnline>
__global__ void __launch_bounds__(kThreads)
flash_prefix_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ dvec, const float* __restrict__ lse_in,
                       const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                       float* __restrict__ lse_out, int n, float scale_log2, float sm_scale) {
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

  float dr[2], lse[2], m_run[2], l_run[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    dr[r] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[r] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
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
    if (kOnline) {
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
        lse[r] = m_new;  // P below is relative to the running max
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(s[nt][e] - lse[r]);
        if (kOnline) l_run[r] += p;
        s[nt][e] = p * (dp[nt][e] - dr[r]);  // dS
      }
    }
    mma_pb<D>(acc, s, sK, lane);
  }

  float scale[2] = {sm_scale, sm_scale};
  if (kOnline) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      scale[r] = l > 0.f ? sm_scale / l : 0.f;
      const int row = row0 + 8 * r;
      if (t == 0 && row < n)
        lse_out[(size_t)head * n + row] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
    }
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

// dk and dv for one (head, 64-key tile), kernel 13
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefix_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ dvec, const float* __restrict__ lse,
                        const int* __restrict__ kv_lens, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int n, float scale_log2, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBQ * LD;
  bf16* sQ = sV + kBQ * LD;
  bf16* sDO = sQ + kBKV * LD;
  float* sL = reinterpret_cast<float*>(sDO + kBKV * LD);  // lse of the query tile
  float* sD = sL + kBKV;                                  // D of the query tile

  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const size_t off = (size_t)head * n * D;
  const int kv_len = min(kv_lens[head], n);
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys: key0, key0 + 8
  const bool valid[2] = {key0 < kv_len, key0 + 8 < kv_len};

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }
  if (k0 < kv_len) {  // block-uniform: a tile of masked keys keeps zero gradients
    load_rows<D>(sK, k + off, k0, n, tid);
    load_rows<D>(sV, v + off, k0, n, tid);
    __syncthreads();
    uint32_t kf[D / 16][4], vf[D / 16][4];
    load_a_frags<D>(kf, sK, warp, lane);
    load_a_frags<D>(vf, sV, warp, lane);

    const int q_tiles = (n + kBKV - 1) / kBKV;
    for (int i = 0; i < q_tiles; ++i) {
      const int qq0 = i * kBKV;
      __syncthreads();
      load_rows<D>(sQ, q + off, qq0, n, tid);
      load_rows<D>(sDO, dout + off, qq0, n, tid);
      if (tid < kBKV) {
        const bool in = qq0 + tid < n;
        sL[tid] = in ? lse[(size_t)head * n + qq0 + tid] : 0.f;
        sD[tid] = in ? dvec[(size_t)head * n + qq0 + tid] : 0.f;
      }
      __syncthreads();

      float st[kNS][4], dpt[kNS][4];
      mma_abt<D>(st, kf, sQ, lane);
      mma_abt<D>(dpt, vf, sDO, lane);
#pragma unroll
      for (int nt = 0; nt < kNS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const float p = (valid[e >> 1] && qq0 + col < n)
                              ? exp2f(st[nt][e] * scale_log2 - sL[col]) : 0.f;
          st[nt][e] = p;                             // P^T
          dpt[nt][e] = p * (dpt[nt][e] - sD[col]);   // dS^T
        }
      }
      mma_pb<D>(dva, st, sDO, lane);
      mma_pb<D>(dka, dpt, sQ, lane);
    }
  }
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int col = dt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 8 * r;
      if (row < n) {
        *reinterpret_cast<uint32_t*>(dk + off + (size_t)row * D + col) =
            pack_bf16x2(dka[dt][2 * r] * sm_scale, dka[dt][2 * r + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + off + (size_t)row * D + col) =
            pack_bf16x2(dva[dt][2 * r], dva[dt][2 * r + 1]);
      }
    }
  }
}

template <bool kOnline>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                      void* lse_out, int H, int n, float scale_log2, float sm_scale,
                      cudaStream_t stream) {
  constexpr int D = 64;
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_dq_kernel<D, kOnline>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_dq_kernel<D, kOnline><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse_in), static_cast<const int*>(kv_lens),
      static_cast<bf16*>(dq), static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* dvec, const void* lse, const void* kv_lens, void* dk,
                       void* dv, int H, int n, float scale_log2, float sm_scale,
                       cudaStream_t stream) {
  constexpr int D = 64;
  const int smem = 4 * 64 * (D + 8) * (int)sizeof(bf16) + 2 * kBKV * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse), static_cast<const int*>(kv_lens),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale_log2, sm_scale);
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

// kernel 10
extern "C" int f5_flash_prefix_fwd_lse(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, void* lse, int H, int n,
                                       int d, float scale_log2, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_fwd<64, true>(q, k, v, kv_lens, out, lse, H, n, scale_log2,
                                       static_cast<cudaStream_t>(stream));
}

// kernel 11
extern "C" int f5_flash_prefix_dq_lsein(const void* q, const void* k, const void* v,
                                        const void* dout, const void* dvec, const void* lse,
                                        const void* kv_lens, void* dq, int H, int n, int d,
                                        float scale_log2, float sm_scale, int device,
                                        void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_dq<false>(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H, n,
                                   scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 12
extern "C" int f5_flash_prefix_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* dvec, const void* kv_lens,
                                  void* dq, void* lse_out, int H, int n, int d, float scale_log2,
                                  float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_dq<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                  scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 13
extern "C" int f5_flash_prefix_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* dvec, const void* lse,
                                   const void* kv_lens, void* dk, void* dv, int H, int n, int d,
                                   float scale_log2, float sm_scale, int device, void* stream) {
  if (int err = f5::check_args(device, H, n, d)) return err;
  return (int)f5::launch_dkv(q, k, v, dout, dvec, lse, kv_lens, dk, dv, H, n, scale_log2,
                             sm_scale, static_cast<cudaStream_t>(stream));
}

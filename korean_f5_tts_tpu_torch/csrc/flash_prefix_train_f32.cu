// Prefix-masked flash attention for training on fp32 operands, for Hopper
// (sm_90a): the fp32 forms of kernels 11, 12 (dq) and 13 (dk, dv). Kernel
// 10's fp32 form is kernel A's split 3xTF32 kernel with an lse output
// (flash_prefix.cu, f5_flash_prefix_f32_fwd_lse); both build on
// attn_tf32.cuh.
//
// Replaces, on fp32 inputs, the TPU kernels of
// korean_f5_tts_tpu/ops/flash_prefix.py:
//   11  _flash_prefix_dq_lsein -> _kernel_dq_lsein (dq from the forward's lse)
//   12  _flash_prefix_dq       -> _kernel_dq       (dq, recomputing the lse)
//   13  _flash_prefix_dkv      -> _kernel_dkv      (dk and dv)
// The functions are those of the bf16 forms (flash_prefix_train.cu): folded
// heads q, k, v, dO, dq, dk, dv [H, n, 64] fp32 (at d = 128 the entry
// points below hand the call to flash_prefix_train_tf32_d128.cu's split
// 3xTF32 kernels), kv_lens [H] int32, lse and
// D = rowsum(dO * o) [H, n] fp32, lse in base 2 of the scores pre-scaled by
// scale_log2 = log2(e) / sqrt(64). On fp32 inputs the TPU kernels keep "the
// exact f32 dot": S, P, dP, dS, the accumulators and the outputs stay fp32.
//
// Products: on the tensor cores as split "3xTF32" products (mma.cuh): each
// operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a.b ~
// hi.hi + hi.lo + lo.hi in mma.sync m16n8k8 .tf32 with fp32 accumulation,
// which keeps fp32 accuracy (the dropped lo.lo is ~2^-22 relative; a single
// TF32 product keeps 10 mantissa bits, ~1e-3, and fails the 1e-4 bound of
// the fp32 forms). Each tile is split once, as it lands in shared memory
// (hi and lo tiles side by side); dS and P are split once in registers.
// P = exp2(S * scale_log2 - lse) and dS = P * (dP - D) stay fp32 registers.
// The dq, dK and dV accumulators chain over the whole sweep, and the tensor
// cores' fp32 accumulation truncates where fp32 would round (probe_hopper.cu,
// probe (15)): that bias is the ~1e-5 these forms read against their plain
// versions; the forward (flash_prefix.cu), which sums each tile's P.V in an
// accumulator of its own, reads ~1e-6.
//
// What bounds them: at the training shape (H 128, n 1280, every key valid)
// 11 and 12 are 6 * n^2 * 64 * H = 80.5 GFLOP and 13 is 8 * n^2 * 64 * H =
// 107 GFLOP of fp32-accurate products. In 3xTF32 at the card's dense TF32
// rate (494.7 TFLOP/s, three products each: 164.9 TFLOP/s) that is 0.488 ms
// and 0.651 ms, against 168-252 MB of operands (0.05-0.08 ms); in FFMA, at
// the 67 TFLOP/s of fp32 outside the tensor cores, 1.20 and 1.60 ms, the
// bound of the FFMA loops these kernels replace. The n x n scores stay out
// of device memory.
//
// Design: 256 threads a block, eight warps of 16 rows each; every product
// is mma.sync m16n8k8 on fragments from padded row-major tiles (row stride
// 68 words: ldmatrix and the scalar B reads are conflict-free). The first
// product of a pair (S, dP) contracts over d with A and B by ldmatrix; its
// accumulator becomes the A fragment of the second (dq, dK, dV), which
// contracts over the tile's 64 columns, taking them in the order 2t, 2t + 1
// (mma.cuh), so the second product's B rows are read in that order by
// scalar loads. In 11 and 12 the next K/V tile's fp32 rows are loaded into
// registers while this tile's products run; 13 loads each q/dO tile at the
// top of its turn, with no prefetch (a prefetched tile, held in registers
// across the products beside 13's four accumulators, spilled).
//   dq (11, 12)  one block per (head, 128 queries): q and dO split into
//                shared memory for the whole sweep; each 64-key tile of K
//                and V is split in; warp w computes S and dP of its 16
//                queries over the 64 keys, P = exp2(S * scale_log2 - lse),
//                dS = P * (dP - D), then dq += dS.K over the tile. The sweep
//                stops at ceil(kv_len / 64) tiles; keys past kv_len in the
//                last one get P = 0. kOnline (12) keeps the running max and
//                denominator instead of the lse: dq is rescaled on each max
//                update and divided by l at the end (dS is linear in P), and
//                the lse it ends with is written.
//   dk, dv (13)  one block per (head, 128 keys): K and V split into shared
//                memory; each 64-query tile of q and dO is split in with its
//                lse and D; warp w computes S^T and dP^T of its 16 keys over
//                the 64 queries, P^T and dS^T, then dV += P^T.dO and dK +=
//                dS^T.q. Every query row is walked, padded ones included; a
//                query at or past n gets lse +inf (P = 0). A block whose
//                first key is at or past kv_len writes zero dk and dv. A
//                block owns its key rows: no atomics, and the result does not
//                depend on block order.
// 204-205 KB of shared memory a block: one block an SM.
// A row with no valid key gets lse 0 and zero gradients.
#include "attn_tf32.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace {

constexpr int kDqRows = 128;    // queries a dq block
constexpr int kDqTile = 64;     // keys a dq tile
constexpr int kDkvRows = 128;   // keys a dkv block
constexpr int kDkvTile = 64;    // queries a dkv tile

constexpr int kDqTfSmem = 4 * (kDqRows + kDqTile) * kLD32 * (int)sizeof(uint32_t);
constexpr int kDkvTfSmem =
    (4 * (kDkvRows + kDkvTile) * kLD32 + 2 * kDkvTile) * (int)sizeof(uint32_t);

// dq for one (head, 128-query block); kOnline: kernel 12 (lse recomputed and
// written to lse_out), otherwise kernel 11 (lse_in given)
template <bool kOnline>
__global__ void __launch_bounds__(kT32, 1)
flash_prefix_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ dvec, const float* __restrict__ lse_in,
                            const int* __restrict__ kv_lens, float* __restrict__ dq,
                            float* __restrict__ lse_out, int n, float scale_log2,
                            float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQh = reinterpret_cast<uint32_t*>(smem_raw);  // [128][68] each
  uint32_t* sQl = sQh + kDqRows * kLD32;
  uint32_t* sOh = sQl + kDqRows * kLD32;
  uint32_t* sOl = sOh + kDqRows * kLD32;
  uint32_t* sKh = sOl + kDqRows * kLD32;  // [64][68] each
  uint32_t* sKl = sKh + kDqTile * kLD32;
  uint32_t* sVh = sKl + kDqTile * kLD32;
  uint32_t* sVl = sVh + kDqTile * kLD32;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t off = (size_t)head * n * kD32;
  const int kv_len = min(kv_lens[head], n);
  {
    HeadRows<kDqRows> r;
    head_load(r, q + off, kD32, q0, n, tid);
    head_split(sQh, sQl, r, tid);
    head_load(r, dout + off, kD32, q0, n, tid);
    head_split(sOh, sOl, r, tid);
  }
  // this thread's rows: wr + g and wr + g + 8 of the block
  float dr[2], lse[2], m_run[2], l_run[2], acc[8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    dr[h] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[h] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
  }
  zero84(acc);

  const int n_tiles = kv_len > 0 ? (kv_len + kDqTile - 1) / kDqTile : 0;
  HeadRows<kDqTile> kr, vr;
  if (n_tiles > 0) {
    head_load(kr, k + off, kD32, 0, n, tid);
    head_load(vr, v + off, kD32, 0, n, tid);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kDqTile;
    __syncthreads();  // the previous tile's readers (and the q, dO stores) are done
    head_split(sKh, sKl, kr, tid);
    head_split(sVh, sVl, vr, tid);
    __syncthreads();
    if (jt + 1 < n_tiles) {  // the next tile's rows load while this one's products run
      head_load(kr, k + off, kD32, k0 + kDqTile, n, tid);
      head_load(vr, v + off, kD32, k0 + kDqTile, n, tid);
    }
    float s[8][4], dp[8][4];
    zero84(s);
    zero84(dp);
    mm_rows(s, sQh, sQl, sKh, sKl, wr, lane);
    mm_rows(dp, sOh, sOl, sVh, sVl, wr, lane);
    // s[j][e]: row wr + g + 8 * (e >> 1), key k0 + 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kv_len ? s[j][e] * scale_log2 : -INFINITY;
    if (kOnline) {
      // tile 0 holds key 0 < kv_len: the running max is finite from then on
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float m_new = fmaxf(m_run[h], quad_max(mx));
        const float alpha = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
        lse[h] = m_new;  // P below is relative to the running max
        l_run[h] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][2 * h] *= alpha;
          acc[j][2 * h + 1] *= alpha;
        }
      }
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - lse[e >> 1]);
        ps[e >> 1] += p;
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);  // dS
      }
    if (kOnline) {
      l_run[0] += quad_sum(ps[0]);
      l_run[1] += quad_sum(ps[1]);
    }
    mm_acc(acc, s, sKh, sKl, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= n) continue;
    float scale = sm_scale;
    if (kOnline) {
      scale = l_run[h] > 0.f ? sm_scale / l_run[h] : 0.f;
      if (t == 0)
        lse_out[(size_t)head * n + row] = l_run[h] > 0.f ? m_run[h] + log2f(l_run[h]) : 0.f;
    }
    float* dst = dq + off + (size_t)row * kD32 + 2 * t;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) =
          make_float2(acc[nd][2 * h] * scale, acc[nd][2 * h + 1] * scale);
  }
}

// dk and dv for one (head, 128-key block)
__global__ void __launch_bounds__(kT32, 1)
flash_prefix_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ dvec, const float* __restrict__ lse,
                             const int* __restrict__ kv_lens, float* __restrict__ dk,
                             float* __restrict__ dv, int n, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sKh = reinterpret_cast<uint32_t*>(smem_raw);  // [128][68] each
  uint32_t* sKl = sKh + kDkvRows * kLD32;
  uint32_t* sVh = sKl + kDkvRows * kLD32;
  uint32_t* sVl = sVh + kDkvRows * kLD32;
  uint32_t* sQh = sVl + kDkvRows * kLD32;  // [64][68] each
  uint32_t* sQl = sQh + kDkvTile * kLD32;
  uint32_t* sOh = sQl + kDkvTile * kLD32;
  uint32_t* sOl = sOh + kDkvTile * kLD32;
  float* sLse = reinterpret_cast<float*>(sOl + kDkvTile * kLD32);  // [64]
  float* sD = sLse + kDkvTile;                                     // [64]
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kDkvRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t off = (size_t)head * n * kD32;
  const int kv_len = min(kv_lens[head], n);

  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients
    for (int i = tid; i < kDkvRows * (kD32 / 4); i += kT32) {
      const int r = k0 + (i >> 4), c = (i & 15) * 4;
      if (r < n) {
        *reinterpret_cast<float4*>(dk + off + (size_t)r * kD32 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + off + (size_t)r * kD32 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  {
    HeadRows<kDkvRows> r;
    head_load(r, k + off, kD32, k0, n, tid);
    head_split(sKh, sKl, r, tid);
    head_load(r, v + off, kD32, k0, n, tid);
    head_split(sVh, sVl, r, tid);
  }
  const bool valid[2] = {k0 + wr + g < kv_len, k0 + wr + g + 8 < kv_len};
  float dk_acc[8][4], dv_acc[8][4];
  zero84(dk_acc);
  zero84(dv_acc);

  const int q_tiles = (n + kDkvTile - 1) / kDkvTile;
  for (int it = 0; it < q_tiles; ++it) {
    const int qb = it * kDkvTile;
    {
      HeadRows<kDkvTile> qr, orr;
      head_load(qr, q + off, kD32, qb, n, tid);
      head_load(orr, dout + off, kD32, qb, n, tid);
      float lr = 0.f, dd = 0.f;
      if (tid < kDkvTile) {
        lr = qb + tid < n ? lse[(size_t)head * n + qb + tid] : INFINITY;
        dd = qb + tid < n ? dvec[(size_t)head * n + qb + tid] : 0.f;
      }
      __syncthreads();  // the previous tile's readers (and the K, V stores) are done
      head_split(sQh, sQl, qr, tid);
      head_split(sOh, sOl, orr, tid);
      if (tid < kDkvTile) {
        sLse[tid] = lr;
        sD[tid] = dd;
      }
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    zero84(s);
    zero84(dp);
    mm_rows(s, sKh, sKl, sQh, sQl, wr, lane);   // S^T
    mm_rows(dp, sVh, sVl, sOh, sOl, wr, lane);  // dP^T
    // s[j][e]: key wr + g + 8 * (e >> 1), query qb + 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = valid[e >> 1] ? exp2f(s[j][e] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
        s[j][e] = p;                                     // P^T
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));  // dS^T
      }
    }
    mm_acc(dv_acc, s, sOh, sOl, lane);   // dV += P^T.dO
    mm_acc(dk_acc, dp, sQh, sQl, lane);  // dK += dS^T.q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wr + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const size_t at = off + (size_t)row * kD32 + nd * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dk_acc[nd][2 * h] * sm_scale, dk_acc[nd][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
}

template <bool kOnline>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                          void* lse_out, int H, int n, float scale_log2, float sm_scale,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_dq_tf32_kernel<kOnline>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqTfSmem);
  if (err != cudaSuccess) return err;
  flash_prefix_dq_tf32_kernel<kOnline>
      <<<dim3((n + kDqRows - 1) / kDqRows, H), kT32, kDqTfSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(dvec), static_cast<const float*>(lse_in),
          static_cast<const int*>(kv_lens), static_cast<float*>(dq),
          static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

// d = 64 here, d = 128 in flash_prefix_train_tf32_d128.cu
int check_args_f32(int device, int H, int n, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || (d != kD32 && d != 128)) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
}  // namespace f5

// kernel 11's fp32 form
extern "C" int f5_flash_prefix_f32_dq_lsein(const void* q, const void* k, const void* v,
                                            const void* dout, const void* dvec, const void* lse,
                                            const void* kv_lens, void* dq, int H, int n, int d,
                                            float scale_log2, float sm_scale, int device,
                                            void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::tf32_dq(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H, n,
                                  scale_log2, sm_scale, false, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_dq_f32<false>(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H, n,
                                       scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 12's fp32 form
extern "C" int f5_flash_prefix_f32_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* dvec, const void* kv_lens,
                                      void* dq, void* lse_out, int H, int n, int d,
                                      float scale_log2, float sm_scale, int device,
                                      void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::tf32_dq(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                  scale_log2, sm_scale, true, static_cast<cudaStream_t>(stream));
  return (int)f5::launch_dq_f32<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                      scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 13's fp32 form
extern "C" int f5_flash_prefix_f32_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* dvec, const void* lse,
                                       const void* kv_lens, void* dk, void* dv, int H, int n,
                                       int d, float scale_log2, float sm_scale, int device,
                                       void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  if (d == 128)
    return (int)f5::d128::tf32_dkv(q, k, v, dout, dvec, lse, kv_lens, dk, dv, H, n, scale_log2,
                                   sm_scale, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaFuncSetAttribute(f5::flash_prefix_dkv_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         f5::kDkvTfSmem);
  if (err != cudaSuccess) return (int)err;
  f5::flash_prefix_dkv_tf32_kernel<<<dim3((n + f5::kDkvRows - 1) / f5::kDkvRows, H), f5::kT32,
                                      f5::kDkvTfSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse), static_cast<const int*>(kv_lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, scale_log2, sm_scale);
  return (int)cudaGetLastError();
}

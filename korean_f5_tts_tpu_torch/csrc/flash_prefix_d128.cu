// Prefix-masked flash attention at head dim 128, for Hopper (sm_90a): the
// forward with its logsumexp, with the rotary embedding inside, and the
// backward sweeps, in bf16 and in fp32.
//
// Replaces, at d = 128, the TPU kernels of korean_f5_tts_tpu/ops/flash_prefix.py:
//   A   _flash_prefix_folded      -> _kernel           (o)
//   10  _flash_prefix_folded_lse  -> _kernel_lse       (o and lse)
//   11  _flash_prefix_dq_lsein    -> _kernel_dq_lsein  (dq from the forward's lse)
//   12  _flash_prefix_dq          -> _kernel_dq        (dq, recomputing the lse)
//   13  _flash_prefix_dkv         -> _kernel_dkv       (dk and dv)
//   18  _flash_prefix_rope_call   -> _kernel_rope      (A with rope inside, split heads)
// which the JAX dispatch takes at d in (64, 128) (ops/attention.py:260, :296).
// The functions are those of the d = 64 forms (flash_prefix_train.cu,
// flash_prefix_rope.cu): folded heads [H, n, 128], kv_lens [H] int32, lse in
// base 2 of the scores pre-scaled by scale_log2 = log2(e) / sqrt(128), D =
// rowsum(dO * o); rows past n are zero-filled on load and never stored; a
// row with no valid key gets output 0, lse 0 and zero gradients; the key
// sweeps stop at ceil(kv_len / 64) tiles and keys past kv_len get P = 0.
//
// What bounds them on the card: the same FLOPs as the d = 64 forms at half
// the heads. At the serving shape (16 heads, n 1536, 1376 valid keys) A and
// 18 are 4 * 16 * 1536 * 1376 * 128 = 17.3 GFLOP; at the training shape (H
// 64, n 1280) 10 is 53.7, 11 and 12 80.5 and 13 107 GFLOP, against 42-126 MB
// of [H, n, 128] operands: tensor-core bound in bf16 (0.0175-0.1086 ms at
// 989 TFLOP/s), bound by the 67 TFLOP/s of fp32 outside the tensor cores in
// the fp32 FFMA forms (0.26-1.60 ms). The n x n scores stay out of device
// memory.
//
// bf16: A, 10 and 18 run on the TMA + wgmma attention core's D = 128 form
// (attn_wgmma.cuh, flash_prefix_core_d128.cu: d128::core), 13 on the
// attention backward core's D = 128 form (flash_prefix_bwd_core_d128.cu:
// d128::core_dkv, on attn_bwd_wgmma.cuh's pieces); 11 and 12 on the first
// port's mma.sync building blocks (flash_prefix.cuh), a block of 128 threads
// over 64 rows, each warp 16 of them, shared tiles [64][136] bf16 (17 KB
// each, four a block), as 13 did before the core:
//   A, 10, 18  flash_prefix_fwd_kernel<128, kLse, kRope>: q held as A
//              fragments, 64-key K/V tiles loaded synchronously, S and P.V
//              on mma.sync m16n8k16 with P re-packed in registers; kRope (18)
//              rotates q and the K tiles of the rotating heads in fp32 with
//              the bf16 tables as they land (ops/flash_prefix.py:
//              rope_reference). The designs the core replaced, served by no
//              path and kept for chip_smoke.py's timing
//              (f5_flash_prefix_d128_fwd_mma).
//   11, 12     flash_prefix_dq_d128_kernel<kOnline>: a block per (head, 64
//              queries), Q and dO resident in shared memory (their fragments
//              read per k step, which keeps the 16 x 128 fp32 dq accumulator
//              a warp in registers without spills), K/V tiles streamed, S and
//              dP by mma_abt_s, P = exp2(S * scale_log2 - lse), dS = P (dP -
//              D), dq += dS.K by mma_pb; kOnline (12) keeps a running max and
//              denominator instead of the lse, rescales dq on each max
//              update, divides by l at the end (dS is linear in P) and writes
//              the lse it ends with.
//   13         (kept for timing: f5_flash_prefix_d128_bwd_mma)
//              flash_prefix_dkv_d128_kernel: a block per (head, 64 keys), K
//              and V resident, 64-query tiles of Q, dO, lse and D streamed;
//              S^T and dP^T by mma_abt_s, dV += P^T.dO and dK += dS^T.Q by
//              mma_pb; every query row is walked (rows past n get lse +inf:
//              P = 0); a block whose first key is at or past kv_len writes
//              zeros. A block owns its key rows: no atomics.
// P and dS are rounded to bf16 for their products (the row sums use fp32
// P), as in the d = 64 forms.
//
// fp32 ("the exact f32 dot" of the TPU kernels on fp32 inputs): A, 10 and 18
// run on split 3xTF32 products on the tensor cores (flash_prefix_tf32_d128.cu:
// d128::tf32), and so do 11, 12 and 13 (flash_prefix_train_tf32_d128.cu:
// d128::tf32_dq, d128::tf32_dkv); the FFMA kernels of A, 10, 18 and 11-13 are
// kept, served by no path, for chip_smoke.py's timing of the 3xTF32 kernels
// (f5_flash_prefix_f32_d128_fwd_ffma, f5_flash_prefix_f32_d128_bwd_ffma).
// FFMA: a 256-thread block over 64 rows,
// thread (ty, tx) of a 16 x 16 grid owning rows 4 ty .. 4 ty + 3, score
// columns 4 tx .. and output columns 4 tx .. and 64 + 4 tx ..; the operands
// of the products over d transposed into [d][row] tiles (row stride 68
// floats) so the inner loops read float4; P, dS through shared memory
// between a product and the next:
//   A, 10, 18  (kept for timing) flash_prefix_f32_kernel<kLse, kRope>: q and
//              each K tile transposed, V row-major, the online softmax per
//              tile; kRope rotates in fp32 by the fp32 tables, each product
//              and the sum rounded once.
//   11, 12     (kept for timing) flash_prefix_dq_f32_d128_kernel<kOnline>: q and dO
//              transposed and resident, each key tile transposed (K, V) and
//              K row-major for dq += dS.K (185 KB of shared memory).
//   13         (kept for timing) flash_prefix_dkv_f32_d128_kernel: K, V transposed and
//              resident, each query tile transposed (Q, dO) and row-major for
//              dV += P^T.dO and dK += dS^T.Q, P^T and dS^T in turn through one
//              [64][68] tile (218 KB).
// One block an SM for 12 and 13; every sum is an fp32 FMA chain.
#include "attn_tf32.cuh"  // rotate_pair
#include "flash_prefix.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace {

constexpr int kD128 = 128;
constexpr int kLd128 = kD128 + 8;  // bf16 tile row stride
constexpr int kNd128 = kD128 / 8;  // n-tiles of a 16 x 128 accumulator

// ---------------------------------------------------------------------------
// bf16: dq (11, 12) and dk, dv (13) on mma.sync
// ---------------------------------------------------------------------------

template <bool kOnline>
__global__ void __launch_bounds__(kThreads)
flash_prefix_dq_d128_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ dvec, const float* __restrict__ lse_in,
                            const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                            float* __restrict__ lse_out, int n, float scale_log2,
                            float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + 64 * kLd128;
  bf16* sK = sO + 64 * kLd128;
  bf16* sV = sK + 64 * kLd128;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const size_t off = (size_t)head * n * kD128;
  const int kv_len = min(kv_lens[head], n);
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_rows<kD128>(sQ, q + off, q0, n, tid);
  load_rows<kD128>(sO, dout + off, q0, n, tid);
  float dr[2], lse[2], m_run[2], l_run[2], acc[kNd128][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    dr[h] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[h] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kNd128; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBKV;
    __syncthreads();  // the previous tile's readers (and the Q, dO stores) are done
    load_rows<kD128>(sK, k + off, k0, n, tid);
    load_rows<kD128>(sV, v + off, k0, n, tid);
    __syncthreads();
    float s[kNS][4], dp[kNS][4];
    mma_abt_s<kD128>(s, sQ, sK, warp, lane);
    mma_abt_s<kD128>(dp, sO, sV, warp, lane);
    // s[nt][e]: row row0 + 8 * (e >> 1), key k0 + 8 nt + 2t + (e & 1)
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = k0 + nt * 8 + 2 * t + (e & 1) < kv_len ? s[nt][e] * scale_log2 : -INFINITY;
    if (kOnline) {
      // tile 0 holds key 0 < kv_len: the running max is finite from then on
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNS; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        const float m_new = fmaxf(m_run[h], quad_max(mx));
        const float alpha = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
        lse[h] = m_new;  // P below is relative to the running max
        l_run[h] *= alpha;
#pragma unroll
        for (int i = 0; i < kNd128; ++i) {
          acc[i][2 * h] *= alpha;
          acc[i][2 * h + 1] *= alpha;
        }
      }
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - lse[e >> 1]);
        ps[e >> 1] += p;
        s[nt][e] = p * (dp[nt][e] - dr[e >> 1]);  // dS
      }
    if (kOnline) {
      l_run[0] += quad_sum(ps[0]);
      l_run[1] += quad_sum(ps[1]);
    }
    mma_pb<kD128>(acc, s, sK, lane);  // dq += dS.K
  }

  float scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    scale[h] = sm_scale;
    if (kOnline) {
      scale[h] = l_run[h] > 0.f ? sm_scale / l_run[h] : 0.f;
      if (t == 0 && row0 + 8 * h < n)
        lse_out[(size_t)head * n + row0 + 8 * h] =
            l_run[h] > 0.f ? m_run[h] + log2f(l_run[h]) : 0.f;
    }
  }
  store_output_rows<kNd128>(dq + off, kD128, acc, scale, row0, n, t);
}

// zero rows [r0, min(r0 + 64, n)) of two [n, 128] heads (a block whose keys
// are all past kv_len); elements of T, 16 bytes a store
template <typename T>
__device__ __forceinline__ void zero_rows(T* a, T* b, int r0, int n, int tid, int threads) {
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int i = tid; i < 64 * (kD128 / kPer); i += threads) {
    const int r = r0 + i / (kD128 / kPer), c = (i % (kD128 / kPer)) * kPer;
    if (r < n) {
      *reinterpret_cast<int4*>(a + (size_t)r * kD128 + c) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(b + (size_t)r * kD128 + c) = make_int4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_prefix_dkv_d128_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ dvec, const float* __restrict__ lse,
                             const int* __restrict__ kv_lens, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int n, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + 64 * kLd128;
  bf16* sQ = sV + 64 * kLd128;
  bf16* sO = sQ + 64 * kLd128;
  float* sL = reinterpret_cast<float*>(sO + 64 * kLd128);  // [64]
  float* sD = sL + 64;                                     // [64]
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const size_t off = (size_t)head * n * kD128;
  const int kv_len = min(kv_lens[head], n);
  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients
    zero_rows(dk + off, dv + off, k0, n, tid, kThreads);
    return;
  }
  load_rows<kD128>(sK, k + off, k0, n, tid);
  load_rows<kD128>(sV, v + off, k0, n, tid);
  const int row0 = k0 + warp * 16 + (lane >> 2);  // this lane's keys row0, row0 + 8
  const bool valid[2] = {row0 < kv_len, row0 + 8 < kv_len};
  float dka[kNd128][4], dva[kNd128][4];
#pragma unroll
  for (int i = 0; i < kNd128; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int qb = 0; qb < n; qb += 64) {
    __syncthreads();  // the previous tile's readers (and the K, V stores) are done
    load_rows<kD128>(sQ, q + off, qb, n, tid);
    load_rows<kD128>(sO, dout + off, qb, n, tid);
    if (tid < 64) {
      sL[tid] = qb + tid < n ? lse[(size_t)head * n + qb + tid] : INFINITY;
      sD[tid] = qb + tid < n ? dvec[(size_t)head * n + qb + tid] : 0.f;
    }
    __syncthreads();
    float s[kNS][4];
    mma_abt_s<kD128>(s, sK, sQ, warp, lane);  // S^T: key rows, query columns
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = valid[e >> 1] ? exp2f(s[nt][e] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
    }
    mma_pb<kD128>(dva, s, sO, lane);  // dV += P^T.dO
    float dp[kNS][4];
    mma_abt_s<kD128>(dp, sV, sO, warp, lane);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kNS; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? d2.y : d2.x));
    }
    mma_pb<kD128>(dka, dp, sQ, lane);  // dK += dS^T.Q
  }
  const float sc[2] = {sm_scale, sm_scale}, one[2] = {1.f, 1.f};
  store_output_rows<kNd128>(dk + off, kD128, dka, sc, row0, n, t);
  store_output_rows<kNd128>(dv + off, kD128, dva, one, row0, n, t);
}

// ---------------------------------------------------------------------------
// fp32: FFMA
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32LD = 64 + 4;  // row stride of the [c][row] and [row][key] tiles

// rows [row0, row0 + 64) of a [n, 128] head, transposed into dst[c][row];
// rows at or past n give zeros. Consecutive threads take consecutive rows:
// the shared-memory stores are conflict-free.
__device__ __forceinline__ void load_rows_t_f32(float* dst, const float* src, int row0, int n,
                                                int tid) {
  for (int i = tid; i < 64 * (kD128 / 4); i += kF32Threads) {
    const int r = i & 63;
    const int c = (i >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD128 + c);
    dst[(c + 0) * kF32LD + r] = v.x;
    dst[(c + 1) * kF32LD + r] = v.y;
    dst[(c + 2) * kF32LD + r] = v.z;
    dst[(c + 3) * kF32LD + r] = v.w;
  }
}

// the same, rotated on the way by the fp32 tables cos, sin [n, 64] (columns
// c and c + 64 are a pair), each product and the sum rounded once
__device__ __forceinline__ void load_rows_t_f32_rope(float* dst, const float* src, int row0,
                                                     int n, const float* __restrict__ cos,
                                                     const float* __restrict__ sin, int tid) {
  for (int i = tid; i < 64 * (kD128 / 8); i += kF32Threads) {
    const int r = i & 63;
    const int c = (i >> 6) * 4;  // 0 .. 60; the partner is at c + 64
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < n) {
      const float* p = src + (size_t)(row0 + r) * kD128 + c;
      a = *reinterpret_cast<const float4*>(p);
      b = *reinterpret_cast<const float4*>(p + 64);
      const float4 cs = *reinterpret_cast<const float4*>(cos + (size_t)(row0 + r) * 64 + c);
      const float4 sn = *reinterpret_cast<const float4*>(sin + (size_t)(row0 + r) * 64 + c);
      rotate_pair(a.x, b.x, cs.x, sn.x);
      rotate_pair(a.y, b.y, cs.y, sn.y);
      rotate_pair(a.z, b.z, cs.z, sn.z);
      rotate_pair(a.w, b.w, cs.w, sn.w);
    }
    dst[(c + 0) * kF32LD + r] = a.x;
    dst[(c + 1) * kF32LD + r] = a.y;
    dst[(c + 2) * kF32LD + r] = a.z;
    dst[(c + 3) * kF32LD + r] = a.w;
    dst[(c + 64) * kF32LD + r] = b.x;
    dst[(c + 65) * kF32LD + r] = b.y;
    dst[(c + 66) * kF32LD + r] = b.z;
    dst[(c + 67) * kF32LD + r] = b.w;
  }
}

// rows [row0, row0 + 64) of a [n, 128] head into a row-major [64][128]
// tile; rows at or past n give zeros
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0, int n,
                                              int tid) {
  for (int i = tid; i < 64 * (kD128 / 4); i += kF32Threads) {
    const int r = i / (kD128 / 4);
    const int c = (i % (kD128 / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD128 + c);
    *reinterpret_cast<float4*>(dst + r * kD128 + c) = val;
  }
}

// sum / max over the 16 lanes that share a row
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

// s[i][j] += sum_c a[c][4 ty + i] * b[c][4 tx + j] over the 128 columns of
// two transposed tiles
__device__ __forceinline__ void ffma_abt(float (&s)[4][4], const float* at, const float* bt, int ty,
                                         int tx) {
#pragma unroll 8
  for (int c = 0; c < kD128; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(at + c * kF32LD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + c * kF32LD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][gg * 4 + j] += sum_key p[4 ty + i][key] * b[key][gg * 64 + 4 tx + j]
// for a [64][68] tile p and a row-major [64][128] tile b
__device__ __forceinline__ void ffma_pb(float (&acc)[4][8], const float* p, const float* b, int ty,
                                        int tx) {
#pragma unroll 8
  for (int key = 0; key < 64; ++key) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * kF32LD + key];
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const float4 bb = *reinterpret_cast<const float4*>(b + key * kD128 + gg * 64 + tx * 4);
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][gg * 4 + j] = fmaf(pv[i], bv[j], acc[i][gg * 4 + j]);
    }
  }
}

__device__ __forceinline__ void store_p(float* p, const float (&s)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(p + (ty * 4 + i) * kF32LD + tx * 4) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// the rows of acc (scaled by scale[i]) into a [n, 128] head; rows at or past n
// are not stored
__device__ __forceinline__ void store_rows_f32(float* dst, const float (&acc)[4][8],
                                               const float (&scale)[4], int row0, int n, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= n) continue;
#pragma unroll
    for (int gg = 0; gg < 2; ++gg)
      *reinterpret_cast<float4*>(dst + (size_t)row * kD128 + gg * 64 + tx * 4) =
          make_float4(acc[i][gg * 4] * scale[i], acc[i][gg * 4 + 1] * scale[i],
                      acc[i][gg * 4 + 2] * scale[i], acc[i][gg * 4 + 3] * scale[i]);
  }
}

__device__ __forceinline__ void zero48(float (&a)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) a[i][c] = 0.f;
}

// A, 10 (kLse) and 18 (kRope) in fp32: one block per (folded head, 64
// queries)
template <bool kLse, bool kRope>
__global__ void __launch_bounds__(kF32Threads)
flash_prefix_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ kv_lens,
                        float* __restrict__ out, float* __restrict__ lse, int n, float scale_log2,
                        RopeHeads rh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [128][68]
  float* sKt = sQt + kD128 * kF32LD;                // [128][68]
  float* sV = sKt + kD128 * kF32LD;                 // [64][128]
  float* sP = sV + 64 * kD128;                      // [64][68]
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.y;
  const int item = kRope ? head / rh.heads : head;
  const bool rot = kRope && head - item * rh.heads < rh.n_rope;  // block-uniform
  const float* cos = static_cast<const float*>(rh.cos);
  const float* sin = static_cast<const float*>(rh.sin);
  const size_t off = (size_t)head * n * kD128;
  const int kv_len = min(kv_lens[item], n);

  if (rot)
    load_rows_t_f32_rope(sQt, q + off, q0, n, cos, sin, tid);
  else
    load_rows_t_f32(sQt, q + off, q0, n, tid);
  float o[4][8], m_run[4], l_run[4];
  zero48(o);
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
      load_rows_t_f32_rope(sKt, k + off, k0, n, cos, sin, tid);
    else
      load_rows_t_f32(sKt, k + off, k0, n, tid);
    load_rows_f32(sV, v + off, k0, n, tid);
    __syncthreads();

    float s[4][4] = {};
    ffma_abt(s, sQt, sKt, ty, tx);
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
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    store_p(sP, s, ty, tx);
    __syncthreads();
    ffma_pb(o, sP, sV, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;  // kv_len == 0: zeros
    const int row = q0 + ty * 4 + i;
    // m_run is in the base-2 domain of the scaled scores, l_run the whole row's sum
    if (kLse && tx == 0 && row < n)
      lse[(size_t)head * n + row] = l_run[i] > 0.f ? m_run[i] + log2f(l_run[i]) : 0.f;
  }
  store_rows_f32(out + off, o, inv, q0 + ty * 4, n, tx);
}

// dq for one (head, 64-query block) in fp32; kOnline: kernel 12 (lse
// recomputed and written to lse_out), otherwise kernel 11 (lse_in given)
template <bool kOnline>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_prefix_dq_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ dvec, const float* __restrict__ lse_in,
                                const int* __restrict__ kv_lens, float* __restrict__ dq,
                                float* __restrict__ lse_out, int n, float scale_log2,
                                float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [128][68] each
  float* sOt = sQt + kD128 * kF32LD;
  float* sKt = sOt + kD128 * kF32LD;
  float* sVt = sKt + kD128 * kF32LD;
  float* sK = sVt + kD128 * kF32LD;  // [64][128]
  float* sS = sK + 64 * kD128;       // [64][68]
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)head * n * kD128;
  const int kv_len = min(kv_lens[head], n);

  load_rows_t_f32(sQt, q + off, q0, n, tid);
  load_rows_t_f32(sOt, dout + off, q0, n, tid);
  float dr[4], lse[4], m_run[4], l_run[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    dr[i] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[i] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  zero48(acc);

  const int n_tiles = kv_len > 0 ? (kv_len + 63) / 64 : 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * 64;
    __syncthreads();  // the previous tile's readers (and the q, dO stores) are done
    load_rows_t_f32(sKt, k + off, k0, n, tid);
    load_rows_t_f32(sVt, v + off, k0, n, tid);
    load_rows_f32(sK, k + off, k0, n, tid);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    ffma_abt(s, sQt, sKt, ty, tx);
    ffma_abt(dp, sOt, sVt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = k0 + tx * 4 + j < kv_len ? s[i][j] * scale_log2 : -INFINITY;
      if (kOnline) {
        // tile 0 holds key 0 < kv_len: the running max is finite from then on
        const float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
        const float m_new = fmaxf(m_run[i], row16_max(mx));
        const float alpha = exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
        lse[i] = m_new;  // P below is relative to the running max
        l_run[i] *= alpha;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      }
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - lse[i]);
        ps += p;
        s[i][j] = p * (dp[i][j] - dr[i]);  // dS
      }
      if (kOnline) l_run[i] += row16_sum(ps);
    }
    store_p(sS, s, ty, tx);
    __syncthreads();
    ffma_pb(acc, sS, sK, ty, tx);  // dq += dS.K
  }

  float scale[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    scale[i] = sm_scale;
    const int row = q0 + ty * 4 + i;
    if (kOnline) {
      scale[i] = l_run[i] > 0.f ? sm_scale / l_run[i] : 0.f;
      if (tx == 0 && row < n)
        lse_out[(size_t)head * n + row] = l_run[i] > 0.f ? m_run[i] + log2f(l_run[i]) : 0.f;
    }
  }
  store_rows_f32(dq + off, acc, scale, q0 + ty * 4, n, tx);
}

// dk and dv for one (head, 64-key block) in fp32
__global__ void __launch_bounds__(kF32Threads, 1)
flash_prefix_dkv_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ dvec, const float* __restrict__ lse,
                                 const int* __restrict__ kv_lens, float* __restrict__ dk,
                                 float* __restrict__ dv, int n, float scale_log2,
                                 float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sKt = reinterpret_cast<float*>(smem_raw);  // [128][68] each
  float* sVt = sKt + kD128 * kF32LD;
  float* sQt = sVt + kD128 * kF32LD;
  float* sOt = sQt + kD128 * kF32LD;
  float* sQ = sOt + kD128 * kF32LD;  // [64][128] each
  float* sO = sQ + 64 * kD128;
  float* sP = sO + 64 * kD128;  // [64][68]: P^T, then dS^T
  float* sL = sP + 64 * kF32LD;  // [64]
  float* sD = sL + 64;           // [64]
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)head * n * kD128;
  const int kv_len = min(kv_lens[head], n);
  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients
    zero_rows(dk + off, dv + off, k0, n, tid, kF32Threads);
    return;
  }
  load_rows_t_f32(sKt, k + off, k0, n, tid);
  load_rows_t_f32(sVt, v + off, k0, n, tid);
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) valid[i] = k0 + ty * 4 + i < kv_len;
  float dka[4][8], dva[4][8];
  zero48(dka);
  zero48(dva);

  for (int qb = 0; qb < n; qb += 64) {
    __syncthreads();  // the previous tile's readers (and the K, V stores) are done
    load_rows_t_f32(sQt, q + off, qb, n, tid);
    load_rows_t_f32(sOt, dout + off, qb, n, tid);
    load_rows_f32(sQ, q + off, qb, n, tid);
    load_rows_f32(sO, dout + off, qb, n, tid);
    if (tid < 64) {
      sL[tid] = qb + tid < n ? lse[(size_t)head * n + qb + tid] : INFINITY;
      sD[tid] = qb + tid < n ? dvec[(size_t)head * n + qb + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    ffma_abt(s, sKt, sQt, ty, tx);   // S^T: key rows, query columns
    ffma_abt(dp, sVt, sOt, ty, tx);  // dP^T
    const float4 l4 = *reinterpret_cast<const float4*>(sL + tx * 4);
    const float4 d4 = *reinterpret_cast<const float4*>(sD + tx * 4);
    const float lv[4] = {l4.x, l4.y, l4.z, l4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i] ? exp2f(s[i][j] * scale_log2 - lv[j]) : 0.f;
        s[i][j] = p;                        // P^T
        dp[i][j] = p * (dp[i][j] - dd[j]);  // dS^T
      }
    store_p(sP, s, ty, tx);
    __syncthreads();
    ffma_pb(dva, sP, sO, ty, tx);  // dV += P^T.dO
    __syncthreads();
    store_p(sP, dp, ty, tx);
    __syncthreads();
    ffma_pb(dka, sP, sQ, ty, tx);  // dK += dS^T.q
  }
  const float sc[4] = {sm_scale, sm_scale, sm_scale, sm_scale}, one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows_f32(dk + off, dka, sc, k0 + ty * 4, n, tx);
  store_rows_f32(dv + off, dva, one, k0 + ty * 4, n, tx);
}

constexpr int kF32FwdSmem = (2 * kD128 * kF32LD + 64 * kD128 + 64 * kF32LD) * (int)sizeof(float);
constexpr int kF32DqSmem = (4 * kD128 * kF32LD + 64 * kD128 + 64 * kF32LD) * (int)sizeof(float);
constexpr int kF32DkvSmem =
    (4 * kD128 * kF32LD + 2 * 64 * kD128 + 64 * kF32LD + 2 * 64) * (int)sizeof(float);
constexpr int kDqSmem = 4 * 64 * kLd128 * (int)sizeof(bf16);
constexpr int kDkvSmem = 4 * 64 * kLd128 * (int)sizeof(bf16) + 2 * 64 * (int)sizeof(float);
static_assert(kF32DkvSmem <= 232448, "kernel 13's fp32 tiles must fit a block");

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kLse, bool kRope>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, const void* kv_lens,
                           void* out, void* lse, int H, int n, float scale_log2,
                           RopeHeads rh, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_prefix_f32_kernel<kLse, kRope>, kF32FwdSmem);
  if (err != cudaSuccess) return err;
  flash_prefix_f32_kernel<kLse, kRope><<<dim3((n + 63) / 64, H), kF32Threads, kF32FwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), static_cast<float*>(lse), n,
      scale_log2, rh);
  return cudaGetLastError();
}

template <bool kOnline>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                      void* lse_out, int H, int n, float scale_log2, float sm_scale, bool f32,
                      cudaStream_t stream) {
  const dim3 grid((n + 63) / 64, H);
  cudaError_t err;
  if (f32) {
    err = set_smem(flash_prefix_dq_f32_d128_kernel<kOnline>, kF32DqSmem);
    if (err != cudaSuccess) return err;
    flash_prefix_dq_f32_d128_kernel<kOnline><<<grid, kF32Threads, kF32DqSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(dvec),
        static_cast<const float*>(lse_in), static_cast<const int*>(kv_lens),
        static_cast<float*>(dq), static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  } else {
    err = set_smem(flash_prefix_dq_d128_kernel<kOnline>, kDqSmem);
    if (err != cudaSuccess) return err;
    flash_prefix_dq_d128_kernel<kOnline><<<grid, kThreads, kDqSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(dvec),
        static_cast<const float*>(lse_in), static_cast<const int*>(kv_lens),
        static_cast<bf16*>(dq), static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  }
  return cudaGetLastError();
}

}  // namespace

namespace d128 {

cudaError_t fwd(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                void* lse, int H, int n, float scale_log2, bool f32, cudaStream_t stream) {
  const RopeHeads none{1, 0, nullptr, nullptr};
  if (f32)
    return lse ? launch_fwd_f32<true, false>(q, k, v, kv_lens, out, lse, H, n, scale_log2, none,
                                             stream)
               : launch_fwd_f32<false, false>(q, k, v, kv_lens, out, nullptr, H, n, scale_log2,
                                              none, stream);
  return lse ? launch_fwd<kD128, true>(q, k, v, kv_lens, out, H, n, scale_log2, stream, lse)
             : launch_fwd<kD128>(q, k, v, kv_lens, out, H, n, scale_log2, stream);
}

cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
               const void* lse_in, const void* kv_lens, void* dq, void* lse_out, int H, int n,
               float scale_log2, float sm_scale, bool online, bool f32, cudaStream_t stream) {
  return online ? launch_dq<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                  scale_log2, sm_scale, f32, stream)
                : launch_dq<false>(q, k, v, dout, dvec, lse_in, kv_lens, dq, nullptr, H, n,
                                   scale_log2, sm_scale, f32, stream);
}

cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
                const void* lse, const void* kv_lens, void* dk, void* dv, int H, int n,
                float scale_log2, float sm_scale, bool f32, cudaStream_t stream) {
  const dim3 grid((n + 63) / 64, H);
  cudaError_t err;
  if (f32) {
    err = set_smem(flash_prefix_dkv_f32_d128_kernel, kF32DkvSmem);
    if (err != cudaSuccess) return err;
    flash_prefix_dkv_f32_d128_kernel<<<grid, kF32Threads, kF32DkvSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(dvec),
        static_cast<const float*>(lse), static_cast<const int*>(kv_lens),
        static_cast<float*>(dk), static_cast<float*>(dv), n, scale_log2, sm_scale);
  } else {
    err = set_smem(flash_prefix_dkv_d128_kernel, kDkvSmem);
    if (err != cudaSuccess) return err;
    flash_prefix_dkv_d128_kernel<<<grid, kThreads, kDkvSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(dvec),
        static_cast<const float*>(lse), static_cast<const int*>(kv_lens),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale_log2, sm_scale);
  }
  return cudaGetLastError();
}

cudaError_t rope_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                     const void* cos, const void* sin, void* out, int B, int heads, int n,
                     int n_rope, float scale_log2, bool f32, cudaStream_t stream) {
  const RopeHeads rh{heads, n_rope, cos, sin};
  if (f32)
    return launch_fwd_f32<false, true>(q, k, v, kv_lens, out, nullptr, B * heads, n, scale_log2,
                                       rh, stream);
  return launch_fwd<kD128, false, true>(q, k, v, kv_lens, out, B * heads, n, scale_log2, stream,
                                        nullptr, rh);
}

}  // namespace d128
}  // namespace f5

namespace {

bool d128_dims_ok(int B, int heads, int n) {
  return B > 0 && heads > 0 && n > 0 && (long long)B * heads <= 65535;
}

// kernels A (cos == nullptr: B folded heads of one head each, kv_lens [B]),
// 10 (cos == nullptr, lse [B, n] fp32 written) and 18 (lse == nullptr) at d =
// 128 on the designs that no path runs any more: bf16 on the mma.sync loop,
// fp32 on FFMA
int kept_fwd(const void* q, const void* k, const void* v, const void* kv_lens, const void* cos,
             const void* sin, void* out, void* lse, int B, int heads, int n, int n_rope,
             float scale_log2, bool f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!d128_dims_ok(B, heads, n) || (cos != nullptr && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cos == nullptr)
    return (int)f5::d128::fwd(q, k, v, kv_lens, out, lse, B * heads, n, scale_log2, f32, s);
  return (int)f5::d128::rope_fwd(q, k, v, kv_lens, cos, sin, out, B, heads, n, n_rope,
                                 scale_log2, f32, s);
}

// kernels 11 (form 11: lse read, out0 = dq), 12 (form 12: out0 = dq, out1 =
// the lse written) and 13 (form 13: lse read, out0 = dk, out1 = dv) at d =
// 128 on the mma.sync kernels (bf16) or the FFMA kernels (fp32)
int kept_bwd(const void* q, const void* k, const void* v, const void* dout, const void* dvec,
             const void* lse, const void* kv_lens, void* out0, void* out1, int H, int n, int form,
             float scale_log2, float sm_scale, bool f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || (form != 11 && form != 12 && form != 13))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 13)
    return (int)f5::d128::dkv(q, k, v, dout, dvec, lse, kv_lens, out0, out1, H, n, scale_log2,
                              sm_scale, f32, s);
  return (int)f5::d128::dq(q, k, v, dout, dvec, form == 11 ? lse : nullptr, kv_lens, out0,
                           form == 12 ? out1 : nullptr, H, n, scale_log2, sm_scale, form == 12,
                           f32, s);
}

}  // namespace

// kernel 18 at d = 128: q, k, v, out [B, heads, n, 128] contiguous, bf16 (f32
// == 0) or fp32, q and k before the rotation; kv_lens [B] int32; cos, sin
// [n, 64] of the operands' dtype; heads g < n_rope rotate. bf16 runs on the
// attention core (flash_prefix_core_d128.cu), fp32 on split 3xTF32
// (flash_prefix_tf32_d128.cu).
extern "C" int f5_flash_prefix_rope_d128_fwd(const void* q, const void* k, const void* v,
                                             const void* kv_lens, const void* cos,
                                             const void* sin, void* out, int B, int heads, int n,
                                             int n_rope, float scale_log2, int f32, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!d128_dims_ok(B, heads, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)f5::d128::tf32(q, k, v, kv_lens, cos, sin, out, nullptr, B * heads, heads, n,
                               n_rope, scale_log2, s);
  return (int)f5::d128::core(q, k, v, kv_lens, cos, sin, out, nullptr, B * heads, heads, n,
                             n_rope, scale_log2, s);
}

// kernels A, 10 and 18 at d = 128 in bf16 on the mma.sync loop that the
// attention core replaced (kept_fwd; chip_smoke.py times the designs against
// each other, no path calls it)
extern "C" int f5_flash_prefix_d128_fwd_mma(const void* q, const void* k, const void* v,
                                            const void* kv_lens, const void* cos,
                                            const void* sin, void* out, void* lse, int B,
                                            int heads, int n, int n_rope, float scale_log2,
                                            int device, void* stream) {
  return kept_fwd(q, k, v, kv_lens, cos, sin, out, lse, B, heads, n, n_rope, scale_log2, false,
                  device, stream);
}

// kernels A, 10 (lse written) and 18 at d = 128 in fp32 on the FFMA kernel
// that the split 3xTF32 kernel replaced (kept_fwd; cos, sin [n, 64] fp32)
extern "C" int f5_flash_prefix_f32_d128_fwd_ffma(const void* q, const void* k, const void* v,
                                                 const void* kv_lens, const void* cos,
                                                 const void* sin, void* out, void* lse, int B,
                                                 int heads, int n, int n_rope, float scale_log2,
                                                 int device, void* stream) {
  return kept_fwd(q, k, v, kv_lens, cos, sin, out, lse, B, heads, n, n_rope, scale_log2, true,
                  device, stream);
}

// kernel 13 at d = 128 in bf16 (form 13) on the mma.sync kernel that the
// attention backward core replaced (chip_smoke.py times the designs against
// each other, no path calls it); forms 11 and 12 run the mma.sync kernel
// that f5_flash_prefix_dq_lsein and f5_flash_prefix_dq take at d = 128 in
// bf16. Arguments as f5_flash_prefix_f32_d128_bwd_ffma's.
extern "C" int f5_flash_prefix_d128_bwd_mma(const void* q, const void* k, const void* v,
                                            const void* dout, const void* dvec, const void* lse,
                                            const void* kv_lens, void* out0, void* out1, int H,
                                            int n, int form, float scale_log2, float sm_scale,
                                            int device, void* stream) {
  return kept_bwd(q, k, v, dout, dvec, lse, kv_lens, out0, out1, H, n, form, scale_log2,
                  sm_scale, false, device, stream);
}

// kernels 11 (form 11: lse read, out0 = dq), 12 (form 12: out0 = dq, out1 =
// the lse written) and 13 (form 13: lse read, out0 = dk, out1 = dv) at d =
// 128 in fp32 on the FFMA kernels that the split 3xTF32 kernels replaced
// (chip_smoke.py times the designs against each other, no path calls it)
extern "C" int f5_flash_prefix_f32_d128_bwd_ffma(const void* q, const void* k, const void* v,
                                                 const void* dout, const void* dvec,
                                                 const void* lse, const void* kv_lens, void* out0,
                                                 void* out1, int H, int n, int form,
                                                 float scale_log2, float sm_scale, int device,
                                                 void* stream) {
  return kept_bwd(q, k, v, dout, dvec, lse, kv_lens, out0, out1, H, n, form, scale_log2,
                  sm_scale, true, device, stream);
}

// Kernels 11, 12 (dq) and 13 (dk, dv) at head dim 128 on fp32 operands, for
// Hopper (sm_90a): split 3xTF32 products on the tensor cores.
//
// Replaces, on fp32 inputs at d = 128, the TPU kernels of
// korean_f5_tts_tpu/ops/flash_prefix.py:
//   11  _flash_prefix_dq_lsein -> _kernel_dq_lsein (dq from the forward's lse)
//   12  _flash_prefix_dq       -> _kernel_dq       (dq, recomputing the lse)
//   13  _flash_prefix_dkv      -> _kernel_dkv      (dk and dv)
// which the JAX dispatch takes at d in (64, 128) (ops/attention.py:260,
// :296) and which keep "the exact f32 dot" on fp32 inputs. The functions are
// those of the d = 64 fp32 forms (flash_prefix_train_f32.cu): folded heads
// q, k, v, dO, dq, dk, dv [H, n, 128] fp32, kv_lens [H] int32, lse and D =
// rowsum(dO * o) [H, n] fp32, lse in base 2 of the scores pre-scaled by
// scale_log2 = log2(e) / sqrt(128); rows past n are zero-filled and never
// stored; keys past kv_len get P = 0; a head with kv_len 0 gives zero
// gradients and, for 12, lse 0. Entry points: f5_flash_prefix_f32_dq_lsein,
// f5_flash_prefix_f32_dq and f5_flash_prefix_f32_dkv at d = 128
// (flash_prefix_train_f32.cu), through d128::tf32_dq and d128::tf32_dkv.
// f5_flash_prefix_f32_d128_bwd_ffma (flash_prefix_d128.cu) runs the FFMA
// kernels these replaced, for timing.
//
// What bounds them: at the training shape (64 folded heads, n 1280, every
// key valid) 11 and 12 are 6 * 64 * 1280^2 * 128 = 80.5 GFLOP and 13 107
// GFLOP of fp32-accurate products: 0.488 and 0.651 ms at the tensor cores'
// TF32 rate taken three times (494.7 / 3 TFLOP/s), against 1.20 and 1.60
// ms in FFMA at the 67 TFLOP/s of fp32 outside them, the bound of the
// kernels these replace. The n x n scores stay out of device memory.
//
// Design: the d = 64 forms' split 3xTF32 products (x = hi + lo by cvt.rna,
// a.b ~ hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 .tf32, mma.cuh) on the d =
// 128 forward's tiles (tf32_d128.cuh: 128 columns at a stride of 132 words,
// rows loaded a tile ahead into registers and split as they are stored).
// The d = 64 layouts do not fit at D = 128: q and dO split at 128 rows alone
// would take 270,336 bytes, over the 232,448 a block may have, and 13's dK
// and dV at 16 rows x 128 columns a warp would be 128 accumulator registers
// a thread. Accumulators chain over the whole sweep, as at d = 64 (the
// tensor cores' fp32 accumulation truncates, probe_hopper.cu; that bias
// reads ~1e-5 against the plain versions, bound 1e-4).
//   dq (11, 12)  a block per (head, 128 queries), 256 threads, eight warps
//                of 16 queries; q and dO stored unsplit [128][132] for the
//                whole sweep, each warp splitting the A fragments of its own
//                rows as it reads them (no warp reads another's, so nothing
//                is split twice); 32-key K and V tiles split hi and lo. S =
//                q.K^T and dP = dO.V^T are 16 x 32 a warp, masked at kv_len
//                and scaled; P = exp2(S - lse), dS = P (dP - D) in
//                registers; dq += dS.K with dS split in registers as the A
//                fragment (t128_pv's pattern, columns 0 and 64). The sweep
//                stops at ceil(kv_len / 32) tiles. kOnline (12) keeps the
//                running max and denominator per row instead of the lse,
//                rescales dq on each max update, divides by l at the end and
//                writes the lse it ends with. 202,752 bytes: one block an SM.
//   dk, dv (13)  a block per (head, 64 keys); K and V split and resident
//                ([64][132] x 4); each 32-query tile of q and dO split in
//                with its lse and D (a query at or past n gets lse +inf: P
//                = 0). Warp w owns keys 16 (w & 3) and the 64-column half w
//                >> 2 of dK and dV (2 x 16 x 64 accumulators, 64 floats a
//                thread). The two warps of a key group split the first
//                products between them by product: w >> 2 == 0 computes S^T
//                = K.q^T and P^T, the other dP^T = V.dO^T, each 16 keys x 32
//                queries over the 128 columns (their A fragments read once
//                for 32 queries, not twice for 16); each writes its tile to
//                an exchange tile [64][40] of its own, meets its partner at
//                a named barrier of 64 threads, reads the partner's, forms
//                dS^T = P^T (dP^T - D) and takes P^T and dS^T as the A
//                fragments of dV += P^T.dO[:, half] and dK += dS^T.q[:,
//                half]. A block whose first key is at or past kv_len writes
//                zeros; a block owns its key rows (no atomics, the result
//                does not depend on block order); dk is scaled by sm_scale
//                at the store. 223,488 bytes: one block an SM.
// A trial of 13 with the pair split by queries instead (each warp S^T and
// dP^T of 16 keys x 16 queries, both tiles through the exchange) took 2.5675
// and 2.5391 ms at the training shape against 2.1292 and 2.0847 for the kept
// split by product, under one timer (NVIDIA H100 80GB HBM3, 700.00 W), and
// spilled 92 bytes; it is not kept. Registers (ptxas): dq 208-210, dk, dv
// 212, no spill.
#include <atomic>

#include "gemm_bf16.cuh"   // allow_smem, kMaxDevices
#include "flash_prefix_d128.cuh"
#include "tf32_d128.cuh"   // t128_qk, t128_pv, t128_load, t128_split

namespace f5 {
namespace {

constexpr int kQRows = 128;  // queries a dq block
constexpr int kQKeys = 32;   // keys a dq tile
constexpr int kKRows = 64;   // keys a dkv block
constexpr int kKQ = 32;      // queries a dkv tile
constexpr int kXLd = 40;     // row stride of the exchange tiles (8 mod 32: float2 conflict-free)
// q and dO unsplit, a K and a V tile as hi and lo
constexpr int kDqSmem = (2 * kQRows + 4 * kQKeys) * kTLd * (int)sizeof(uint32_t);
// K, V and a q and a dO tile as hi and lo, the tile's lse and D, two exchange tiles
constexpr int kDkvSmem =
    ((4 * kKRows + 4 * kKQ) * kTLd + 2 * kKQ + 2 * kKRows * kXLd) * (int)sizeof(uint32_t);
static_assert(kDqSmem == 202752 && kDqSmem <= kTSmemMax, "the dq tiles do not fit a block");
static_assert(kDkvSmem == 223488 && kDkvSmem <= kTSmemMax, "the dkv tiles do not fit a block");

// rows [row0, row0 + 128) of a [n, 128] head stored unsplit into a [128][132]
// tile (rows at or past n zero); a warp stores one row's 512 contiguous bytes
__device__ __forceinline__ void t128_store_rows(uint32_t* dst, const float* src, int row0, int n,
                                                int tid) {
#pragma unroll 4
  for (int i = tid; i < kQRows * (kTD / 4); i += kTThreads) {
    const int row = row0 + (i >> 5), c = (i & 31) * 4;
    const float4 x = row < n ? *reinterpret_cast<const float4*>(src + (size_t)row * kTD + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + (i >> 5) * kTLd + c) = x;
  }
}

// the 64 threads of warps w and w + 4 (a key group of kernel 13)
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// warp w owns queries q0 + 16w .. + 15; lane (g, t) holds rows 16w + g and
// 16w + g + 8, columns 8j + 2t, 8j + 2t + 1 of S, dP and dq (dq in two
// 64-column halves)
template <bool kOnline>
__global__ void __launch_bounds__(kTThreads, 1)
flash_prefix_dq_tf32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ dvec, const float* __restrict__ lse_in,
                                 const int* __restrict__ kv_lens, float* __restrict__ dq,
                                 float* __restrict__ lse_out, int n, float scale_log2,
                                 float sm_scale) {
  constexpr int NT = kQKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem_raw);  // [128][132] unsplit each
  uint32_t* sO = sQ + kQRows * kTLd;
  uint32_t* sKh = sO + kQRows * kTLd;  // [32][132] each
  uint32_t* sKl = sKh + kQKeys * kTLd;
  uint32_t* sVh = sKl + kQKeys * kTLd;
  uint32_t* sVl = sVh + kQKeys * kTLd;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t off = (size_t)head * n * kTD;
  const int kv_len = min(kv_lens[head], n);
  const int n_tiles = kv_len > 0 ? (kv_len + kQKeys - 1) / kQKeys : 0;

  t128_store_rows(sQ, q + off, q0, n, tid);
  t128_store_rows(sO, dout + off, q0, n, tid);
  float dr[2], lse[2], m_run[2], l_run[2], acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    dr[h] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[h] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
    m_run[h] = -INFINITY;
    l_run[h] = 0.f;
  }
  zero84(acc[0]);
  zero84(acc[1]);

  Rows128<kQKeys, false> kr, vr;
  if (n_tiles > 0) {
    t128_load(kr, k + off, 0, n, tid, false, nullptr, nullptr);
    t128_load(vr, v + off, 0, n, tid, false, nullptr, nullptr);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kQKeys;
    __syncthreads();  // the previous tile's readers (and the q, dO stores) are done
    t128_split(sKh, sKl, kr, tid, false);
    t128_split(sVh, sVl, vr, tid, false);
    __syncthreads();
    if (jt + 1 < n_tiles) {  // the next tile's rows load while this one's products run
      t128_load(kr, k + off, k0 + kQKeys, n, tid, false, nullptr, nullptr);
      t128_load(vr, v + off, k0 + kQKeys, n, tid, false, nullptr, nullptr);
    }
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    t128_qk<NT, true>(s, sQ, nullptr, sKh, sKl, wr, lane);
    t128_qk<NT, true>(dp, sO, nullptr, sVh, sVl, wr, lane);
    // s[j][e]: row wr + g + 8 (e >> 1), key k0 + 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kv_len ? s[j][e] * scale_log2 : -INFINITY;
    if (kOnline) {
      // tile 0 holds key 0 < kv_len: the running max is finite from then on
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float m_new = fmaxf(m_run[h], quad_max(mx));
        const float alpha = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
        lse[h] = m_new;  // P below is relative to the running max
        l_run[h] *= alpha;
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[half][j][2 * h] *= alpha;
            acc[half][j][2 * h + 1] *= alpha;
          }
      }
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
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
    t128_pv<NT>(acc[0], s, sKh, sKl, 0, lane);  // dq += dS.K, columns 0-63
    t128_pv<NT>(acc[1], s, sKh, sKl, 64, lane);  // and 64-127
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
    float* dst = dq + off + (size_t)row * kTD + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
        *reinterpret_cast<float2*>(dst + 64 * half + nd * 8) =
            make_float2(acc[half][nd][2 * h] * scale, acc[half][nd][2 * h + 1] * scale);
  }
}

// dk and dv for one (head, 64-key block). Warp w: key group kg = w & 3
// (keys 16 kg .. 16 kg + 15 of the block), role / column half hf = w >> 2;
// lane (g, t) holds keys 16 kg + g and + 8, queries 8j + 2t, 8j + 2t + 1 of
// S^T / dP^T and columns 64 hf + 8 nd + 2t, + 1 of dK and dV.
__global__ void __launch_bounds__(kTThreads, 1)
flash_prefix_dkv_tf32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ dvec, const float* __restrict__ lse,
                                  const int* __restrict__ kv_lens, float* __restrict__ dk,
                                  float* __restrict__ dv, int n, float scale_log2,
                                  float sm_scale) {
  constexpr int NT = kKQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sKh = reinterpret_cast<uint32_t*>(smem_raw);  // [64][132] each
  uint32_t* sKl = sKh + kKRows * kTLd;
  uint32_t* sVh = sKl + kKRows * kTLd;
  uint32_t* sVl = sVh + kKRows * kTLd;
  uint32_t* sQh = sVl + kKRows * kTLd;  // [32][132] each
  uint32_t* sQl = sQh + kKQ * kTLd;
  uint32_t* sOh = sQl + kKQ * kTLd;
  uint32_t* sOl = sOh + kKQ * kTLd;
  float* sLse = reinterpret_cast<float*>(sOl + kKQ * kTLd);  // [32]
  float* sD = sLse + kKQ;                                    // [32]
  float* sX = sD + kKQ;  // [2][64][40]: P^T (hf 0), dP^T (hf 1)
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kKRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, kr0 = 16 * (warp & 3), hf = warp >> 2;
  const size_t off = (size_t)head * n * kTD;
  const int kv_len = min(kv_lens[head], n);

  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients
    for (int i = tid; i < kKRows * (kTD / 4); i += kTThreads) {
      const int r = k0 + (i >> 5), c = (i & 31) * 4;
      if (r < n) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dk + off + (size_t)r * kTD + c) = z;
        *reinterpret_cast<float4*>(dv + off + (size_t)r * kTD + c) = z;
      }
    }
    return;
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {  // K and V in two 32-row halves: 16 registers each
    Rows128<32, false> r;
    t128_load(r, k + off, k0 + 32 * part, n, tid, false, nullptr, nullptr);
    t128_split(sKh + 32 * part * kTLd, sKl + 32 * part * kTLd, r, tid, false);
    t128_load(r, v + off, k0 + 32 * part, n, tid, false, nullptr, nullptr);
    t128_split(sVh + 32 * part * kTLd, sVl + 32 * part * kTLd, r, tid, false);
  }
  const bool valid[2] = {k0 + kr0 + g < kv_len, k0 + kr0 + g + 8 < kv_len};
  float dk_acc[8][4], dv_acc[8][4];
  zero84(dk_acc);
  zero84(dv_acc);
  // this warp's first product: S^T = K.q^T (hf 0) or dP^T = V.dO^T (hf 1)
  const uint32_t* ah_t = hf ? sVh : sKh;
  const uint32_t* al_t = hf ? sVl : sKl;
  const uint32_t* bh_t = hf ? sOh : sQh;
  const uint32_t* bl_t = hf ? sOl : sQl;
  float* x_mine = sX + hf * kKRows * kXLd + kr0 * kXLd;
  const float* x_other = sX + (1 - hf) * kKRows * kXLd + kr0 * kXLd;

  const int q_tiles = (n + kKQ - 1) / kKQ;
  Rows128<kKQ, false> qr, orr;
  t128_load(qr, q + off, 0, n, tid, false, nullptr, nullptr);
  t128_load(orr, dout + off, 0, n, tid, false, nullptr, nullptr);
  float lr = 0.f, dd = 0.f;
  if (tid < kKQ) {
    lr = tid < n ? lse[(size_t)head * n + tid] : INFINITY;
    dd = tid < n ? dvec[(size_t)head * n + tid] : 0.f;
  }
  for (int it = 0; it < q_tiles; ++it) {
    const int qb = it * kKQ;
    __syncthreads();  // the previous tile's readers (and the K, V stores) are done
    t128_split(sQh, sQl, qr, tid, false);
    t128_split(sOh, sOl, orr, tid, false);
    if (tid < kKQ) {
      sLse[tid] = lr;
      sD[tid] = dd;
    }
    __syncthreads();
    if (it + 1 < q_tiles) {  // the next tile's rows load while this one's products run
      const int nb = qb + kKQ;
      t128_load(qr, q + off, nb, n, tid, false, nullptr, nullptr);
      t128_load(orr, dout + off, nb, n, tid, false, nullptr, nullptr);
      if (tid < kKQ) {
        lr = nb + tid < n ? lse[(size_t)head * n + nb + tid] : INFINITY;
        dd = nb + tid < n ? dvec[(size_t)head * n + nb + tid] : 0.f;
      }
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    t128_qk<NT>(s, ah_t, al_t, bh_t, bl_t, kr0, lane);
    // s[j][e]: key kr0 + g + 8 (e >> 1), query qb + 8j + 2t + (e & 1)
    if (hf == 0) {  // P^T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = valid[e >> 1] ? exp2f(s[j][e] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(x_mine + (g + 8 * h) * kXLd + 8 * j + 2 * t) =
            make_float2(s[j][2 * h], s[j][2 * h + 1]);
    pair_barrier(1 + (warp & 3));
    float p[NT][4], ds[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 o2 =
            *reinterpret_cast<const float2*>(x_other + (g + 8 * h) * kXLd + 8 * j + 2 * t);
        const float pt0 = hf ? o2.x : s[j][2 * h], pt1 = hf ? o2.y : s[j][2 * h + 1];
        const float dp0 = hf ? s[j][2 * h] : o2.x, dp1 = hf ? s[j][2 * h + 1] : o2.y;
        p[j][2 * h] = pt0;
        p[j][2 * h + 1] = pt1;
        ds[j][2 * h] = pt0 * (dp0 - d2.x);  // dS^T
        ds[j][2 * h + 1] = pt1 * (dp1 - d2.y);
      }
    }
    t128_pv<NT>(dv_acc, p, sOh, sOl, 64 * hf, lane);   // dV[:, half] += P^T.dO[:, half]
    t128_pv<NT>(dk_acc, ds, sQh, sQl, 64 * hf, lane);  // dK[:, half] += dS^T.q[:, half]
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + kr0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const size_t at = off + (size_t)row * kTD + 64 * hf + nd * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dk_acc[nd][2 * h] * sm_scale, dk_acc[nd][2 * h + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
}

template <bool kOnline>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                           const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                           void* lse_out, int H, int n, float scale_log2, float sm_scale,
                           cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(flash_prefix_dq_tf32_d128_kernel<kOnline>, kDqSmem, ready);
  if (err != cudaSuccess) return err;
  flash_prefix_dq_tf32_d128_kernel<kOnline>
      <<<dim3((n + kQRows - 1) / kQRows, H), kTThreads, kDqSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(dvec), static_cast<const float*>(lse_in),
          static_cast<const int*>(kv_lens), static_cast<float*>(dq),
          static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace

namespace d128 {

cudaError_t tf32_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                    void* lse_out, int H, int n, float scale_log2, float sm_scale, bool online,
                    cudaStream_t stream) {
  return online ? launch_dq_tf32<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                       scale_log2, sm_scale, stream)
                : launch_dq_tf32<false>(q, k, v, dout, dvec, lse_in, kv_lens, dq, nullptr, H, n,
                                        scale_log2, sm_scale, stream);
}

cudaError_t tf32_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* dvec, const void* lse, const void* kv_lens, void* dk, void* dv,
                     int H, int n, float scale_log2, float sm_scale, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(flash_prefix_dkv_tf32_d128_kernel, kDkvSmem, ready);
  if (err != cudaSuccess) return err;
  flash_prefix_dkv_tf32_d128_kernel<<<dim3((n + kKRows - 1) / kKRows, H), kTThreads, kDkvSmem,
                                      stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse), static_cast<const int*>(kv_lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace d128
}  // namespace f5

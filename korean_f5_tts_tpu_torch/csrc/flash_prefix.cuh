// Tiles, warp-level products, the online-softmax step and the forward loop
// of the first port's mma.sync attention: kernel 10 at d = 128
// (flash_prefix_fwd_kernel; its forms without lse and with rope are the
// designs that kernels A and 18 at d = 128 ran on, kept for timing; d = 64
// and A and 18 at d = 128 run on attn_wgmma.cuh), the dq and dk/dv kernels
// 11, 12 and 13 at d = 128 (flash_prefix_d128.cu; d = 64 runs on
// attn_bwd_wgmma.cuh), kernel 14 at d = 128 (flash_prefix_int8_d128.cu), and
// the probes of the rope loop's idioms (probe_hopper.cu: the strided and
// rope loaders at d = 64).
//
// A block is 128 threads over a 64-row tile; each warp owns 16 of the rows.
// Shared tiles are [64][D + 8] bf16 (mma.cuh's padded stride); rows at or
// past n are zero-filled on load and never stored, so n needs no multiple.
#pragma once

#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kBQ = 64;   // rows of a block's own tile (queries, or keys in dk/dv)
constexpr int kBKV = 64;  // rows of a streamed tile
constexpr int kThreads = 128;
constexpr int kNS = kBKV / 8;  // n-tiles of a 16 x 64 score tile

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

// head dim of the strided loaders' default (probe_hopper.cu)
constexpr int kD = 64;
constexpr int kLD = kD + 8;

// rows [row0, row0 + 64) of one head (row stride ld) into a [64][D + 8]
// shared tile; rows at or past n are zero-filled
template <int D = kD>
__device__ __forceinline__ void load_rows_strided(bf16* dst, const bf16* src, size_t ld, int row0,
                                                  int n, int tid) {
  for (int i = tid; i < 64 * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<int4*>(dst + r * (D + 8) + c) = val;
  }
}

// the same, with the half-split rotation applied on the way: cos, sin are
// [n, D / 2] bf16 tables; the arithmetic in fp32, one rounding of each
// result (ops/flash_prefix.py:rope_reference)
template <int D = kD>
__device__ __forceinline__ void load_rows_rope(bf16* dst, const bf16* src, size_t ld, int row0,
                                               int n, const bf16* __restrict__ cos,
                                               const bf16* __restrict__ sin, int tid) {
  for (int i = tid; i < 64 * (D / 16); i += kThreads) {
    const int r = i / (D / 16);
    const int c = (i % (D / 16)) * 8;  // the partner is at c + D / 2
    int4 lo = make_int4(0, 0, 0, 0), hi = make_int4(0, 0, 0, 0);
    const int row = row0 + r;
    if (row < n) {
      const bf16* p = src + (size_t)row * ld + c;
      const int4 xlo = *reinterpret_cast<const int4*>(p);
      const int4 xhi = *reinterpret_cast<const int4*>(p + D / 2);
      const int4 cr = *reinterpret_cast<const int4*>(cos + (size_t)row * (D / 2) + c);
      const int4 sr = *reinterpret_cast<const int4*>(sin + (size_t)row * (D / 2) + c);
      const bf16* a = reinterpret_cast<const bf16*>(&xlo);
      const bf16* b = reinterpret_cast<const bf16*>(&xhi);
      const bf16* ce = reinterpret_cast<const bf16*>(&cr);
      const bf16* se = reinterpret_cast<const bf16*>(&sr);
      uint32_t* plo = reinterpret_cast<uint32_t*>(&lo);
      uint32_t* phi = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float x1[2], x2[2], cc[2], ss[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          x1[u] = __bfloat162float(a[e + u]);
          x2[u] = __bfloat162float(b[e + u]);
          cc[u] = __bfloat162float(ce[e + u]);
          ss[u] = __bfloat162float(se[e + u]);
        }
        plo[e / 2] = pack_bf16x2(__fsub_rn(__fmul_rn(x1[0], cc[0]), __fmul_rn(x2[0], ss[0])),
                                 __fsub_rn(__fmul_rn(x1[1], cc[1]), __fmul_rn(x2[1], ss[1])));
        phi[e / 2] = pack_bf16x2(__fadd_rn(__fmul_rn(x2[0], cc[0]), __fmul_rn(x1[0], ss[0])),
                                 __fadd_rn(__fmul_rn(x2[1], cc[1]), __fmul_rn(x1[1], ss[1])));
      }
    }
    *reinterpret_cast<int4*>(dst + r * (D + 8) + c) = lo;
    *reinterpret_cast<int4*>(dst + r * (D + 8) + c + D / 2) = hi;
  }
}

// A fragments of this warp's 16 rows of a shared [64][D + 8] tile
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* tile,
                                             int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(a[kk], a_frag_addr(tile + (warp * 16) * LD + kk * 16, LD, lane));
}

// s (16 x 64, fp32) = A (16 x D, fragments) . B^T for a shared [64][D + 8]
// tile B: q.k^T, dO.v^T, k.q^T and v.dO^T are all this product
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[kNS][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int i = 0; i < kNS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kNS; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_nk_addr(tile + (nt * 8) * LD + kk * 16, LD, lane));
      mma_bf16_16816(s[nt], a[kk], b[0], b[1]);
      mma_bf16_16816(s[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// the same product with the A rows read from a shared [64][D + 8] tile as
// it goes (this warp's 16 rows): the dq and dk/dv kernels keep Q, dO, K and
// V in shared memory instead of holding their fragments in registers
template <int D>
__device__ __forceinline__ void mma_abt_s(float (&s)[kNS][4], const bf16* ta, const bf16* tb,
                                          int warp, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int i = 0; i < kNS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_frag_addr(ta + (warp * 16) * LD + kk * 16, LD, lane));
#pragma unroll
    for (int nt = 0; nt < kNS; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_nk_addr(tb + (nt * 8) * LD + kk * 16, LD, lane));
      mma_bf16_16816(s[nt], a, b[0], b[1]);
      mma_bf16_16816(s[nt + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D, fp32) += P . B, where P is a 16 x 64 accumulator-layout tile
// rounded to bf16 here (score n-tiles 2kt, 2kt + 1 are the A fragment of key
// step kt, so P never leaves registers) and B a shared [64][D + 8] tile:
// P.V, dS.K, P^T.dO and dS^T.Q are all this product
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[kNS][4],
                                       const bf16* tile, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kt = 0; kt < kBKV / 16; ++kt) {
    uint32_t a[4];
    a[0] = pack_bf16x2(p[2 * kt][0], p[2 * kt][1]);
    a[1] = pack_bf16x2(p[2 * kt][2], p[2 * kt][3]);
    a[2] = pack_bf16x2(p[2 * kt + 1][0], p[2 * kt + 1][1]);
    a[3] = pack_bf16x2(p[2 * kt + 1][2], p[2 * kt + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_kn_addr(tile + (kt * 16) * LD + dt * 8, LD, lane));
      mma_bf16_16816(acc[dt], a, b[0], b[1]);
      mma_bf16_16816(acc[dt + 1], a, b[2], b[3]);
    }
  }
}

// One 64-key tile of the online softmax, on this warp's 16 x 64 raw scores s
// (keys k0 .. k0 + 63): scale into the base-2 domain, mask keys at or past
// kv_len, update the running max and denominator, rescale the output
// accumulator o, and leave the un-normalised probabilities in s.
template <int ND>
__device__ __forceinline__ void online_softmax_tile(float (&s)[kNS][4], float (&o)[ND][4],
                                                    float (&m_run)[2], float (&l_run)[2],
                                                    int k0, int kv_len, float scale_log2, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
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
    // tile 0 always holds key 0 < kv_len, so m_new is finite from then on
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
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
}

// Store this warp's normalised 16 x (8 * ND) output rows (row0 and row0 + 8
// for this lane) into a row-major array of row stride ld; rows at or past n
// are not stored.
template <int ND>
__device__ __forceinline__ void store_output_rows(bf16* out, int ld, const float (&o)[ND][4],
                                                  const float (&inv)[2], int row0, int n, int t) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * ld + col) =
          pack_bf16x2(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (row0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + 8) * ld + col) =
          pack_bf16x2(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

// Where the rope form's heads lie (kernel 18 at d = 128): the operands are
// contiguous [B, heads, n, D], so folded head blockIdx.y = item * heads + g
// is the block [n, D] at blockIdx.y * n * D, as for kernel A; item b
// attends keys [0, kv_lens[b]), and heads g < n_rope rotate q and k by the
// [n, D / 2] tables cos, sin of the operands' dtype.
struct RopeHeads {
  int heads, n_rope;
  const void* cos;
  const void* sin;
};

// Forward: one block per (folded head, 64-row query tile); a row with no
// valid key gets output 0. kLse (kernel 10 at d = 128): each row's base-2
// logsumexp lse = m + log2(l) of the scaled scores, 0 for a row with no
// valid key. kRope (kernel 18 at d = 128): q and k of the rotating heads
// are rotated as they are loaded into shared memory.
template <int D, bool kLse = false, bool kRope = false>
__global__ void __launch_bounds__(kThreads)
flash_prefix_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ kv_lens,
                        bf16* __restrict__ out, float* __restrict__ lse, int n, float scale_log2,
                        RopeHeads rh) {
  constexpr int LD = D + 8;
  constexpr int ND = D / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBKV * LD;

  const int head = blockIdx.y;
  const int item = kRope ? head / rh.heads : head;
  const bool rot = kRope && head - item * rh.heads < rh.n_rope;  // block-uniform
  const bf16* cos = static_cast<const bf16*>(rh.cos);
  const bf16* sin = static_cast<const bf16*>(rh.sin);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const size_t off = (size_t)head * n * D;
  const int kv_len = min(kv_lens[item], n);

  if (rot)
    load_rows_rope<D>(sQ, q + off, D, q0, n, cos, sin, tid);
  else
    load_rows<D>(sQ, q + off, q0, n, tid);
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_frags<D>(qf, sQ, warp, lane);

  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  const int n_tiles = kv_len > 0 ? (kv_len + kBKV - 1) / kBKV : 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    if (rot)
      load_rows_rope<D>(sK, k + off, D, k0, n, cos, sin, tid);
    else
      load_rows<D>(sK, k + off, k0, n, tid);
    load_rows<D>(sV, v + off, k0, n, tid);
    __syncthreads();

    float s[kNS][4];
    mma_abt<D>(s, qf, sK, lane);

    online_softmax_tile<ND>(s, o, m_run, l_run, k0, kv_len, scale_log2, t);
    mma_pb<D>(o, s, sV, lane);
  }

  float inv[2];
  const int row0 = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros, as the TPU kernel
    if (kLse && t == 0 && row0 + 8 * r < n)
      lse[(size_t)head * n + row0 + 8 * r] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
  }
  store_output_rows<ND>(out + off, D, o, inv, row0, n, t);
}

template <int D, bool kLse = false, bool kRope = false>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                       void* out, int H, int n, float scale_log2, cudaStream_t stream,
                       void* lse = nullptr, RopeHeads rh = RopeHeads{1, 0, nullptr, nullptr}) {
  const int smem = 3 * 64 * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_fwd_kernel<D, kLse, kRope>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, H);
  flash_prefix_fwd_kernel<D, kLse, kRope><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_lens), static_cast<bf16*>(out), static_cast<float*>(lse), n,
      scale_log2, rh);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// The bf16 attention core for Hopper: kernel A (prefix attention) at head
// dim 64, on TMA, mbarriers and wgmma (hopper.cuh), and kernel 10 (the
// training forward, flash_prefix_train.cu), which is kernel A that also
// writes each row's base-2 logsumexp lse = m + log2(l) (the template flag
// kLse; kernel A's instantiation has no lse code).
//
// The function is kernel A's (flash_prefix.cu): folded heads q, k, v, out
// [H, n, 64] bf16, kv_lens [H] int32; head h attends keys [0, kv_lens[h])
// (clamped to n); every query row, padded ones included, gets a softmax over
// those keys; a head with kv_len 0 gives zeros. It replaces, for bf16 d = 64,
// the mma.sync loop of flash_prefix.cuh, which the TPU kernel
// (korean_f5_tts_tpu/ops/flash_prefix.py:_kernel_nomax_hn) was first ported
// to. What held that loop to a sixth of the bf16 peak: every 64-row block
// streamed the whole prefix of K and V from L2 (270 MB a call at the main
// shape), its loads were synchronous with two barriers a tile, its products
// were mma.sync, and its exponentials ran between the products.
//
// Design. One block per (folded head, tile of 192 query rows), 512 threads:
// three consumer warpgroups of 64 query rows each and a producer warpgroup
// whose one thread issues the TMA loads (setmaxnreg moves the producer's
// registers to the consumers). The producer loads the q tile once
// and streams 128-key tiles of K and V through a ring of kAttnStages stages
// with full/empty mbarriers. The maps are 3-D, [H, n, 64]: a box stops at
// its head's row n with zero fill, so a tile never reads the next head and
// q rows past n are zeros that are never stored. Rows of 64 bf16 are one
// 128-byte swizzle span, so every tile is [rows][128 bytes] swizzled.
//   S = q.K^T      wgmma m64n128k16, both operands from shared memory, four
//                  k16 steps (wgmma_ss_n128).
//   softmax        online max and sum in fp32 on the S accumulator, exp2 with
//                  log2(e) folded into the scale; keys at or past kv_len are
//                  set to -inf before the max (only the last tile needs it).
//                  The loop runs ceil(kv_len / 128) tiles: the TPU kernel's
//                  `prune`.
//   O += P.V       P never leaves registers: the S accumulator of columns
//                  16kk .. 16kk + 15 is, rounded to bf16, the A fragment of
//                  k step kk (the layouts match: hopper.cuh). V [keys][64] is
//                  MN-major for the B operand: wgmma m64n64k16 with A from
//                  registers and B transposed (wgmma_rs_n64_tb, descriptor
//                  wgmma_desc_mn), eight k16 steps a tile.
//   overlap        within a warpgroup the next tile's S product is issued
//                  before this tile's P.V, and the softmax of the next tile
//                  runs while P.V is in flight: both wgmma groups are
//                  asynchronous, the softmax reads S only after its group is
//                  done (wait_group 1) and O is rescaled only after P.V's
//                  (wait_group 0). No register a group in flight reads is
//                  written meanwhile (ptxas serializes wgmma otherwise).
//                  Across warpgroups, ping-pong: a warpgroup issues its
//                  products only in its turn (named barriers, round robin),
//                  so one warpgroup's exponentials run under the others'
//                  products instead of beside them.
//   exp2           ex2.approx.ftz on the scores (one SFU instruction; exp2f
//                  adds a range fix-up that no score needs): the kernel's
//                  output is the same to the last bit at the main shape.
//   epilogue       O / l in registers, bf16 pairs into the warpgroup's own q
//                  slice of shared memory (swizzled, conflict-free), then
//                  16-byte stores of whole rows, masked at n.
// Numerics as the mma.sync loop: fp32 running max and sum, P rounded to bf16
// for P.V (the row sums use fp32 P).
//
// What bounds it: at the main shape (H = 32, n = 1536, 1376 valid keys) a
// call is 4 * 32 * 1536 * 1376 * 64 = 17.3 GFLOP (0.0175 ms at 989 TFLOP/s)
// against 25 MB (0.0075 ms at 3.35 TB/s), and 67.6 M exp2 that the SFUs (16
// a clock per SM) take ~0.018 ms for: products and exponentials must
// overlap. 192-row tiles read K and V from L2 a third as often as the old
// 64-row tiles did (90 MB a call). Grid at the main shape: 8 x 32 = 256
// blocks, 1.9 waves on 132 SMs. On an H100 at the main shape (PERF.md
// section 6) 192 rows a block were faster than 128 (two consumer
// warpgroups, 384 blocks, 2.9 waves), and ping-pong and ex2.approx each
// took time off.
#pragma once

#include "gemm_bf16.cuh"  // align_1024, kMaxDevices, allow_smem

namespace f5 {
namespace {

constexpr int kAttnD = 64;
constexpr int kAttnBK = 128;                           // keys a tile
constexpr int kAttnStages = 3;                         // K/V ring depth
constexpr int kAttnWgBytes = 64 * kRowBytes;           // one warpgroup's 64 q rows
constexpr int kAttnKVBytes = kAttnBK * kRowBytes;      // a K or a V tile
constexpr int kAttnStageBytes = 2 * kAttnKVBytes;
constexpr int kAttnWgs = 3;                            // consumer warpgroups, 64 q rows each
constexpr int kAttnRows = 64 * kAttnWgs;               // q rows a block
constexpr int kAttnSmemBytes =
    1024 + kAttnWgs * kAttnWgBytes + kAttnStages * kAttnStageBytes + (2 * kAttnStages + 1) * 8;

// 2^x in one SFU instruction (denormal results flushed to zero: far below
// what a bf16 P or the fp32 row sum can tell from zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 128-key tile of the online softmax on a warpgroup's raw scores s (the
// m64n128 accumulator: s[4j + e] is row g + 8 (e >> 1), key k0 + 8j + 2t +
// (e & 1)): mask keys at or past kv_len, update the running max (in the
// base-2 domain) and denominator, leave the unnormalised probabilities in s
// and the factor the output must be rescaled by in alpha.
__device__ __forceinline__ void attn_softmax_tile(float (&s)[64], float (&m_run)[2],
                                                  float (&l_run)[2], float (&alpha)[2], int k0,
                                                  int kv_len, float scale_log2, int t) {
  if (k0 + kAttnBK > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every tile holds a key < kv_len, so the max is finite from the first tile on
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], scale_log2, neg_m[r]));
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
}

// P (an m64nN accumulator, N = 128 here, 64 in the backward core) rounded
// to bf16 as the A fragments of the N / 16 k16 steps of P.V: columns 16kk ..
// 16kk + 15 are accumulator column groups 2kk and 2kk + 1, in
// mma.m16n8k16's A order (mma.cuh)
template <int N>
__device__ __forceinline__ void attn_pack_p(const float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ping-pong: warpgroup wg issues its products only in its turn (named
// barrier 4 + wg, 256 threads: its own 128 waiting, the previous
// warpgroup's 128 arriving when it has issued)
__device__ __forceinline__ void attn_turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}

__device__ __forceinline__ void attn_turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + (wg + 1) % kAttnWgs) : "memory");
}

// issue S = q.K^T for one tile (four k16 steps) as one wgmma group
__device__ __forceinline__ void attn_issue_qk(float (&s)[64], uint64_t desc_q,
                                              const unsigned char* tile_k) {
  const uint64_t dk = wgmma_desc(tile_k);
#pragma unroll
  for (int kk = 0; kk < kAttnD / 16; ++kk) wgmma_ss_n128(s, desc_q + 2 * kk, dk + 2 * kk, kk != 0);
  wgmma_commit();
}

// issue O += P.V for one tile (eight k16 steps) as one wgmma group
__device__ __forceinline__ void attn_issue_pv(float (&o)[32], const uint32_t (&p)[8][4],
                                              const unsigned char* tile_v) {
  const uint64_t dv = wgmma_desc_mn(tile_v);
#pragma unroll
  for (int kk = 0; kk < kAttnBK / 16; ++kk) wgmma_rs_n64_tb(o, p[kk], dv + 128 * kk, 1);
  wgmma_commit();
}

// kLse: also write lse [H, n] fp32, the base-2 logsumexp of each row's
// scaled scores (kernel 10); kernel A instantiates it without
template <bool kLse>
__global__ void __launch_bounds__(128 * (kAttnWgs + 1), 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const int* __restrict__ kv_lens,
                      bf16* __restrict__ out, float* __restrict__ lse, int n, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_q = smem;
  unsigned char* ring = smem + kAttnWgs * kAttnWgBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kAttnStages * kAttnStageBytes);
  uint64_t* empty = full + kAttnStages;
  uint64_t* q_full = empty + kAttnStages;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kAttnRows;
  const int kv_len = min(kv_lens[head], n);
  const int n_tiles = kv_len > 0 ? (kv_len + kAttnBK - 1) / kAttnBK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kAttnStages; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive; TMA counts the bytes
      mbar_init(&empty[s], 4 * kAttnWgs);  // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kAttnWgs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (tid == 128 * kAttnWgs) {
      mbar_arrive_expect_tx(q_full, kAttnWgs * kAttnWgBytes);
      tma_load_3d(s_q, &map_q, q_full, 0, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kAttnStages;
        mbar_wait(&empty[s], ((j / kAttnStages) & 1) ^ 1);  // passes at once on the first round
        unsigned char* tile = ring + s * kAttnStageBytes;
        mbar_arrive_expect_tx(&full[s], kAttnStageBytes);
        tma_load_3d(tile, &map_k, &full[s], 0, j * kAttnBK, head);
        tma_load_3d(tile + kAttnKVBytes, &map_v, &full[s], 0, j * kAttnBK, head);
      }
    }
  } else {
    // 128 x 32 + 384 x 160 = 512 x 128: the registers the block was launched with
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    unsigned char* my_q = s_q + wg * kAttnWgBytes;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp's 16
    float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      const uint64_t desc_q = wgmma_desc(my_q);
      float s[64];
      uint32_t p[8][4];
      float alpha[2];
      if (wg == kAttnWgs - 1) attn_turn_pass(wg);  // warpgroup 0 starts
      mbar_wait(&full[0], 0);
      attn_turn_wait(wg);
      wgmma_fence();
      attn_issue_qk(s, desc_q, ring);
      attn_turn_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      attn_softmax_tile(s, m_run, l_run, alpha, 0, kv_len, scale_log2, t);
      attn_pack_p<kAttnBK>(s, p);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kAttnStages, prev = (j - 1) % kAttnStages;
        mbar_wait(&full[st], (j / kAttnStages) & 1);
        attn_turn_wait(wg);
        wgmma_fence();
        attn_issue_qk(s, desc_q, ring + st * kAttnStageBytes);
        attn_issue_pv(o, p, ring + prev * kAttnStageBytes + kAttnKVBytes);
        attn_turn_pass(wg);
        wgmma_wait<1>();  // S of tile j is done; P.V of tile j - 1 may still run
        wgmma_fence_regs(s);
        attn_softmax_tile(s, m_run, l_run, alpha, j * kAttnBK, kv_len, scale_log2, t);
        wgmma_wait<0>();
        wgmma_fence_regs(o);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        attn_pack_p<kAttnBK>(s, p);
      }
      const int last = (n_tiles - 1) % kAttnStages;
      attn_turn_wait(wg);
      wgmma_fence();
      attn_issue_pv(o, p, ring + last * kAttnStageBytes + kAttnKVBytes);
      if (wg != kAttnWgs - 1) attn_turn_pass(wg);  // the last turn: nobody waits on warpgroup 0's barrier
      wgmma_wait<0>();
      wgmma_fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[last]);
    }

    // epilogue: rows of bf16 through this warpgroup's q slice (its last S
    // product is done), chunk j of row r at chunk j ^ (r & 7)
    const int row = (warp & 3) * 16 + g;  // and row + 8; (row + 8) & 7 == g too
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      inv[r] = l > 0.f ? 1.f / l : 0.f;  // kv_len == 0: zeros, as the TPU kernel
      const int grow = q0 + wg * 64 + row + 8 * r;
      // m_run is already in the base-2 domain of the scaled scores; a row
      // with no valid key gets lse 0
      if (kLse && t == 0 && grow < n)
        lse[(size_t)head * n + grow] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = (j ^ g) << 4;
      *reinterpret_cast<uint32_t*>(my_q + row * kRowBytes + chunk + 4 * t) =
          pack_bf16x2(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(my_q + (row + 8) * kRowBytes + chunk + 4 * t) =
          pack_bf16x2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
    bf16* out_head = out + (size_t)head * n * kAttnD;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = wt + 128 * it, r = i >> 3, c = i & 7;
      const int grow = q0 + wg * 64 + r;
      if (grow < n)
        *reinterpret_cast<int4*>(out_head + (size_t)grow * kAttnD + 8 * c) =
            *reinterpret_cast<const int4*>(my_q + r * kRowBytes + ((c ^ (r & 7)) << 4));
    }
  }
}

// kernel A (kLse false, lse unused) or kernel 10 (kLse) at head dim 64 on
// this core. q, k, v, out: [H, n, 64] bf16, 16-byte aligned; kv_lens [H]
// int32; lse [H, n] fp32.
template <bool kLse>
cudaError_t launch_attn_fwd_wgmma(const void* q, const void* k, const void* v,
                                  const void* kv_lens, void* out, void* lse, int H, int n,
                                  float scale_log2, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!tensor_map_3d(&map_q, q, H, n, kAttnD, kAttnRows, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, kAttnD, kAttnBK, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, kAttnD, kAttnBK, kMapBf16))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<kLse>, kAttnSmemBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kAttnRows - 1) / kAttnRows, H);
  attn_fwd_wgmma_kernel<kLse><<<grid, 128 * (kAttnWgs + 1), kAttnSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<const int*>(kv_lens), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

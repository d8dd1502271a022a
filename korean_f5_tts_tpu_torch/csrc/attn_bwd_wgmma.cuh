// The bf16 attention backward core for Hopper: kernel 13 (dk and dv of
// prefix attention) at head dim 64, on TMA, mbarriers and wgmma (hopper.cuh);
// its D = 128 form, attn_dkv_d128_wgmma_kernel, is built from these pieces in
// flash_prefix_bwd_core_d128.cu.
//
// The function is the TPU kernel's (korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_dkv -> _kernel_dkv, with cast=True): folded heads q, k, v, dO,
// dk, dv [H, n, 64] bf16, lse and D = rowsum(dO * o) [H, n] fp32, kv_lens [H]
// int32. Key j of head h has gradients only if j < kv_len:
//   S^T  = K.Q^T                     (fp32)
//   P^T  = exp2(S^T * scale_log2 - lse[query])
//   dV  += P^T.dO                    (P^T rounded to bf16)
//   dP^T = V.dO^T                    (fp32)
//   dS^T = P^T * (dP^T - D[query])
//   dK  += dS^T.Q                    (dS^T rounded to bf16); dK *= 1/sqrt(64)
// summed over every query row, padded ones included (a padded row attends
// the prefix too, and its dO is not assumed zero). It replaces the mma.sync
// kernel the TPU kernel was first ported to (flash_prefix_train.cu before
// this core), which held k and v of 64 keys in registers, loaded each 64-query
// tile synchronously with two barriers and ran its four products on mma.sync.
//
// What bounds it: at the training shape (H = 128, n = 1280, every key valid)
// a call is 8 * 128 * 1280^2 * 64 = 107 GFLOP (0.109 ms at 989 TFLOP/s)
// against 84 MB (0.025 ms at 3.35 TB/s), and 210 M exp2 that the SFUs (16 a
// clock per SM) take ~0.05 ms for: tensor-core bound, with the exponentials
// to hide under the products.
//
// Design. One block per (folded head, tile of 128 keys), 384 threads: two
// consumer warpgroups of 64 keys each and a producer warpgroup (setmaxnreg
// moves its registers to the consumers: 128 x 40 + 256 x 232 = 65,536).
//   K, V        the block's 128 key rows of K and V are loaded once by TMA
//               (3-D maps over [H, n, 64], boxes stop at n with zeros) and
//               stay in shared memory: each warpgroup's 64 rows are the A
//               operands of its S^T and dP^T products.
//   Q, dO       the producer streams 64-query tiles of Q and dO through a
//               ring of kBwdStages stages with full/empty mbarriers, and its
//               first warp copies the tile's 64 lse and D values into the
//               stage beside them (plain loads: an [H, n] fp32 row of n =
//               301 starts at no 16-byte boundary, so no TMA map fits it);
//               a query at or past n gets lse +inf (P = 0 there, not left to
//               the zero fill of q and dO) and D 0.
//   S^T, dP^T   wgmma m64n64k16, both operands k-major in shared memory
//               (wgmma_ss_n64), four k16 steps over d, a group each.
//   dV, dK      wgmma m64n64k16 with A from registers (P^T or dS^T of the
//               m64n64 accumulator rounded to bf16: attn_pack_p<64>) and B
//               the stage's dO or Q tile, MN-major through a transposed-B
//               descriptor (the P.V form of attn_wgmma.cuh), four k16 steps
//               over the tile's queries.
//   tile width  64 queries: registers decide it. A lane holds S^T and dP^T
//               (2 x 32 fp32), dK and dV (2 x 32) and the packed P^T and dS^T
//               (2 x 16): 160, so the next tile's scores can be in flight
//               while this tile's gradients run. At 128 queries the same
//               overlap needs 256 registers, past the 240 at most that a
//               consumer of two can get beside a producer.
//   overlap     a warpgroup issues tile i's S^T and dP^T, then tile i - 1's
//               dV and dK, as three groups; it computes P^T of tile i when
//               S^T is done (wait_group 2), dS^T when dP^T is done (1), and
//               packs both for the next turn once i - 1's products are done
//               (0), which also frees that stage. No register a group in
//               flight reads is written meanwhile (ptxas serializes wgmma
//               otherwise). Across the two warpgroups, ping-pong: each issues
//               its products only in its turn, so one's exponentials run
//               under the other's products.
//   masks       keys at or past kv_len (rows of S^T) get P = 0 in the
//               warpgroup whose 64 keys straddle kv_len; a block whose first
//               key is at or past kv_len writes zero dK and dV without
//               walking the queries (the TPU kernel's keys past kv_len get
//               zero gradients too).
//   epilogue    dK * 1/sqrt(64) and dV as bf16 through the warpgroup's own K
//               and V slices of shared memory (swizzled, conflict-free), then
//               16-byte stores of whole rows, masked at n. No atomics: a
//               block owns its key rows, so the result does not depend on
//               the order blocks run in.
// Measured on an H100 at the training shape (PERF.md section 6): the
// turns took 6-7% off, six stages against four ~1%; three consumer
// warpgroups (192 keys a block, 160 registers each) spilled 320 bytes and
// took twice the time.
// Numerics as the TPU kernel with cast=True: fp32 S^T and dP^T, P^T and dS^T
// rounded to bf16 only for their products, fp32 accumulation. The scale
// meets S^T in one fmaf with the lse (one rounding where the TPU kernel has
// two) and exp2 is ex2.approx, as in kernel A.
//
// Kernel 11 (dq from the forward's lse, the TPU kernel's _flash_prefix_dq_lsein
// -> _kernel_dq_lsein with cast=True) runs on the same pieces with keys and
// queries swapped (attn_dq_wgmma_kernel below):
//   S   = Q.K^T, P = exp2(S * scale_log2 - lse), dP = dO.V^T,
//   dS  = P * (dP - D), dq += dS.K (dS rounded to bf16), dq *= 1/sqrt(64).
// It replaces the first port's mma.sync loop (flash_prefix_train.cu: one
// 128-thread block per 64 queries, q and dO as mma fragments, K and V tiles
// loaded synchronously with two barriers a tile), which reached a quarter of
// its bound. What bounds it: 6 * n^2 * 64 * H = 80.5 GFLOP at the training
// shape (0.0814 ms at 989 TFLOP/s) against 84 MB, and 210 M exp2 (~0.05 ms on
// the SFUs): tensor-core bound, the exponentials to hide under the products.
// Design. One block per (folded head, 128 queries), 384 threads: two
// consumer warpgroups of 64 queries each and a producer warpgroup
// (setmaxnreg 40 / 232, as above).
//   Q, dO       loaded once by TMA (3-D maps, boxes of 128 rows that stop at
//               n with zeros); each warpgroup's 64 rows are the A operands of
//               its S and dP products and stay in shared memory.
//   lse, D      rows of the accumulator, so fixed per lane: two plain loads
//               each (an [H, n] fp32 row starts at no 16-byte boundary at n =
//               301); a query at or past n gets lse +inf (P = 0) and D 0.
//   K, V        the producer streams kDqKeys-key tiles of K and V through a
//               ring of kDqStages stages with full/empty mbarriers, only the
//               ceil(kv_len / kDqKeys) tiles that hold valid keys (the TPU
//               kernel walks every chunk, but keys past kv_len get
//               MASK_VALUE, so P is exactly 0 there: the same function).
//   S, dP       wgmma with both operands k-major in shared memory (the
//               forward core's S product, attn_issue_qk).
//   dq          wgmma m64n64k16 with dS from registers (attn_pack_p) and the
//               K tile MN-major through a transposed-B descriptor: the
//               forward's P.V form with K in V's place.
//   overlap     tile i's S and dP, then tile i - 1's dq product, as three
//               groups; P of tile i when S is done (wait_group 2), dS when dP
//               is done (1), and its packing only when i - 1's product is
//               done (0), which also frees that stage: one fragment buffer,
//               and no register that a group in flight reads is written
//               meanwhile (ptxas serializes wgmma otherwise). Ping-pong
//               between the two warpgroups, as above.
//   masks       keys at or past kv_len in the last tile get P = 0; a head
//               with kv_len 0 walks no tile and writes zero dq.
//   epilogue    dq * 1/sqrt(64) as bf16 through the warpgroup's own Q slice
//               (its products are done), then 16-byte stores of whole rows,
//               masked at n. No atomics.
//   key tile    128 keys (kDqKeys) through 4 stages (kDqStages): a lane
//               then holds S and dP (2 x 64 fp32), dq (32) and the packed dS
//               (32), 192 of the 232 registers, with no spill. A trial on an
//               H100 80GB HBM3 (700 W) at the training shape, with the width
//               and depth then template parameters (PERF.md section 6):
//               128 keys with 3 or 4 stages and 64 keys (kernel 13's product
//               forms) with 4 stages took the same time within noise
//               (0.1557-0.1574 ms); 64 keys with 6 stages 2% more, 128 keys
//               with 2 stages 31% more. Only the chosen form is built.
// Numerics as the TPU kernel with cast=True: fp32 S and dP, dS rounded to
// bf16 for its product, fp32 accumulation; the scale meets S in one fmaf
// with the lse (the TPU kernel scales q in bf16 first: one rounding the bf16
// bounds cover) and exp2 is ex2.approx, as in kernel 13.
//
// Kernel 12 (dq that recomputes the lse, the TPU kernel's _flash_prefix_dq ->
// _kernel_dq with cast=True) is the same kernel with kLseOut: no lse is
// read; a running max m and sum l per row take its place, as in _kernel_dq:
//   x = S * scale_log2 (keys at or past kv_len -inf), m_new = max(m, the
//   tile's row max), alpha = exp2(m - m_new), p = exp2(x - m_new), l = alpha
//   l + rowsum(p), dS = p (dP - D) rounded to bf16, dq = alpha dq + dS.K;
//   at the end dq * 1/sqrt(64) / l (l = 0 read as 1) and lse = m + log2(l)
//   (0 for a row with no valid key) written out.
// The rescale meets the pipelining: tile i - 1's dq += dS.K is in flight
// while tile i's S gives alpha_i, so the 32 accumulators are multiplied by
// alpha_i only after wait_group 0 has seen that product done, and before
// tile i's dS is packed for the next product; scaling an accumulator that a
// wgmma is writing would be a silent race. dS of tile i - 1 was taken
// against m_(i-1), so the product it adds must be rescaled too: it is, since
// it lands before the multiply. The running max is per 128-key tile where
// the TPU kernel keeps it per chunk (640 keys at n = 1280); p lies in [0, 1]
// either way and the one rounding that sees the max, bf16(dS), is relative,
// so the bf16 bounds hold. It replaces the first port's mma.sync loop
// (flash_prefix_train.cu before this form: 64-query blocks of 128 threads,
// 64-key tiles loaded synchronously with two barriers a tile), which reached
// 0.17 of its bound. Its bound is kernel 11's (the same products and
// exponentials, the max and sum an element more). Registers: m, l and alpha
// beside 11's arrays spilled 16 bytes at 232 a consumer thread, so kernel
// 12 splits the block's registers 24 (the TMA-only producer) / 240.
#pragma once

#include "attn_wgmma.cuh"  // fast_exp2, attn_pack_p, kAttnD, align_1024, allow_smem

namespace f5 {
namespace {

constexpr int kBwdWgs = 2;                           // consumer warpgroups, 64 keys each
constexpr int kBwdKeys = 64 * kBwdWgs;               // key rows a block
constexpr int kBwdBQ = 64;                           // queries a streamed tile
constexpr int kBwdStages = 6;                        // Q/dO ring depth
constexpr int kBwdTileBytes = kBwdBQ * kRowBytes;    // a Q or a dO tile
constexpr int kBwdKVBytes = kBwdKeys * kRowBytes;    // the block's K or V rows
constexpr int kBwdRowsOff = 2 * kBwdTileBytes;       // the tile's lse, then its D (fp32)
constexpr int kBwdStageBytes = kBwdRowsOff + 1024;   // stages stay 1024-byte aligned
constexpr int kBwdSmemBytes =
    1024 + 2 * kBwdKVBytes + kBwdStages * kBwdStageBytes + (2 * kBwdStages + 1) * 8;

// ping-pong as in attn_wgmma.cuh: warpgroup wg issues its products only in
// its turn (named barrier 4 + wg, 256 threads: its own 128 waiting, the other
// warpgroup's 128 arriving when it has issued)
__device__ __forceinline__ void bwd_turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}

__device__ __forceinline__ void bwd_turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + (wg + 1) % kBwdWgs) : "memory");
}

// one 64 x 64 score tile of the backward, S^T = K.Q^T or dP^T = V.dO^T
// (the A operand at desc_a, the B tile k-major), four k16 steps over d, as
// one wgmma group
__device__ __forceinline__ void bwd_issue_scores(float (&d)[32], uint64_t desc_a,
                                                 const unsigned char* tile_b) {
  const uint64_t db = wgmma_desc(tile_b);
#pragma unroll
  for (int kk = 0; kk < kAttnD / 16; ++kk) wgmma_ss_n64(d, desc_a + 2 * kk, db + 2 * kk, kk != 0);
  wgmma_commit();
}

// acc (64 rows x 64) += A (64 rows x 64 bf16, A fragments in registers) . B
// (the tile's [64][64] rows, MN-major): dV += P^T.dO and dK += dS^T.Q; no
// commit, so that both products of a tile go as one group
__device__ __forceinline__ void bwd_issue_grad(float (&acc)[32], const uint32_t (&a)[4][4],
                                               const unsigned char* tile) {
  const uint64_t db = wgmma_desc_mn(tile);
#pragma unroll
  for (int kk = 0; kk < kBwdBQ / 16; ++kk) wgmma_rs_n64_tb(acc, a[kk], db + 128 * kk, 1);
}

// P^T in place of S^T for this lane's keys (rows g, g + 8 of its warp's 16)
// and the tile's queries (s[4j + e] is query 8j + 2t + (e & 1)); mask: the
// warpgroup's keys straddle kv_len, and a key of this lane at or past it
// (valid false) gets P = 0
__device__ __forceinline__ void bwd_probs(float (&s)[32], const float* lse, float scale_log2,
                                          int t, bool mask, const bool (&valid)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x));
      if (mask && !valid[e >> 1]) x = -INFINITY;
      s[4 * j + e] = fast_exp2(x);
    }
  }
}

// dS^T = P^T * (dP^T - D) in place of dP^T
__device__ __forceinline__ void bwd_dscores(float (&dp)[32], const float (&p)[32],
                                            const float* dvec, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(dvec + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
  }
}

// this warpgroup's 64 x 64 accumulator, times `scale`, as bf16 rows into its
// swizzled slice of shared memory (chunk j of row r at chunk j ^ (r & 7))
__device__ __forceinline__ void bwd_stage_rows(unsigned char* slice, const float (&acc)[32],
                                               float scale, int row, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int chunk = (j ^ g) << 4;
    *reinterpret_cast<uint32_t*>(slice + row * kRowBytes + chunk + 4 * t) =
        pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(slice + (row + 8) * kRowBytes + chunk + 4 * t) =
        pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

__global__ void __launch_bounds__(128 * (kBwdWgs + 1), 1)
attn_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                      const float* __restrict__ dvec, const int* __restrict__ kv_lens,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float scale_log2,
                      float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_k = smem;
  unsigned char* s_v = smem + kBwdKVBytes;
  unsigned char* ring = smem + 2 * kBwdKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBwdStages * kBwdStageBytes);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kv_full = empty + kBwdStages;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBwdKeys;
  const int kv_len = min(kv_lens[head], n);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t off = (size_t)head * n * kAttnD;

  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients, no query walked
    for (int i = tid; i < kBwdKeys * 8; i += 128 * (kBwdWgs + 1)) {
      const int r = k0 + (i >> 3), c = i & 7;
      if (r < n) {
        *reinterpret_cast<int4*>(dk + off + (size_t)r * kAttnD + 8 * c) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(dv + off + (size_t)r * kAttnD + 8 * c) = make_int4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int q_tiles = (n + kBwdBQ - 1) / kBwdBQ;

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 32);            // the producer warp's lanes; lane 0's also expects the bytes
      mbar_init(&empty[s], 4 * kBwdWgs);  // lane 0 of every consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kBwdWgs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * kBwdWgs) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kBwdKVBytes);
        tma_load_3d(s_k, &map_k, kv_full, 0, k0, head);
        tma_load_3d(s_v, &map_v, kv_full, 0, k0, head);
      }
      const float* lse_h = lse + (size_t)head * n;
      const float* d_h = dvec + (size_t)head * n;
      for (int i = 0; i < q_tiles; ++i) {
        const int s = i % kBwdStages;
        mbar_wait(&empty[s], ((i / kBwdStages) & 1) ^ 1);  // passes at once on the first round
        unsigned char* stage = ring + s * kBwdStageBytes;
        float* rows = reinterpret_cast<float*>(stage + kBwdRowsOff);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * lane + e, qrow = i * kBwdBQ + c;
          rows[c] = qrow < n ? lse_h[qrow] : INFINITY;
          rows[kBwdBQ + c] = qrow < n ? d_h[qrow] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kBwdTileBytes);
          tma_load_3d(stage, &map_q, &full[s], 0, i * kBwdBQ, head);
          tma_load_3d(stage + kBwdTileBytes, &map_do, &full[s], 0, i * kBwdBQ, head);
        } else {
          mbar_arrive(&full[s]);  // releases this lane's lse and D stores
        }
      }
    }
  } else {
    // 128 x 40 + 256 x 232 = 65,536: the registers the block was launched
    // with (the producer's lse and D copies need more than the 24 of a
    // TMA-only producer)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + wg * 64;          // this warpgroup's first key
    const int row = (warp & 3) * 16 + g;   // this lane's keys: wk0 + row, wk0 + row + 8
    const bool mask = wk0 + 64 > kv_len;   // warpgroup-uniform
    const bool valid[2] = {wk0 + row < kv_len, wk0 + row + 8 < kv_len};
    unsigned char* my_k = s_k + wg * 64 * kRowBytes;
    unsigned char* my_v = s_v + wg * 64 * kRowBytes;
    const uint64_t desc_k = wgmma_desc(my_k), desc_v = wgmma_desc(my_v);
    float dk_acc[32], dv_acc[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    uint32_t p[4][4], ds[4][4];
    mbar_wait(kv_full, 0);

    // tile 0: its scores and gradients' operands
    mbar_wait(&full[0], 0);
    if (wg == kBwdWgs - 1) bwd_turn_pass(wg);  // warpgroup 0 starts
    bwd_turn_wait(wg);
    wgmma_fence();
    bwd_issue_scores(s, desc_k, ring);
    bwd_issue_scores(dp, desc_v, ring + kBwdTileBytes);
    bwd_turn_pass(wg);
    wgmma_wait<1>();
    wgmma_fence_regs(s);
    const float* rows = reinterpret_cast<const float*>(ring + kBwdRowsOff);
    bwd_probs(s, rows, scale_log2, t, mask, valid);
    wgmma_wait<0>();
    wgmma_fence_regs(dp);
    bwd_dscores(dp, s, rows + kBwdBQ, t);
    attn_pack_p<kBwdBQ>(s, p);
    attn_pack_p<kBwdBQ>(dp, ds);
    for (int i = 1; i < q_tiles; ++i) {
      const int st = i % kBwdStages, prev = (i - 1) % kBwdStages;
      unsigned char* stage = ring + st * kBwdStageBytes;
      unsigned char* pstage = ring + prev * kBwdStageBytes;
      mbar_wait(&full[st], (i / kBwdStages) & 1);
      bwd_turn_wait(wg);
      wgmma_fence();
      bwd_issue_scores(s, desc_k, stage);                  // S^T of tile i
      bwd_issue_scores(dp, desc_v, stage + kBwdTileBytes);  // dP^T of tile i
      bwd_issue_grad(dv_acc, p, pstage + kBwdTileBytes);   // dV += P^T.dO of tile i - 1
      bwd_issue_grad(dk_acc, ds, pstage);                  // dK += dS^T.Q of tile i - 1
      wgmma_commit();
      bwd_turn_pass(wg);
      rows = reinterpret_cast<const float*>(stage + kBwdRowsOff);
      wgmma_wait<2>();  // S^T of tile i is done; its dP^T and tile i - 1's products may run
      wgmma_fence_regs(s);
      bwd_probs(s, rows, scale_log2, t, mask, valid);
      wgmma_wait<1>();
      wgmma_fence_regs(dp);
      bwd_dscores(dp, s, rows + kBwdBQ, t);
      wgmma_wait<0>();
      wgmma_fence_regs(dk_acc);
      wgmma_fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      attn_pack_p<kBwdBQ>(s, p);
      attn_pack_p<kBwdBQ>(dp, ds);
    }
    unsigned char* last = ring + ((q_tiles - 1) % kBwdStages) * kBwdStageBytes;
    bwd_turn_wait(wg);
    wgmma_fence();
    bwd_issue_grad(dv_acc, p, last + kBwdTileBytes);
    bwd_issue_grad(dk_acc, ds, last);
    wgmma_commit();
    if (wg != kBwdWgs - 1) bwd_turn_pass(wg);  // the last turn: nobody waits on warpgroup 0's
    wgmma_wait<0>();
    wgmma_fence_regs(dk_acc);
    wgmma_fence_regs(dv_acc);

    // epilogue: dK and dV through this warpgroup's K and V slices (its last
    // products are done), then whole rows, masked at n
    bwd_stage_rows(my_k, dk_acc, sm_scale, row, g, t);
    bwd_stage_rows(my_v, dv_acc, 1.f, row, g, t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = wt + 128 * it, r = i >> 3, c = i & 7;
      const int grow = wk0 + r;
      if (grow < n) {
        const int src = r * kRowBytes + ((c ^ (r & 7)) << 4);
        *reinterpret_cast<int4*>(dk + off + (size_t)grow * kAttnD + 8 * c) =
            *reinterpret_cast<const int4*>(my_k + src);
        *reinterpret_cast<int4*>(dv + off + (size_t)grow * kAttnD + 8 * c) =
            *reinterpret_cast<const int4*>(my_v + src);
      }
    }
  }
}

// kernel 13 on this core. q, k, v, dout, dk, dv: [H, n, 64] bf16, 16-byte
// aligned; dvec, lse: [H, n] fp32 (any alignment: they are read by plain
// loads); kv_lens [H] int32.
cudaError_t launch_attn_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                  const void* dvec, const void* lse, const void* kv_lens,
                                  void* dk, void* dv, int H, int n, float scale_log2,
                                  float sm_scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tensor_map_3d(&map_q, q, H, n, kAttnD, kBwdBQ, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, kAttnD, kBwdKeys, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, kAttnD, kBwdKeys, kMapBf16) ||
      !tensor_map_3d(&map_do, dout, H, n, kAttnD, kBwdBQ, kMapBf16))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_dkv_wgmma_kernel, kBwdSmemBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBwdKeys - 1) / kBwdKeys, H);
  attn_dkv_wgmma_kernel<<<grid, 128 * (kBwdWgs + 1), kBwdSmemBytes, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_lens), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernels 11 and 12: dq, from the forward's lse or recomputing it
// ---------------------------------------------------------------------------

constexpr int kDqWgs = 2;                 // consumer warpgroups, 64 queries each
constexpr int kDqRows = 64 * kDqWgs;      // query rows a block
constexpr int kDqKeys = 128;              // keys a K/V tile (the trial's choice)
constexpr int kDqStages = 4;              // K/V ring depth at 128 keys (the trial's choice)

constexpr int kDqSmemBytes = 1024 + 2 * kDqRows * kRowBytes +
                             kDqStages * 2 * kDqKeys * kRowBytes + (2 * kDqStages + 1) * 8;

// dq (64 rows x 64) += dS (A fragments in registers) . K (the tile's rows,
// MN-major); no commit
__device__ __forceinline__ void dq_issue_grad(float (&acc)[32],
                                              const uint32_t (&a)[kDqKeys / 16][4],
                                              const unsigned char* tile_k) {
  const uint64_t db = wgmma_desc_mn(tile_k);
#pragma unroll
  for (int kk = 0; kk < kDqKeys / 16; ++kk) wgmma_rs_n64_tb(acc, a[kk], db + 128 * kk, 1);
}

// P in place of S (s[4j + e] is row g + 8 (e >> 1), key k0 + 8j + 2t + (e &
// 1)), keys at or past kv_len masked (kernel 11: against the given lse)
__device__ __forceinline__ void dq_probs(float (&s)[kDqKeys / 2], const float (&neg_lse)[2],
                                         float scale_log2, int k0, int kv_len, int t) {
  const bool mask = k0 + kDqKeys > kv_len;
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = fmaf(s[i], scale_log2, neg_lse[r]);
    if (mask && k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) x = -INFINITY;
    s[i] = fast_exp2(x);
  }
}

// kernel 12: P in place of S against the running max, which this tile
// updates, as the row sums l; alpha, the factor dq must be rescaled by, is
// left for the caller to apply once the previous tile's product is done
__device__ __forceinline__ void dq_probs_online(float (&s)[kDqKeys / 2], float (&m_run)[2],
                                                float (&l_run)[2], float (&alpha)[2],
                                                float scale_log2, int k0, int kv_len, int t) {
  const bool mask = k0 + kDqKeys > kv_len;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = mask && k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len ? -INFINITY : s[i] * scale_log2;
    mx[r] = fmaxf(mx[r], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every tile the sweep walks holds a key < kv_len: the max is finite
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = exp2f(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - m_run[r]);
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
}

// dS = P * (dP - D) in place of dP
__device__ __forceinline__ void dq_ds(float (&dp)[kDqKeys / 2], const float (&p)[kDqKeys / 2],
                                      const float (&dd)[2]) {
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) dp[i] = p[i] * (dp[i] - dd[(i >> 1) & 1]);
}

// kLseOut false: kernel 11, lse read; true: kernel 12, lse recomputed and
// written to lse_out
template <bool kLseOut>
__global__ void __launch_bounds__(128 * (kDqWgs + 1), 1)
attn_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                     const float* __restrict__ dvec, const int* __restrict__ kv_lens,
                     bf16* __restrict__ dq, float* __restrict__ lse_out, int n,
                     float scale_log2, float sm_scale) {
  constexpr int kTileBytes = kDqKeys * kRowBytes;  // a K or a V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_q = smem;
  unsigned char* s_do = smem + kDqRows * kRowBytes;
  unsigned char* ring = s_do + kDqRows * kRowBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDqStages * 2 * kTileBytes);
  uint64_t* empty = full + kDqStages;
  uint64_t* qd_full = empty + kDqStages;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t off = (size_t)head * n * kAttnD;

  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrive; TMA counts the bytes
      mbar_init(&empty[s], 4 * kDqWgs);  // lane 0 of every consumer warp
    }
    mbar_init(qd_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // 128 x 40 + 256 x 232 = 384 x 168, the registers the block is launched
  // with; kernel 12's running max and sum hold four registers more than 11's
  // lse, so its producer, which only issues TMA loads, keeps 24 and its
  // consumers get 240 (128 x 24 + 256 x 240, the same total)
  if (warp >= 4 * kDqWgs) {
    if constexpr (kLseOut) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // read after setmaxnreg: a value live across it is spilled
    const int kv_len = min(kv_lens[head], n);
    const int n_tiles = kv_len > 0 ? (kv_len + kDqKeys - 1) / kDqKeys : 0;
    if (tid == 128 * kDqWgs) {
      mbar_arrive_expect_tx(qd_full, 2 * kDqRows * kRowBytes);
      tma_load_3d(s_q, &map_q, qd_full, 0, q0, head);
      tma_load_3d(s_do, &map_do, qd_full, 0, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&empty[s], ((j / kDqStages) & 1) ^ 1);  // passes at once on the first round
        unsigned char* stage = ring + s * 2 * kTileBytes;
        mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_3d(stage, &map_k, &full[s], 0, j * kDqKeys, head);
        tma_load_3d(stage + kTileBytes, &map_v, &full[s], 0, j * kDqKeys, head);
      }
    }
  } else {
    if constexpr (kLseOut) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int kv_len = min(kv_lens[head], n);
    const int n_tiles = kv_len > 0 ? (kv_len + kDqKeys - 1) / kDqKeys : 0;
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row = (warp & 3) * 16 + g;  // this lane's queries: row, row + 8 of the warpgroup's
    unsigned char* my_q = s_q + wg * 64 * kRowBytes;
    const uint64_t desc_q = wgmma_desc(my_q);
    const uint64_t desc_do = wgmma_desc(s_do + wg * 64 * kRowBytes);
    float neg_lse[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int grow = q0 + wg * 64 + row + 8 * r;
      if constexpr (!kLseOut) neg_lse[r] = grow < n ? -lse[(size_t)head * n + grow] : -INFINITY;
      dd[r] = grow < n ? dvec[(size_t)head * n + grow] : 0.f;
    }
    // kernel 12: the running max and this lane's share of the row sums
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(qd_full, 0);
    if (n_tiles > 0) {
      float s[kDqKeys / 2], dp[kDqKeys / 2];
      uint32_t ds[kDqKeys / 16][4];
      mbar_wait(&full[0], 0);
      if (wg == kDqWgs - 1) bwd_turn_pass(wg);  // warpgroup 0 starts
      bwd_turn_wait(wg);
      wgmma_fence();
      attn_issue_qk(s, desc_q, ring);
      attn_issue_qk(dp, desc_do, ring + kTileBytes);
      bwd_turn_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_regs(s);
      if constexpr (kLseOut) dq_probs_online(s, m_run, l_run, alpha, scale_log2, 0, kv_len, t);
      else dq_probs(s, neg_lse, scale_log2, 0, kv_len, t);
      wgmma_wait<0>();
      wgmma_fence_regs(dp);
      dq_ds(dp, s, dd);
      attn_pack_p<kDqKeys>(dp, ds);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kDqStages, prev = (i - 1) % kDqStages;
        unsigned char* stage = ring + st * 2 * kTileBytes;
        mbar_wait(&full[st], (i / kDqStages) & 1);
        bwd_turn_wait(wg);
        wgmma_fence();
        attn_issue_qk(s, desc_q, stage);                // S of tile i
        attn_issue_qk(dp, desc_do, stage + kTileBytes);  // dP of tile i
        dq_issue_grad(acc, ds, ring + prev * 2 * kTileBytes);  // dq += dS.K of tile i - 1
        wgmma_commit();
        bwd_turn_pass(wg);
        wgmma_wait<2>();  // S of tile i is done; its dP and tile i - 1's product may run
        wgmma_fence_regs(s);
        if constexpr (kLseOut)
          dq_probs_online(s, m_run, l_run, alpha, scale_log2, i * kDqKeys, kv_len, t);
        else
          dq_probs(s, neg_lse, scale_log2, i * kDqKeys, kv_len, t);
        wgmma_wait<1>();
        wgmma_fence_regs(dp);
        dq_ds(dp, s, dd);
        wgmma_wait<0>();
        wgmma_fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);
        if constexpr (kLseOut) {
          // tile i - 1's product has landed: rescale to tile i's max before
          // tile i's dS (taken against it) is added
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] *= alpha[(e >> 1) & 1];
        }
        attn_pack_p<kDqKeys>(dp, ds);
      }
      bwd_turn_wait(wg);
      wgmma_fence();
      dq_issue_grad(acc, ds, ring + ((n_tiles - 1) % kDqStages) * 2 * kTileBytes);
      wgmma_commit();
      if (wg != kDqWgs - 1) bwd_turn_pass(wg);  // the last turn: nobody waits on warpgroup 0's
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
    }

    if constexpr (kLseOut) {
      // kernel 12: dq / l and lse = m + log2(l); a row with no valid key has
      // l = 0 (read as 1: its dq is zero) and lse 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_run[r]);
        const float inv = l > 0.f ? 1.f / l : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 2 * r] *= inv;
          acc[4 * j + 2 * r + 1] *= inv;
        }
        const int grow = q0 + wg * 64 + row + 8 * r;
        if (t == 0 && grow < n)
          lse_out[(size_t)head * n + grow] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
      }
    }
    // epilogue: dq through this warpgroup's Q slice (its products are done),
    // then whole rows, masked at n
    bwd_stage_rows(my_q, acc, sm_scale, row, g, t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = wt + 128 * it, r = i >> 3, c = i & 7;
      const int grow = q0 + wg * 64 + r;
      if (grow < n)
        *reinterpret_cast<int4*>(dq + off + (size_t)grow * kAttnD + 8 * c) =
            *reinterpret_cast<const int4*>(my_q + r * kRowBytes + ((c ^ (r & 7)) << 4));
    }
  }
}

// kernel 11 (lse given, lse_out null) or 12 (kLseOut: lse null, lse_out
// written) on this core. q, k, v, dout, dq: [H, n, 64] bf16, 16-byte
// aligned; dvec, lse, lse_out: [H, n] fp32 (any alignment); kv_lens [H]
// int32.
template <bool kLseOut>
cudaError_t launch_attn_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                 const void* dvec, const void* lse, const void* kv_lens,
                                 void* dq, void* lse_out, int H, int n, float scale_log2,
                                 float sm_scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tensor_map_3d(&map_q, q, H, n, kAttnD, kDqRows, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, kAttnD, kDqKeys, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, kAttnD, kDqKeys, kMapBf16) ||
      !tensor_map_3d(&map_do, dout, H, n, kAttnD, kDqRows, kMapBf16))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_dq_wgmma_kernel<kLseOut>, kDqSmemBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kDqRows - 1) / kDqRows, H);
  attn_dq_wgmma_kernel<kLseOut><<<grid, 128 * (kDqWgs + 1), kDqSmemBytes, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_lens), static_cast<bf16*>(dq),
      static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

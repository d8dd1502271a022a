// Kernels 13 (dk and dv of prefix attention) and 11, 12 (dq) at head dim 128
// in bf16, for Hopper (sm_90a): the D = 128 forms of the TMA + wgmma
// attention backward core (attn_bwd_wgmma.cuh, whose pieces they are built
// from).
//
// Replaces the TPU kernels korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_dkv -> _kernel_dkv, _flash_prefix_dq_lsein ->
// _kernel_dq_lsein and _flash_prefix_dq -> _kernel_dq (cast=True) at d = 128,
// which the JAX dispatch takes at d in (64, 128) (ops/attention.py:260,
// :296). The functions are the D = 64 cores' (attn_bwd_wgmma.cuh) on folded
// heads [H, n, 128], dK and dq *= 1/sqrt(128). Entry points: f5_flash_prefix_dkv
// (through d128::core_dkv), f5_flash_prefix_dq_lsein and f5_flash_prefix_dq
// (through d128::core_dq), flash_prefix_train.cu, at d = 128 on bf16 operands;
// the fp32 forms run on split 3xTF32 (flash_prefix_train_tf32_d128.cu). They
// replace the first port's mma.sync kernels (flash_prefix_d128.cu:
// flash_prefix_dkv_d128_kernel, 128 threads over 64 keys, K and V resident,
// 64-query tiles of Q and dO loaded synchronously with two barriers a tile,
// at 255 registers; flash_prefix_dq_d128_kernel<kOnline>, 128 threads over
// 64 queries, Q and dO resident, 64-key K/V tiles loaded synchronously, S,
// dP and dq on mma.sync m16n8k16), which no path runs any more:
// f5_flash_prefix_d128_bwd_mma keeps them for timing.
//
// What bounds them: at the training shape (H 64, n 1280, every key valid)
// 13 is 8 * 64 * 1280^2 * 128 = 107 GFLOP, 0.1086 ms at 989 TFLOP/s, 11 and 12
// 6 * 64 * 1280^2 * 128 = 80.5 GFLOP, 0.0814 ms, against 84-126 MB (0.025-
// 0.038 ms at 3.35 TB/s), and 105 M exp2, half the D = 64 cores' for the
// same FLOPs: tensor-core bound.
//
// dk, dv (attn_dkv_d128_wgmma_kernel). What differs from the D = 64 core (as
// the forward core's D = 128 form differs from its D = 64 one, attn_wgmma.cuh):
//   spans     a 256-byte row of K, V, Q and dO lies as two 128-byte swizzle
//             spans, each tile TMA'd from one 3-D map over [H, n, 128] at
//             columns 0 and 64: the block's K is [span][128 keys][128 B], a
//             stage's Q tile [span][64 queries][128 B], the same for V, dO.
//   S^T, dP^T wgmma m64n64k16, eight k16 steps: span 0, then span 1.
//   dV, dK    N = 128 over both spans of the tile: two m64n64k16 products a
//             k16 step, one a span, on the proven MN-major B
//             (wgmma_rs_n64_tb); dK and dV are each held as two 32-float
//             halves.
//   schedule  dK and dV alone are 128 floats a lane, so the D = 64 core's
//             cross-tile overlap (tile i's scores in flight with tile i - 1's
//             gradients) does not fit beside 64-query tiles. A warpgroup
//             issues tile i's S^T and dP^T in its turn, computes P^T and dS^T
//             as they land, then issues tile i's dV and dK in a second turn
//             and waits for them: the exponentials hide under the other
//             warpgroup's products (ping-pong), not under its own.
//   trial     two forms were built and timed under one timer at the training
//             shape (chip_smoke.py --phases 1,2 of a build that had both;
//             NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6), neither
//             spilling, registers as scripts/sass_registers.py reads them
//             from the SASS (ptxas -v gives the launch share, 168):
//             (i)  64-query tiles without the cross-tile overlap, as above:
//                  0.1824-0.1829 ms, 220 registers. KEPT.
//             (ii) 32-query tiles (m64n32 S^T and dP^T, 16 + 16 floats,
//                  packed 8 + 8) with the D = 64 core's three-group overlap,
//                  eight stages: 0.1950-0.1953 ms, 200 registers.
//             Only (i) is built.
//   smem      K and V 64 KB; a stage is Q and dO (four spans of 64 rows) and
//             their lse and D, padded to 1024 bytes, 33 KB; four stages:
//             201,800 bytes in all (static_assert below).
//   epilogue  dK * 1/sqrt(128) and dV as bf16 through the warpgroup's own K
//             and V slices, both spans, then 16-byte row stores masked at n.
// Everything else is the D = 64 core's: one block per (folded head, 128
// keys), two consumer warpgroups of 64 keys and a producer warpgroup
// (setmaxnreg 40 / 232), K and V resident, Q and dO streamed through a
// full/empty mbarrier ring, lse and D copied into the stage by the producer
// warp with plain loads (an [H, n] fp32 row at n = 301 starts at no 16-byte
// boundary; a query at or past n gets lse +inf and D 0), keys at or past
// kv_len get P = 0, a block whose first key is at or past kv_len writes
// zeros, no atomics, P^T and dS^T rounded to bf16 only for their products,
// fp32 accumulation, ex2.approx.
//
// dq (attn_dq_d128_wgmma_kernel<kLseOut>: kernel 11, and 12 with kLseOut):
// the D = 64 dq core's function and schedule, with 13's products with Q and
// K swapped:
//   block     one per (folded head, 128 queries): two consumer warpgroups of
//             64 queries and a producer warpgroup; setmaxnreg 40 / 232 (11),
//             24 / 240 (12, whose producer only issues TMA), as at D = 64.
//   spans     Q and dO resident, each [span][128 queries][128 B] (64 KB
//             together), by TMA at columns 0 and 64; K and V stream in 64-key
//             tiles, a stage [K span 0, K span 1, V span 0, V span 1], 32 KB,
//             through four stages: 197,704 bytes in all (static_assert). A
//             128-key tile fits two stages only, which the D = 64 trial found
//             31% slower (attn_bwd_wgmma.cuh).
//   S, dP     b128_issue_scores: m64n64k16, eight k16 steps, A the warpgroup's
//             Q (dO) slice in its two spans, B the K (V) tile's two spans.
//   dq        b128_issue_grad: dS from registers (attn_pack_p<64>), the K tile
//             MN-major over both spans, two m64n64k16 products a k16 step;
//             dq as two 32-float halves.
//   schedule  registers allow what 13 at D = 128 could not: the D = 64 dq
//             core's cross-tile overlap. Tile i's S and dP, then tile i - 1's
//             dq += dS.K, as three groups in the warpgroup's turn
//             (ping-pong); P when S lands, dS when dP lands, and dS packed
//             once i - 1's product has landed, which also frees its stage. A
//             lane holds S 32, dP 32, dq 64 and the packed dS 16 floats (12
//             adds m, l and alpha). Kernel 12 multiplies dq by alpha only
//             after wait_group 0 has seen tile i - 1's product land, before
//             tile i's dS is packed (the other order is a silent race); its
//             running max is per 64-key tile where the TPU kernel keeps it
//             per chunk: the same function within the bf16 bounds
//             (attn_bwd_wgmma.cuh gives the reason).
//   masks     keys at or past kv_len get P = 0 in the last tile; a head with
//             kv_len 0 walks no tile and writes zero dq (12: lse 0); a query
//             at or past n gets P = 0 (11: lse +inf) and D 0 and is never
//             stored; lse and D are read with plain loads.
//   epilogue  dq * 1/sqrt(128) (12: / l, l = 0 read as 1, lse = m + log2(l))
//             as bf16 through the warpgroup's own Q slice, both spans, then
//             16-byte row stores masked at n. No atomics.
//   registers 191 (11) and 194 (12) a consumer thread as
//             scripts/sass_registers.py reads them from the SASS (ptxas -v
//             gives the launch share, 168), no spill, no C7513.
//   measured  at the training shape 0.1207 ms (11) and 0.1505 ms (12), 0.675
//             and 0.541 of the bound, against 0.4076 and 0.4580 ms on the
//             mma.sync kernel in the same process (chip_smoke.py --phases
//             1,2; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
#include "attn_bwd_wgmma.cuh"
#include "flash_prefix_d128.cuh"

namespace f5 {
namespace {

constexpr int kB128Keys = 64 * kBwdWgs;             // key rows a block
constexpr int kB128KSpan = kB128Keys * kRowBytes;   // one span of the block's K or V rows
constexpr int kB128Q = 64;                          // queries a streamed tile
constexpr int kB128QSpan = kB128Q * kRowBytes;      // one span of a Q or a dO tile
constexpr int kB128Stages = 4;                      // Q/dO ring depth
constexpr int kB128RowsOff = 4 * kB128QSpan;        // the tile's lse, then its D (fp32)
constexpr int kB128StageBytes = kB128RowsOff + 1024;  // stages stay 1024-byte aligned
constexpr int kB128SmemBytes =
    1024 + 4 * kB128KSpan + kB128Stages * kB128StageBytes + (2 * kB128Stages + 1) * 8;
static_assert(kB128SmemBytes <= kBlockSmemMax, "kernel 13's d = 128 ring does not fit a block");

// S^T = K.Q^T or dP^T = V.dO^T of one tile over the 128 columns: the A
// operand's spans at desc_a0, desc_a1, the B tile's at tile_b and tile_b +
// kB128QSpan, eight k16 steps (four a span), as one group
__device__ __forceinline__ void b128_issue_scores(float (&d)[32], uint64_t desc_a0,
                                                  uint64_t desc_a1, const unsigned char* tile_b) {
  const uint64_t db0 = wgmma_desc(tile_b), db1 = wgmma_desc(tile_b + kB128QSpan);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n64(d, (kk < 4 ? desc_a0 : desc_a1) + 2 * (kk & 3),
                 (kk < 4 ? db0 : db1) + 2 * (kk & 3), kk != 0);
  wgmma_commit();
}

// acc0 | acc1 (64 rows x 128) += A (64 rows x 64 bf16, fragments in
// registers) . B (the tile's 64 rows, MN-major, span 0 then span 1): dV +=
// P^T.dO and dK += dS^T.Q; no commit
__device__ __forceinline__ void b128_issue_grad(float (&acc0)[32], float (&acc1)[32],
                                                const uint32_t (&a)[4][4],
                                                const unsigned char* tile) {
  const uint64_t db0 = wgmma_desc_mn(tile), db1 = wgmma_desc_mn(tile + kB128QSpan);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_n64_tb(acc0, a[kk], db0 + 128 * kk, 1);
    wgmma_rs_n64_tb(acc1, a[kk], db1 + 128 * kk, 1);
  }
}

__global__ void __launch_bounds__(128 * (kBwdWgs + 1), 1)
attn_dkv_d128_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           const int* __restrict__ kv_lens, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int n, float scale_log2, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_k = smem;  // span 0 of the block's 128 key rows, then span 1
  unsigned char* s_v = smem + 2 * kB128KSpan;
  unsigned char* ring = smem + 4 * kB128KSpan;  // a stage: Q spans, dO spans, lse, D
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kB128Stages * kB128StageBytes);
  uint64_t* empty = full + kB128Stages;
  uint64_t* kv_full = empty + kB128Stages;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kB128Keys;
  const int kv_len = min(kv_lens[head], n);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t off = (size_t)head * n * 128;

  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients, no query walked
    for (int i = tid; i < kB128Keys * 16; i += 128 * (kBwdWgs + 1)) {
      const int r = k0 + (i >> 4), c = i & 15;
      if (r < n) {
        *reinterpret_cast<int4*>(dk + off + (size_t)r * 128 + 8 * c) = make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(dv + off + (size_t)r * 128 + 8 * c) = make_int4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int q_tiles = (n + kB128Q - 1) / kB128Q;

  if (tid == 0) {
    for (int s = 0; s < kB128Stages; ++s) {
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
        mbar_arrive_expect_tx(kv_full, 4 * kB128KSpan);
        tma_load_3d(s_k, &map_k, kv_full, 0, k0, head);
        tma_load_3d(s_k + kB128KSpan, &map_k, kv_full, 64, k0, head);
        tma_load_3d(s_v, &map_v, kv_full, 0, k0, head);
        tma_load_3d(s_v + kB128KSpan, &map_v, kv_full, 64, k0, head);
      }
      const float* lse_h = lse + (size_t)head * n;
      const float* d_h = dvec + (size_t)head * n;
      for (int i = 0; i < q_tiles; ++i) {
        const int s = i % kB128Stages;
        mbar_wait(&empty[s], ((i / kB128Stages) & 1) ^ 1);  // passes at once on the first round
        unsigned char* stage = ring + s * kB128StageBytes;
        float* rows = reinterpret_cast<float*>(stage + kB128RowsOff);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * lane + e, qrow = i * kB128Q + c;
          rows[c] = qrow < n ? lse_h[qrow] : INFINITY;
          rows[kB128Q + c] = qrow < n ? d_h[qrow] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 4 * kB128QSpan);
          tma_load_3d(stage, &map_q, &full[s], 0, i * kB128Q, head);
          tma_load_3d(stage + kB128QSpan, &map_q, &full[s], 64, i * kB128Q, head);
          tma_load_3d(stage + 2 * kB128QSpan, &map_do, &full[s], 0, i * kB128Q, head);
          tma_load_3d(stage + 3 * kB128QSpan, &map_do, &full[s], 64, i * kB128Q, head);
        } else {
          mbar_arrive(&full[s]);  // releases this lane's lse and D stores
        }
      }
    }
  } else {
    // 128 x 40 + 256 x 232 = 64,512 of the block's 65,536 registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + wg * 64;          // this warpgroup's first key
    const int row = (warp & 3) * 16 + g;   // this lane's keys: wk0 + row, wk0 + row + 8
    const bool mask = wk0 + 64 > kv_len;   // warpgroup-uniform
    const bool valid[2] = {wk0 + row < kv_len, wk0 + row + 8 < kv_len};
    unsigned char* my_k = s_k + wg * 64 * kRowBytes;  // span 0 of this warpgroup's rows
    unsigned char* my_v = s_v + wg * 64 * kRowBytes;
    const uint64_t desc_k0 = wgmma_desc(my_k), desc_k1 = wgmma_desc(my_k + kB128KSpan);
    const uint64_t desc_v0 = wgmma_desc(my_v), desc_v1 = wgmma_desc(my_v + kB128KSpan);
    float dk0[32], dk1[32], dv0[32], dv1[32];  // columns 0-63 and 64-127
#pragma unroll
    for (int i = 0; i < 32; ++i) dk0[i] = dk1[i] = dv0[i] = dv1[i] = 0.f;
    float s[32], dp[32];
    uint32_t p[4][4], ds[4][4];
    mbar_wait(kv_full, 0);
    if (wg == kBwdWgs - 1) bwd_turn_pass(wg);  // warpgroup 0 starts

    // a tile's scores, then its gradients, each in a turn of its own
    for (int i = 0; i < q_tiles; ++i) {
      const int st = i % kB128Stages;
      unsigned char* stage = ring + st * kB128StageBytes;
      const float* rows = reinterpret_cast<const float*>(stage + kB128RowsOff);
      mbar_wait(&full[st], (i / kB128Stages) & 1);
      bwd_turn_wait(wg);
      wgmma_fence();
      b128_issue_scores(s, desc_k0, desc_k1, stage);                     // S^T
      b128_issue_scores(dp, desc_v0, desc_v1, stage + 2 * kB128QSpan);   // dP^T
      bwd_turn_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_regs(s);
      bwd_probs(s, rows, scale_log2, t, mask, valid);
      wgmma_wait<0>();
      wgmma_fence_regs(dp);
      bwd_dscores(dp, s, rows + kB128Q, t);
      attn_pack_p<kB128Q>(s, p);
      attn_pack_p<kB128Q>(dp, ds);
      bwd_turn_wait(wg);
      wgmma_fence();
      b128_issue_grad(dv0, dv1, p, stage + 2 * kB128QSpan);  // dV += P^T.dO
      b128_issue_grad(dk0, dk1, ds, stage);                  // dK += dS^T.Q
      wgmma_commit();
      // the last turn: nobody waits on warpgroup 0's
      if (i + 1 < q_tiles || wg != kBwdWgs - 1) bwd_turn_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_regs(dk0);
      wgmma_fence_regs(dk1);
      wgmma_fence_regs(dv0);
      wgmma_fence_regs(dv1);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: dK and dV through this warpgroup's K and V slices, both spans
    // (its last products are done), then whole rows, masked at n
    bwd_stage_rows(my_k, dk0, sm_scale, row, g, t);
    bwd_stage_rows(my_k + kB128KSpan, dk1, sm_scale, row, g, t);
    bwd_stage_rows(my_v, dv0, 1.f, row, g, t);
    bwd_stage_rows(my_v + kB128KSpan, dv1, 1.f, row, g, t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int i = wt + 128 * it, r = i >> 4, c = i & 15;  // 16 chunks of 16 bytes a row
      const int grow = wk0 + r;
      if (grow < n) {
        const int src = (c >> 3) * kB128KSpan + r * kRowBytes + (((c & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<int4*>(dk + off + (size_t)grow * 128 + 8 * c) =
            *reinterpret_cast<const int4*>(my_k + src);
        *reinterpret_cast<int4*>(dv + off + (size_t)grow * 128 + 8 * c) =
            *reinterpret_cast<const int4*>(my_v + src);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels 11 and 12 at D = 128: dq, from the forward's lse or recomputing it
// ---------------------------------------------------------------------------

constexpr int kQ128Rows = 64 * kDqWgs;              // query rows a block
constexpr int kQ128Span = kQ128Rows * kRowBytes;    // one span of the block's Q or dO rows
constexpr int kQ128Keys = 64;                       // keys a K/V tile
constexpr int kQ128KSpan = kQ128Keys * kRowBytes;   // one span of a K or a V tile
constexpr int kQ128Stages = 4;                      // K/V ring depth
constexpr int kQ128StageBytes = 4 * kQ128KSpan;     // K's two spans, then V's
constexpr int kQ128SmemBytes =
    1024 + 4 * kQ128Span + kQ128Stages * kQ128StageBytes + (2 * kQ128Stages + 1) * 8;
static_assert(kQ128SmemBytes <= kBlockSmemMax, "the d = 128 dq ring does not fit a block");
static_assert(kQ128KSpan == kB128QSpan, "b128_issue_* find a tile's second span kB128QSpan on");

// kLseOut false: kernel 11, lse read; true: kernel 12, lse recomputed and
// written to lse_out
template <bool kLseOut>
__global__ void __launch_bounds__(128 * (kDqWgs + 1), 1)
attn_dq_d128_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                          float* __restrict__ lse_out, int n, float scale_log2, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_q = smem;                   // span 0 of the block's 128 query rows, then span 1
  unsigned char* s_do = smem + 2 * kQ128Span;
  unsigned char* ring = smem + 4 * kQ128Span;  // a stage: K spans, V spans
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kQ128Stages * kQ128StageBytes);
  uint64_t* empty = full + kQ128Stages;
  uint64_t* qd_full = empty + kQ128Stages;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kQ128Rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t off = (size_t)head * n * 128;

  if (tid == 0) {
    for (int s = 0; s < kQ128Stages; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrive; TMA counts the bytes
      mbar_init(&empty[s], 4 * kDqWgs);  // lane 0 of every consumer warp
    }
    mbar_init(qd_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // registers as the D = 64 form's: 40 / 232 (11), 24 / 240 (12)
  if (warp >= 4 * kDqWgs) {
    if constexpr (kLseOut) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // read after setmaxnreg: a value live across it is spilled
    const int kv_len = min(kv_lens[head], n);
    const int n_tiles = kv_len > 0 ? (kv_len + kQ128Keys - 1) / kQ128Keys : 0;
    if (tid == 128 * kDqWgs) {
      mbar_arrive_expect_tx(qd_full, 4 * kQ128Span);
      tma_load_3d(s_q, &map_q, qd_full, 0, q0, head);
      tma_load_3d(s_q + kQ128Span, &map_q, qd_full, 64, q0, head);
      tma_load_3d(s_do, &map_do, qd_full, 0, q0, head);
      tma_load_3d(s_do + kQ128Span, &map_do, qd_full, 64, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kQ128Stages;
        mbar_wait(&empty[s], ((j / kQ128Stages) & 1) ^ 1);  // passes at once on the first round
        unsigned char* stage = ring + s * kQ128StageBytes;
        mbar_arrive_expect_tx(&full[s], kQ128StageBytes);
        tma_load_3d(stage, &map_k, &full[s], 0, j * kQ128Keys, head);
        tma_load_3d(stage + kQ128KSpan, &map_k, &full[s], 64, j * kQ128Keys, head);
        tma_load_3d(stage + 2 * kQ128KSpan, &map_v, &full[s], 0, j * kQ128Keys, head);
        tma_load_3d(stage + 3 * kQ128KSpan, &map_v, &full[s], 64, j * kQ128Keys, head);
      }
    }
  } else {
    if constexpr (kLseOut) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int kv_len = min(kv_lens[head], n);
    const int n_tiles = kv_len > 0 ? (kv_len + kQ128Keys - 1) / kQ128Keys : 0;
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row = (warp & 3) * 16 + g;  // this lane's queries: row, row + 8 of the warpgroup's
    unsigned char* my_q = s_q + wg * 64 * kRowBytes;  // span 0 of this warpgroup's rows
    unsigned char* my_do = s_do + wg * 64 * kRowBytes;
    const uint64_t desc_q0 = wgmma_desc(my_q), desc_q1 = wgmma_desc(my_q + kQ128Span);
    const uint64_t desc_do0 = wgmma_desc(my_do), desc_do1 = wgmma_desc(my_do + kQ128Span);
    float neg_lse[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int grow = q0 + wg * 64 + row + 8 * r;
      if constexpr (!kLseOut) neg_lse[r] = grow < n ? -lse[(size_t)head * n + grow] : -INFINITY;
      dd[r] = grow < n ? dvec[(size_t)head * n + grow] : 0.f;
    }
    // kernel 12: the running max and this lane's share of the row sums
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
    float acc0[32], acc1[32];  // dq columns 0-63 and 64-127
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    mbar_wait(qd_full, 0);
    if (n_tiles > 0) {
      float s[32], dp[32];
      uint32_t ds[4][4];
      mbar_wait(&full[0], 0);
      if (wg == kDqWgs - 1) bwd_turn_pass(wg);  // warpgroup 0 starts
      bwd_turn_wait(wg);
      wgmma_fence();
      b128_issue_scores(s, desc_q0, desc_q1, ring);                     // S
      b128_issue_scores(dp, desc_do0, desc_do1, ring + 2 * kQ128KSpan);  // dP
      bwd_turn_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_regs(s);
      if constexpr (kLseOut)
        dq_probs_online<kQ128Keys>(s, m_run, l_run, alpha, scale_log2, 0, kv_len, t);
      else
        dq_probs<kQ128Keys>(s, neg_lse, scale_log2, 0, kv_len, t);
      wgmma_wait<0>();
      wgmma_fence_regs(dp);
      dq_ds<kQ128Keys>(dp, s, dd);
      attn_pack_p<kQ128Keys>(dp, ds);
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kQ128Stages, prev = (i - 1) % kQ128Stages;
        unsigned char* stage = ring + st * kQ128StageBytes;
        mbar_wait(&full[st], (i / kQ128Stages) & 1);
        bwd_turn_wait(wg);
        wgmma_fence();
        b128_issue_scores(s, desc_q0, desc_q1, stage);                      // S of tile i
        b128_issue_scores(dp, desc_do0, desc_do1, stage + 2 * kQ128KSpan);  // dP of tile i
        b128_issue_grad(acc0, acc1, ds, ring + prev * kQ128StageBytes);   // dq += dS.K of i - 1
        wgmma_commit();
        bwd_turn_pass(wg);
        wgmma_wait<2>();  // S of tile i is done; its dP and tile i - 1's product may run
        wgmma_fence_regs(s);
        if constexpr (kLseOut)
          dq_probs_online<kQ128Keys>(s, m_run, l_run, alpha, scale_log2, i * kQ128Keys, kv_len, t);
        else
          dq_probs<kQ128Keys>(s, neg_lse, scale_log2, i * kQ128Keys, kv_len, t);
        wgmma_wait<1>();
        wgmma_fence_regs(dp);
        dq_ds<kQ128Keys>(dp, s, dd);
        wgmma_wait<0>();
        wgmma_fence_regs(acc0);
        wgmma_fence_regs(acc1);
        if (lane == 0) mbar_arrive(&empty[prev]);
        if constexpr (kLseOut) {
          // tile i - 1's product has landed: rescale to tile i's max before
          // tile i's dS (taken against it) is added
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            acc0[e] *= alpha[(e >> 1) & 1];
            acc1[e] *= alpha[(e >> 1) & 1];
          }
        }
        attn_pack_p<kQ128Keys>(dp, ds);
      }
      bwd_turn_wait(wg);
      wgmma_fence();
      b128_issue_grad(acc0, acc1, ds, ring + ((n_tiles - 1) % kQ128Stages) * kQ128StageBytes);
      wgmma_commit();
      if (wg != kDqWgs - 1) bwd_turn_pass(wg);  // the last turn: nobody waits on warpgroup 0's
      wgmma_wait<0>();
      wgmma_fence_regs(acc0);
      wgmma_fence_regs(acc1);
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
          acc0[4 * j + 2 * r] *= inv;
          acc0[4 * j + 2 * r + 1] *= inv;
          acc1[4 * j + 2 * r] *= inv;
          acc1[4 * j + 2 * r + 1] *= inv;
        }
        const int grow = q0 + wg * 64 + row + 8 * r;
        if (t == 0 && grow < n)
          lse_out[(size_t)head * n + grow] = l > 0.f ? m_run[r] + log2f(l) : 0.f;
      }
    }
    // epilogue: dq through this warpgroup's Q slice, both spans (its products
    // are done), then whole rows, masked at n
    bwd_stage_rows(my_q, acc0, sm_scale, row, g, t);
    bwd_stage_rows(my_q + kQ128Span, acc1, sm_scale, row, g, t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int i = wt + 128 * it, r = i >> 4, c = i & 15;  // 16 chunks of 16 bytes a row
      const int grow = q0 + wg * 64 + r;
      if (grow < n)
        *reinterpret_cast<int4*>(dq + off + (size_t)grow * 128 + 8 * c) =
            *reinterpret_cast<const int4*>(my_q + (c >> 3) * kQ128Span + r * kRowBytes +
                                           (((c & 7) ^ (r & 7)) << 4));
    }
  }
}

template <bool kLseOut>
cudaError_t launch_dq_d128(const void* q, const void* k, const void* v, const void* dout,
                           const void* dvec, const void* lse, const void* kv_lens, void* dq,
                           void* lse_out, int H, int n, float scale_log2, float sm_scale,
                           cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tensor_map_3d(&map_q, q, H, n, 128, kQ128Rows, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, 128, kQ128Keys, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, 128, kQ128Keys, kMapBf16) ||
      !tensor_map_3d(&map_do, dout, H, n, 128, kQ128Rows, kMapBf16))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_dq_d128_wgmma_kernel<kLseOut>, kQ128SmemBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQ128Rows - 1) / kQ128Rows, H);
  attn_dq_d128_wgmma_kernel<kLseOut><<<grid, 128 * (kDqWgs + 1), kQ128SmemBytes, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_lens), static_cast<bf16*>(dq),
      static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

}  // namespace

namespace d128 {

// q, k, v, dout, dk, dv: [H, n, 128] bf16, 16-byte aligned; dvec, lse: [H, n]
// fp32 (any alignment: they are read by plain loads); kv_lens [H] int32
cudaError_t core_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* dvec, const void* lse, const void* kv_lens, void* dk, void* dv,
                     int H, int n, float scale_log2, float sm_scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tensor_map_3d(&map_q, q, H, n, 128, kB128Q, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, 128, kB128Keys, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, 128, kB128Keys, kMapBf16) ||
      !tensor_map_3d(&map_do, dout, H, n, 128, kB128Q, kMapBf16))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_dkv_d128_wgmma_kernel, kB128SmemBytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kB128Keys - 1) / kB128Keys, H);
  attn_dkv_d128_wgmma_kernel<<<grid, 128 * (kBwdWgs + 1), kB128SmemBytes, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<const int*>(kv_lens), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

// kernels 11 (online false: lse_in read) and 12 (online: lse_out written) in
// bf16. q, k, v, dout, dq: [H, n, 128] bf16, 16-byte aligned; dvec, lse_in,
// lse_out: [H, n] fp32 (any alignment); kv_lens [H] int32
cudaError_t core_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                    void* lse_out, int H, int n, float scale_log2, float sm_scale, bool online,
                    cudaStream_t stream) {
  return online ? launch_dq_d128<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                       scale_log2, sm_scale, stream)
                : launch_dq_d128<false>(q, k, v, dout, dvec, lse_in, kv_lens, dq, nullptr, H, n,
                                        scale_log2, sm_scale, stream);
}

}  // namespace d128
}  // namespace f5

// Kernel 13 (dk and dv of prefix attention) at head dim 128 in bf16, for
// Hopper (sm_90a): the D = 128 form of the TMA + wgmma attention backward
// core (attn_bwd_wgmma.cuh, whose pieces it is built from).
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/flash_prefix.py:
// _flash_prefix_dkv -> _kernel_dkv (cast=True) at d = 128, which the JAX
// dispatch takes at d in (64, 128) (ops/attention.py:260, :296). The function
// is the D = 64 core's (attn_bwd_wgmma.cuh) on folded heads [H, n, 128],
// dK *= 1/sqrt(128). Its entry point is f5_flash_prefix_dkv
// (flash_prefix_train.cu) at d = 128 on bf16 operands, through
// d128::core_dkv; the fp32 form runs on split 3xTF32
// (flash_prefix_train_tf32_d128.cu). It replaces the first port's mma.sync
// kernel (flash_prefix_d128.cu: flash_prefix_dkv_d128_kernel, 128 threads
// over 64 keys, K and V resident, 64-query tiles of Q and dO loaded
// synchronously with two barriers a tile, at 255 registers), which no path
// runs any more: f5_flash_prefix_d128_bwd_mma keeps it for timing.
//
// What bounds it: at the training shape (H 64, n 1280, every key valid)
// 8 * 64 * 1280^2 * 128 = 107 GFLOP, 0.1086 ms at 989 TFLOP/s, against 126 MB
// (0.038 ms at 3.35 TB/s), and 105 M exp2, half the D = 64 core's for the
// same FLOPs: tensor-core bound.
//
// What differs from the D = 64 core (as the forward core's D = 128 form
// differs from its D = 64 one, attn_wgmma.cuh):
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
//             201,800 bytes in all (static_assert in the launcher).
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

}  // namespace d128
}  // namespace f5

// Probes of the three idioms of the mma.sync rope loop that kernels 18 and 19
// first ran on (flash_prefix.cuh's strided and rope loaders; both now run on
// attn_wgmma.cuh's rope form), one tiny kernel each, run by
// scripts/probe_hopper.py against two lines of torch. Counterpart of
// the TPU package's scripts/probe_mosaic.py, which probes the Mosaic
// lowering of the same three idioms (a half-slice product, two halves written
// side by side, the half swap) for _kernel_qkv.
// Each launch is one 128-thread block on 64 rows.
//
// Three more probes hold the idioms of the TMA + wgmma product core
// (gemm_bf16.cuh) before the whole kernel is trusted: a TMA tile load into
// 128-byte-swizzled shared memory signalled on an mbarrier, wgmma with both
// operands from swizzled shared-memory descriptors, and wgmma with the A
// operand computed in registers from an ldmatrix read of a swizzled tile.
// A seventh entry point runs kernel 8's product at a forced output tile
// width, so that the tile cost gemm_tile_n() weighs waves with can be timed.
//
// The int8 core (gemm_int8.cuh) rests on the same layout with 8-bit
// elements: an int8 TMA box (128 int8 a 128-byte row) lands swizzled like a
// bf16 one (probe (4) with an int8 tensor map), and wgmma m64nNk32
// .s32.s8.s8 with both operands read through shared-memory descriptors,
// four k32 steps of one 128-deep stage, the descriptor advancing 32 bytes a
// step (probe (7), N = 128 and 256). f5_tile_width says which width
// gemm_tile_n() picks for a product, so that a test can cover both.
//
// The attention core (attn_wgmma.cuh) adds two idioms: a 3-D tensor map over
// folded heads [H, n, 64], whose box stops at a head's last row with zeros
// and never reads the next head (probe (8)); and O = P.V with P an m64n128
// accumulator rounded to bf16 into A fragments in registers and V [128][64]
// an MN-major operand read through a transposed-B descriptor (probe (9)):
// the form nothing else of the port used before and the likeliest place for
// a silent error.
//
// The rope form of the attention core (attn_wgmma.cuh, kernel 19) adds two:
// a strided 4-D tensor map over one head's 64 columns of a fused qkv array,
// whose box equals the torch slice and stops at row n with zeros, never
// reading the next item (probe (11)); and the rotation applied in shared
// memory to TMA-landed swizzled q and K tiles (partners at chunks p and p ^
// 4; K's table rows landed by TMA beside it), made visible to wgmma by
// fence.proxy.async, then S = q.K^T (probe (12)): the rotated tile must be
// the torch-rotated rows swizzled, to the bit, and S their product.
//
// The split-head rope form (kernel 18) reads [B, heads, n, 64] through the
// same 4-D map with slot stride n * 64 and row stride 64: the box of head g
// of item b must equal the torch slice and stop at row n (probe (11) with
// split_heads). The int8 form of the attention core (kernel 14) adds three
// (probe (13)): S = q8.k8^T on wgmma .s32.s8.s8 from int8 tiles whose 64-byte
// rows TMA fills to the core's 128-byte boxes with zeros (and past the
// head's row n); wgmma m64n64k32 .s32.s8.s8 with the 8-bit A operand from
// registers in mma.m16n8k32's fragment layout; and p8 = rint(127 p) packed
// from the m64n128 score accumulator's positions into those fragments
// against v8 in kernel 14's slot permutation, which must give the product
// in natural key order.
//
// The attention backward core (attn_bwd_wgmma.cuh) adds the 64-wide score
// product: wgmma m64n64k16 with both operands read through k-major
// shared-memory descriptors (wgmma_ss_n64, as S^T = K.Q^T over a 64-query
// tile), and that m64n64 accumulator rounded to bf16 into A fragments for a
// product with an MN-major 64-row tile (dV += P^T.dO) (probe (10)).
// The fp32 product core (gemm_f32.cuh: the fp32 forms of B, 7 and 8) adds
// wgmma m64n128k8 .tf32 over an fp32 tile that TMA lands through an fp32
// map (probe (4) with an fp32 box: 32 fp32 a 128-byte row), with both
// operands through descriptors and with A from registers by ldmatrix of 32-bit
// words, which shows how .tf32 reads a raw fp32 word (its low 13 bits
// dropped, or rounded); and the split 3xTF32 product of that core, B split
// into a hi tile in place and a lo tile beside it by the block's threads and
// fenced for the async proxy, A split in registers (probe (14)). Probe (15)
// measures the tensor cores' fp32 accumulation itself: a chain of products
// that each add three quarters of an ulp to an accumulator of 1, on
// mma.sync m16n8k8 .tf32 (the fp32 attention kernels) and on wgmma .tf32;
// rounded to nearest each adds an ulp, truncated none.
#include "attn_bwd_wgmma.cuh"
#include "flash_prefix.cuh"
#include "gemm_int8.cuh"

namespace f5 {
namespace {

// (1) a 64-column slice of a wider row-major array as an mma operand:
// out[64, 64] fp32 = x[:, cx : cx + 64] . y[:, cy : cy + 64]^T
__global__ void __launch_bounds__(kThreads)
probe_slice_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                       float* __restrict__ out, int ld, int cx, int cy) {
  __shared__ __align__(16) bf16 sX[64 * kLD];
  __shared__ __align__(16) bf16 sY[64 * kLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  load_rows_strided(sX, x + cx, ld, 0, 64, tid);
  load_rows_strided(sY, y + cy, ld, 0, 64, tid);
  __syncthreads();
  uint32_t a[kD / 16][4];
  load_a_frags<kD>(a, sX, warp, lane);
  float s[kNS][4];
  mma_abt<kD>(s, a, sY, lane);
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNS; ++nt) {
    const int col = nt * 8 + 2 * t;
    out[row * 64 + col] = s[nt][0];
    out[row * 64 + col + 1] = s[nt][1];
    out[(row + 8) * 64 + col] = s[nt][2];
    out[(row + 8) * 64 + col + 1] = s[nt][3];
  }
}

// (2) two heads' results stored side by side into one merged row:
// out[64, 128] bf16, out[:, g * 64 : (g + 1) * 64] = q[g] . k[g]^T for the
// two heads g of q, k [2, 64, 64]
__global__ void __launch_bounds__(kThreads)
probe_pair_store_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 sQ[64 * kLD];
  __shared__ __align__(16) bf16 sK[64 * kLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float one[2] = {1.f, 1.f};
  for (int g = 0; g < 2; ++g) {
    __syncthreads();
    load_rows_strided(sQ, q + g * 64 * kD, kD, 0, 64, tid);
    load_rows_strided(sK, k + g * 64 * kD, kD, 0, 64, tid);
    __syncthreads();
    uint32_t a[kD / 16][4];
    load_a_frags<kD>(a, sQ, warp, lane);
    float s[kNS][4];
    mma_abt<kD>(s, a, sK, lane);
    store_output_rows<kNS>(out + g * 64, 128, s, one, warp * 16 + (lane >> 2), 64, lane & 3);
  }
}

// (3) the half swap inside a 64-wide head: out[64, 64] bf16 = rope(x) with
// cos, sin [64, 32], through the loader kernels 18 and 19 stage rows with
__global__ void __launch_bounds__(kThreads)
probe_half_swap_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cos,
                       const bf16* __restrict__ sin, bf16* __restrict__ out, int ld) {
  __shared__ __align__(16) bf16 sX[64 * kLD];
  const int tid = threadIdx.x;
  load_rows_rope(sX, x, ld, 0, 64, cos, sin, tid);
  __syncthreads();
  for (int i = tid; i < 64 * kD; i += kThreads) out[i] = sX[(i / kD) * kLD + i % kD];
}

// one thread arms the barrier and asks for the tiles (64 rows of A, b_rows
// of B); every thread waits
__device__ __forceinline__ void probe_load(unsigned char* tile_a, const CUtensorMap* map_a,
                                           unsigned char* tile_b, const CUtensorMap* map_b,
                                           uint64_t* bar, int col, int row_a, int row_b,
                                           int b_rows) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 + (tile_b ? b_rows : 0)) * kRowBytes);
    tma_load_2d(tile_a, map_a, bar, col, row_a);
    if (tile_b) tma_load_2d(tile_b, map_b, bar, col, row_b);
  }
  mbar_wait(bar, 0);
}

// (4) a box of 64 rows x 128 bytes (64 bf16, 128 int8 or 32 fp32) at (row,
// col) of x, by TMA; raw: the 8 KB of shared memory as they lie (row r,
// 16-byte chunk c at chunk c ^ (r & 7))
__global__ void __launch_bounds__(kThreads)
probe_tma_kernel(const __grid_constant__ CUtensorMap map, unsigned char* __restrict__ raw,
                 int row, int col) {
  __shared__ __align__(1024) unsigned char tile[64 * kRowBytes];
  __shared__ uint64_t bar;
  probe_load(tile, &map, nullptr, nullptr, &bar, col, row, 0, 0);
  for (int i = threadIdx.x; i < 64 * kRowBytes / 16; i += kThreads)
    reinterpret_cast<int4*>(raw)[i] = reinterpret_cast<const int4*>(tile)[i];
}

// (5), (6) out[64, 128] fp32 = A . B^T over k = 64 for A = x[0:64, 0:64] (5)
// or A = bf16(2 x + 1) formed in registers (6), B = y[0:128, 0:64]
template <bool kRegisterA>
__global__ void __launch_bounds__(kThreads)
probe_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_y, float* __restrict__ out) {
  __shared__ __align__(1024) unsigned char tile_a[64 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_b[128 * kRowBytes];
  __shared__ uint64_t bar;
  probe_load(tile_a, &map_x, tile_b, &map_y, &bar, 0, 0, 0, 128);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a[kTileK / 16][4];
  if (kRegisterA) {
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t x[4];
      ldmatrix_x4(x, swz_chunk_addr(tile_a, warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16x2(2.f * __uint_as_float(x[r] << 16) + 1.f,
                               2.f * __uint_as_float(x[r] & 0xffff0000u) + 1.f);
    }
  }
  const uint64_t da = wgmma_desc(tile_a), db = wgmma_desc(tile_b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    if (kRegisterA) wgmma_rs_n128(acc, a[kk], db + 2 * kk, kk != 0);
    else wgmma_ss_n128(acc, da + 2 * kk, db + 2 * kk, kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    out[row * 128 + col] = acc[4 * j];
    out[row * 128 + col + 1] = acc[4 * j + 1];
    out[(row + 8) * 128 + col] = acc[4 * j + 2];
    out[(row + 8) * 128 + col + 1] = acc[4 * j + 3];
  }
}

// (7) out[64, N] s32 = x[0:64, 0:128] . y[0:N, 0:128]^T, int8 operands, four
// k32 steps
template <int N>
__global__ void __launch_bounds__(kThreads)
probe_wgmma_i8_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_y, int* __restrict__ out) {
  __shared__ __align__(1024) unsigned char tile_a[64 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_b[N * kRowBytes];
  __shared__ uint64_t bar;
  probe_load(tile_a, &map_x, tile_b, &map_y, &bar, 0, 0, 0, N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  const uint64_t da = wgmma_desc(tile_a), db = wgmma_desc(tile_b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK8 / 32; ++kk) {
    if constexpr (N == 256) wgmma_ss_s8_n256(acc, da + 2 * kk, db + 2 * kk, kk != 0);
    else wgmma_ss_s8_n128(acc, da + 2 * kk, db + 2 * kk, kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t;
    out[row * N + col] = acc[4 * j];
    out[row * N + col + 1] = acc[4 * j + 1];
    out[(row + 8) * N + col] = acc[4 * j + 2];
    out[(row + 8) * N + col + 1] = acc[4 * j + 3];
  }
}

// (8) a box of 64 rows x 64 bf16 at (row, plane) of a 3-D map over [planes,
// rows, 64]; raw: the 8 KB of shared memory as they lie
__global__ void __launch_bounds__(kThreads)
probe_tma_3d_kernel(const __grid_constant__ CUtensorMap map, unsigned char* __restrict__ raw,
                    int row, int plane) {
  __shared__ __align__(1024) unsigned char tile[64 * kRowBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * kRowBytes);
    tma_load_3d(tile, &map, &bar, 0, row, plane);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < 64 * kRowBytes / 16; i += kThreads)
    reinterpret_cast<int4*>(raw)[i] = reinterpret_cast<const int4*>(tile)[i];
}

// (9) out[64, 64] fp32 = P . V for P [64, 128] bf16 (read into the m64n128
// accumulator layout as the attention core's S would lie, then packed by
// attn_pack_p) and V [128, 64] bf16 by TMA, through attn_issue_pv
__global__ void __launch_bounds__(kThreads)
probe_pv_kernel(const bf16* __restrict__ p_in, const __grid_constant__ CUtensorMap map_v,
                float* __restrict__ out) {
  __shared__ __align__(1024) unsigned char tile_v[kAttnKVBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, kAttnKVBytes);
    tma_load_2d(tile_v, &map_v, &bar, 0, 0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = warp * 16 + g;
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    s[i] = __bfloat162float(p_in[(row + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * t + (i & 1)]);
  uint32_t p[8][4];
  attn_pack_p<kAttnBK>(s, p);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(&bar, 0);
  wgmma_fence();
  attn_issue_pv(o, p, tile_v);
  wgmma_wait<0>();
  wgmma_fence_regs(o);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    out[row * 64 + col] = o[4 * j];
    out[row * 64 + col + 1] = o[4 * j + 1];
    out[(row + 8) * 64 + col] = o[4 * j + 2];
    out[(row + 8) * 64 + col + 1] = o[4 * j + 3];
  }
}

// (10) s[64, 64] fp32 = x . y^T over k = 64 (bwd_issue_scores: wgmma_ss_n64,
// both operands k-major), then g[64, 64] fp32 = bf16(s) . z with bf16(s) in
// registers (attn_pack_p<64>) and z [64, 64] an MN-major operand
// (bwd_issue_grad); x, y, z by TMA
__global__ void __launch_bounds__(kThreads)
probe_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_y,
                 const __grid_constant__ CUtensorMap map_z, float* __restrict__ s_out,
                 float* __restrict__ g_out) {
  __shared__ __align__(1024) unsigned char tiles[3 * 64 * kRowBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 3 * 64 * kRowBytes);
    tma_load_2d(tiles, &map_x, &bar, 0, 0);
    tma_load_2d(tiles + 64 * kRowBytes, &map_y, &bar, 0, 0);
    tma_load_2d(tiles + 128 * kRowBytes, &map_z, &bar, 0, 0);
  }
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
  float s[32], g[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) g[i] = 0.f;
  wgmma_fence();
  bwd_issue_scores(s, wgmma_desc(tiles), tiles + 64 * kRowBytes);
  wgmma_wait<0>();
  wgmma_fence_regs(s);
  uint32_t p[4][4];
  attn_pack_p<64>(s, p);
  wgmma_fence();
  bwd_issue_grad(g, p, tiles + 128 * kRowBytes);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(g);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    s_out[row * 64 + col] = s[4 * j];
    s_out[row * 64 + col + 1] = s[4 * j + 1];
    s_out[(row + 8) * 64 + col] = s[4 * j + 2];
    s_out[(row + 8) * 64 + col + 1] = s[4 * j + 3];
    g_out[row * 64 + col] = g[4 * j];
    g_out[row * 64 + col + 1] = g[4 * j + 1];
    g_out[(row + 8) * 64 + col] = g[4 * j + 2];
    g_out[(row + 8) * 64 + col + 1] = g[4 * j + 3];
  }
}

// (11) a box of 64 rows x 64 bf16 at (slot, row, item) of a strided 4-D map
// over a fused qkv array [items, rows, slots * 64]; raw: the 8 KB of shared
// memory as they lie
__global__ void __launch_bounds__(kThreads)
probe_tma_4d_kernel(const __grid_constant__ CUtensorMap map, unsigned char* __restrict__ raw,
                    int slot, int row, int item) {
  __shared__ __align__(1024) unsigned char tile[64 * kRowBytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * kRowBytes);
    tma_load_4d(tile, &map, &bar, slot, row, item);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < 64 * kRowBytes / 16; i += kThreads)
    reinterpret_cast<int4*>(raw)[i] = reinterpret_cast<const int4*>(tile)[i];
}

// (12) q rows [q0, q0 + 64) of slot 0 and K rows [k0, k0 + 128) of slot 1 of
// a fused qkv array [1, n, 3 * 64] by TMA (4-D maps), and the K rows' cos and
// sin by TMA beside them (unswizzled table maps), both tiles rotated in
// shared memory by attn_rope_tile as the kernel rotates them (q from the
// tables in device memory, K from the staged rows; rows past n stay zero),
// then s[64, 128] fp32 = q . K^T through attn_issue_qk (wgmma m64n128k16,
// both operands through descriptors); raw_k: the rotated K tile as shared
// memory holds it
__global__ void __launch_bounds__(kThreads)
probe_rope_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_cos,
                  const __grid_constant__ CUtensorMap map_sin, const bf16* __restrict__ cos,
                  const bf16* __restrict__ sin, int n, int q0, int k0, float* __restrict__ s_out,
                  unsigned char* __restrict__ raw_k) {
  __shared__ __align__(1024) unsigned char tile_q[64 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_k[kAttnKVBytes];
  __shared__ __align__(128) bf16 tab[2 * kAttnBK * 32];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * kRowBytes + kAttnKVBytes + 2 * kAttnTabBytes);
    tma_load_4d(tile_q, &map_q, &bar, 0, q0, 0);
    tma_load_4d(tile_k, &map_k, &bar, 1, k0, 0);
    tma_load_2d(tab, &map_cos, &bar, 0, k0);
    tma_load_2d(tab + kAttnBK * 32, &map_sin, &bar, 0, k0);
  }
  mbar_wait(&bar, 0);
  attn_rope_tile(tile_q, 64, q0, n, cos, sin, threadIdx.x, kThreads);
  attn_rope_tile_staged(smem_addr(tile_k), kAttnBK, k0, n, smem_addr(tab), kAttnTabBytes,
                        threadIdx.x, kThreads);
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
  float s[64];
  wgmma_fence();
  attn_issue_qk(s, wgmma_desc(tile_q), tile_k);
  wgmma_wait<0>();
  wgmma_fence_regs(s);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    s_out[row * 128 + col] = s[4 * j];
    s_out[row * 128 + col + 1] = s[4 * j + 1];
    s_out[(row + 8) * 128 + col] = s[4 * j + 2];
    s_out[(row + 8) * 128 + col + 1] = s[4 * j + 3];
  }
  for (int i = threadIdx.x; i < kAttnKVBytes / 16; i += kThreads)
    reinterpret_cast<int4*>(raw_k)[i] = reinterpret_cast<const int4*>(tile_k)[i];
}

// (13) the int8 attention core's pieces: S = q8[q0 : q0 + 64] . k8[0 : 128]^T
// (one head [1, n, 64] int8 through 3-D maps with 128-byte boxes: columns
// 64..127 and rows past n are zeros) into s_out [64, 128] int32; then pv =
// A . v8^T with v8 [64][128] int8 k-major from a 3-D map over [1, 64, 128]
// and A [64, 128] s8 either read as it is into mma.m16n8k32's A fragments
// (mode 0: a8) or packed by attn_pack_p8 from probabilities p [64, 128] at
// the score accumulator's positions (mode 1), into pv_out [64, 64] int32
__global__ void __launch_bounds__(kThreads)
probe_attn_i8_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const int8_t* __restrict__ a8,
                     const float* __restrict__ p, int mode, int q0, int* __restrict__ s_out,
                     int* __restrict__ pv_out) {
  __shared__ __align__(1024) unsigned char tile_q[64 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_k[kAttnBK * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_v[kAttnV8Bytes];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, (64 + kAttnBK) * kRowBytes + kAttnV8Bytes);
    tma_load_3d(tile_q, &map_q, &bar, 0, q0, 0);
    tma_load_3d(tile_k, &map_k, &bar, 0, 0, 0);
    tma_load_3d(tile_v, &map_v, &bar, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row = warp * 16 + (lane >> 2);
  int si[64];
  wgmma_fence();
  attn_issue_qk_s8(si, wgmma_desc(tile_q), tile_k);
  wgmma_wait<0>();
  wgmma_fence_regs(si);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    s_out[row * 128 + col] = si[4 * j];
    s_out[row * 128 + col + 1] = si[4 * j + 1];
    s_out[(row + 8) * 128 + col] = si[4 * j + 2];
    s_out[(row + 8) * 128 + col + 1] = si[4 * j + 3];
  }
  uint32_t frag[4][4];
  if (mode == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int8_t* r0 = a8 + row * 128 + 32 * kk + 4 * t;
      frag[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      frag[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128);
      frag[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      frag[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128 + 16);
    }
  } else {
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = p[(row + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * t + (i & 1)];
    attn_pack_p8(s, frag);
  }
  int pv[32] = {};  // attn_issue_pv_s8 adds to its accumulator (a chunk's tiles)
  wgmma_fence();
  attn_issue_pv_s8(pv, frag, tile_v);
  wgmma_wait<0>();
  wgmma_fence_regs(pv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    pv_out[row * 64 + col] = pv[4 * j];
    pv_out[row * 64 + col + 1] = pv[4 * j + 1];
    pv_out[(row + 8) * 64 + col] = pv[4 * j + 2];
    pv_out[(row + 8) * 64 + col + 1] = pv[4 * j + 3];
  }
}

// (14) out[64, 128] fp32 = A . B^T over k = 32 (four k8 steps) on wgmma
// m64n128k8 .tf32, A = x[0:64, 0:32] and B = y[0:128, 0:32] fp32 by TMA:
// kMode 0 both operands through descriptors as they landed, 1 A from
// registers by ldmatrix as it landed, 2 the split 3xTF32 product of
// gemm_f32.cuh (A split in registers, B split in shared memory, the small
// terms first)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
probe_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_y, float* __restrict__ out) {
  __shared__ __align__(1024) unsigned char tile_a[64 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_b[128 * kRowBytes];
  __shared__ __align__(1024) unsigned char tile_bl[128 * kRowBytes];
  __shared__ uint64_t bar;
  probe_load(tile_a, &map_x, tile_b, &map_y, &bar, 0, 0, 0, 128);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kMode == 2) {
    uint4* b = reinterpret_cast<uint4*>(tile_b);
    uint4* b_lo = reinterpret_cast<uint4*>(tile_bl);
    for (int i = threadIdx.x; i < 128 * kRowBytes / 16; i += kThreads) {
      const uint4 x = b[i];
      uint4 h, l;
      split_tf32(__uint_as_float(x.x), h.x, l.x);
      split_tf32(__uint_as_float(x.y), h.y, l.y);
      split_tf32(__uint_as_float(x.z), h.z, l.z);
      split_tf32(__uint_as_float(x.w), h.w, l.w);
      b[i] = h;
      b_lo[i] = l;
    }
    fence_proxy_async();
    __syncthreads();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t ah[4][4], al[4][4];
  if (kMode != 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t x[4];
      ldmatrix_x4(x, swz_chunk_addr(tile_a, warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kMode == 2) split_tf32(__uint_as_float(x[i]), ah[kk][i], al[kk][i]);
        else ah[kk][i] = x[i];
      }
    }
  }
  const uint64_t da = wgmma_desc(tile_a), db = wgmma_desc(tile_b), dbl = wgmma_desc(tile_bl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kMode == 0) wgmma_ss_tf32_n128(acc, da + 2 * kk, db + 2 * kk, kk != 0);
    if (kMode == 1) wgmma_rs_tf32_n128(acc, ah[kk], db + 2 * kk, kk != 0);
    if (kMode == 2) {
      wgmma_rs_tf32_n128(acc, al[kk], db + 2 * kk, kk != 0);
      wgmma_rs_tf32_n128(acc, ah[kk], dbl + 2 * kk, 1);
    }
  }
  if (kMode == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tf32_n128(acc, ah[kk], db + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  const int row = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    out[row * 128 + col] = acc[4 * j];
    out[row * 128 + col + 1] = acc[4 * j + 1];
    out[(row + 8) * 128 + col] = acc[4 * j + 2];
    out[(row + 8) * 128 + col + 1] = acc[4 * j + 3];
  }
}

// (15) every element of an accumulator of 1, then kAccSteps products that
// each add 1.5 * 2^-24 (three quarters of an ulp of 1): on mma.sync m16n8k8
// .tf32 (warp 0; out[0]) and on wgmma m64n128k8 .tf32 from registers
// (out[1]). A's column 0 is 1 and B's row k = 0 holds the small term, the
// rest zeros.
constexpr int kAccSteps = 32;

__global__ void __launch_bounds__(kThreads)
probe_tf32_accumulate_kernel(float* __restrict__ out) {
  __shared__ __align__(1024) float tile_b[128 * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const float small = 1.5f * 0x1p-24f;
  for (int i = threadIdx.x; i < 128 * 32; i += kThreads) tile_b[i] = 0.f;
  __syncthreads();
  // element k = 0 of row n: logical chunk 0 of the row sits at chunk n & 7
  for (int n = threadIdx.x; n < 128; n += kThreads) tile_b[n * 32 + ((n & 7) << 2)] = small;
  fence_proxy_async();
  __syncthreads();
  const uint32_t one = t == 0 ? __float_as_uint(1.f) : 0u;
  const uint32_t a[4] = {one, one, 0u, 0u};  // (g, 0), (g + 8, 0): column 0
  if (warp == 0) {
    float d[4] = {1.f, 1.f, 1.f, 1.f};
    const uint32_t b0 = t == 0 ? __float_as_uint(small) : 0u;  // (k = 0, n = g)
#pragma unroll
    for (int i = 0; i < kAccSteps; ++i) mma_tf32_1688(d, a, b0, 0u);
    if (lane == 0) out[0] = d[0];
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 1.f;
  const uint64_t db = wgmma_desc(tile_b);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kAccSteps; ++i) wgmma_rs_tf32_n128(acc, a, db, 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  if (threadIdx.x == 0) out[1] = acc[0];
}

}  // namespace
}  // namespace f5

// x, y, z: [64, 64] bf16; s, g: [64, 64] fp32 (probe (10))
extern "C" int f5_probe_bwd(const void* x, const void* y, const void* z, void* s, void* g,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_y, map_z;
  if (!f5::tensor_map(&map_x, x, 64, 64, 64, f5::kMapBf16) ||
      !f5::tensor_map(&map_y, y, 64, 64, 64, f5::kMapBf16) ||
      !f5::tensor_map(&map_z, z, 64, 64, 64, f5::kMapBf16))
    return (int)cudaErrorInvalidValue;
  f5::probe_bwd_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_y, map_z, static_cast<float*>(s), static_cast<float*>(g));
  return (int)cudaGetLastError();
}

// x: [planes, rows, 64] bf16; raw: the 8 KB box of 64 rows at (row, plane)
// as shared memory holds it; rows past the plane's last are zeros
extern "C" int f5_probe_tma_3d(const void* x, void* raw, int planes, int rows, int row, int plane,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  if (!f5::tensor_map_3d(&map, x, planes, rows, 64, 64, f5::kMapBf16))
    return (int)cudaErrorInvalidValue;
  f5::probe_tma_3d_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<unsigned char*>(raw), row, plane);
  return (int)cudaGetLastError();
}

// p: [64, 128], v: [128, 64] bf16; out: [64, 64] fp32
extern "C" int f5_probe_pv(const void* p, const void* v, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_v;
  if (!f5::tensor_map(&map_v, v, 128, 64, 128, f5::kMapBf16)) return (int)cudaErrorInvalidValue;
  f5::probe_pv_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(p), map_v, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x: [rows, cols] bf16 (type 0, cols % 8 == 0), int8 (type 1, cols % 16 ==
// 0) or fp32 (type 2, cols % 4 == 0); raw: the 8 KB box of 64 rows x 128
// bytes as shared memory holds it; the box starts at (row, col) and may hang
// over either edge
extern "C" int f5_probe_tma(const void* x, void* raw, int rows, int cols, int row, int col,
                            int type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const CUtensorMapDataType types[3] = {f5::kMapBf16, f5::kMapInt8, f5::kMapF32};
  CUtensorMap map;
  if (type < 0 || type > 2 || (cols * f5::map_elem_bytes(types[type])) % 16 ||
      !f5::tensor_map(&map, x, rows, cols, 64, types[type]))
    return (int)cudaErrorInvalidValue;
  f5::probe_tma_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<unsigned char*>(raw), row, col);
  return (int)cudaGetLastError();
}

// x: [64, 32], y: [128, 32] fp32; out: [64, 128] fp32; mode: probe (14)'s kMode
extern "C" int f5_probe_wgmma_tf32(const void* x, const void* y, void* out, int mode, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_y;
  if (mode < 0 || mode > 2 || !f5::tensor_map(&map_x, x, 64, 32, 64, f5::kMapF32) ||
      !f5::tensor_map(&map_y, y, 128, 32, 128, f5::kMapF32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == 0) f5::probe_wgmma_tf32_kernel<0><<<1, f5::kThreads, 0, s>>>(map_x, map_y, o);
  if (mode == 1) f5::probe_wgmma_tf32_kernel<1><<<1, f5::kThreads, 0, s>>>(map_x, map_y, o);
  if (mode == 2) f5::probe_wgmma_tf32_kernel<2><<<1, f5::kThreads, 0, s>>>(map_x, map_y, o);
  return (int)cudaGetLastError();
}

// out: [2] fp32, the two accumulators after probe (15)'s 32 steps
extern "C" int f5_probe_tf32_accumulate(void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  f5::probe_tf32_accumulate_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x: [64, 128], y: [n, 128] int8; out: [64, n] int32; n 128 or 256
extern "C" int f5_probe_wgmma_i8(const void* x, const void* y, void* out, int n, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_y;
  if ((n != 128 && n != 256) || !f5::tensor_map(&map_x, x, 64, 128, 64, f5::kMapInt8) ||
      !f5::tensor_map(&map_y, y, n, 128, n, f5::kMapInt8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (n == 256) f5::probe_wgmma_i8_kernel<256><<<1, f5::kThreads, 0, s>>>(map_x, map_y, o);
  else f5::probe_wgmma_i8_kernel<128><<<1, f5::kThreads, 0, s>>>(map_x, map_y, o);
  return (int)cudaGetLastError();
}

// the output tile width (128 or 256) the bf16 core (int8 == 0) or the int8
// core runs an [M, n] product with segments of seg_n columns at on this device
extern "C" int f5_tile_width(int M, int n, int seg_n, int int8, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  return int8 ? f5::gemm_tile_n(M, n, seg_n, f5::kI8NarrowCost10) : f5::gemm_tile_n(M, n, seg_n);
}

// x: [64, 64], y: [128, 64] bf16; out: [64, 128] fp32; register_a picks probe (6)
extern "C" int f5_probe_wgmma(const void* x, const void* y, void* out, int register_a, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_y;
  if (!f5::tensor_map(&map_x, x, 64, 64, 64, f5::kMapBf16) ||
      !f5::tensor_map(&map_y, y, 128, 64, 128, f5::kMapBf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (register_a)
    f5::probe_wgmma_kernel<true><<<1, f5::kThreads, 0, s>>>(map_x, map_y, static_cast<float*>(out));
  else
    f5::probe_wgmma_kernel<false><<<1, f5::kThreads, 0, s>>>(map_x, map_y, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// f5_proj_gated_fwd (fused_linears.cu) at the output tile width bn (128 or
// 256, d % bn == 0) instead of the one gemm_tile_n() picks
extern "C" int f5_probe_tile_width(const void* a, const void* h, const void* gate, const void* w,
                                   const void* b, void* out, int M, int din, int d, int bn,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::gemm_dims_ok(M, d, din) || (bn != 128 && bn != 256) || d % bn != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bn == 256 ? f5::launch_gated_residual_gemm<256>(a, w, b, h, gate, out, M, d, din, s)
                         : f5::launch_gated_residual_gemm<128>(a, w, b, h, gate, out, M, d, din, s));
}

// x, y: [64, ld] bf16; out: [64, 64] fp32; cx, cy: first columns, multiples of 8
extern "C" int f5_probe_slice_mma(const void* x, const void* y, void* out, int ld, int cx, int cy,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cx % 8 || cy % 8 || ld % 8 || cx + 64 > ld || cy + 64 > ld)
    return (int)cudaErrorInvalidValue;
  f5::probe_slice_mma_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(x), static_cast<const f5::bf16*>(y),
      static_cast<float*>(out), ld, cx, cy);
  return (int)cudaGetLastError();
}

// q, k: [2, 64, 64] bf16; out: [64, 128] bf16
extern "C" int f5_probe_pair_store(const void* q, const void* k, void* out, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  f5::probe_pair_store_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(q), static_cast<const f5::bf16*>(k),
      static_cast<f5::bf16*>(out));
  return (int)cudaGetLastError();
}

// x: [64, ld] bf16 (the head is its first 64 columns); cos, sin: [64, 32] bf16;
// out: [64, 64] bf16
extern "C" int f5_probe_half_swap(const void* x, const void* cos, const void* sin, void* out,
                                  int ld, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ld % 8 || ld < 64) return (int)cudaErrorInvalidValue;
  f5::probe_half_swap_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const f5::bf16*>(x), static_cast<const f5::bf16*>(cos),
      static_cast<const f5::bf16*>(sin), static_cast<f5::bf16*>(out), ld);
  return (int)cudaGetLastError();
}

// x: [items, rows, slots * 64] bf16 (the fused qkv layout), or with
// split_heads [items, slots, rows, 64] (kernel 18's split heads); raw: the 8
// KB box of 64 rows of slot `slot` of item `item` from row `row` as shared
// memory holds it (probe (11))
extern "C" int f5_probe_tma_4d(const void* x, void* raw, int items, int rows, int slots, int row,
                               int slot, int item, int split_heads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  const uint64_t ld = (uint64_t)slots * 64, hs = (uint64_t)rows * 64;
  const bool ok = split_heads
                      ? f5::tensor_map_4d(&map, x, slots, rows, items, hs, 64, slots * hs, 64,
                                          f5::kMapBf16)
                      : f5::tensor_map_4d(&map, x, slots, rows, items, 64, ld, rows * ld, 64,
                                          f5::kMapBf16);
  if (!ok) return (int)cudaErrorInvalidValue;
  f5::probe_tma_4d_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<unsigned char*>(raw), slot, row, item);
  return (int)cudaGetLastError();
}

// qkv: [1, n, 3 * 64] bf16; cos, sin: [n, 32] bf16; s: [64, 128] fp32; raw_k:
// the 16 KB rotated K tile (probe (12))
extern "C" int f5_probe_rope(const void* qkv, const void* cos, const void* sin, void* s,
                             void* raw_k, int n, int q0, int k0, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_cos, map_sin;
  if (!f5::tensor_map_4d(&map_q, qkv, 3, n, 1, 64, 3 * 64, (uint64_t)n * 3 * 64, 64,
                         f5::kMapBf16) ||
      !f5::tensor_map_4d(&map_k, qkv, 3, n, 1, 64, 3 * 64, (uint64_t)n * 3 * 64, f5::kAttnBK,
                         f5::kMapBf16) ||
      !f5::tensor_map_table(&map_cos, cos, n, 32, f5::kAttnBK) ||
      !f5::tensor_map_table(&map_sin, sin, n, 32, f5::kAttnBK))
    return (int)cudaErrorInvalidValue;
  f5::probe_rope_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_cos, map_sin, static_cast<const f5::bf16*>(cos),
      static_cast<const f5::bf16*>(sin), n, q0, k0, static_cast<float*>(s),
      static_cast<unsigned char*>(raw_k));
  return (int)cudaGetLastError();
}

// q8, k8: [1, n, 64] int8 (n <= 128); v8: [1, 64, 128] int8; a8: [64, 128]
// int8; p: [64, 128] fp32 in [0, 1]; s_out [64, 128], pv_out [64, 64] int32
// (probe (13))
extern "C" int f5_probe_attn_i8(const void* q8, const void* k8, const void* v8, const void* a8,
                                const void* p, int mode, int n, int q0, void* s_out,
                                void* pv_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_v;
  if (!f5::tensor_map_3d(&map_q, q8, 1, n, 64, 64, f5::kMapInt8) ||
      !f5::tensor_map_3d(&map_k, k8, 1, n, 64, f5::kAttnBK, f5::kMapInt8) ||
      !f5::tensor_map_3d(&map_v, v8, 1, 64, 128, 64, f5::kMapInt8))
    return (int)cudaErrorInvalidValue;
  f5::probe_attn_i8_kernel<<<1, f5::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<const int8_t*>(a8), static_cast<const float*>(p), mode, q0,
      static_cast<int*>(s_out), static_cast<int*>(pv_out));
  return (int)cudaGetLastError();
}

// The bf16 attention core for Hopper: kernel A (prefix attention) at head
// dim 64, on TMA, mbarriers and wgmma (hopper.cuh), and kernel 10 (the
// training forward, flash_prefix_train.cu), which is kernel A that also
// writes each row's base-2 logsumexp lse = m + log2(l) (the template flag
// kLse; kernel A's instantiation has no lse code), and kernel 19
// (flash_prefix_qkv.cu), which is kernel A read straight from the fused qkv
// projection output with the rotary embedding applied in the kernel (the
// template flag kRope; A's and 10's instantiations have none of it), and
// kernel 18 (flash_prefix_rope.cu), the same rope form over split heads; and
// kernel 14 (flash_prefix_int8.cu), kernel A with int8 products (the
// template flag kI8; the others' instantiations have none of it). Kernels A,
// 10 and 18 at head dim 128 in bf16 run on the core's D = 128 form
// (attn_fwd_d128_wgmma_kernel, its own note at the end of this file;
// flash_prefix_core_d128.cu).
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
//
// The rope form (kRope, kernel 19). qkv [B, n, 3 * heads * 64]: a head's q,
// k or v is a 128-byte column slice of 6 KB rows (at 16 heads), so the maps
// are 4-D and strided (hopper.cuh:tensor_map_4d: dims 64 columns, 3 * heads
// head slots, n rows, B items; q of head g at slot g, k at heads + g, v at
// 2 * heads + g); a box stops at row n of its item with zero fill, as the
// 3-D maps stop at a head's row n. Block y is (item, head g), kv_lens is
// per item, and the output rows are stored merged into [B, n, heads * 64].
// The rotation (heads g < n_rope) is applied in shared memory, on the
// swizzled tiles TMA left there (attn_rope_tile: the partners c and c + 32
// of a row sit at chunks p and p ^ 4):
//   q   each consumer warpgroup rotates its own 64 rows once after they land
//       (tables read from L2), then fences the async proxy and syncs the
//       warpgroup before its first wgmma;
//   K   warps 1-3 of the producer warpgroup (idle in A) rotate every K tile
//       after its TMA lands, up to kv_len (past it the scores are masked),
//       and arrive on a second per-stage barrier (roped), on which the
//       consumers wait besides the TMA's. The tile's 128 rows of cos and
//       sin land by TMA in the same stage (unswizzled 8 KB boxes,
//       hopper.cuh:tensor_map_table), so the rotation reads only shared
//       memory. The register split stays A's (32 and 160): the rotating
//       warps work on 32-bit shared addresses, in 8-byte halves of an item,
//       and read kv_len after setmaxnreg (a value live across it is
//       spilled). A stage is 48 KB, four stages 192 KB. V is read as it is.
// Measured (chip_smoke.py phase 2, PERF.md section 6): at the main shape the
// rope form without rotation (pe_attn_head 0) takes A's time; the rotation
// adds about half as much again. Its instructions compete with the
// softmax's for the schedulers, and the rotating warps have 32 registers
// for it. Trial builds that were slower and not kept: the tables read from
// L2 by the rotating warps, 16-byte items (ptxas spills), a 56 / 152 or 40
// / 152 register split (the consumers lose more than the rotation gains),
// all four producer warps rotating with the TMA thread among them, and
// pairs of blocks in a cluster that rotate half a tile each and store it in
// both.
// Cost: a K tile's rotation is 512 pairs of 16-byte chunks, 6 flops a value:
// ~1.5% of the tile's products in flops, off the tensor cores' path, and 16
// KB more of TMA traffic a tile from L2. What bounds it is A's bound: at the
// main shape (B 2, 16 heads, n 1536, 1376 valid keys) 17.3 GFLOP, 0.0175 ms
// at 989 TFLOP/s. Kernel 18 reads the split-head layout [B, heads, n, 64]
// through three 4-D maps of the same form (slot stride n * 64, row stride
// 64; slot_k = slot_v = 0) and is 19's instantiation.
//
// The int8 form (kI8: kAttnI8Qk, kAttnI8Qkpv or kAttnI8QkpvF32, kernel 14;
// kAttnI8QkpvF32 is "qkpv" with the output stored as fp32, kernel 14's fp32
// form, whose quantized operands are those of fp32 inputs). The function is
// the TPU kernel's (korean_f5_tts_tpu/ops/flash_prefix.py:_kernel_i8) on the
// operands its quantization pass (quant_heads.cu) writes: q8, k8 [H, n, 64]
// int8, c[h] = aq ak / 127^2 * log2(e) / sqrt(64), and under "qkpv" v8 [H,
// 64, n_pad] int8 (keys contiguous, permuted in groups of 32, zero past n)
// with sv[h] = av / 127^2:
//   s   = float(q8 . k8^T) * c            exact s32 sums, base-2 domain,
//                                         keys at or past kv_len masked
//   online max m and sum l in fp32 over the unquantized p = exp2(s - m),
//         the max taken per chunk of 512 keys (kAttnI8Group tiles; the
//         JAX kernel's chunks at its default bkv, _chunk_plan: 512 keys
//         from key 0, the last chunk what is left) and one alpha a chunk
//   qkpv  acc = acc * alpha + float(p8 . v8) * sv, p8 = rint(127 p), the
//         product one s32 accumulator across the chunk's tiles
//   qk    acc = acc * alpha + bf16(p) . v (v unquantized bf16, A's P.V)
//   out   = acc / l, rounded once to bf16 (fp32 under kAttnI8QkpvF32:
//         nothing else in "qkpv" is below fp32)
// p8 sees the running max of the chunks visited so far, so the chunk is
// part of the arithmetic: the plain version repeats it (ops/flash_prefix.py:
// I8_KEY_CHUNK = 512, the JAX wrapper's default bkv).
//   S     wgmma m64n128k32 .s32.s8.s8, both operands from shared memory.
//         Rows of q8 and k8 are 64 bytes; their 3-D maps take A's 128-byte
//         boxes, which TMA fills past the row's 64 bytes with zeros, so the
//         tiles are A's swizzled [rows][128 bytes] and S is two k32 steps of
//         the first half. The s32 accumulator lies as A's fp32 one.
//   p8    rint(127 p) is 127 p + 1.5 * 2^23 in fp32 (the add rounds to the
//         nearest integer, ties to even; its low byte is the value), packed
//         by byte permutes straight into the 8-bit A fragment of a k32 step,
//         mma.m16n8k32's per warp: a thread's accumulator holds keys 8j + 2t
//         + {0, 1}, the fragment wants slots 4t .. 4t + 3 and 16 + 4t .., so
//         v8's keys are stored at slot 16h + 4t + 2j + e for key 16h + 8j + 2t
//         + e of each group of 32 (ops/flash_prefix.py:_v8_kernel_layout).
//   P.V   qkpv: wgmma m64n64k32 .s32.s8.s8 with A from registers and the v8
//         tile [64][128 keys] k-major from shared memory (the int8 GEMM
//         core's B), four k32 steps; qk: A's bf16 P.V.
//   s32 -> fp32  one conversion, exact (|s| < 2^24: 64 x 127^2 for S, 512 x
//         127^2 for a chunk's P.V); the integer trick of p8 (two instructions) measured
//         slower here than the conversion instruction.
// The consumer walks the tiles a chunk (group of four tiles) at a time,
// each product waited for:
//   sweep 1  S of each tile of the group, converted, scaled and masked, for
//            the group's row max; m_next = max(m, group max), one alpha for
//            acc and l. The S of four tiles (64 rows x 512 keys, 256 fp32 a
//            thread) cannot stay in registers, and S is exact in s32, so
//            sweep 2 computes it again to the same bits.
//   sweep 2  S again, p = exp2(s - m_next), l, p8 (or bf16 p) and P.V tile
//            by tile; under "qkpv" the s32 P.V accumulator sums the group's
//            tiles (|sum| <= 512 x 127^2 < 2^24: its conversion is exact)
//            and acc = acc * alpha + float(pv) * sv once a group, the plain
//            version's arithmetic.
//   ring     the group's K (and V) tiles stay in shared memory across both
//            sweeps: a stage is released after sweep 2, and the ring holds
//            kAttnI8Stages = 6 stages (four for the group, two for the next
//            group's first tiles), 192 KB beside the 24 KB of q.
//   edges    the sweep stops at ceil(kv_len / 128) tiles: the tiles it skips
//            of the last chunk are masked whole, and a masked tile leaves m,
//            l and acc as they are (p = 0), so skipping them is exact; the
//            last group takes the tiles that exist.
// The three warpgroups overlap one another's products and softmax without
// turns. At int8 rates the products are a small part of a tile's
// time: exactness to the plain version costs ~10 instructions an element
// (the conversion, the scale, the max, the shift, the row sum, p8's multiply,
// round and pack, P.V's conversion and update) where A's softmax takes ~4,
// so the int8 form is bound by instruction issue, not by its products. Trial
// builds at the main shape, of the form before the chunked max (one sweep,
// the max per tile), not kept: A's schedule (S(j + 1) in flight under
// P.V(j), with or without ping-pong turns) was faster for "qk" but slower
// for "qkpv", whose s32 P.V accumulator then lives beside S, O and P; turns
// alone were slower for both; p8 through the float-to-int conversion instead
// of the 1.5 * 2^23 add was slower still. The _rn intrinsics keep nvcc
// from contracting the scale, the rescale and the update into fused
// multiply-adds, so they round as the plain version does.
// What bounds it: at the main shape 17.3 GOP of int8 products (0.0087 ms at
// 1,979 TOP/s) and 67.6 M exp2 (~0.018 ms on the SFUs). The second S sweep
// adds the S product (half the int8 products) and a conversion, scale, mask
// and max an element to the ~10 instructions an element it is bound by.
#pragma once

#include "gemm_bf16.cuh"  // align_1024, kMaxDevices, allow_smem

namespace f5 {
namespace {

constexpr int kAttnD = 64;
constexpr int kAttnBK = 128;                           // keys a tile
constexpr int kAttnStages = 3;                         // K/V ring depth
constexpr int kAttnWgBytes = 64 * kRowBytes;           // one warpgroup's 64 q rows
constexpr int kAttnKVBytes = kAttnBK * kRowBytes;      // a K or a V tile
constexpr int kAttnWgs = 3;                            // consumer warpgroups, 64 q rows each
constexpr int kAttnRows = 64 * kAttnWgs;               // q rows a block
constexpr int kAttnV8Bytes = kAttnD * kRowBytes;       // a v8 tile: 64 rows of 128 keys
// the int8 forms (kI8) of the core, kernel 14's two modes
constexpr int kAttnI8Group = 4;   // tiles a chunk of the int8 forms' running max (512 keys)
constexpr int kAttnI8Stages = 6;  // their ring: a whole chunk resident, and two more
constexpr int kAttnI8Qk = 1;    // int8 q.k^T, bf16 p.v
constexpr int kAttnI8Qkpv = 2;  // int8 q.k^T and p.v
constexpr int kAttnI8QkpvF32 = 3;  // as kAttnI8Qkpv, the output fp32 (kernel 14's fp32 form)
// the forms whose P.V is int8 (a v8 tile a stage)
__host__ __device__ constexpr bool attn_i8_pv8(int i8) { return i8 >= kAttnI8Qkpv; }

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

// ping-pong: warpgroup wg of kWgs issues its products only in its turn
// (named barrier 4 + wg, 256 threads: its own 128 waiting, the previous
// warpgroup's 128 arriving when it has issued)
__device__ __forceinline__ void attn_turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}

template <int kWgs = kAttnWgs>
__device__ __forceinline__ void attn_turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + (wg + 1) % kWgs) : "memory");
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

// What the rope form of the core (kRope: kernel 19) needs besides the maps:
// the half-split rotary tables and where each head's q, k, v and output lie.
struct AttnRope {
  CUtensorMap map_cos;    // the tables by TMA, 128 rows a K tile (tensor_map_table)
  CUtensorMap map_sin;
  const bf16* cos;        // [n, 32] bf16 (64-byte rows), read directly for q
  const bf16* sin;
  int heads;              // gridDim.y = items * heads
  int n_rope;             // heads g < n_rope rotate q and k
  int slot_k, slot_v;     // 4-D map slots of head 0's k and v (q: slot g)
  size_t out_bs, out_hs, out_ld;  // out: item, head and row strides in elements
};

// Rotary embedding in place on a swizzled [rows][64] bf16 tile in shared
// memory whose row r is sequence row row0 + r, for column c < 32:
//   x[c]      <- x[c]      * cos[row, c] - x[c + 32] * sin[row, c]
//   x[c + 32] <- x[c + 32] * cos[row, c] + x[c]      * sin[row, c]
// in fp32 from the bf16 tables, rounded once to bf16, with the _rn
// intrinsics (no contraction into a fused multiply-add): the arithmetic of
// the plain version (ops/flash_prefix.py:rope_reference) to the bit. Under
// the 128-byte swizzle the 16-byte chunk j of row r sits at chunk j ^ (r & 7),
// so the partners c and c + 32 (chunks j and j + 4) sit in one row at chunks
// p and p ^ 4: a thread reads both halves of 8 columns and writes both back.
// Item i of rows * 4 is (row r, chunk j < 4) with j = i & 3 and r = 8 (i >>
// 5) + ((i >> 3) & 3) + 4 ((i >> 2) & 1): the 8 items of a quarter-warp take
// rows r and r + 4, whose chunks j ^ (r & 7) fill all eight 16-byte bank
// groups, so the accesses are conflict-free. Thread t of nthreads (a
// multiple of 32) takes items t, t + nthreads, ...: the same j, rows r0,
// r0 + nthreads / 4, ... (a multiple of 8 apart), so the same chunk position
// p in every row, and its rows rise: the loop stops at the first row at or
// past lim (n, where TMA left zeros and the tables have no row, or, for K,
// kv_len, past which the scores are masked).

// 8 or 16 bytes of shared memory at a 32-bit shared address
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts64(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// the rotation of one bf16 pair word of each half (x1 = lo, x2 = hi) with
// one word each of cos and sin: bf16 -> fp32 is exact (the bits shifted up)
__device__ __forceinline__ void rope_word(uint32_t& lo, uint32_t& hi, uint32_t c, uint32_t sn) {
  float o1[2], o2[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int sh = u ? 0 : 16;
    const float x1 = __uint_as_float((lo << sh) & 0xffff0000u);
    const float x2 = __uint_as_float((hi << sh) & 0xffff0000u);
    const float cc = __uint_as_float((c << sh) & 0xffff0000u);
    const float ss = __uint_as_float((sn << sh) & 0xffff0000u);
    o1[u] = __fsub_rn(__fmul_rn(x1, cc), __fmul_rn(x2, ss));
    o2[u] = __fadd_rn(__fmul_rn(x2, cc), __fmul_rn(x1, ss));
  }
  lo = pack_bf16x2(o1[0], o1[1]);
  hi = pack_bf16x2(o2[0], o2[1]);
}

// thread tid's chunk j, first row r0 and chunk position p (see above)
__device__ __forceinline__ int rope_first_row(int tid) {
  return ((tid >> 5) << 3) + ((tid >> 3) & 3) + (((tid >> 2) & 1) << 2);
}

// q: the tables [n, 32] in device memory (L2-resident), row row0 + r read
// with 16-byte non-coherent loads; 16-byte items
__device__ __forceinline__ void attn_rope_tile(unsigned char* tile, int rows, int row0, int lim,
                                               const bf16* __restrict__ cos,
                                               const bf16* __restrict__ sin, int tid,
                                               int nthreads) {
  const int j = tid & 3, r0 = rope_first_row(tid), step = nthreads >> 2;
  const uint32_t x_addr = smem_addr(tile) + r0 * kRowBytes + ((j ^ (r0 & 7)) << 4);
  for (int r = r0; r < rows && row0 + r < lim; r += step) {
    const uint32_t lo_a = x_addr + (r - r0) * kRowBytes, hi_a = lo_a ^ 64;  // chunk p ^ 4
    uint4 xlo = lds128(lo_a), xhi = lds128(hi_a);
    const size_t tab = (size_t)(row0 + r) * 32 + 8 * j;
    const uint4 cr = __ldg(reinterpret_cast<const uint4*>(cos + tab));
    const uint4 sr = __ldg(reinterpret_cast<const uint4*>(sin + tab));
    rope_word(xlo.x, xhi.x, cr.x, sr.x);
    rope_word(xlo.y, xhi.y, cr.y, sr.y);
    rope_word(xlo.z, xhi.z, cr.z, sr.z);
    rope_word(xlo.w, xhi.w, cr.w, sr.w);
    sts128(lo_a, xlo);
    sts128(hi_a, xhi);
  }
}

// K: the tile's own rows of the tables, which TMA put beside it in shared
// memory (64-byte rows, cos at tab_a, sin tab_sin bytes on), row r. All
// addresses are 32-bit shared ones, and the rotating warps have 32
// registers, so an item goes in two 8-byte halves (two words of each
// operand live at a time, not four); the two quarter-warps of a half-warp
// start on different halves, so each 8-byte access of a half-warp lands in
// its own bank pair.
__device__ __forceinline__ void attn_rope_tile_staged(uint32_t tile_a, int rows, int row0,
                                                      int lim, uint32_t tab_a, uint32_t tab_sin,
                                                      int tid, int nthreads) {
  const int j = tid & 3, r0 = rope_first_row(tid), step = nthreads >> 2;
  const uint32_t x_addr = tile_a + r0 * kRowBytes + ((j ^ (r0 & 7)) << 4);
  const uint32_t t_addr = tab_a + r0 * 64 + 16 * j;
  const uint32_t first = ((tid >> 3) & 1) << 3;  // the half this thread starts on
  for (int r = r0; r < rows && row0 + r < lim; r += step) {
    const uint32_t lo_a = x_addr + (r - r0) * kRowBytes, t_r = t_addr + (r - r0) * 64;
#pragma unroll 1
    for (uint32_t e = 0; e < 16; e += 8) {
      const uint32_t h = e ^ first;
      uint2 xlo = lds64(lo_a + h), xhi = lds64((lo_a ^ 64) + h);
      const uint2 cr = lds64(t_r + h), sr = lds64(t_r + tab_sin + h);
      rope_word(xlo.x, xhi.x, cr.x, sr.x);
      rope_word(xlo.y, xhi.y, cr.y, sr.y);
      sts64(lo_a + h, xlo);
      sts64((lo_a ^ 64) + h, xhi);
    }
  }
}

// K/V ring depth: the rope form keeps a fourth stage, since a K tile waits
// for its rotation after it lands; the int8 forms hold a chunk of four tiles
// across two sweeps
template <bool kRope, int kI8 = 0>
__host__ __device__ constexpr int attn_stages() {
  return kRope ? kAttnStages + 1 : kI8 != 0 ? kAttnI8Stages : kAttnStages;
}

constexpr int kAttnTabBytes = kAttnBK * 32 * 2;  // a tile's rows of one rotary table

// a ring stage: the K tile, the V tile and, in the rope form, the tile's rows
// of cos and sin
template <bool kRope>
__host__ __device__ constexpr int attn_stage_bytes() {
  return 2 * kAttnKVBytes + (kRope ? 2 * kAttnTabBytes : 0);
}

template <bool kRope, int kI8 = 0>
__host__ __device__ constexpr int attn_smem_bytes() {
  return 1024 + kAttnWgs * kAttnWgBytes +
         attn_stages<kRope, kI8>() * attn_stage_bytes<kRope>() +
         ((kRope ? 3 : 2) * attn_stages<kRope, kI8>() + 1) * 8;
}

// the producer warpgroup's warps 1-3 rotate K tiles in the rope form
constexpr int kAttnRopeThreads = 96;

// kv_len (clamped to n) of folded head or item i, and its 128-key tiles
__device__ __forceinline__ void attn_kv_tiles(const int* __restrict__ kv_lens, int i, int n,
                                              int& kv_len, int& n_tiles) {
  kv_len = min(kv_lens[i], n);
  n_tiles = kv_len > 0 ? (kv_len + kAttnBK - 1) / kAttnBK : 0;
}

// ---------------------------------------------------------------------------
// the int8 form (kI8, kernel 14)
// ---------------------------------------------------------------------------

// rint(127 p) for p in [0, 1] in the low byte: 127 p + 1.5 * 2^23 rounds to
// an integer (ties to even) in fp32
__device__ __forceinline__ uint32_t p8_bits(float p) {
  return __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), 12582912.f));
}

__device__ __forceinline__ uint32_t pack_p8x4(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(p8_bits(a), p8_bits(b), 0x0040),
                     __byte_perm(p8_bits(c), p8_bits(d), 0x0040), 0x5410);
}

// P (the m64n128 accumulator, keys 8j + 2t + e of rows g, g + 8 at s[4j +
// 2 (row) + e]) as p8 in the 8-bit A fragments of the four k32 steps of
// P.V: step kk's registers are rows g / g + 8 of slots 4t .. 4t + 3 and 16 +
// 4t .., which hold keys 8j + 2t + e for j = 4kk, 4kk + 1 and 4kk + 2, 4kk +
// 3 (the v8 slot order)
__device__ __forceinline__ void attn_pack_p8(const float (&s)[64], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* x = s + 16 * kk;
    p[kk][0] = pack_p8x4(x[0], x[1], x[4], x[5]);
    p[kk][1] = pack_p8x4(x[2], x[3], x[6], x[7]);
    p[kk][2] = pack_p8x4(x[8], x[9], x[12], x[13]);
    p[kk][3] = pack_p8x4(x[10], x[11], x[14], x[15]);
  }
}

// d[32] (+)= A (64 x 32 s8, registers) . B^T (B: [64][32] s8 k-major in
// shared memory), exact s32 sums
__device__ __forceinline__ void wgmma_rs_s8_n64(int (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// issue S = q8.k8^T for one tile (two k32 steps over the rows' 64 bytes) as
// one wgmma group
__device__ __forceinline__ void attn_issue_qk_s8(int (&s)[64], uint64_t desc_q,
                                                 const unsigned char* tile_k) {
  const uint64_t dk = wgmma_desc(tile_k);
#pragma unroll
  for (int kk = 0; kk < kAttnD / 32; ++kk)
    wgmma_ss_s8_n128(s, desc_q + 2 * kk, dk + 2 * kk, kk != 0);
  wgmma_commit();
}

// issue pv += p8.v8 for one tile (four k32 steps) as one wgmma group: the
// s32 accumulator sums a chunk's tiles
__device__ __forceinline__ void attn_issue_pv_s8(int (&pv)[32], const uint32_t (&p)[4][4],
                                                 const unsigned char* tile_v8) {
  const uint64_t dv = wgmma_desc(tile_v8);
#pragma unroll
  for (int kk = 0; kk < kAttnBK / 32; ++kk) wgmma_rs_s8_n64(pv, p[kk], dv + 2 * kk, 1);
  wgmma_commit();
}

// the int8 form's scaled score of accumulator element i: float(S) * c (one
// rounding, the plain version's), -inf at or past kv_len
__device__ __forceinline__ float attn_score_i8(int si, int i, bool mask, int k0, int kv_len,
                                               float c, int t) {
  const float x = __fmul_rn(__int2float_rn(si), c);
  return mask && k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len ? -INFINITY : x;
}

// sweep 1 of the int8 form, one 128-key tile: the rows' max of the scaled,
// masked scores, taken into this lane's share mx of the group's max
__device__ __forceinline__ void attn_tile_max_i8(const int (&si)[64], float (&mx)[2], int k0,
                                                 int kv_len, float c, int t) {
  const bool mask = k0 + kAttnBK > kv_len;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], attn_score_i8(si[i], i, mask, k0, kv_len, c, t));
}

// sweep 2 of the int8 form, one 128-key tile: p = exp2(s - m) against the
// group's running max m, left in s, and its row sums added to l (one
// rounding for the scale, one for the subtraction, as the plain version)
__device__ __forceinline__ void attn_probs_i8(const int (&si)[64], float (&s)[64],
                                              const float (&m_run)[2], float (&l_run)[2], int k0,
                                              int kv_len, float c, int t) {
  const bool mask = k0 + kAttnBK > kv_len;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(__fsub_rn(attn_score_i8(si[i], i, mask, k0, kv_len, c, t), m_run[r]));
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = __fadd_rn(l_run[r], rs[r]);
}

// kLse: also write lse [H, n] fp32, the base-2 logsumexp of each row's
// scaled scores (kernel 10); kernel A instantiates it without.
// kRope (kernels 19 and 18): 4-D maps over the fused qkv array or the split
// heads (tensor_map_4d), the rotation applied in shared memory, and a
// strided output; block y is (item, head) = (y / heads, y % heads) and
// kv_lens is per item.
// kI8 (kernel 14): int8 q8, k8 (and v8) maps, the scales c_scale and
// sv_scale [H]; scale_log2 is not read (c carries it).
template <bool kLse, bool kRope, int kI8 = 0>
__global__ void __launch_bounds__(128 * (kAttnWgs + 1), 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const int* __restrict__ kv_lens,
                      bf16* __restrict__ out, float* __restrict__ lse, int n, float scale_log2,
                      const __grid_constant__ AttnRope rope, const float* __restrict__ c_scale,
                      const float* __restrict__ sv_scale) {
  constexpr int kStagesT = attn_stages<kRope, kI8>();
  constexpr int kStageBytes = attn_stage_bytes<kRope>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_q = smem;
  unsigned char* ring = smem + kAttnWgs * kAttnWgBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStagesT * kStageBytes);
  uint64_t* empty = full + kStagesT;
  uint64_t* q_full = empty + kStagesT;
  uint64_t* roped = q_full + 1;  // kRope: K tile s rotated
  const int head = blockIdx.y;   // kRope: item * heads + g
  const int item = kRope ? head / rope.heads : 0;
  const int g = kRope ? head - item * rope.heads : 0;
  const bool rope_on = kRope && g < rope.n_rope;
  const int q0 = blockIdx.x * kAttnRows;
  // the rope form reads kv_len after each setmaxnreg instead: a value live
  // across one is spilled
  int kv_len = 0, n_tiles = 0;
  if constexpr (!kRope) attn_kv_tiles(kv_lens, head, n, kv_len, n_tiles);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStagesT; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive; TMA counts the bytes
      mbar_init(&empty[s], 4 * kAttnWgs);  // lane 0 of every consumer warp
      if (kRope) mbar_init(&roped[s], kAttnRopeThreads);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kAttnWgs) {
    if constexpr (kRope) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
      attn_kv_tiles(kv_lens, item, n, kv_len, n_tiles);
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    }
    if (tid == 128 * kAttnWgs) {
      mbar_arrive_expect_tx(q_full, kAttnWgs * kAttnWgBytes);
      if constexpr (kRope) tma_load_4d(s_q, &map_q, q_full, g, q0, item);
      else tma_load_3d(s_q, &map_q, q_full, 0, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesT;
        mbar_wait(&empty[s], ((j / kStagesT) & 1) ^ 1);  // passes at once on the first round
        unsigned char* tile = ring + s * kStageBytes;
        if constexpr (kRope) {
          mbar_arrive_expect_tx(&full[s], rope_on ? kStageBytes : 2 * kAttnKVBytes);
          tma_load_4d(tile, &map_k, &full[s], rope.slot_k + g, j * kAttnBK, item);
          tma_load_4d(tile + kAttnKVBytes, &map_v, &full[s], rope.slot_v + g, j * kAttnBK, item);
          if (rope_on) {
            tma_load_2d(tile + 2 * kAttnKVBytes, &rope.map_cos, &full[s], 0, j * kAttnBK);
            tma_load_2d(tile + 2 * kAttnKVBytes + kAttnTabBytes, &rope.map_sin, &full[s], 0,
                        j * kAttnBK);
          }
        } else if constexpr (attn_i8_pv8(kI8)) {
          // the v8 tile: keys j * 128 .. + 127 (columns) of the head's 64 rows
          mbar_arrive_expect_tx(&full[s], kAttnKVBytes + kAttnV8Bytes);
          tma_load_3d(tile, &map_k, &full[s], 0, j * kAttnBK, head);
          tma_load_3d(tile + kAttnKVBytes, &map_v, &full[s], j * kAttnBK, 0, head);
        } else {
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_3d(tile, &map_k, &full[s], 0, j * kAttnBK, head);
          tma_load_3d(tile + kAttnKVBytes, &map_v, &full[s], 0, j * kAttnBK, head);
        }
      }
    } else if (kRope && rope_on && warp > 4 * kAttnWgs) {
      // warps 1-3: rotate each K tile once it has landed, then hand it to
      // the consumers on roped[s] (the stage cannot be refilled before the
      // consumers release it, which they do only after roped[s])
      // (32 registers: the barriers' addresses follow from the ring's, and
      // what depends on the thread is worked out anew each tile)
      const uint32_t ring_a = smem_addr(ring);
      const uint32_t full_a = ring_a + kStagesT * kStageBytes;
      const uint32_t roped_a = full_a + (2 * kStagesT + 1) * 8;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesT;
        mbar_wait(full_a + 8 * s, (j / kStagesT) & 1);
        int rt = tid - 128 * kAttnWgs - 32;
        asm volatile("" : "+r"(rt));  // keeps the per-thread addresses out of the loop's state
        const uint32_t tile_a = ring_a + s * kStageBytes;
        attn_rope_tile_staged(tile_a, kAttnBK, j * kAttnBK, kv_len, tile_a + 2 * kAttnKVBytes,
                              kAttnTabBytes, rt, kAttnRopeThreads);
        fence_proxy_async();
        mbar_arrive(roped_a + 8 * s);
      }
    }
  } else {
    // 128 x 32 + 384 x 160 = 512 x 128: the registers the block was launched with
    if constexpr (kRope) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
      attn_kv_tiles(kv_lens, item, n, kv_len, n_tiles);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    }
    const int wg = warp >> 2, g8 = lane >> 2, t = lane & 3;
    unsigned char* my_q = s_q + wg * kAttnWgBytes;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g8 and g8 + 8 of this warp's 16
    float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
    mbar_wait(q_full, 0);
    if constexpr (kI8 != 0) {
      // a chunk of kAttnI8Group tiles at a time, two sweeps, each product
      // waited for (header)
      if (n_tiles > 0) {
        const uint64_t desc_q = wgmma_desc(my_q);
        const float c = c_scale[head];
        const float sv = attn_i8_pv8(kI8) ? sv_scale[head] : 0.f;
        for (int j0 = 0; j0 < n_tiles; j0 += kAttnI8Group) {
          const int j1 = min(j0 + kAttnI8Group, n_tiles);
          // sweep 1: the group's row max (its first tile holds a key < kv_len,
          // so the max is finite)
          float mx[2] = {-INFINITY, -INFINITY};
          for (int j = j0; j < j1; ++j) {
            const int st = j % kStagesT;
            mbar_wait(&full[st], (j / kStagesT) & 1);
            int si[64];
            wgmma_fence();
            attn_issue_qk_s8(si, desc_q, ring + st * kStageBytes);
            wgmma_wait<0>();
            wgmma_fence_regs(si);
            attn_tile_max_i8(si, mx, j * kAttnBK, kv_len, c, t);
          }
          float alpha[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
            alpha[r] = exp2f(__fsub_rn(m_run[r], m_new));
            m_run[r] = m_new;
            l_run[r] = __fmul_rn(l_run[r], alpha[r]);
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = __fmul_rn(o[i], alpha[(i >> 1) & 1]);
          // sweep 2: S again (the tiles are still resident), p, l and P.V
          int pv[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) pv[i] = 0;
          for (int j = j0; j < j1; ++j) {
            const int st = j % kStagesT;
            const unsigned char* tile = ring + st * kStageBytes;
            int si[64];
            wgmma_fence();
            attn_issue_qk_s8(si, desc_q, tile);
            wgmma_wait<0>();
            wgmma_fence_regs(si);
            float s[64];
            attn_probs_i8(si, s, m_run, l_run, j * kAttnBK, kv_len, c, t);
            if constexpr (attn_i8_pv8(kI8)) {
              uint32_t p8[4][4];
              attn_pack_p8(s, p8);
              wgmma_fence();
              attn_issue_pv_s8(pv, p8, tile + kAttnKVBytes);
              wgmma_wait<0>();
              wgmma_fence_regs(pv);
            } else {
              uint32_t p[8][4];
              attn_pack_p<kAttnBK>(s, p);
              wgmma_fence();
              attn_issue_pv(o, p, tile + kAttnKVBytes);
              wgmma_wait<0>();
              wgmma_fence_regs(o);
            }
            if (lane == 0) mbar_arrive(&empty[st]);
          }
          if constexpr (attn_i8_pv8(kI8)) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              o[i] = __fadd_rn(o[i], __fmul_rn(__int2float_rn(pv[i]), sv));
          }
        }
      }
    } else if (kRope && rope_on && n_tiles > 0) {
      // this warpgroup's 64 q rows, rotated once, visible to its wgmma
      attn_rope_tile(my_q, 64, q0 + wg * 64, n, rope.cos, rope.sin, tid & 127, 128);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    if (kI8 == 0 && n_tiles > 0) {  // the int8 form ran its own loop above
      const uint64_t desc_q = wgmma_desc(my_q);
      float s[64];
      uint32_t p[8][4];
      float alpha[2];
      if (wg == kAttnWgs - 1) attn_turn_pass(wg);  // warpgroup 0 starts
      mbar_wait(&full[0], 0);
      if (rope_on) mbar_wait(&roped[0], 0);
      attn_turn_wait(wg);
      wgmma_fence();
      attn_issue_qk(s, desc_q, ring);
      attn_turn_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      attn_softmax_tile(s, m_run, l_run, alpha, 0, kv_len, scale_log2, t);
      attn_pack_p<kAttnBK>(s, p);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kStagesT, prev = (j - 1) % kStagesT;
        mbar_wait(&full[st], (j / kStagesT) & 1);
        if (rope_on) mbar_wait(&roped[st], (j / kStagesT) & 1);
        attn_turn_wait(wg);
        wgmma_fence();
        attn_issue_qk(s, desc_q, ring + st * kStageBytes);
        attn_issue_pv(o, p, ring + prev * kStageBytes + kAttnKVBytes);
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
      const int last = (n_tiles - 1) % kStagesT;
      attn_turn_wait(wg);
      wgmma_fence();
      attn_issue_pv(o, p, ring + last * kStageBytes + kAttnKVBytes);
      if (wg != kAttnWgs - 1) attn_turn_pass(wg);  // the last turn: nobody waits on warpgroup 0's barrier
      wgmma_wait<0>();
      wgmma_fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[last]);
    }

    // epilogue: rows of bf16 through this warpgroup's q slice (its last S
    // product is done), chunk j of row r at chunk j ^ (r & 7); fp32 rows
    // (kAttnI8QkpvF32) straight from the accumulator
    const int row = (warp & 3) * 16 + g8;  // and row + 8; (row + 8) & 7 == g8 too
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
    if constexpr (kI8 == kAttnI8QkpvF32) {
      // out is fp32 [H, n, 64]: o[4j + 2r + e] is row row + 8r, column 8j + 2t
      // + e, so a quad writes 32 contiguous bytes of a row
      float* out_head = reinterpret_cast<float*>(out) + (size_t)head * n * kAttnD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int grow = q0 + wg * 64 + row + 8 * r;
        if (grow < n) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(out_head + (size_t)grow * kAttnD + 8 * j + 2 * t) =
                make_float2(__fmul_rn(o[4 * j + 2 * r], inv[r]),
                            __fmul_rn(o[4 * j + 2 * r + 1], inv[r]));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int chunk = (j ^ g8) << 4;
        *reinterpret_cast<uint32_t*>(my_q + row * kRowBytes + chunk + 4 * t) =
            pack_bf16x2(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(my_q + (row + 8) * kRowBytes + chunk + 4 * t) =
            pack_bf16x2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
      const int wt = tid & 127;
      bf16* out_head = kRope ? out + item * rope.out_bs + g * rope.out_hs
                             : out + (size_t)head * n * kAttnD;
      const size_t ld = kRope ? rope.out_ld : kAttnD;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int i = wt + 128 * it, r = i >> 3, c = i & 7;
        const int grow = q0 + wg * 64 + r;
        if (grow < n)
          *reinterpret_cast<int4*>(out_head + (size_t)grow * ld + 8 * c) =
              *reinterpret_cast<const int4*>(my_q + r * kRowBytes + ((c ^ (r & 7)) << 4));
      }
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
  constexpr int smem = attn_smem_bytes<false>();
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<kLse, false>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kAttnRows - 1) / kAttnRows, H);
  attn_fwd_wgmma_kernel<kLse, false><<<grid, 128 * (kAttnWgs + 1), smem, stream>>>(
      map_q, map_k, map_v, static_cast<const int*>(kv_lens), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, scale_log2, AttnRope{}, nullptr, nullptr);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head dim 128: kernels A and 18 in bf16 (attn_fwd_d128_wgmma_kernel)
// ---------------------------------------------------------------------------
//
// The function is kernel A's at d = 128 (folded heads q, k, v, out [H, n,
// 128] bf16, kv_lens [H]) and, in the rope form, kernel 18's (its split
// heads [B, heads, n, 128] are contiguous, so they are the folded [B *
// heads, n, 128] with kv_lens per item; the rotation as at d = 64, on the
// [n, 64] tables) and, in the lse form, kernel 10's (o and lse [H, n] fp32,
// as at D = 64). It replaces, in bf16, the first port's mma.sync loop
// (flash_prefix.cuh:flash_prefix_fwd_kernel<128, ...>, which no path runs
// any more: f5_flash_prefix_d128_fwd_mma keeps it for timing): 64 query rows
// a block,
// 64-key tiles loaded synchronously with two barriers a tile, mma.sync, the
// exponentials between the products, the whole K/V prefix streamed from L2
// by every 64-row block.
//
// What differs from the D = 64 core above:
//   spans     a 128-column bf16 row is 256 bytes, two 128-byte swizzle
//             spans; every tile (q, K, V) lies as two [rows][128 bytes]
//             boxes, span 0 (columns 0-63) then span 1 (64-127), each TMA'd
//             from the same 3-D map at columns 0 and 64.
//   S         eight k16 steps: steps 0-3 on span 0 of q and K, 4-7 on span
//             1 (the descriptors' start moves to the other span, not by +2
//             across its edge).
//   P.V       N = 128 over both spans of V: two m64n64k16 products a k step,
//             one a span (wgmma_rs_n64_tb, the D = 64 core's proven MN-major
//             B), O held as two 32-float halves. The other way, m64n128 with
//             the MN-major descriptor's stride between spans, would need
//             that unused field proved first; two n64 products need nothing
//             new and issue at the same rate.
//   registers S (64 fp32 at 128 keys), O (64) and P (32) are ~160 a thread
//             before addresses: two consumer warpgroups of 64 rows (128 a
//             block) at setmaxnreg 240 and a producer warpgroup at 24, 128 x
//             24 + 256 x 240 = 384 x 168, the launch's share. The rope form
//             has two producer warpgroups (512 threads): 256 x 40 + 256 x
//             216 = 512 x 128. ptxas: no spill, no serialized wgmma.
//   smem      q 2 x 16 KB; a stage of 128 keys is K and V, 2 x 32 KB; three
//             stages and q take 224 KB of the 227 a block may have
//             (attn_d128_smem_bytes, static_assert in the launcher). The
//             rope form adds the tile's rows of cos and sin (2 x 16 KB a
//             stage), so it has two stages. 64-key tiles (A six stages, 18
//             four: 48 KB a stage) were slower for both (times in
//             flash_prefix_core_d128.cu's note); 18 must equal A on roped
//             inputs to the bit, so the two share one key tile.
//   ring      a stage's K (with its tables) and its V are filled and freed
//             apart (full_k / empty_k, full_v / empty_v): K(j) is read by
//             S(j) one iteration before V(j) is read by P.V(j), so the
//             producer loads K a tile ahead of V, into the slot S freed,
//             and K(j + 2) lands (and is rotated) while tile j is still in
//             P.V. A trial build with one full and one empty barrier a
//             stage was slower in the rope form, and lost to A even with
//             the rotation off: two such stages leave the next tile's load
//             and rotation no time to hide in.
//   rope      the partners c and c + 64 of a row are the same chunk of the
//             same row in the two spans (w128_rope_q, w128_rope_k): + span
//             bytes instead of ^ 64; 128-byte table rows. q by its consumer
//             warpgroup from L2, each K tile from the tables TMA lands in the
//             stage, as at D = 64, but by seven warps (the two producer
//             warpgroups but the TMA warp) in 16-byte items: the rotation
//             is the rope form's cost, and its warps are latency-bound.
//             Trial builds, slower: three rotating warps (one producer
//             warpgroup, the D = 64 form's) in 8-byte halves at 40
//             registers, or in 16-byte items two or three rows at a time at
//             56 or 72; seven warps two rows at a time at 48 (spilled).
// Schedule and numerics as at D = 64: S(j + 1) issued before P.V(j),
// ping-pong across the two warpgroups, fp32 running max and sum, P rounded
// to bf16 for P.V, ex2.approx; keys at or past kv_len are -inf before the
// max, the loop runs ceil(kv_len / 128) tiles, a head with kv_len 0 gives
// zeros, rows past n are zero-filled by TMA and never stored; O / l through
// the warpgroup's own q slice (both spans), then 16-byte row stores.
// What bounds it: at the serving shape (16 folded heads, n 1536, 1376 keys)
// 17.3 GFLOP, 0.0175 ms at 989 TFLOP/s, and 33.8 M exp2 (half D = 64's for
// the same FLOPs). Grid: 12 x 16 = 192 blocks of 128 rows, 1.45 waves on
// 132 SMs: the second wave runs 60 blocks, so 72 of the 264 block slots of
// the two waves (27%) are idle tail (a persistent schedule is later work).
// Kernel 10 (kLse) at the training shape (H 64, n 1280, every key valid):
// 53.7 GFLOP, 0.0543 ms at 989 TFLOP/s; grid 10 x 64 = 640 blocks, 4.85
// waves on 132 SMs, so 20 of the 660 block slots (3%) are idle tail. The lse
// form writes lse = m + log2(l) per row in the epilogue (thread t == 0 of
// each row's quad, after the quad sum; 0 for a row with no valid key, with
// zero output): two live floats in the epilogue, nothing in the loop and no
// shared memory, so A and 18 keep instantiations without it and 10's o is
// A's to the bit.
// The rope form's rotation is ~12 instructions a pair of values (four
// products and two sums, each rounded apart, the bf16 unpacking and
// packing) on seven warps, redone by each of a head's 12 blocks.

constexpr int kW128Keys = 128;                     // keys a K/V tile
constexpr int kW128Wgs = 2;                        // consumer warpgroups, 64 q rows each
constexpr int kW128Rows = 64 * kW128Wgs;           // q rows a block
constexpr int kW128QSpan = kW128Rows * kRowBytes;  // one 64-column span of the q tile
constexpr int kW128WgSpan = 64 * kRowBytes;        // a warpgroup's rows of one q span
constexpr int kW128RopeThreads = 224;              // the rope form's warps 1-7 of its producers
// threads a block: the consumers and one producer warpgroup, two in the rope form
template <bool kRope>
__host__ __device__ constexpr int w128_threads() {
  return 128 * (kW128Wgs + (kRope ? 2 : 1));
}
constexpr int kBlockSmemMax = 232448;              // dynamic shared memory a block may take

constexpr int kW128Span = kW128Keys * kRowBytes;   // one 64-column span of a K, V or table tile

// a ring stage: K and V, two spans each, and in the rope form the tile's
// rows of cos and sin; the ring: what fits beside q
template <bool kRope>
__host__ __device__ constexpr int w128_stage_bytes() {
  return (kRope ? 6 : 4) * kW128Span;
}

template <bool kRope>
__host__ __device__ constexpr int w128_stages() {
  return kRope ? 2 : 3;
}

// 1024 bytes of alignment slack, q, the ring and its barriers (full and
// empty apart for K and V, and roped in the rope form, a stage each; q_full)
template <bool kRope>
__host__ __device__ constexpr int attn_d128_smem_bytes() {
  return 1024 + 2 * kW128QSpan + w128_stages<kRope>() * w128_stage_bytes<kRope>() +
         ((kRope ? 5 : 4) * w128_stages<kRope>() + 1) * 8;
}

// issue S = q.K^T for one tile (eight k16 steps: four on each span) as one
// wgmma group
__device__ __forceinline__ void w128_issue_qk(float (&s)[64], uint64_t desc_q0, uint64_t desc_q1,
                                              const unsigned char* tile_k) {
  const uint64_t dk0 = wgmma_desc(tile_k), dk1 = wgmma_desc(tile_k + kW128Span);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n128(s, (kk < 4 ? desc_q0 : desc_q1) + 2 * (kk & 3),
                  (kk < 4 ? dk0 : dk1) + 2 * (kk & 3), kk != 0);
  wgmma_commit();
}

// issue O += P.V for one tile (eight k16 steps, a product on each span of
// V) as one wgmma group; o0 holds output columns 0-63, o1 64-127
__device__ __forceinline__ void w128_issue_pv(float (&o0)[32], float (&o1)[32],
                                              const uint32_t (&p)[8][4],
                                              const unsigned char* tile_v) {
  const uint64_t dv0 = wgmma_desc_mn(tile_v), dv1 = wgmma_desc_mn(tile_v + kW128Span);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs_n64_tb(o0, p[kk], dv0 + 128 * kk, 1);
    wgmma_rs_n64_tb(o1, p[kk], dv1 + 128 * kk, 1);
  }
  wgmma_commit();
}

// The rotation at D = 128 on a swizzled tile held as two spans (span 1
// span_bytes after span 0), rows row0 + r for r < rows, stopping at the
// first row at or past lim; the arithmetic and rounding of rope_word (the
// plain version's to the bit). Item (row r, chunk j < 8): the partners
// c and c + 64 are chunk j ^ (r & 7) of row r in both spans; thread t of
// nthreads takes chunk t & 7 of rows t / 8, t / 8 + nthreads / 8, ..., so
// a quarter-warp covers one row's eight chunks (conflict-free).
// q: the tables [n, 64] in device memory (L2-resident), 16-byte items.
__device__ __forceinline__ void w128_rope_q(uint32_t tile_a, int span_bytes, int rows, int row0,
                                            int lim, const bf16* __restrict__ cos,
                                            const bf16* __restrict__ sin, int tid,
                                            int nthreads) {
  const int j = tid & 7;
  for (int r = tid >> 3; r < rows && row0 + r < lim; r += nthreads >> 3) {
    const uint32_t lo_a = tile_a + r * kRowBytes + ((j ^ (r & 7)) << 4);
    uint4 xlo = lds128(lo_a), xhi = lds128(lo_a + span_bytes);
    const size_t tab = (size_t)(row0 + r) * 64 + 8 * j;
    const uint4 cr = __ldg(reinterpret_cast<const uint4*>(cos + tab));
    const uint4 sr = __ldg(reinterpret_cast<const uint4*>(sin + tab));
    rope_word(xlo.x, xhi.x, cr.x, sr.x);
    rope_word(xlo.y, xhi.y, cr.y, sr.y);
    rope_word(xlo.z, xhi.z, cr.z, sr.z);
    rope_word(xlo.w, xhi.w, cr.w, sr.w);
    sts128(lo_a, xlo);
    sts128(lo_a + span_bytes, xhi);
  }
}

// K: the tile's own rows of the tables, which TMA put in the stage (cos at
// tab_a, sin span_bytes on, unswizzled 128-byte rows), 16-byte items
__device__ __forceinline__ void w128_rope_k(uint32_t tile_a, int span_bytes, int rows, int row0,
                                            int lim, uint32_t tab_a, int tid, int nthreads) {
  const int j = tid & 7, end = min(rows, lim - row0);
#pragma unroll 1
  for (int r = tid >> 3; r < end; r += nthreads >> 3) {
    const uint32_t lo_a = tile_a + r * kRowBytes + ((j ^ (r & 7)) << 4);
    const uint32_t t_r = tab_a + r * kRowBytes + 16 * j;
    uint4 xlo = lds128(lo_a), xhi = lds128(lo_a + span_bytes);
    const uint4 cr = lds128(t_r), sr = lds128(t_r + span_bytes);
    rope_word(xlo.x, xhi.x, cr.x, sr.x);
    rope_word(xlo.y, xhi.y, cr.y, sr.y);
    rope_word(xlo.z, xhi.z, cr.z, sr.z);
    rope_word(xlo.w, xhi.w, cr.w, sr.w);
    sts128(lo_a, xlo);
    sts128(lo_a + span_bytes, xhi);
  }
}

// kRope false: kernel A (block y = folded head, kv_lens per head); true:
// kernel 18 (block y = item * heads + g, kv_lens per item, heads g <
// n_rope rotate). kLse (kernel 10, kRope false): also lse [H, n] fp32.
template <bool kLse, bool kRope>
__global__ void __launch_bounds__(w128_threads<kRope>(), 1)
attn_fwd_d128_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const int* __restrict__ kv_lens, bf16* __restrict__ out,
                           float* __restrict__ lse, int n, float scale_log2,
                           const __grid_constant__ AttnRope rope) {
  static_assert(!(kLse && kRope), "the d = 128 core's lse form is kernel 10's, without rope");
  constexpr int BK = kW128Keys, kSpan = kW128Span, kStages = w128_stages<kRope>();
  constexpr int kStageBytes = w128_stage_bytes<kRope>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* s_q = smem;  // span 0 of the block's 128 rows, then span 1
  unsigned char* ring = smem + 2 * kW128QSpan;
  // a stage's K (with its tables) and its V are filled and released apart
  uint64_t* full_k = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* q_full = empty_v + kStages;
  uint64_t* roped = q_full + 1;  // kRope: K tile s rotated
  const int head = blockIdx.y;
  const int item = kRope ? head / rope.heads : head;
  const bool rope_on = kRope && head - item * rope.heads < rope.n_rope;
  const int q0 = blockIdx.x * kW128Rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);  // the producer's arrive; TMA counts the bytes
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 4 * kW128Wgs);  // lane 0 of every consumer warp
      mbar_init(&empty_v[s], 4 * kW128Wgs);
      if (kRope) mbar_init(&roped[s], kW128RopeThreads);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // kv_len is read after each setmaxnreg: a value live across one is spilled
  if (warp >= 4 * kW128Wgs) {
    if constexpr (kRope) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int kv_len = min(kv_lens[item], n);
    const int n_tiles = kv_len > 0 ? (kv_len + BK - 1) / BK : 0;
    if (tid == 128 * kW128Wgs) {
      mbar_arrive_expect_tx(q_full, 2 * kW128QSpan);
      tma_load_3d(s_q, &map_q, q_full, 0, q0, head);
      tma_load_3d(s_q + kW128QSpan, &map_q, q_full, 64, q0, head);
      // K runs a tile ahead of V: K(j) (and its tables) as soon as S(j -
      // kStages) has read its slot, then V(j - 1) once P.V(j - 1 - kStages)
      // has read its own; the empty waits pass at once on the first round
      for (int j = 0; j <= n_tiles; ++j) {
        if (j < n_tiles) {
          const int s = j % kStages;
          unsigned char* tile = ring + s * kStageBytes;
          mbar_wait(&empty_k[s], ((j / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full_k[s], (rope_on ? 4 : 2) * kSpan);
          tma_load_3d(tile, &map_k, &full_k[s], 0, j * BK, head);
          tma_load_3d(tile + kSpan, &map_k, &full_k[s], 64, j * BK, head);
          if (rope_on) {
            tma_load_2d(tile + 4 * kSpan, &rope.map_cos, &full_k[s], 0, j * BK);
            tma_load_2d(tile + 5 * kSpan, &rope.map_sin, &full_k[s], 0, j * BK);
          }
        }
        if (j > 0) {
          const int jv = j - 1, s = jv % kStages;
          unsigned char* tile = ring + s * kStageBytes;
          mbar_wait(&empty_v[s], ((jv / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full_v[s], 2 * kSpan);
          tma_load_3d(tile + 2 * kSpan, &map_v, &full_v[s], 0, jv * BK, head);
          tma_load_3d(tile + 3 * kSpan, &map_v, &full_v[s], 64, jv * BK, head);
        }
      }
    } else if (rope_on && warp > 4 * kW128Wgs) {
      // warps 1-7 of the producers: rotate each K tile once it has landed,
      // up to kv_len, then hand it to the consumers on roped[s]
      const uint32_t ring_a = smem_addr(ring);
      const uint32_t full_k_a = ring_a + kStages * kStageBytes;
      const uint32_t roped_a = full_k_a + (4 * kStages + 1) * 8;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(full_k_a + 8 * s, (j / kStages) & 1);
        int rt = tid - 128 * kW128Wgs - 32;
        asm volatile("" : "+r"(rt));  // keeps the per-thread addresses out of the loop's state
        const uint32_t tile_a = ring_a + s * kStageBytes;
        w128_rope_k(tile_a, kSpan, BK, j * BK, kv_len, tile_a + 4 * kSpan, rt, kW128RopeThreads);
        fence_proxy_async();
        mbar_arrive(roped_a + 8 * s);
      }
    }
  } else {
    // 128 x 24 + 256 x 240 = 384 x 168 (rope: 256 x 40 + 256 x 216 = 512 x
    // 128): the registers the block was launched with
    if constexpr (kRope) asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int kv_len = min(kv_lens[item], n);
    const int n_tiles = kv_len > 0 ? (kv_len + BK - 1) / BK : 0;
    const int wg = warp >> 2, g8 = lane >> 2, t = lane & 3;
    unsigned char* my_q = s_q + wg * kW128WgSpan;  // span 0 of this warpgroup's rows
    float o0[32], o1[32];  // output columns 0-63 and 64-127
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g8 and g8 + 8 of this warp's 16
    float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
    mbar_wait(q_full, 0);
    if (rope_on && n_tiles > 0) {
      // this warpgroup's 64 q rows, rotated once, visible to its wgmma
      w128_rope_q(smem_addr(my_q), kW128QSpan, 64, q0 + wg * 64, n, rope.cos, rope.sin,
                  tid & 127, 128);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    if (n_tiles > 0) {
      const uint64_t desc_q0 = wgmma_desc(my_q), desc_q1 = wgmma_desc(my_q + kW128QSpan);
      float s[64];
      uint32_t p[8][4];
      float alpha[2];
      if (wg == kW128Wgs - 1) attn_turn_pass<kW128Wgs>(wg);  // warpgroup 0 starts
      mbar_wait(&full_k[0], 0);
      if (rope_on) mbar_wait(&roped[0], 0);
      attn_turn_wait(wg);
      wgmma_fence();
      w128_issue_qk(s, desc_q0, desc_q1, ring);
      attn_turn_pass<kW128Wgs>(wg);
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      if (lane == 0) mbar_arrive(&empty_k[0]);
      attn_softmax_tile(s, m_run, l_run, alpha, 0, kv_len, scale_log2, t);
      attn_pack_p<BK>(s, p);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kStages, prev = (j - 1) % kStages;
        mbar_wait(&full_k[st], (j / kStages) & 1);
        if (rope_on) mbar_wait(&roped[st], (j / kStages) & 1);
        mbar_wait(&full_v[prev], ((j - 1) / kStages) & 1);
        attn_turn_wait(wg);
        wgmma_fence();
        w128_issue_qk(s, desc_q0, desc_q1, ring + st * kStageBytes);
        w128_issue_pv(o0, o1, p, ring + prev * kStageBytes + 2 * kSpan);
        attn_turn_pass<kW128Wgs>(wg);
        wgmma_wait<1>();  // S of tile j is done; P.V of tile j - 1 may still run
        wgmma_fence_regs(s);
        if (lane == 0) mbar_arrive(&empty_k[st]);
        attn_softmax_tile(s, m_run, l_run, alpha, j * BK, kv_len, scale_log2, t);
        wgmma_wait<0>();
        wgmma_fence_regs(o0);
        wgmma_fence_regs(o1);
        if (lane == 0) mbar_arrive(&empty_v[prev]);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          o0[i] *= alpha[(i >> 1) & 1];
          o1[i] *= alpha[(i >> 1) & 1];
        }
        attn_pack_p<BK>(s, p);
      }
      const int last = (n_tiles - 1) % kStages;
      mbar_wait(&full_v[last], ((n_tiles - 1) / kStages) & 1);
      attn_turn_wait(wg);
      wgmma_fence();
      w128_issue_pv(o0, o1, p, ring + last * kStageBytes + 2 * kSpan);
      // the last turn: nobody waits on warpgroup 0's barrier
      if (wg != kW128Wgs - 1) attn_turn_pass<kW128Wgs>(wg);
      wgmma_wait<0>();
      wgmma_fence_regs(o0);
      wgmma_fence_regs(o1);
      if (lane == 0) mbar_arrive(&empty_v[last]);
    }

    // epilogue: rows of bf16 through this warpgroup's q slice, both spans
    // (its last S product is done), chunk j of row r at chunk j ^ (r & 7)
    const int row = (warp & 3) * 16 + g8;  // and row + 8; (row + 8) & 7 == g8 too
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
      const int chunk = (j ^ g8) << 4;
      unsigned char* a = my_q + row * kRowBytes + chunk + 4 * t;
      unsigned char* b = a + 8 * kRowBytes;  // row + 8
      *reinterpret_cast<uint32_t*>(a) = pack_bf16x2(o0[4 * j] * inv[0], o0[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(b) =
          pack_bf16x2(o0[4 * j + 2] * inv[1], o0[4 * j + 3] * inv[1]);
      *reinterpret_cast<uint32_t*>(a + kW128QSpan) =
          pack_bf16x2(o1[4 * j] * inv[0], o1[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(b + kW128QSpan) =
          pack_bf16x2(o1[4 * j + 2] * inv[1], o1[4 * j + 3] * inv[1]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup alone
    const int wt = tid & 127;
    bf16* out_head = out + (size_t)head * n * 128;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int i = wt + 128 * it, r = i >> 4, c = i & 15;  // 16 chunks of 16 bytes a row
      const int grow = q0 + wg * 64 + r;
      if (grow < n)
        *reinterpret_cast<int4*>(out_head + (size_t)grow * 128 + 8 * c) =
            *reinterpret_cast<const int4*>(my_q + (c >> 3) * kW128QSpan + r * kRowBytes +
                                           (((c & 7) ^ (r & 7)) << 4));
    }
  }
}

// kernel A (kRope false: cos, sin unread, heads 1, kv_lens [H] per folded
// head), kernel 10 (kLse: A's function and lse [H, n] fp32) or kernel 18
// (kRope: kv_lens [H / heads] per item, cos, sin [n, 64] bf16, heads g <
// n_rope rotate) at head dim 128 on this core. q, k, v, out: [H, n, 128]
// bf16 (18's split heads [B, heads, n, 128] with H = B * heads), 16-byte
// aligned.
template <bool kLse, bool kRope>
cudaError_t launch_attn_fwd_d128(const void* q, const void* k, const void* v,
                                 const void* kv_lens, const void* cos, const void* sin,
                                 void* out, void* lse, int H, int heads, int n, int n_rope,
                                 float scale_log2, cudaStream_t stream) {
  // the lse form takes A's shared memory: its lse goes from registers to device memory
  constexpr int smem = attn_d128_smem_bytes<kRope>();
  static_assert(smem <= kBlockSmemMax, "the d = 128 core's ring does not fit a block");
  CUtensorMap map_q, map_k, map_v;
  AttnRope rope{};
  if (!tensor_map_3d(&map_q, q, H, n, 128, kW128Rows, kMapBf16) ||
      !tensor_map_3d(&map_k, k, H, n, 128, kW128Keys, kMapBf16) ||
      !tensor_map_3d(&map_v, v, H, n, 128, kW128Keys, kMapBf16))
    return cudaErrorInvalidValue;
  if constexpr (kRope) {
    if (heads <= 0 || H % heads != 0 || !tensor_map_table(&rope.map_cos, cos, n, 64, kW128Keys) ||
        !tensor_map_table(&rope.map_sin, sin, n, 64, kW128Keys))
      return cudaErrorInvalidValue;
    rope.cos = static_cast<const bf16*>(cos);
    rope.sin = static_cast<const bf16*>(sin);
    rope.heads = heads;
    rope.n_rope = n_rope;
  }
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err =
      allow_smem(attn_fwd_d128_wgmma_kernel<kLse, kRope>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kW128Rows - 1) / kW128Rows, H);
  attn_fwd_d128_wgmma_kernel<kLse, kRope><<<grid, w128_threads<kRope>(), smem, stream>>>(
      map_q, map_k, map_v, static_cast<const int*>(kv_lens), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, scale_log2, rope);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// Grouped conv1d (SAME padding) + bias + optional Mish for Hopper (sm_90a):
// ConvPositionEmbedding's two convolutions (k = 31, 16 groups of C / 16).
//
// Group widths. Both forms are templates on the group width CG = C / groups
// and take 16, 32, 64 and 128 (dim 256, 512, 1024, 2048 at 16 groups): every
// width the TPU kernel takes (grouped_conv.py:42-50: CG divides 128) from 16
// up. The text below describes CG = 64; the other widths change only this:
//   bf16  a tile row is min(CG, 64) channels, 32, 64 or 128 bytes, in the
//         swizzle of that span (TMA's 32B, 64B or 128B mode, the wgmma layout
//         types B32, B64, B128; swz_addr, conv_desc_mn): the TMA boxes are
//         rows x min(CG, 64) channels, the wgmma is m64nCGk16 (n16, n32,
//         n64) with CG / 16 k16 steps a tap, a k step 16 tile rows further
//         in the weights' descriptor. At CG = 128 (256-byte rows, past every
//         swizzle span) the window and each tap's weights are two 64-channel
//         tiles in the 128B swizzle: k steps 0-3 read the first window tile
//         and 4-7 the second, and each k step runs two m64n64k16 products,
//         one per half of the output channels, into two accumulators (one
//         block an SM: 168 KB of shared memory).
//   fp32  a block computes min(CG, 64) output channels (two blocks a group
//         at CG = 128) from the group's input channels in passes of
//         min(CG, 64) (two at CG = 128, the window reloaded between them,
//         one accumulator across both); at CG 16 and 32 the eight warps
//         are 16 rows each, one m16 tile by CG / 8 n8 tiles.
// Widths below 16 have no instantiation of their own: a wgmma is at least 16
// deep in k and a TMA box row at least 16 bytes. At 8 channels a group (dim
// 128 at 16 groups, which the TPU kernel takes: 16 groups fill its 128-lane
// block) the wrapper packs each pair of groups into one 16-channel group
// with block-diagonal taps, the TPU kernel's packing (grouped_conv.py:53-64)
// two groups deep (ops/grouped_conv.py:pack_group_pairs), and launches the
// CG = 16 instantiation at groups / 2; the zeros off the diagonal double the
// products, not the launches.
// Widths that do not divide 128 (48 at dim 768, F5TTS_Small and E2TTS_Small)
// never reach the kernel: conv-pos takes the plain convolution there, as the
// JAX package does (models/modules.py:conv_position_embedding).
//
// Replaces the TPU kernel korean_f5_tts_tpu/ops/grouped_conv.py:_gc_kernel
// (via grouped_conv1d_mish). x, out: [B, N, C] bf16 channels-last;
// w: [k, cg, C] bf16 in the JAX layout (group-major output channels, so
// out[.., g*cg + o] = sum_t sum_i x[.. + t - k/2, g*cg + i] * w[t, i, g*cg + o]);
// b: [C] bf16 or null. Accumulation, bias and Mish in fp32, one cast.
//
// What bounds it on the card: at the main-path shape (B = 2, N = 1536,
// C = 1024, k = 31) a call is 12.5 GFLOP (0.0126 ms at 989 TFLOP/s) against
// 6 MB of activations and 2 MB of weights: the tensor cores bound it,
// provided the 31-fold reuse of each input row stays on chip instead of
// being unfolded in device memory.
//
// Design (bf16): implicit GEMM on TMA and wgmma (hopper.cuh), one block per
// (128 output rows, group, batch item), 288 threads: two consumer
// warpgroups of 64 output rows each and one producer warp.
//   window   TMA loads the block's input window (rows n0 - k/2 .. n0 + 127 +
//            k/2 of the group's 64 channels) once, through a 3-D map over
//            [B, N, C] whose box TMA fills with zeros outside [0, N), the
//            negative rows included: exactly the SAME padding. The window
//            lies in the 128-byte swizzled layout.
//   weights  one group's 31 taps are 254 KB, past the 227 KB of shared
//            memory, so the producer streams the per-tap tiles w[t, 0:64,
//            c0:c0+64] by TMA through a ring of kConvStages stages with
//            full/empty mbarriers. A tile is [64 in][64 out], out-channels
//            contiguous: the MN-major B operand (wgmma_desc_mn), the P.V form
//            of the attention core.
//   A        tap t is the window shifted by t rows. wgmma's shared-memory
//            descriptors address 8-row core matrices, so a one-row shift is
//            no descriptor offset: each warp reads its 16 rows at the shift
//            with ldmatrix (any row of the swizzled layout, conflict-free)
//            into the register-A fragments, as kernel 7's core reads its A
//            operand. Two fragment buffers: tap t + 1's are read while tap
//            t's wgmma group runs, and a buffer is written only after the
//            group that read it is done (wait_group 1), so ptxas has no
//            wgmma to serialize. (The other way, the TPU kernel's phase
//            trick, kept eight copies of the window shifted by 0-7 rows,
//            160 KB, so that tap 8a + r is copy r at a whole-atom offset of
//            8a rows, both operands from shared memory, one block an SM.
//            It was built and timed against this design at the main shape
//            and lost, 0.0441-0.0443 ms against 0.0278-0.0281 ms (H100 80GB
//            HBM3, 700 W; PERF.md section 6), so it was taken out.)
//   products wgmma m64n64k16 with A from registers, four k16 steps a tap,
//            one group a tap, fp32 accumulation over the 31 taps.
//   epilogue bias and Mish in fp32 (softplus in the logaddexp form), one
//            bf16 cast, 4-byte stores masked at N.
// 54 KB of shared memory and at most 112 registers a thread: two blocks an
// SM, so one block's epilogue overlaps the other's products. Grid at the
// main shape: 12 x 16 x 2 = 384 blocks on 132 SMs (2.9 blocks an SM). The
// TPU kernel's 128-lane block-diagonal group packing (grouped_conv.py:53-63)
// is a lane trade for the TPU's MXU and is not carried over. Before this
// design kernel C was an mma.sync implicit GEMM (eight warps, one tap's
// weights loaded synchronously between two barriers, 0.0547 ms at the main
// shape).
//
// fp32 operands (f5_grouped_conv_f32_fwd; the offline entry points keep fp32
// weights unless told otherwise, so this form runs twice a step of every
// fp32 utterance on F5TTS()'s own default path): grouped_conv_tf32_kernel,
// the same implicit GEMM as split 3xTF32 products on the tensor cores
// (mma.cuh: x = hi + lo, a.b ~ hi.hi + hi.lo + lo.hi in mma.sync m16n8k8
// .tf32; a single TF32 product keeps 10 mantissa bits and fails the fp32
// bound, which is why cuDNN's default TF32 convolution is the less exact of
// the two on the card). What bounds it: the same 12.5 GFLOP of fp32-accurate
// products, 0.076 ms at the TF32 rate taken three times (494.7 / 3 TFLOP/s;
// 0.19 ms at the 67 TFLOP/s of FFMA), against 25 MB of fp32 activations and
// 8 MB of weights (0.0099 ms).
//   block    256 threads, eight warps as 4 (32 output rows) x 2 (32 output
//            channels of the group), 128 output rows a block; grid
//            (ceil(N / 128), groups, B), 12 x 16 x 2 = 384 blocks at the main
//            shape (2.9 an SM at one block an SM).
//   window   rows n0 - k/2 .. n0 + 127 + k/2 of the group's 64 channels,
//            split once into hi and lo tf32 tiles [160][68] (attn_tf32.cuh's
//            row stride), zeros outside [0, N): the SAME padding.
//   A        tap t is the window shifted by t rows: lda_tf32 (ldmatrix) at
//            row offset t. ldmatrix takes one address a row, so the one-row
//            shift that no wgmma descriptor can express costs nothing here.
//   B        tap t's weights w[t, 0:64, c0:c0+64] are [in][out]: [k][n], read
//            as scalar B fragments (rows t and t + 4 of a k8 step, column g),
//            no transpose; the tile's row stride of 72 words puts the 32 lanes
//            of a read into distinct banks. Tap t + 1's tile is split into
//            hi and lo in the other of two buffers after tap t's products,
//            from registers loaded a tap earlier (16 floats a thread), so the
//            loads hide behind a tap's products and one barrier a tap
//            suffices. (A .tf32 wgmma would need the weights k-major, a
//            transposing split, for B, and the window's one-row shift as an
//            A operand from registers: this is the simpler of the two.)
//   products a tap is 64 deep: eight k8 steps of three TF32 products (the
//            small terms first), 24 mma.sync a fragment, summed into an
//            accumulator of its own, zeroed per tap, which is added to the
//            running sum with fp32 adds. The tensor cores' fp32 accumulation
//            truncates (probe_hopper.cu's accumulation probe): one chain over
//            31 taps would be 744 products deep, up to 744 x 2^-24 = 4.4e-5
//            of bias, against the fp32 bound of 1e-4.
//   epilogue bias and Mish in fp32 (mish(), softplus in the logaddexp form),
//            float2 stores masked at N.
// 157 KB of dynamic shared memory (window 85 KB, two buffers of hi and lo
// weights 72 KB) and 153 registers a thread (ptxas): one block an SM.
#include "attn_tf32.cuh"  // lda_tf32, split4 and the 3xTF32 product
#include "gemm_bf16.cuh"  // hopper.cuh, align_1024, allow_smem

namespace f5 {
namespace {

constexpr int kMaxTaps = 33;  // window rows = kConvRows + k - 1

__device__ __forceinline__ float mish(float x) {
  // softplus as logaddexp(x, 0), the form jax.nn.softplus computes
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// mish(x) = x tanh(softplus(x)) = x n / (n + 2) with n = e^x (e^x + 2): one
// exponential and one division in place of mish()'s exp, log1p and tanh (the
// bf16 form's epilogue was a third of its time). x > 20 gives x (tanh is 1 in
// fp32 there); rounded once to bf16, it agrees with mish() to fp32 rounding.
__device__ __forceinline__ float mish_fast(float x) {
  const float e = __expf(fminf(x, 20.f));
  const float n = e * (e + 2.f);
  return x * __fdividef(n, n + 2.f);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one instantiation per group width CG
// ---------------------------------------------------------------------------

constexpr int kConvWgs = 2;                      // consumer warpgroups, 64 rows each
constexpr int kConvRows = 64 * kConvWgs;         // output rows a block
constexpr int kConvThreads = 128 * kConvWgs + 32;
constexpr int kConvStages = 4;                   // weight ring depth
constexpr int kConvWinRows = kConvRows + kMaxTaps - 1;

// The geometry of one group width. A tile row is min(CG, 64) channels: 32,
// 64 or 128 bytes, swizzled over that span (TMA's 32B, 64B or 128B swizzle,
// the wgmma layout types B32, B64, B128). At CG = 128 (256-byte rows) the
// window and each tap's weights are two tiles of 64 channels, both B128:
// the K halves of the window, the N halves of the weights.
template <int CG>
struct ConvGeom {
  static_assert(CG == 16 || CG == 32 || CG == 64 || CG == 128, "group width");
  static constexpr int kSub = CG > 64 ? 2 : 1;              // tiles across the group
  static constexpr int kSubCols = CG / kSub;                // channels a tile row
  static constexpr int kRowB = kSubCols * 2;                // bytes a tile row
  static constexpr int kKSteps = CG / 16;                   // wgmma k16 steps a tap
  static constexpr int kWinTile = kConvWinRows * kRowB;     // one window tile
  static constexpr int kTapTile = CG * kRowB;               // one weight tile (N half)
  static constexpr int kTapBytes = kSub * kTapTile;         // one tap's weights
  static constexpr int kSmem = 1024 + kSub * kWinTile + kConvStages * kTapBytes +
                               (2 * kConvStages + 1) * 8;
  static constexpr int kMinBlocks = CG > 64 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (kRowB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr uint64_t kLayout = kRowB == 128 ? 1 : (kRowB == 64 ? 2 : 3);
  static constexpr int kAccN = kSubCols;                    // columns an accumulator
};
static_assert(ConvGeom<16>::kWinTile % 256 == 0 && ConvGeom<32>::kWinTile % 512 == 0 &&
                  ConvGeom<64>::kWinTile % 1024 == 0 && ConvGeom<16>::kTapTile % 256 == 0 &&
                  ConvGeom<32>::kTapTile % 512 == 0 && ConvGeom<64>::kTapTile % 1024 == 0,
              "every tile starts on its swizzle's repeat");

// address of 16-byte chunk `chunk` of row `row` of a tile of kRowB-byte rows
// in the matching swizzle (CUTLASS Swizzle<B, 4, 3>: the chunk bits XOR the
// address bits 7 and up); kRowB 128 is hopper.cuh's swz_chunk_addr
template <int kRowB>
__device__ __forceinline__ const unsigned char* swz_addr(const unsigned char* tile, int row,
                                                         int chunk) {
  const int sw = ((row * kRowB) >> 7) & (kRowB / 16 - 1);
  return tile + row * kRowB + ((chunk ^ sw) << 4);
}

// descriptor of an MN-major operand tile of kRowB-byte rows (N contiguous in
// a row, k down the rows): 8 rows (8 kRowB bytes) between k groups; the
// other offset (between N atoms) is never used, N being one atom wide
template <int CG>
__device__ __forceinline__ uint64_t conv_desc_mn(const void* tile) {
  constexpr uint64_t kOff = (8 * ConvGeom<CG>::kRowB) >> 4;
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (kOff << 16) | (kOff << 32) |
         (ConvGeom<CG>::kLayout << 62);
}

// d[8] (+)= A (64 x 16, registers) . B (B: [16][16] MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[16] (+)= A (64 x 16, registers) . B (B: [16][32] MN-major, transposed)
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16_tb(d, a, db, 1);
  else if constexpr (N == 32) wgmma_rs_n32_tb(d, a, db, 1);
  else wgmma_rs_n64_tb(d, a, db, 1);
}

// a warp's 16 output rows of an m64nNA accumulator (acc[4j + e] is row
// row0 + g + 8 (e >> 1), channel 8j + 2t + (e & 1)) plus the bias, Mish in
// fp32 and one bf16 cast, into out (the item's [N, C] rows at column c0),
// rows masked at N
template <int NA>
__device__ __forceinline__ void conv_epilogue(const float (&acc)[NA / 2],
                                              const bf16* __restrict__ bias,
                                              bf16* __restrict__ out, int N, int C, int c0,
                                              int row0, int lane, int fuse_mish) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NA / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float bb0 = bias ? __bfloat162float(bias[c0 + col]) : 0.f;
    const float bb1 = bias ? __bfloat162float(bias[c0 + col + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < N) {
        float v0 = acc[4 * j + 2 * half] + bb0;
        float v1 = acc[4 * j + 2 * half + 1] + bb1;
        if (fuse_mish) {
          v0 = mish_fast(v0);
          v1 = mish_fast(v1);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) = pack_bf16x2(v0, v1);
      }
    }
  }
}

// the register-A fragments of tap t for this warp's 16 output rows: window
// rows row0 + t .. + 15, CG / 16 k16 steps over the group's input channels
// (at CG = 128 steps 0-3 from the first window tile, 4-7 from the second)
template <int CG>
__device__ __forceinline__ void conv_frags(uint32_t (&a)[ConvGeom<CG>::kKSteps][4],
                                           const unsigned char* win, int row0, int t, int lane) {
  using G = ConvGeom<CG>;
  const int r = row0 + t + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < G::kKSteps; ++kk) {
    constexpr int kStepsPerTile = G::kSubCols / 16;
    const unsigned char* tile = win + (kk / kStepsPerTile) * G::kWinTile;
    ldmatrix_x4(a[kk], swz_addr<G::kRowB>(tile, r, 2 * (kk % kStepsPerTile) + (lane >> 4)));
  }
}

// one tap's product, acc += A . W_t, as one wgmma group: CG / 16 k16 steps,
// each on every N half of the weights (a k16 step is 16 tile rows further)
template <int CG>
__device__ __forceinline__ void conv_issue(float (&acc)[ConvGeom<CG>::kSub][ConvGeom<CG>::kAccN / 2],
                                           const uint32_t (&a)[ConvGeom<CG>::kKSteps][4],
                                           const unsigned char* tile_w) {
  using G = ConvGeom<CG>;
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < G::kSub; ++h) {
    const uint64_t db = conv_desc_mn<CG>(tile_w + h * G::kTapTile);
#pragma unroll
    for (int kk = 0; kk < G::kKSteps; ++kk)
      wgmma_rs_tb<G::kAccN>(acc[h], a[kk], db + kk * G::kRowB);
  }
  wgmma_commit();
}

template <int CG>
__global__ void __launch_bounds__(kConvThreads, ConvGeom<CG>::kMinBlocks)
grouped_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const bf16* __restrict__ bias, bf16* __restrict__ out, int N, int C,
                          int taps, int fuse_mish) {
  using G = ConvGeom<CG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* win = smem;
  unsigned char* ring = smem + G::kSub * G::kWinTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kConvStages * G::kTapBytes);
  uint64_t* empty = full + kConvStages;
  uint64_t* win_full = empty + kConvStages;
  const int n0 = blockIdx.x * kConvRows;
  const int c0 = blockIdx.y * CG;
  const int item = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive; TMA counts the bytes
      mbar_init(&empty[s], 4 * kConvWgs);  // lane 0 of every consumer warp
    }
    mbar_init(win_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kConvWgs) {
    if (lane == 0) {
      mbar_arrive_expect_tx(win_full, G::kSub * (kConvRows + taps - 1) * G::kRowB);
      for (int h = 0; h < G::kSub; ++h)
        tma_load_3d(win + h * G::kWinTile, &map_x, win_full, c0 + h * G::kSubCols,
                    n0 - taps / 2, item);
      for (int t = 0; t < taps; ++t) {
        const int s = t % kConvStages;
        mbar_wait(&empty[s], ((t / kConvStages) & 1) ^ 1);  // passes at once on the first round
        mbar_arrive_expect_tx(&full[s], G::kTapBytes);
        for (int h = 0; h < G::kSub; ++h)
          tma_load_2d(ring + s * G::kTapBytes + h * G::kTapTile, &map_w, &full[s],
                      c0 + h * G::kSubCols, t * CG);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int row0 = wg * 64 + (warp & 3) * 16;  // this warp's first output row in the block
  float acc[G::kSub][G::kAccN / 2];
#pragma unroll
  for (int h = 0; h < G::kSub; ++h)
#pragma unroll
    for (int i = 0; i < G::kAccN / 2; ++i) acc[h][i] = 0.f;
  uint32_t a0[G::kKSteps][4], a1[G::kKSteps][4];
  mbar_wait(win_full, 0);
  conv_frags<CG>(a0, win, row0, 0, lane);
  // tap t on `cur`; then, once tap t - 1's group is done, its stage is freed
  // and tap t + 1's fragments go into `next`, the buffer that group read
  auto step = [&](int t, const uint32_t (&cur)[G::kKSteps][4], uint32_t (&next)[G::kKSteps][4]) {
    const int s = t % kConvStages;
    mbar_wait(&full[s], (t / kConvStages) & 1);
    conv_issue<CG>(acc, cur, ring + s * G::kTapBytes);
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % kConvStages]);
    if (t + 1 < taps) conv_frags<CG>(next, win, row0, t + 1, lane);
  };
  for (int t = 0; t < taps; t += 2) {
    step(t, a0, a1);
    if (t + 1 < taps) step(t + 1, a1, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < G::kSub; ++h) {
    wgmma_fence_regs(acc[h]);
    conv_epilogue<G::kAccN>(acc[h], bias, out + (size_t)item * N * C + c0 + h * G::kSubCols, N,
                            C, c0 + h * G::kSubCols, n0 + row0, lane, fuse_mish);
  }
}

// ---------------------------------------------------------------------------
// fp32: split 3xTF32 on mma.sync, one instantiation per group width CG
// ---------------------------------------------------------------------------

constexpr int kTfRows = 128;                        // output rows a block
constexpr int kTfWinRows = kTfRows + kMaxTaps - 1;  // window rows, at most

// A block computes OC = min(CG, 64) output channels of one group (grid.y runs
// over groups x CG / OC) from the group's CG input channels, taken as passes
// of IC = min(CG, 64) channels; eight warps as WR row groups x WC channel
// groups, each MT m16 tiles x NT n8 tiles.
template <int CG>
struct TfGeom {
  static constexpr int kOC = CG < 64 ? CG : 64;
  static constexpr int kIC = kOC;
  static constexpr int kPasses = CG / kIC;   // input passes
  static constexpr int kHalves = CG / kOC;   // output-channel blocks of a group
  static constexpr int kWC = kOC >= 64 ? 2 : 1;
  static constexpr int kWR = 8 / kWC;
  static constexpr int kMT = kTfRows / (kWR * 16);
  static constexpr int kNT = kOC / kWC / 8;
  static constexpr int kLdW = kOC + 8;   // weight tile row stride (words): 72, 40, 24
  static constexpr int kTile = kIC * kLdW;  // one hi or lo weight tile (words)
  static constexpr int kSmem = (2 * kTfWinRows * kLD32 + 4 * kTile) * (int)sizeof(uint32_t);
  static constexpr int kLoads = (kIC * kOC / 4 + kT32 - 1) / kT32;  // float4 a thread a tap
};

// weights of step s = pass * taps + t: w[t, pass * IC + i, co0 + o] at
// (t * CG + pass * IC + i) * C + co0 + o; thread tid holds float4 number
// tid + 256 it of the [IC][OC] tile (row i / (OC / 4))
template <int CG>
__device__ __forceinline__ void conv_w_load(float4 (&r)[TfGeom<CG>::kLoads], const float* w,
                                            int s, int taps, int C, int tid) {
  using G = TfGeom<CG>;
  const int t = s % taps, pass = s / taps;
#pragma unroll
  for (int it = 0; it < G::kLoads; ++it) {
    const int i = tid + it * kT32;
    if (i < G::kIC * G::kOC / 4)
      r[it] = *reinterpret_cast<const float4*>(
          w + ((size_t)t * CG + pass * G::kIC + i / (G::kOC / 4)) * C + (i % (G::kOC / 4)) * 4);
  }
}

// those registers split into the hi tile at wt and the lo tile after it
template <int CG>
__device__ __forceinline__ void conv_w_split(uint32_t* wt, const float4 (&r)[TfGeom<CG>::kLoads],
                                             int tid) {
  using G = TfGeom<CG>;
#pragma unroll
  for (int it = 0; it < G::kLoads; ++it) {
    const int i = tid + it * kT32;
    if (i < G::kIC * G::kOC / 4)
      split4(wt, wt + G::kTile, (i / (G::kOC / 4)) * G::kLdW + (i % (G::kOC / 4)) * 4, r[it]);
  }
}

// window rows [n0 - taps / 2, n0 + 128 + taps / 2) of input channels xb[0,
// IC), zero outside [0, N), split into hi and lo tiles [160][68]
template <int CG>
__device__ __forceinline__ void conv_window(uint32_t* win_h, uint32_t* win_l, const float* xb,
                                            int n0, int N, int C, int taps, int tid) {
  constexpr int kQ = TfGeom<CG>::kIC / 4;  // float4 a row
  const int rows = kTfRows + taps - 1;
  for (int i = tid; i < rows * kQ; i += kT32) {
    const int r = i / kQ, cc = (i % kQ) * 4, pos = n0 - taps / 2 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos >= 0 && pos < N) val = *reinterpret_cast<const float4*>(xb + (size_t)pos * C + cc);
    split4(win_h, win_l, r * kLD32 + cc, val);
  }
}

// warp w owns output rows 16 MT (w / WC) .. and channels (OC / WC) (w % WC)
// .. of the block; acc[mt][nt][e] is row 16 MT (w / WC) + 16 mt + g + 8 (e >>
// 1), channel (OC / WC) (w % WC) + 8 nt + 2t + (e & 1)
template <int CG>
__global__ void __launch_bounds__(kT32, 1)
grouped_conv_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int N, int C,
                         int taps, int fuse_mish) {
  using G = TfGeom<CG>;
  constexpr int MT = G::kMT, NT = G::kNT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* win_h = reinterpret_cast<uint32_t*>(smem_raw);  // [160][68] each
  uint32_t* win_l = win_h + kTfWinRows * kLD32;
  uint32_t* wts = win_l + kTfWinRows * kLD32;  // two buffers of [hi, lo][IC][LdW]
  const int n0 = blockIdx.x * kTfRows;
  const int g0 = (blockIdx.y / G::kHalves) * CG;           // the group's first channel
  const int co0 = g0 + (blockIdx.y % G::kHalves) * G::kOC;  // this block's output channels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = (warp / G::kWC) * 16 * MT, cb = (warp % G::kWC) * (G::kOC / G::kWC);
  const float* xb = x + (size_t)blockIdx.z * N * C + g0;
  const float* wg = w + co0;
  const int steps = G::kPasses * taps;

  float4 wr[G::kLoads];
  float acc[MT][NT][4] = {};
  for (int pass = 0; pass < G::kPasses; ++pass) {
    if (pass == 0) conv_w_load<CG>(wr, wg, 0, taps, C, tid);
    conv_window<CG>(win_h, win_l, xb + pass * G::kIC, n0, N, C, taps, tid);
    if (pass == 0) {
      conv_w_split<CG>(wts, wr, tid);
      if (steps > 1) conv_w_load<CG>(wr, wg, 1, taps, C, tid);
    }
    __syncthreads();
    for (int t = 0; t < taps; ++t) {
      const int s = pass * taps + t;
      const uint32_t* bh = wts + (s & 1) * 2 * G::kTile;
      const uint32_t* bl = bh + G::kTile;
      float part[MT][NT][4] = {};  // this tap's product, a chain of its own
#pragma unroll
      for (int ks = 0; ks < G::kIC / 8; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          lda_tf32(ah[mt], win_h, r0 + 16 * mt + t, ks * 8, lane);
          lda_tf32(al[mt], win_l, r0 + 16 * mt + t, ks * 8, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int at = (ks * 8 + tq) * G::kLdW + cb + 8 * nt + g;
          const uint32_t bh0 = bh[at], bh1 = bh[at + 4 * G::kLdW];
          const uint32_t bl0 = bl[at], bl1 = bl[at + 4 * G::kLdW];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      if (s + 1 < steps) {  // step s + 1 into the buffer step s - 1 was read from
        conv_w_split<CG>(wts + ((s + 1) & 1) * 2 * G::kTile, wr, tid);
        if (s + 2 < steps) conv_w_load<CG>(wr, wg, s + 2, taps, C, tid);
      }
      __syncthreads();
    }
  }

  float* ob = out + (size_t)blockIdx.z * N * C + co0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = cb + 8 * nt + 2 * tq;
    const float bb0 = bias ? bias[co0 + col] : 0.f;
    const float bb1 = bias ? bias[co0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = n0 + r0 + 16 * mt + g + 8 * h;
        if (row >= N) continue;
        float v0 = acc[mt][nt][2 * h] + bb0, v1 = acc[mt][nt][2 * h + 1] + bb1;
        if (fuse_mish) {
          v0 = mish(v0);
          v1 = mish(v1);
        }
        *reinterpret_cast<float2*>(ob + (size_t)row * C + col) = make_float2(v0, v1);
      }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int CG>
int launch_conv_f32(const void* x, const void* w, const void* b, void* out, int B, int N, int C,
                    int groups, int taps, int fuse_mish, cudaStream_t stream) {
  using G = TfGeom<CG>;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(grouped_conv_tf32_kernel<CG>, G::kSmem, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kTfRows - 1) / kTfRows, groups * G::kHalves, B);
  grouped_conv_tf32_kernel<CG><<<grid, kT32, G::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), N, C, taps, fuse_mish);
  return (int)cudaGetLastError();
}

// x [B, N, C] bf16 as boxes of (kConvRows + taps - 1) rows x min(CG, 64)
// channels of one item; w [taps * CG, C] as boxes of CG rows x min(CG, 64)
// channels; both in CG's swizzle
template <int CG>
int launch_conv_bf16(const void* x, const void* w, const void* b, void* out, int B, int N,
                     int C, int groups, int taps, int fuse_mish, cudaStream_t stream) {
  using G = ConvGeom<CG>;
  CUtensorMap map_x, map_w;
  const MapKey kx{x, 3, {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B, 0},
                  {(cuuint64_t)C * 2, (cuuint64_t)N * C * 2, 0},
                  {G::kSubCols, (cuuint32_t)(kConvRows + taps - 1), 1, 0}, kMapBf16, G::kSwizzle};
  const MapKey kw{w, 2, {(cuuint64_t)C, (cuuint64_t)taps * CG, 0, 0}, {(cuuint64_t)C * 2, 0, 0},
                  {G::kSubCols, CG, 0, 0}, kMapBf16, G::kSwizzle};
  if (!encode_map(&map_x, kx) || !encode_map(&map_w, kw)) return (int)cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(grouped_conv_wgmma_kernel<CG>, G::kSmem, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kConvRows - 1) / kConvRows, groups, B);
  grouped_conv_wgmma_kernel<CG><<<grid, kConvThreads, G::kSmem, stream>>>(
      map_x, map_w, static_cast<const bf16*>(b), static_cast<bf16*>(out), N, C, taps, fuse_mish);
  return (int)cudaGetLastError();
}

bool conv_dims_ok(int B, int N, int C, int groups, int taps) {
  if (B <= 0 || N <= 0 || groups <= 0 || C % groups || taps % 2 == 0 || taps > kMaxTaps ||
      B > 65535 || groups > 32767)
    return false;
  const int cg = C / groups;
  return cg == 16 || cg == 32 || cg == 64 || cg == 128;
}

}  // namespace
}  // namespace f5

// C / groups 16, 32, 64 or 128 (one instantiation each); taps odd and at most
// 33. x, w, out 16-byte aligned.
extern "C" int f5_grouped_conv_f32_fwd(const void* x, const void* w, const void* b, void* out,
                                       int B, int N, int C, int groups, int taps, int fuse_mish,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::conv_dims_ok(B, N, C, groups, taps)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (C / groups) {
    case 16: return f5::launch_conv_f32<16>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    case 32: return f5::launch_conv_f32<32>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    case 64: return f5::launch_conv_f32<64>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    default: return f5::launch_conv_f32<128>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
  }
}

extern "C" int f5_grouped_conv_fwd(const void* x, const void* w, const void* b, void* out, int B,
                                   int N, int C, int groups, int taps, int fuse_mish, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!f5::conv_dims_ok(B, N, C, groups, taps)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (C / groups) {
    case 16: return f5::launch_conv_bf16<16>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    case 32: return f5::launch_conv_bf16<32>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    case 64: return f5::launch_conv_bf16<64>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
    default: return f5::launch_conv_bf16<128>(x, w, b, out, B, N, C, groups, taps, fuse_mish, s);
  }
}

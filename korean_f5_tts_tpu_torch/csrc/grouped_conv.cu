// Grouped conv1d (SAME padding) + bias + optional Mish for Hopper (sm_90a):
// ConvPositionEmbedding's two convolutions (k = 31, 16 groups of 64).
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

constexpr int kCG = 64;        // channels per group (the only width taken)
constexpr int kMaxTaps = 33;   // window rows = kConvRows + k - 1

__device__ __forceinline__ float mish(float x) {
  // softplus as logaddexp(x, 0), the form jax.nn.softplus computes
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

constexpr int kConvWgs = 2;                      // consumer warpgroups, 64 rows each
constexpr int kConvRows = 64 * kConvWgs;         // output rows a block
constexpr int kConvThreads = 128 * kConvWgs + 32;
constexpr int kConvStages = 4;                   // weight ring depth
constexpr int kConvWinBytes = (kConvRows + kMaxTaps - 1) * kRowBytes;  // 20 KB, 1024-aligned
constexpr int kConvTapBytes = kCG * kRowBytes;   // one tap's [64][64] weights
constexpr int kConvSmemBytes =
    1024 + kConvWinBytes + kConvStages * kConvTapBytes + (2 * kConvStages + 1) * 8;

// mish(x) = x tanh(softplus(x)) = x n / (n + 2) with n = e^x (e^x + 2): one
// exponential and one division in place of mish()'s exp, log1p and tanh (the
// bf16 form's epilogue was a third of its time). x > 20 gives x (tanh is 1 in
// fp32 there); rounded once to bf16, it agrees with mish() to fp32 rounding.
__device__ __forceinline__ float mish_fast(float x) {
  const float e = __expf(fminf(x, 20.f));
  const float n = e * (e + 2.f);
  return x * __fdividef(n, n + 2.f);
}

// a warp's 16 output rows of the m64n64 accumulator (acc[4j + e] is row
// row0 + g + 8 (e >> 1), channel 8j + 2t + (e & 1)) plus the bias, Mish in
// fp32 and one bf16 cast, into out (the item's [N, C] rows at column c0),
// rows masked at N
__device__ __forceinline__ void conv_epilogue(const float (&acc)[32], const bf16* __restrict__ bias,
                                              bf16* __restrict__ out, int N, int C, int c0,
                                              int row0, int lane, int fuse_mish) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
// rows row0 + t .. + 15, four k16 steps over the 64 input channels
__device__ __forceinline__ void conv_frags(uint32_t (&a)[4][4], const unsigned char* win,
                                           int row0, int t, int lane) {
  const int r = row0 + t + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], swz_chunk_addr(win, r, 2 * kk + (lane >> 4)));
}

// one tap's product, acc += A . W_t, as one wgmma group
__device__ __forceinline__ void conv_issue(float (&acc)[32], const uint32_t (&a)[4][4],
                                           const unsigned char* tile_w) {
  const uint64_t db = wgmma_desc_mn(tile_w);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, a[kk], db + 128 * kk, 1);
  wgmma_commit();
}

__global__ void __launch_bounds__(kConvThreads, 2)
grouped_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const bf16* __restrict__ bias, bf16* __restrict__ out, int N, int C,
                          int taps, int fuse_mish) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* win = smem;
  unsigned char* ring = smem + kConvWinBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kConvStages * kConvTapBytes);
  uint64_t* empty = full + kConvStages;
  uint64_t* win_full = empty + kConvStages;
  const int n0 = blockIdx.x * kConvRows;
  const int c0 = blockIdx.y * kCG;
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
      mbar_arrive_expect_tx(win_full, (kConvRows + taps - 1) * kRowBytes);
      tma_load_3d(win, &map_x, win_full, c0, n0 - taps / 2, item);
      for (int t = 0; t < taps; ++t) {
        const int s = t % kConvStages;
        mbar_wait(&empty[s], ((t / kConvStages) & 1) ^ 1);  // passes at once on the first round
        mbar_arrive_expect_tx(&full[s], kConvTapBytes);
        tma_load_2d(ring + s * kConvTapBytes, &map_w, &full[s], c0, t * kCG);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int row0 = wg * 64 + (warp & 3) * 16;  // this warp's first output row in the block
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];
  mbar_wait(win_full, 0);
  conv_frags(a0, win, row0, 0, lane);
  // tap t on `cur`; then, once tap t - 1's group is done, its stage is freed
  // and tap t + 1's fragments go into `next`, the buffer that group read
  auto step = [&](int t, const uint32_t (&cur)[4][4], uint32_t (&next)[4][4]) {
    const int s = t % kConvStages;
    mbar_wait(&full[s], (t / kConvStages) & 1);
    conv_issue(acc, cur, ring + s * kConvTapBytes);
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % kConvStages]);
    if (t + 1 < taps) conv_frags(next, win, row0, t + 1, lane);
  };
  for (int t = 0; t < taps; t += 2) {
    step(t, a0, a1);
    if (t + 1 < taps) step(t + 1, a1, a0);
  }
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  conv_epilogue(acc, bias, out + (size_t)item * N * C + c0, N, C, c0, n0 + row0, lane,
                fuse_mish);
}

// ---------------------------------------------------------------------------
// fp32: split 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kTfRows = 128;                        // output rows a block
constexpr int kTfWinRows = kTfRows + kMaxTaps - 1;  // window rows, at most
constexpr int kTfLdW = 72;                          // weight tile row stride (words)
constexpr int kTfTile = kCG * kTfLdW;               // one hi or lo weight tile (words)
constexpr int kTfSmem = (2 * kTfWinRows * kLD32 + 4 * kTfTile) * (int)sizeof(uint32_t);

// tap t's [64 in][64 out] weights of the group at w (w[t, i, c0 + o] at
// (t * 64 + i) * C + o): thread tid holds rows (tid + 256 it) / 16, columns
// 4 ((tid + 256 it) % 16) .. + 3
__device__ __forceinline__ void conv_w_load(float4 (&r)[4], const float* w, int t, int C,
                                            int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + it * kT32;
    r[it] = *reinterpret_cast<const float4*>(w + ((size_t)t * kCG + (i >> 4)) * C + (i & 15) * 4);
  }
}

// those registers split into the hi tile at wt and the lo tile after it;
// eight consecutive threads store one row's 32 words
__device__ __forceinline__ void conv_w_split(uint32_t* wt, const float4 (&r)[4], int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + it * kT32;
    split4(wt, wt + kTfTile, (i >> 4) * kTfLdW + (i & 15) * 4, r[it]);
  }
}

// warp w owns output rows 32 (w / 2) .. + 31 and channels 32 (w % 2) .. + 31
// of the block; acc[mt][nt][e] is row 32 (w / 2) + 16 mt + g + 8 (e >> 1),
// channel 32 (w % 2) + 8 nt + 2t + (e & 1)
__global__ void __launch_bounds__(kT32, 1)
grouped_conv_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int N, int C,
                         int taps, int fuse_mish) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* win_h = reinterpret_cast<uint32_t*>(smem_raw);  // [160][68] each
  uint32_t* win_l = win_h + kTfWinRows * kLD32;
  uint32_t* wts = win_l + kTfWinRows * kLD32;  // two buffers of [hi, lo][64][72]
  const int n0 = blockIdx.x * kTfRows;
  const int c0 = blockIdx.y * kCG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = (warp >> 1) * 32, cb = (warp & 1) * 32;
  const float* xb = x + (size_t)blockIdx.z * N * C + c0;
  const float* wg = w + c0;

  float4 wr[4];
  conv_w_load(wr, wg, 0, C, tid);
  // the window: positions [n0 - taps / 2, n0 + 128 + taps / 2), zero outside [0, N)
  const int rows = kTfRows + taps - 1;
  for (int i = tid; i < rows * (kCG / 4); i += kT32) {
    const int r = i >> 4, cc = (i & 15) * 4, pos = n0 - taps / 2 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos >= 0 && pos < N) val = *reinterpret_cast<const float4*>(xb + (size_t)pos * C + cc);
    split4(win_h, win_l, r * kLD32 + cc, val);
  }
  conv_w_split(wts, wr, tid);
  if (taps > 1) conv_w_load(wr, wg, 1, C, tid);
  float acc[2][4][4] = {};
  __syncthreads();

  for (int t = 0; t < taps; ++t) {
    const uint32_t* bh = wts + (t & 1) * 2 * kTfTile;
    const uint32_t* bl = bh + kTfTile;
    float part[2][4][4] = {};  // this tap's product, a chain of its own
#pragma unroll
    for (int ks = 0; ks < kCG / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        lda_tf32(ah[mt], win_h, r0 + 16 * mt + t, ks * 8, lane);
        lda_tf32(al[mt], win_l, r0 + 16 * mt + t, ks * 8, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int at = (ks * 8 + tq) * kTfLdW + cb + 8 * nt + g;
        const uint32_t bh0 = bh[at], bh1 = bh[at + 4 * kTfLdW];
        const uint32_t bl0 = bl[at], bl1 = bl[at + 4 * kTfLdW];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    if (t + 1 < taps) {  // tap t + 1 into the buffer tap t - 1 was read from
      conv_w_split(wts + ((t + 1) & 1) * 2 * kTfTile, wr, tid);
      if (t + 2 < taps) conv_w_load(wr, wg, t + 2, C, tid);
    }
    __syncthreads();
  }

  float* ob = out + (size_t)blockIdx.z * N * C + c0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = cb + 8 * nt + 2 * tq;
    const float bb0 = bias ? bias[c0 + col] : 0.f;
    const float bb1 = bias ? bias[c0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
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

}  // namespace
}  // namespace f5

static bool conv_dims_ok(int B, int N, int C, int groups, int taps) {
  return B > 0 && N > 0 && groups > 0 && C == groups * f5::kCG && taps % 2 == 1 &&
         taps <= f5::kMaxTaps && B <= 65535 && groups <= 65535;
}

// the same on fp32 x, w, b, out
extern "C" int f5_grouped_conv_f32_fwd(const void* x, const void* w, const void* b, void* out,
                                       int B, int N, int C, int groups, int taps, int fuse_mish,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!conv_dims_ok(B, N, C, groups, taps)) return (int)cudaErrorInvalidValue;
  static std::atomic<bool> ready[f5::kMaxDevices];
  err = f5::allow_smem(f5::grouped_conv_tf32_kernel, f5::kTfSmem, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + f5::kTfRows - 1) / f5::kTfRows, groups, B);
  f5::grouped_conv_tf32_kernel<<<grid, f5::kT32, f5::kTfSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), N, C, taps, fuse_mish);
  return (int)cudaGetLastError();
}

// C / groups must be 64; taps odd and at most 33. x, w, out 16-byte aligned.
extern "C" int f5_grouped_conv_fwd(const void* x, const void* w, const void* b, void* out, int B,
                                   int N, int C, int groups, int taps, int fuse_mish, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!conv_dims_ok(B, N, C, groups, taps)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!f5::tensor_map_3d(&map_x, x, B, N, C, f5::kConvRows + taps - 1, f5::kMapBf16) ||
      !f5::tensor_map(&map_w, w, (uint64_t)taps * f5::kCG, C, f5::kCG, f5::kMapBf16))
    return (int)cudaErrorInvalidValue;
  static std::atomic<bool> ready[f5::kMaxDevices];
  err = f5::allow_smem(f5::grouped_conv_wgmma_kernel, f5::kConvSmemBytes, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + f5::kConvRows - 1) / f5::kConvRows, groups, B);
  f5::grouped_conv_wgmma_kernel<<<grid, f5::kConvThreads, f5::kConvSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const f5::bf16*>(b), static_cast<f5::bf16*>(out), N, C, taps,
      fuse_mish);
  return (int)cudaGetLastError();
}

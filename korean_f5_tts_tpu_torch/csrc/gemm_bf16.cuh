// The bf16 product core of the FF half-block (ff_block.cu: kernel B) and of
// the attention-side linears (fused_linears.cu: kernels 7 and 8), designed
// for Hopper: TMA-fed ring of shared-memory stages, wgmma products, warp
// specialisation.
//
// Three kernels:
//   ln_stats_kernel: mean and 1/std of every row of h (two passes in fp32,
//       one warp per row), written once as [2, M] fp32. The product kernel
//       reads them, so the N / BN column blocks of a row tile do not each
//       recompute them.
//   ln_mod_gemm_kernel<BN, kGelu>:
//       out = bf16(act(bf16(LN(h) * (1 + sc) + sh) @ W^T + b)), act =
//       gelu_tanh or nothing, over up to three weight segments of seg_n
//       output columns (q, k, v), so no fused weight is built.
//   gated_residual_gemm_kernel<BN>: out = bf16(h + gate * (a @ W^T + b)).
//
// One block computes a 128 x BN output tile (BN 128 or 256) with 384
// threads: two consumer warpgroups of 64 rows each and a producer warpgroup
// of which one thread starts the TMA loads; setmaxnreg moves the producer's registers
// to the consumers (a 64 x 256 fp32 accumulator is 128 registers a thread).
// The k loop walks 64-wide steps through a ring of four stages; a stage
// holds the A tile [128][64] and the B tile [BN][64] in the 128-byte
// swizzled layout (hopper.cuh). The producer waits on a stage's `empty`
// barrier, arms its `full` barrier with the byte count and asks for the two
// tile loads; the consumers wait on `full`, start four wgmma m64nBNk16 and
// arrive on `empty` when the products that read the stage have completed
// (gated_residual_gemm_kernel keeps one group of products in flight and
// releases the stage before). There is no __syncthreads() in the loop, and
// loads run up to a ring's depth less one ahead of the products.
//
// The A operand of ln_mod_gemm_kernel is computed, not loaded: the h tile
// arrives by TMA like any operand, each consumer warp reads its 16 rows with
// ldmatrix in the A-fragment layout, applies LN and the modulation to the
// registers in fp32, rounds to bf16 and feeds wgmma with A from registers.
// This was chosen over writing y tiles back into swizzled shared memory:
// it needs no second pass through shared memory, no fence.proxy.async
// between ordinary stores and the tensor cores' reads, and no barrier
// between the warps that write a tile and those that read it. (1 + sc) and
// sh sit in shared memory as fp32 for the whole tile. y never reaches
// device memory. gated_residual_gemm_kernel takes both operands from shared
// memory.
//
// Edges: TMA fills reads past M, N or K with zeros and stores are masked, so
// M needs no multiple and K only the 16-byte row alignment TMA asks for
// (K % 8 == 0); the last k step of a K that is no multiple of 64 multiplies
// zeros. N is a multiple of BN (the host picks BN so that it is).
//
// Rounding points are the TPU kernels': LN and modulation in fp32, y rounded
// to bf16, fp32 accumulation, + b and GELU-tanh in fp32, one cast; the gated
// residual in fp32, one cast. tanh(u) is computed as 1 - 2 / (1 + exp(2u))
// with the fast exponential and division (error ~1e-6, against 4e-3 for the
// bf16 rounding that follows): tanhf is some thirty instructions a call, up
// to 128 calls a thread, in an epilogue that overlaps nothing.
//
// Tiles at the main shape (M = 3072: 24 row tiles; 132 SMs, one block each):
//   B's first product  N 2048: BN 256 -> 192 tiles (1.45 waves), BN 128 -> 384 (2.9)
//   B's second product N 1024: BN 256 ->  96 tiles (0.73),       BN 128 -> 192 (1.45)
//   kernel 7           N 3072: BN 256 -> 288 tiles (2.2),        BN 128 -> 576 (4.4)
//   kernel 8           N 1024: as B's second product
// gemm_tile_n() below picks BN per product by waves x tile cost, from the
// card's SM count (chip_smoke.py times both widths of kernel 8's product).
//
// Measured at M = 3072 on an NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py, phase 2): B 0.083 ms, kernel 7 0.058-0.060, kernel 8
// 0.019-0.020: 310-335 TFLOP/s, a third of the bf16 peak, from 94 TFLOP/s on
// the mma.sync core this file held before. What holds it there: a tile's
// prologue and epilogue overlap nothing (one block per SM at a time, and K =
// 1024 is only 16 k steps): kernel 8 without its epilogue took 12.5 of 22
// microseconds, and a lone 128 x 128 tile takes ~10 where its products need
// 4.7. Next: persistent blocks whose epilogue runs on warps of its own (or
// ping-pong consumers) while the next tile's products start, then clusters
// with TMA multicast to halve the operand traffic from L2 (~4 TB/s now).
#pragma once

#include <atomic>

#include "hopper.cuh"

namespace f5 {
namespace {

constexpr int kBM = 128;           // rows of an output tile: two consumer warpgroups x 64
constexpr int kStages = 4;         // ring depth (6 stages of the 128-wide tile measured no faster)
constexpr int kConsumerWarps = 8;
constexpr int kGemmThreads = 384;  // consumers + the producer warpgroup
constexpr int kATileBytes = kBM * kRowBytes;
constexpr int kMaxLnDim = 4096;    // (1 + sc) and sh as fp32 in shared memory: 32 KB
constexpr int kStatsThreads = 256;

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kATileBytes + BN * kRowBytes;
}

// dynamic shared memory of a product kernel: alignment slack, the ring, the
// barriers, and (ln_mod only) the two fp32 vectors of d_pad elements
template <int BN>
__host__ __device__ constexpr int gemm_smem_bytes(int d_pad) {
  return 1024 + kStages * (stage_bytes<BN>() + 2 * 8) + 2 * d_pad * 4;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = c * (x + 0.044715f * x * x * x);
  const float th = 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
  return 0.5f * x * (1.f + th);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// stats[row] = mean, stats[M + row] = 1 / sqrt(var + eps) of h[row, :d]: two
// passes in fp32, one warp per row, 16-byte loads (d * sizeof(T) % 16 == 0)
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
ln_stats_kernel(const T* __restrict__ h, float* __restrict__ stats, int M, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* p = h + (size_t)row * d;
  float s = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    const int4 raw = *reinterpret_cast<const int4*>(p + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) s += to_float(e[i]);
  }
  const float mu = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    const int4 raw = *reinterpret_cast<const int4*>(p + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float x = to_float(e[i]) - mu;
      v += x * x;
    }
  }
  v = warp_sum(v);
  if (lane == 0) {
    stats[row] = mu;
    stats[M + row] = 1.f / sqrtf(v / d + eps);
  }
}

template <typename T>
cudaError_t launch_ln_stats(const void* h, void* stats, int M, int d, float eps,
                            cudaStream_t stream) {
  const int rows_per_block = kStatsThreads / 32;
  ln_stats_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, kStatsThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<float*>(stats), M, d, eps);
  return cudaGetLastError();
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 256) wgmma_ss_n256(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// the producer's loop: one thread keeps the ring full; a k step is
// kStepCols elements (kTileK bf16 or kTileK8 int8: 128 bytes of a row)
template <int BN, int kStepCols = kTileK>
__device__ __forceinline__ void produce_tiles(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* map_a, const CUtensorMap* map_b,
                                              int m0, int n0, int kt_total) {
  for (int kt = 0; kt < kt_total; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);  // passes at once on the first round
    unsigned char* tile = smem + s * stage_bytes<BN>();
    mbar_arrive_expect_tx(&full[s], stage_bytes<BN>());
    tma_load_2d(tile, map_a, &full[s], kt * kStepCols, m0);
    tma_load_2d(tile + kATileBytes, map_b, &full[s], kt * kStepCols, n0);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], 1);                // the producer's arrive; TMA counts the bytes
    mbar_init(&empty[s], kConsumerWarps);  // lane 0 of every consumer warp
  }
  mbar_init_fence();
}

// barrier of the eight consumer warps alone (__syncthreads is barrier 0)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// The epilogue goes through shared memory so that device memory sees whole
// rows: in the accumulator layout a thread holds two columns of a row, and
// storing from there writes 4 bytes a thread, half a sector per row, which
// measured 9 of kernel 8's 22 microseconds. When both consumer warpgroups
// have left the k loop the ring is free (every load has landed and been
// read): each warp parks its 16 x BN accumulators there as fp32, row stride
// BN + 8 floats (the 8-byte stores of a half-warp then fall into 32 distinct
// banks), and reads them back a row at a time, four columns a lane, so that a
// warp's loads of h and stores of out are 256 contiguous bytes.
template <int BN>
__device__ __forceinline__ float* stage_accumulators(unsigned char* smem, const float (&acc)[BN / 2],
                                                     int warp, int lane) {
  constexpr int LD = BN + 8;
  consumer_sync();
  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(stage + g * LD + 8 * j + 2 * t) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (g + 8) * LD + 8 * j + 2 * t) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
  return stage;
}

// four bf16 at p (8-byte aligned) as floats
__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// two bf16 of h -> two bf16 of y = (x - mu) * rstd * (1 + sc) + sh
__device__ __forceinline__ uint32_t ln_mod_pair(uint32_t x, float mu, float rstd, float2 mul,
                                                float2 add) {
  const float x0 = __uint_as_float(x << 16), x1 = __uint_as_float(x & 0xffff0000u);
  return pack_bf16x2((x0 - mu) * rstd * mul.x + add.x, (x1 - mu) * rstd * mul.y + add.y);
}

// out[M, gridDim.x * BN] = act(bf16(LN(h) * (1 + sc) + sh) @ W^T + b); output
// column block n0 belongs to segment n0 / seg_n (maps map_w0..2, biases b0..2)
template <int BN, bool kGelu>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_mod_gemm_kernel(const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_w0,
                   const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ stats,
                   const bf16* __restrict__ sc, const bf16* __restrict__ sh,
                   const bf16* __restrict__ b0, const bf16* __restrict__ b1,
                   const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int d, int seg_n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int kt_total = (d + kTileK - 1) / kTileK;
  const int d_pad = kt_total * kTileK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<BN>());
  uint64_t* empty = full + kStages;
  float* s_mul = reinterpret_cast<float*>(empty + kStages);  // 1 + sc
  float* s_add = s_mul + d_pad;                              // sh
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int ldo = gridDim.x * BN;
  const int seg = n0 / seg_n;
  const int nloc = n0 - seg * seg_n;  // column block within the segment
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) init_ring(full, empty);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumerWarps * 32) {
      const CUtensorMap* map_w = seg == 0 ? &map_w0 : (seg == 1 ? &map_w1 : &map_w2);
      produce_tiles<BN>(smem, full, empty, &map_h, map_w, m0, nloc, kt_total);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // the modulation vectors, while the producer's first loads are in flight
    for (int i = tid; i < d_pad; i += kConsumerWarps * 32) {
      s_mul[i] = i < d ? 1.f + __bfloat162float(sc[i]) : 0.f;
      s_add[i] = i < d ? __bfloat162float(sh[i]) : 0.f;
    }
    consumer_sync();
    const int g = lane >> 2, t = lane & 3;
    const int row_a = warp * 16;  // this warp's 16 rows of the tile
    const int r0 = m0 + row_a + g, r1 = r0 + 8;
    const float mu0 = r0 < M ? stats[r0] : 0.f, rs0 = r0 < M ? stats[M + r0] : 0.f;
    const float mu1 = r1 < M ? stats[r1] : 0.f, rs1 = r1 < M ? stats[M + r1] : 0.f;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // A step's products are waited for before the next step's fragments are
    // formed: ptxas serializes wgmma whose input registers are written while
    // a group is in flight, so a second set of fragments buys nothing. The
    // other warpgroup's products fill the tensor cores meanwhile.
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const unsigned char* tile_a = smem + s * stage_bytes<BN>();
      uint32_t a[kTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        uint32_t x[4];
        ldmatrix_x4(x, swz_chunk_addr(tile_a, row_a + (lane & 15), kk * 2 + (lane >> 4)));
        const int c = kt * kTileK + kk * 16 + 2 * t;
        const float2 mul_lo = *reinterpret_cast<const float2*>(s_mul + c);
        const float2 add_lo = *reinterpret_cast<const float2*>(s_add + c);
        const float2 mul_hi = *reinterpret_cast<const float2*>(s_mul + c + 8);
        const float2 add_hi = *reinterpret_cast<const float2*>(s_add + c + 8);
        a[kk][0] = ln_mod_pair(x[0], mu0, rs0, mul_lo, add_lo);
        a[kk][1] = ln_mod_pair(x[1], mu1, rs1, mul_lo, add_lo);
        a[kk][2] = ln_mod_pair(x[2], mu0, rs0, mul_hi, add_hi);
        a[kk][3] = ln_mod_pair(x[3], mu1, rs1, mul_hi, add_hi);
      }
      const uint64_t db = wgmma_desc(tile_a + kATileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) wgmma_rs<BN>(acc, a[kk], db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    constexpr int LD = BN + 8;
    const float* stage = stage_accumulators<BN>(smem, acc, warp, lane);
    const bf16* bias = (seg == 0 ? b0 : (seg == 1 ? b1 : b2)) + nloc;
#pragma unroll
    for (int cc = 0; cc < BN; cc += 128) {
      const int cl = cc + 4 * lane;  // column within the block
      const float4 bb = load_bf16x4(bias + cl);
#pragma unroll 8
      for (int r = 0; r < 16; ++r) {
        const int row = m0 + row_a + r;
        float4 o = *reinterpret_cast<const float4*>(stage + r * LD + cl);
        o = make_float4(o.x + bb.x, o.y + bb.y, o.z + bb.z, o.w + bb.w);
        if (kGelu) o = make_float4(gelu_tanh(o.x), gelu_tanh(o.y), gelu_tanh(o.z), gelu_tanh(o.w));
        if (row < M) store_bf16x4(out + (size_t)row * ldo + n0 + cl, o);
      }
    }
  }
}

// out[M, d] = bf16(h + gate * (a[M, K] @ W[d, K]^T + b)); d = gridDim.x * BN
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gated_residual_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ b,
                           const bf16* __restrict__ h, const bf16* __restrict__ gate,
                           bf16* __restrict__ out, int M, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<BN>());
  uint64_t* empty = full + kStages;
  const int kt_total = (K + kTileK - 1) / kTileK;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int d = gridDim.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) init_ring(full, empty);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumerWarps * 32)
      produce_tiles<BN>(smem, full, empty, &map_a, &map_w, m0, n0, kt_total);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // one group of products stays in flight: a step's stage goes back to
    // the producer when the next step's products have been started
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const unsigned char* tile_a = smem + s * stage_bytes<BN>();
      const uint64_t da = wgmma_desc(tile_a + wg * 64 * kRowBytes);  // this warpgroup's 64 rows
      const uint64_t db = wgmma_desc(tile_a + kATileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk)
        wgmma_ss<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);

    constexpr int LD = BN + 8;
    const float* stage = stage_accumulators<BN>(smem, acc, warp, lane);
#pragma unroll
    for (int cc = 0; cc < BN; cc += 128) {
      const int col = n0 + cc + 4 * lane;
      const float4 bb = load_bf16x4(b + col), gg = load_bf16x4(gate + col);
#pragma unroll 8
      for (int r = 0; r < 16; ++r) {
        const int row = m0 + warp * 16 + r;
        if (row < M) {
          const float4 v = *reinterpret_cast<const float4*>(stage + r * LD + cc + 4 * lane);
          const float4 hv = load_bf16x4(h + (size_t)row * d + col);
          store_bf16x4(out + (size_t)row * d + col,
                       make_float4(hv.x + gg.x * (v.x + bb.x), hv.y + gg.y * (v.y + bb.y),
                                   hv.z + gg.z * (v.z + bb.z), hv.w + gg.w * (v.w + bb.w)));
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory limit, once per kernel and device:
// the call costs microseconds of host time, on a path whose host time shows
// end to end. `ready` is the kernel's own flags; a flag is set only after the
// attribute is, so a second host thread that finds it set may launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool> (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  return err;
}

// Host side. seg_n % BN == 0, d % 8 == 0, d <= kMaxLnDim. stats: [2, M] fp32
// scratch. Launches ln_stats_kernel, then the product.
template <int BN, bool kGelu>
cudaError_t launch_ln_mod_gemm(const void* h, const void* sc, const void* sh,
                               const void* const (&w)[3], const void* const (&b)[3], void* stats,
                               void* out, int M, int d, int seg_n, int nseg, float eps,
                               cudaStream_t stream) {
  cudaError_t err = launch_ln_stats<bf16>(h, stats, M, d, eps, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap map_h, map_w[3];
  if (!tensor_map(&map_h, h, M, d, kBM, kMapBf16)) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!tensor_map(&map_w[i], w[i], seg_n, d, BN, kMapBf16)) return cudaErrorInvalidValue;
  const int d_pad = (d + kTileK - 1) / kTileK * kTileK;
  static std::atomic<bool> ready[kMaxDevices];
  err = allow_smem(ln_mod_gemm_kernel<BN, kGelu>, gemm_smem_bytes<BN>(kMaxLnDim), ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(nseg * seg_n / BN, (M + kBM - 1) / kBM);
  ln_mod_gemm_kernel<BN, kGelu><<<grid, kGemmThreads, gemm_smem_bytes<BN>(d_pad), stream>>>(
      map_h, map_w[0], map_w[1], map_w[2], static_cast<const float*>(stats),
      static_cast<const bf16*>(sc), static_cast<const bf16*>(sh), static_cast<const bf16*>(b[0]),
      static_cast<const bf16*>(b[1]), static_cast<const bf16*>(b[2]), static_cast<bf16*>(out), M,
      d, seg_n);
  return cudaGetLastError();
}

// d % BN == 0, K % 8 == 0
template <int BN>
cudaError_t launch_gated_residual_gemm(const void* a, const void* w, const void* b, const void* h,
                                       const void* gate, void* out, int M, int d, int K,
                                       cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  if (!tensor_map(&map_a, a, M, K, kBM, kMapBf16) || !tensor_map(&map_w, w, d, K, BN, kMapBf16))
    return cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes<BN>(0);
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(gated_residual_gemm_kernel<BN>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(d / BN, (M + kBM - 1) / kBM);
  gated_residual_gemm_kernel<BN><<<grid, kGemmThreads, smem, stream>>>(
      map_a, map_w, static_cast<const bf16*>(b), static_cast<const bf16*>(h),
      static_cast<const bf16*>(gate), static_cast<bf16*>(out), M, K);
  return cudaGetLastError();
}

// what a product of [M, K] rows into n columns (weight segments of seg_n
// columns) must satisfy before anything is launched
inline bool gemm_dims_ok(int M, int seg_n, int k) {
  return M > 0 && (M + kBM - 1) / kBM <= 65535 && seg_n > 0 && seg_n % 128 == 0 && k > 0 &&
         k % 8 == 0;
}

// The output tile width an [M, n] product runs at on the current device: the
// one whose waves (tiles over the SMs, one block each, rounded up) times its
// tile cost is least, so that the last wave is not half empty; the wider tile
// on a tie (it reads each operand tile for twice the products). narrow_cost10
// is a 128-wide tile's cost in tenths of a 256-wide one's. The bf16 core's 7:
// alone in a wave a 128-wide tile measures 0.58 (chip_smoke.py's tile-width
// table at M = 1000, H100), but two waves of it take 1.06 of one wave of the
// wider tile (the same table at M = 3072), so near-ties go to the wider tile.
// The int8 core passes its own (gemm_int8.cuh:kI8NarrowCost10). A tile never
// straddles two weight segments, so 256 needs seg_n to be a multiple of it.
inline int gemm_tile_n(int M, int n, int seg_n, int narrow_cost10 = 7) {
  if (seg_n % 256 != 0) return 128;
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev < kMaxDevices ? sm_count[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      return 256;
    if (dev < kMaxDevices) sm_count[dev].store(sms, std::memory_order_relaxed);
  }
  const int rows = (M + kBM - 1) / kBM;
  const int waves_128 = (rows * (n / 128) + sms - 1) / sms;
  const int waves_256 = (rows * (n / 256) + sms - 1) / sms;
  return 10 * waves_256 <= narrow_cost10 * waves_128 ? 256 : 128;
}

}  // namespace
}  // namespace f5

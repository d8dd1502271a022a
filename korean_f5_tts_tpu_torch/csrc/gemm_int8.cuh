// The int8 product core of the int8 FF half-block (ff_block_int8.cu: kernel
// 4), the int8 LN + modulate + qkv product and the int8 out-projection with
// its gated residual (fused_linears_int8.cu: kernels 5 and 6) and the
// dynamic-int8 matmul (qmatmul.cu: kernel 9), designed for Hopper: row
// passes that hold a row in registers, then a TMA-fed ring of shared-memory
// stages, wgmma .s32.s8.s8 products and warp specialisation, the structure of
// the bf16 core (gemm_bf16.cuh) on 8-bit operands.
//
// The function is the TPU kernels' (korean_f5_tts_tpu/ops/ff_block.py:
// _kernel_int8, fused_linears.py:_ln_mod_matmul_int8_kernel,
// _proj_gated_int8_kernel, qmatmul.py:_qmm_kernel). For each row r
// of fp32 values y:
//   s_r = max(max|y_r|, 1e-6) / 127           (fp32, IEEE division)
//   q   = clip(rint(y / s_r), -127, 127)       (IEEE division, ties to even)
//   out = ((float(acc) * s_r) * w_scale[c]) + b[c]   (acc: exact s32 sum;
//                                                     no addition without b)
// then any GELU or gated residual in fp32 and one rounding at the end. The
// divisions and the epilogue use the _rn intrinsics: no reciprocal multiply
// and no fused multiply-add (nvcc contracts a * b + c by default), so the
// rounding is the plain versions'.
//
// Two kernels:
//   quant_rows_reg_kernel<T, kMaxK, kLnMod>: one warp per row, the whole row
//       in registers (kMaxK / 32 values a lane: 32 bf16 of h at d = 1024, 64
//       fp32 of z at dff = 2048), so a row is read from device memory once:
//       the LN statistics (two passes in fp32 over the registers), the
//       modulation, the row's amax and the quantization all work on the
//       registers. Writes q [M, K] int8 and s [M] fp32. The LN sums run
//       lane by lane over 8-column chunks, then across the warp.
//   i8_wgmma_kernel<BN, EPI, T>: out tile 128 x BN (BN 128 or 256) of
//       q_a [M, K] . W^T, W [n, K] int8 in torch layout; 384 threads: two
//       consumer warpgroups of 64 rows each and a producer warpgroup whose
//       one thread starts the TMA loads; setmaxnreg moves the producer's
//       registers to the consumers (a 64 x 256 s32 accumulator is 128
//       registers a thread). A ring stage holds the A tile [128][128 int8]
//       and the B tile [BN][128 int8] in the 128-byte swizzled layout
//       (hopper.cuh): a k depth of 128, four wgmma m64nBNk32 steps, the
//       descriptor advancing 32 bytes (+2 units) a step as bf16's k16 does.
//       Four stages; the consumers keep one group of products in flight and
//       hand a stage back to the producer when the next step's products have
//       started; no __syncthreads() in the k loop. 8-bit wgmma takes no
//       transpose, and none is needed: both operands are k-major.
//       Epilogues (EPI), from the accumulators parked in the free ring as
//       fp32 (gemm_bf16.cuh:stage_accumulators), whole rows per warp:
//         kWgOut           rescale + bias -> bf16 (kernel 5, over up to three
//                          weight segments q, k, v: three tensor maps, no
//                          fused weight);
//         kWgGeluF32       rescale + bias + tanh-GELU -> fp32 z (kernel 4's
//                          first product; the TPU kernel never rounds z);
//         kWgGatedResidual rescale + bias, h + gate * (.) -> bf16 (kernel 4's
//                          second product, kernel 6);
//         kWgGeluOut       rescale + bias + tanh-GELU -> bf16 (kernel 9 with
//                          its activation; without one it takes kWgOut).
//       In kWgOut and kWgGeluOut the bias is optional (kernel 9): a null
//       bias adds nothing.
//
// Row type. The TPU kernels read their rows as fp32 whatever the input's
// dtype and write the input's dtype (ff_block.py:108-109, fused_linears.py:
// 111, 157, qmatmul.py:25), so an fp32 model with int8 weights runs them on
// fp32 rows. Here T, the rows' type, is bf16 or float: the row passes read
// h (and sc, sh) as T, and the epilogues read the bias, h and gate as T and
// write T, with the one rounding at the end (none for float). The vectors
// take the rows' type; the products stay .s32.s8.s8 and the weights int8
// with fp32 w_scale either way.
//
// Edges: TMA fills reads past M and K with zeros and stores are masked, so M
// needs no multiple and K only the 16-byte rows TMA asks for (K % 16 == 0);
// the last k step of a K that is no multiple of 128 multiplies zeros. N is a
// multiple of BN; gemm_tile_n() picks BN from the card's SM count by waves.
// The row passes hold at most kMaxQuantK values a row.
//
// Measured: see ff_block_int8.cu, fused_linears_int8.cu and qmatmul.cu.
#pragma once

#include "gemm_bf16.cuh"
#include "int8_gemm.cuh"  // load8, i8_warp_sum/max, i8_gelu_tanh, kMaxSegments

namespace f5 {
namespace {

constexpr int kRowWarps = 4;      // rows per row-pass block, one warp each
constexpr int kMaxQuantK = 4096;  // longest row a row pass holds in registers
// a 128-wide output tile's cost in tenths of a 256-wide one's, for
// gemm_tile_n(). chip_smoke.py's int8 tile-width tables (check_ff_int8,
// check_ln_mod_int8; H100) time every width of kernel 4's two products and
// of kernel 5 at M = 3072 and 1000: with 6 the pick is the fastest width in
// all six cases; the bf16 core's 7 keeps kernel 4's first product (N = 2048,
// 1.45 waves at 256, 2.9 at 128) at 256, 0.0809 ms against 0.0772.
constexpr int kI8NarrowCost10 = 6;

enum WgEpilogue { kWgOut = 0, kWgGeluF32 = 1, kWgGatedResidual = 2, kWgGeluOut = 3 };

// 16 bytes of T at p (16-byte aligned) as floats: 8 bf16 or 4 fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    load8<kSrcBf16>(p, 0, v);
  }
}

// four values of T at p (aligned to four of them) as floats, and back
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) return *reinterpret_cast<const float4*>(p);
  else return load_bf16x4(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  if constexpr (sizeof(T) == 4) *reinterpret_cast<float4*>(p) = v;
  else store_bf16x4(p, v);
}

// A row pass: q [M, K] int8 and s [M] fp32 from x [M, K] of T (h through LN
// and the modulation by sc, sh [K] of T when kLnMod, else x as it is). K % (16 /
// sizeof(T)) == 0 and K <= kMaxK. Lane l holds, for chunk c, the V = 16 /
// sizeof(T) columns from c * 32 * V + l * V: one 16-byte load each, a warp's
// loads of a chunk contiguous.
template <typename T, int kMaxK, bool kLnMod>
__global__ void __launch_bounds__(kRowWarps * 32)
quant_rows_reg_kernel(const T* __restrict__ x, const T* __restrict__ sc,
                      const T* __restrict__ sh, int8_t* __restrict__ q, float* __restrict__ s,
                      int M, int K, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = kMaxK / (32 * V);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = (size_t)row * K;
  float v[kChunks][V];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * 32 * V + lane * V;
    if (col < K) {
      load16(x + base + col, v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[c][i] = 0.f;
    }
  }
  if constexpr (kLnMod) {  // two-pass fp32 statistics over the registers
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[c][i];  // columns past K hold 0
    const float mu = i8_warp_sum(sum) / K;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 32 * V + lane * V < K) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float dlt = v[c][i] - mu;
          var += dlt * dlt;
        }
      }
    }
    const float rstd = 1.f / sqrtf(i8_warp_sum(var) / K + eps);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c * 32 * V + lane * V;
      if (col < K) {
        float mul[V], add[V];
        load16(sc + col, mul);
        load16(sh + col, add);
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[c][i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][i], mu), rstd),
                                        __fadd_rn(1.f, mul[i])),
                              add[i]);
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * 32 * V + lane * V < K) {
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
    }
  }
  const float scale = __fdiv_rn(fmaxf(i8_warp_max(amax), 1e-6f), 127.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * 32 * V + lane * V;
    if (col < K) {
      uint32_t packed[V / 4];
#pragma unroll
      for (int j = 0; j < V / 4; ++j) packed[j] = 0u;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int qi = min(max(__float2int_rn(__fdiv_rn(v[c][i], scale)), -127), 127);
        packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)qi << (8 * (i % 4));
      }
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(q + base + col) = make_uint2(packed[0], packed[1]);
      else
        *reinterpret_cast<uint32_t*>(q + base + col) = packed[0];
    }
  }
  if (lane == 0) s[row] = scale;
}

template <typename T, bool kLnMod>
cudaError_t launch_quant_rows_reg(const void* x, const void* sc, const void* sh, void* q, void* s,
                                  int M, int K, float eps, cudaStream_t stream) {
  const dim3 grid((M + kRowWarps - 1) / kRowWarps), block(kRowWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* sct = static_cast<const T*>(sc);
  const T* sht = static_cast<const T*>(sh);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(s);
  if (K <= 1024)
    quant_rows_reg_kernel<T, 1024, kLnMod><<<grid, block, 0, stream>>>(xt, sct, sht, qt, st, M, K, eps);
  else if (K <= 2048)
    quant_rows_reg_kernel<T, 2048, kLnMod><<<grid, block, 0, stream>>>(xt, sct, sht, qt, st, M, K, eps);
  else if (K <= kMaxQuantK)
    quant_rows_reg_kernel<T, kMaxQuantK, kLnMod><<<grid, block, 0, stream>>>(xt, sct, sht, qt, st,
                                                                             M, K, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// What a product's epilogue reads besides the accumulators; the vectors and
// h are of the rows' type T (bf16 or float)
struct WgArgs {
  const float* a_scale;                // [M]: the row scales of q_a
  const float* w_scale[kMaxSegments];  // per segment [seg_n]
  const void* bias[kMaxSegments];      // per segment [seg_n] of T
  const void* h;                       // [M, N] of T: residual (kWgGatedResidual)
  const void* gate;                    // [N] of T (kWgGatedResidual)
  void* out;                           // [M, N]: fp32 for kWgGeluF32, else T
  int M, K, seg_n;
};

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256) wgmma_ss_s8_n256(d, da, db, scale_d);
  else wgmma_ss_s8_n128(d, da, db, scale_d);
}

// (float(acc) * s_r) * w_scale[c]: the bias, when there is one, is added after
__device__ __forceinline__ float scaled(float acc, float as, float ws) {
  return __fmul_rn(__fmul_rn(acc, as), ws);
}

// out[M, gridDim.x * BN] = epilogue(q_a . W^T); output column block n0
// belongs to segment n0 / seg_n (maps map_w0..2); T: the rows' type
template <int BN, int EPI, typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w0,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2, const WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<BN>());
  uint64_t* empty = full + kStages;
  const int kt_total = (p.K + kTileK8 - 1) / kTileK8;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int ldo = gridDim.x * BN;
  const int seg = n0 / p.seg_n;
  const int nloc = n0 - seg * p.seg_n;  // column block within the segment
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) init_ring(full, empty);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumerWarps * 32) {
      const CUtensorMap* map_w = seg == 0 ? &map_w0 : (seg == 1 ? &map_w1 : &map_w2);
      produce_tiles<BN, kTileK8>(smem, full, empty, &map_a, map_w, m0, nloc, kt_total);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const unsigned char* tile_a = smem + s * stage_bytes<BN>();
      const uint64_t da = wgmma_desc(tile_a + wg * 64 * kRowBytes);  // this warpgroup's 64 rows
      const uint64_t db = wgmma_desc(tile_a + kATileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK8 / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);

    // the one int32 -> fp32 rounding of the plain versions' int8_product
    float accf[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) accf[i] = __int2float_rn(acc[i]);
    constexpr int LD = BN + 8;
    const float* stage = stage_accumulators<BN>(smem, accf, warp, lane);
    const float* ws = pick(p.w_scale, seg) + nloc;
    const T* bias = static_cast<const T*>(pick(p.bias, seg));
    // only kWgOut and kWgGeluOut (kernels 5 and 9) may be given no bias
    const bool has_bias = !(EPI == kWgOut || EPI == kWgGeluOut) || bias != nullptr;
#pragma unroll
    for (int cc = 0; cc < BN; cc += 128) {
      const int cl = cc + 4 * lane;  // column within the block
      const float4 wv = *reinterpret_cast<const float4*>(ws + cl);
      float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_bias) bb = load4(bias + nloc + cl);
      float4 gg = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (EPI == kWgGatedResidual) gg = load4(static_cast<const T*>(p.gate) + n0 + cl);
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int row = m0 + warp * 16 + r;
        if (row >= p.M) break;
        const float as = p.a_scale[row];
        const float4 a = *reinterpret_cast<const float4*>(stage + r * LD + cl);
        float4 o = make_float4(scaled(a.x, as, wv.x), scaled(a.y, as, wv.y),
                               scaled(a.z, as, wv.z), scaled(a.w, as, wv.w));
        if (has_bias)  // without a bias no addition, not even of 0
          o = make_float4(__fadd_rn(o.x, bb.x), __fadd_rn(o.y, bb.y), __fadd_rn(o.z, bb.z),
                          __fadd_rn(o.w, bb.w));
        const size_t off = (size_t)row * ldo + n0 + cl;
        if constexpr (EPI == kWgGeluOut)
          o = make_float4(i8_gelu_tanh(o.x), i8_gelu_tanh(o.y), i8_gelu_tanh(o.z),
                          i8_gelu_tanh(o.w));
        if constexpr (EPI == kWgGeluF32) {
          *reinterpret_cast<float4*>(static_cast<float*>(p.out) + off) =
              make_float4(i8_gelu_tanh(o.x), i8_gelu_tanh(o.y), i8_gelu_tanh(o.z),
                          i8_gelu_tanh(o.w));
        } else {
          if constexpr (EPI == kWgGatedResidual) {
            const float4 hv = load4(static_cast<const T*>(p.h) + off);
            o = make_float4(__fadd_rn(hv.x, __fmul_rn(gg.x, o.x)),
                            __fadd_rn(hv.y, __fmul_rn(gg.y, o.y)),
                            __fadd_rn(hv.z, __fmul_rn(gg.z, o.z)),
                            __fadd_rn(hv.w, __fmul_rn(gg.w, o.w)));
          }
          store4(static_cast<T*>(p.out) + off, o);
        }
      }
    }
  }
}

// q_a [M, K] int8 (row scales p.a_scale) . [w0; w1; w2][:nseg]^T, each
// w [seg_n, K] int8, through epilogue EPI at tile width BN, rows of type T
template <int BN, int EPI, typename T>
cudaError_t launch_i8_wgmma(const void* a, const void* const (&w)[kMaxSegments], const WgArgs& p,
                            int nseg, cudaStream_t stream) {
  CUtensorMap map_a, map_w[kMaxSegments];
  if (!tensor_map(&map_a, a, p.M, p.K, kBM, kMapInt8)) return cudaErrorInvalidValue;
  for (int i = 0; i < kMaxSegments; ++i)
    if (!tensor_map(&map_w[i], w[i], p.seg_n, p.K, BN, kMapInt8)) return cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes<BN>(0);
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(i8_wgmma_kernel<BN, EPI, T>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(nseg * p.seg_n / BN, (p.M + kBM - 1) / kBM);
  i8_wgmma_kernel<BN, EPI, T><<<grid, kGemmThreads, smem, stream>>>(map_a, map_w[0], map_w[1],
                                                                     map_w[2], p);
  return cudaGetLastError();
}

// the same at tile width bn (128 or 256; 0: the one gemm_tile_n() picks
// with the int8 core's tile cost)
template <int EPI, typename T>
cudaError_t launch_i8_product(const void* a, const void* const (&w)[kMaxSegments],
                              const WgArgs& p, int nseg, int bn, cudaStream_t stream) {
  if (bn == 0) bn = gemm_tile_n(p.M, nseg * p.seg_n, p.seg_n, kI8NarrowCost10);
  if (bn == 256 && p.seg_n % 256 == 0) return launch_i8_wgmma<256, EPI, T>(a, w, p, nseg, stream);
  if (bn == 128) return launch_i8_wgmma<128, EPI, T>(a, w, p, nseg, stream);
  return cudaErrorInvalidValue;
}

// what a product of [M, K] int8 rows into segments of seg_n columns, and
// the row pass before it, must satisfy before anything is launched
inline bool i8_wgmma_dims_ok(int M, int seg_n, int K) {
  return gemm_dims_ok(M, seg_n, K) && K % 16 == 0 && K <= kMaxQuantK;
}

}  // namespace
}  // namespace f5

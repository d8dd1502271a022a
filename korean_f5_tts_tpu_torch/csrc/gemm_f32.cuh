// The fp32 product core: kernel B's two products on fp32 operands (ff_block.cu)
// and kernels 7 and 8 on fp32 operands (fused_linears.cu: the qkv product
// after LN and the modulation, over up to three weight segments, and the
// out-projection folded into the gated residual), for the offline entry
// points, which keep fp32 weights unless told otherwise.
//
// Products: split "3xTF32" on Hopper's tensor cores, fp32-accurate: each
// operand x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (mma.cuh),
// and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on wgmma m64n128k8 .tf32 with
// fp32 accumulation (the dropped lo.lo is ~2^-22 relative; a single TF32
// product keeps 10 mantissa bits, ~1e-3, and fails the 1e-4 bound of the
// fp32 forms). What bounds it: at the main shape (M = 3072, d = 1024, dff =
// 2048) B is 25.8 GFLOP of fp32-accurate products, 0.156 ms at the dense
// TF32 rate taken three times (494.7 / 3 TFLOP/s), against 0.385 ms at the
// 67 TFLOP/s of FFMA outside the tensor cores.
//
// Design: the skeleton of gemm_bf16.cuh (whose notes hold for what is not
// said here). A block computes a 128 x 128 output tile with 384 threads: two
// consumer warpgroups of 64 rows each and a producer warpgroup. A k step of
// a stage is 32 fp32 (one 128-byte swizzle span, four wgmma k8 steps); the
// ring has four stages of the A tile [128][32], the B tile [128][32] and a
// B lo tile [128][32], 48 KB each. Warp 0 of the producer warpgroup keeps
// the TMA loads of A and B in flight (one thread); its warps 1-3 wait on a
// stage's `full` barrier, split the landed B tile in place into its hi part
// and write the lo part beside it (element by element, so the swizzled
// layout is kept), fence for the async proxy and arrive on the stage's
// `split` barrier. The consumers wait on `full` and `split`, read their 16
// rows of A by ldmatrix (32-bit words as the A fragments of .tf32), form
// the operand in registers (kernel 7 and B's first product: y = LN(h) * (1
// + sc) + sh in fp32 from ln_stats_kernel's statistics), split it into hi
// and lo there, and start twelve wgmma a stage from registers, the eight
// small terms first: lo_a.hi_b and hi_a.lo_b of the four k8 steps, then
// hi_a.hi_b. A stage's twelve products go into an accumulator of their own
// (zeroed by the first product's scale-d) that is added to the tile's
// accumulator in fp32 once the group has completed: the tensor cores'
// accumulation drops the low bits of a sum where fp32 would round them
// (probe_hopper.cu's accumulation probe), and a chain over K = 2048 would
// carry that bias into the output; a stage's chain is twelve products deep.
// The epilogue goes through shared memory as in gemm_bf16.cuh: + b and
// GELU-tanh (tanhf) in fp32, or h + gate * (. + b) in fp32; nothing is
// rounded below fp32. wgmma from registers waits for its group before the
// next stage's fragments are formed (ptxas serializes wgmma whose inputs
// change in flight); the other warpgroup's products fill the tensor cores
// meanwhile. Rows past M, columns past K read as TMA's zeros; stores are
// masked; N % 128 == 0, K % 4 == 0 (16-byte rows).
#pragma once

#include "gemm_bf16.cuh"

namespace f5 {
namespace {

constexpr int kTfBN = 128;                        // output columns of a tile
constexpr int kTfStep = kRowBytes / 4;            // fp32 a stage's k step: 32
constexpr int kTfStages = 4;
constexpr int kTfATile = kBM * kRowBytes;         // 16 KB
constexpr int kTfBTile = kTfBN * kRowBytes;       // 16 KB
constexpr int kTfStageBytes = kTfATile + 2 * kTfBTile;  // A | B (hi once split) | B lo
constexpr int kTfSplitThreads = 96;               // producer warps 1-3

// dynamic shared memory: alignment slack, the ring, its three barriers a
// stage, and (LN only) the two fp32 vectors of d_pad elements
__host__ __device__ constexpr int tf_smem_bytes(int d_pad) {
  return 1024 + kTfStages * (kTfStageBytes + 3 * 8) + 2 * d_pad * 4;
}

__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

struct TfRing {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* split;
  uint64_t* empty;
};

__device__ __forceinline__ TfRing tf_ring(unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTfStages * kTfStageBytes);
  return {smem, full, full + kTfStages, full + 2 * kTfStages};
}

__device__ __forceinline__ void tf_init_ring(const TfRing& r) {
  for (int s = 0; s < kTfStages; ++s) {
    mbar_init(&r.full[s], 1);                 // the producer's arrive; TMA counts the bytes
    mbar_init(&r.split[s], kTfSplitThreads);  // every splitting thread
    mbar_init(&r.empty[s], kConsumerWarps);   // lane 0 of every consumer warp
  }
  mbar_init_fence();
}

// the producer warpgroup: warp 0's first thread loads, warps 1-3 split
__device__ __forceinline__ void tf_produce(const TfRing& r, const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, int m0, int n0,
                                           int kt_total, int ptid) {
  if (ptid == 0) {
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % kTfStages;
      mbar_wait(&r.empty[s], ((kt / kTfStages) & 1) ^ 1);  // passes at once on the first round
      unsigned char* tile = r.smem + s * kTfStageBytes;
      mbar_arrive_expect_tx(&r.full[s], kTfATile + kTfBTile);
      tma_load_2d(tile, map_a, &r.full[s], kt * kTfStep, m0);
      tma_load_2d(tile + kTfATile, map_b, &r.full[s], kt * kTfStep, n0);
    }
  } else if (ptid >= 32) {
    const int st = ptid - 32;
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % kTfStages;
      mbar_wait(&r.full[s], (kt / kTfStages) & 1);
      uint4* b = reinterpret_cast<uint4*>(r.smem + s * kTfStageBytes + kTfATile);
      uint4* b_lo = b + kTfBTile / 16;
      for (int i = st; i < kTfBTile / 16; i += kTfSplitThreads) {
        const uint4 x = b[i];
        uint4 h, l;
        split_tf32(__uint_as_float(x.x), h.x, l.x);
        split_tf32(__uint_as_float(x.y), h.y, l.y);
        split_tf32(__uint_as_float(x.z), h.z, l.z);
        split_tf32(__uint_as_float(x.w), h.w, l.w);
        b[i] = h;
        b_lo[i] = l;
      }
      fence_proxy_async();  // the split tiles are read by wgmma
      mbar_arrive(&r.split[s]);
    }
  }
}

// The consumers' k loop: acc (this warpgroup's 64 x 128 of the tile) = A .
// B^T, A the rows of the stage's A tile (kLnMod: (x - mu) * rstd * s_mul[c]
// + s_add[c] of them, mu and rstd of the thread's rows r0 = 16w + g and r1 =
// r0 + 8), B the stage's split B tiles.
template <bool kLnMod>
__device__ __forceinline__ void tf_consume(float (&acc)[64], const TfRing& r, int kt_total,
                                           int warp, int lane, float mu0, float rs0, float mu1,
                                           float rs1, const float* s_mul, const float* s_add) {
  const int t = lane & 3;
  const int row_a = warp * 16;  // this warp's 16 rows of the tile
  float part[64];               // a stage's products
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < kt_total; ++kt) {
    const int s = kt % kTfStages;
    mbar_wait(&r.full[s], (kt / kTfStages) & 1);
    mbar_wait(&r.split[s], (kt / kTfStages) & 1);
    const unsigned char* tile_a = r.smem + s * kTfStageBytes;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t x[4];  // (r0, c), (r1, c), (r0, c + 4), (r1, c + 4), c = 8 kk + t
      ldmatrix_x4(x, swz_chunk_addr(tile_a, row_a + (lane & 15), kk * 2 + (lane >> 4)));
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = __uint_as_float(x[i]);
      if (kLnMod) {
        const int c = kt * kTfStep + kk * 8 + t;
        const float m_lo = s_mul[c], a_lo = s_add[c], m_hi = s_mul[c + 4], a_hi = s_add[c + 4];
        y[0] = (y[0] - mu0) * rs0 * m_lo + a_lo;
        y[1] = (y[1] - mu1) * rs1 * m_lo + a_lo;
        y[2] = (y[2] - mu0) * rs0 * m_hi + a_hi;
        y[3] = (y[3] - mu1) * rs1 * m_hi + a_hi;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(y[i], ah[kk][i], al[kk][i]);
    }
    const uint64_t db_hi = wgmma_desc(tile_a + kTfATile);
    const uint64_t db_lo = wgmma_desc(tile_a + kTfATile + kTfBTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tf32_n128(part, al[kk], db_hi + 2 * kk, kk != 0);
      wgmma_rs_tf32_n128(part, ah[kk], db_lo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tf32_n128(part, ah[kk], db_hi + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(part);
    if (lane == 0) mbar_arrive(&r.empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// out[M, nseg * seg_n] = act(LN(h) * (1 + sc) + sh) @ [W0; W1; W2]^T + [b0; b1; b2]),
// all fp32: up to three weights [seg_n, d] read as segments of the output's
// columns (seg_n % 128 == 0, so a column tile lies in one segment)
template <bool kGelu>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_mod_gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_h,
                        const __grid_constant__ CUtensorMap map_w0,
                        const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w2,
                        const float* __restrict__ stats, const float* __restrict__ sc,
                        const float* __restrict__ sh, const float* __restrict__ b0,
                        const float* __restrict__ b1, const float* __restrict__ b2,
                        float* __restrict__ out, int M, int d, int seg_n) {
  extern __shared__ unsigned char smem_raw[];
  const TfRing ring = tf_ring(align_1024(smem_raw));
  const int kt_total = (d + kTfStep - 1) / kTfStep;
  const int d_pad = kt_total * kTfStep;
  float* s_mul = reinterpret_cast<float*>(ring.empty + kTfStages);  // 1 + sc
  float* s_add = s_mul + d_pad;                                     // sh
  const int n0 = blockIdx.x * kTfBN;
  const int m0 = blockIdx.y * kBM;
  const int ldo = gridDim.x * kTfBN;
  const int seg = n0 / seg_n;
  const int nloc = n0 - seg * seg_n;  // column block within the segment
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) tf_init_ring(ring);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const CUtensorMap* map_w = seg == 0 ? &map_w0 : (seg == 1 ? &map_w1 : &map_w2);
    tf_produce(ring, &map_h, map_w, m0, nloc, kt_total, tid - kConsumerWarps * 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    // the modulation vectors, while the producer's first loads are in flight
    for (int i = tid; i < d_pad; i += kConsumerWarps * 32) {
      s_mul[i] = i < d ? 1.f + sc[i] : 0.f;
      s_add[i] = i < d ? sh[i] : 0.f;
    }
    consumer_sync();
    const int r0 = m0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const float mu0 = r0 < M ? stats[r0] : 0.f, rs0 = r0 < M ? stats[M + r0] : 0.f;
    const float mu1 = r1 < M ? stats[r1] : 0.f, rs1 = r1 < M ? stats[M + r1] : 0.f;
    float acc[64];
    tf_consume<true>(acc, ring, kt_total, warp, lane, mu0, rs0, mu1, rs1, s_mul, s_add);

    constexpr int LD = kTfBN + 8;
    const float* stage = stage_accumulators<kTfBN>(ring.smem, acc, warp, lane);
    const int cl = 4 * lane;  // column within the block
    const float4 bb =
        *reinterpret_cast<const float4*>((seg == 0 ? b0 : (seg == 1 ? b1 : b2)) + nloc + cl);
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int row = m0 + warp * 16 + rr;
      float4 o = *reinterpret_cast<const float4*>(stage + rr * LD + cl);
      o = make_float4(o.x + bb.x, o.y + bb.y, o.z + bb.z, o.w + bb.w);
      if (kGelu)
        o = make_float4(gelu_tanh_f32(o.x), gelu_tanh_f32(o.y), gelu_tanh_f32(o.z),
                        gelu_tanh_f32(o.w));
      if (row < M) *reinterpret_cast<float4*>(out + (size_t)row * ldo + n0 + cl) = o;
    }
  }
}

// out[M, d] = h + gate * (a[M, K] @ W[d, K]^T + b), all fp32; d = gridDim.x * 128
__global__ void __launch_bounds__(kGemmThreads, 1)
gated_residual_gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_w,
                                const float* __restrict__ b, const float* __restrict__ h,
                                const float* __restrict__ gate, float* __restrict__ out, int M,
                                int K) {
  extern __shared__ unsigned char smem_raw[];
  const TfRing ring = tf_ring(align_1024(smem_raw));
  const int kt_total = (K + kTfStep - 1) / kTfStep;
  const int n0 = blockIdx.x * kTfBN;
  const int m0 = blockIdx.y * kBM;
  const int d = gridDim.x * kTfBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) tf_init_ring(ring);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    tf_produce(ring, &map_a, &map_w, m0, n0, kt_total, tid - kConsumerWarps * 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    float acc[64];
    tf_consume<false>(acc, ring, kt_total, warp, lane, 0.f, 0.f, 0.f, 0.f, nullptr, nullptr);

    constexpr int LD = kTfBN + 8;
    const float* stage = stage_accumulators<kTfBN>(ring.smem, acc, warp, lane);
    const int col = n0 + 4 * lane;
    const float4 bb = *reinterpret_cast<const float4*>(b + col);
    const float4 gg = *reinterpret_cast<const float4*>(gate + col);
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int row = m0 + warp * 16 + rr;
      if (row < M) {
        const float4 v = *reinterpret_cast<const float4*>(stage + rr * LD + 4 * lane);
        const float4 hv = *reinterpret_cast<const float4*>(h + (size_t)row * d + col);
        *reinterpret_cast<float4*>(out + (size_t)row * d + col) =
            make_float4(hv.x + gg.x * (v.x + bb.x), hv.y + gg.y * (v.y + bb.y),
                        hv.z + gg.z * (v.z + bb.z), hv.w + gg.w * (v.w + bb.w));
      }
    }
  }
}

// what a product of [M, k] fp32 rows into segments of seg_n columns must
// satisfy before anything is launched
inline bool tf_dims_ok(int M, int seg_n, int k) {
  return M > 0 && (M + kBM - 1) / kBM <= 65535 && seg_n > 0 && seg_n % kTfBN == 0 && k > 0 &&
         k % 4 == 0;
}

// the row statistics, then ln_mod_gemm_tf32_kernel; d % 4 == 0, d <= 4096,
// seg_n % 128 == 0, 1 <= nseg <= 3
template <bool kGelu>
cudaError_t launch_ln_mod_gemm_f32(const void* h, const void* sc, const void* sh,
                                   const void* const (&w)[3], const void* const (&b)[3],
                                   void* stats, void* out, int M, int d, int seg_n, int nseg,
                                   float eps, cudaStream_t stream) {
  if (!tf_dims_ok(M, seg_n, d) || d > kMaxLnDim || nseg < 1 || nseg > 3)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_ln_stats<float>(h, stats, M, d, eps, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap map_h, map_w[3];
  if (!tensor_map(&map_h, h, M, d, kBM, kMapF32)) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!tensor_map(&map_w[i], w[i], seg_n, d, kTfBN, kMapF32)) return cudaErrorInvalidValue;
  const int d_pad = (d + kTfStep - 1) / kTfStep * kTfStep;
  static std::atomic<bool> ready[kMaxDevices];
  err = allow_smem(ln_mod_gemm_tf32_kernel<kGelu>, tf_smem_bytes(kMaxLnDim), ready);
  if (err != cudaSuccess) return err;
  typedef const float* P;
  const dim3 grid(nseg * seg_n / kTfBN, (M + kBM - 1) / kBM);
  ln_mod_gemm_tf32_kernel<kGelu><<<grid, kGemmThreads, tf_smem_bytes(d_pad), stream>>>(
      map_h, map_w[0], map_w[1], map_w[2], static_cast<P>(stats), static_cast<P>(sc),
      static_cast<P>(sh), static_cast<P>(b[0]), static_cast<P>(b[1]), static_cast<P>(b[2]),
      static_cast<float*>(out), M, d, seg_n);
  return cudaGetLastError();
}

// out = h + gate * (a @ W^T + b); a [M, K], W [N, K]; K % 4 == 0, N % 128 == 0
inline cudaError_t launch_gated_residual_gemm_f32(const void* a, const void* w, const void* b,
                                                  const void* h, const void* gate, void* out,
                                                  int M, int N, int K, cudaStream_t stream) {
  if (!tf_dims_ok(M, N, K)) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  if (!tensor_map(&map_a, a, M, K, kBM, kMapF32) || !tensor_map(&map_w, w, N, K, kTfBN, kMapF32))
    return cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err = allow_smem(gated_residual_gemm_tf32_kernel, tf_smem_bytes(0), ready);
  if (err != cudaSuccess) return err;
  typedef const float* P;
  gated_residual_gemm_tf32_kernel<<<dim3(N / kTfBN, (M + kBM - 1) / kBM), kGemmThreads,
                                    tf_smem_bytes(0), stream>>>(
      map_a, map_w, static_cast<P>(b), static_cast<P>(h), static_cast<P>(gate),
      static_cast<float*>(out), M, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace f5

// The quantization pass of int8 attention (kernel 14's operands), for Hopper
// (sm_90a): one kernel from q, k, v [b, h, n, d] bf16 or fp32, d 64 or 128 (views of any
// item, head and row strides, rows contiguous) to what kernel 14 reads. On
// fp32 inputs (the offline entry points' default weights) the amax and x *
// (127 / a) are taken from the fp32 values as they are, never through bf16,
// as the JAX _quant_head does on fp32 (its x.astype(f32) is then no cast).
//
// In the JAX package this pass is XLA (korean_f5_tts_tpu/ops/flash_prefix.py:
// _quant_head :901-907 and flash_prefix_attention_i8 :926-944). Per folded
// head h of each quantized tensor x:
//   a    = max(max |x|, 1e-8)                          (fp32)
//   x8   = clip(rint(x * (127 / a)), -127, 127)         (127 / a an IEEE
//                                                      division, the product
//                                                      one fp32 rounding)
// and per head c = (aq * ak) * (log2(e) / 127^2 / sqrt(d)), sv = av *
// (1 / 127^2), in the JAX wrapper's order of multiplication (the constants
// arrive rounded to fp32, as the wrapper's are). It writes q8, k8 [H, n, d]
// int8 and, under "qkpv", v8 in kernel 14's layout [H, d, n_pad]: keys
// contiguous, zero past n up to n_pad (a multiple of 128), and in every group
// of 32 keys key 16h + 8j + 2t + e at slot 16h + 4t + 2j + e (the order in
// which the kernel's score accumulator holds the keys, ops/flash_prefix.py:
// _v8_kernel_layout). The plain version (ops/flash_prefix.py:_quantize_qkv,
// _v8_kernel_layout) is equal to it to the bit.
//
// What bounds it on the card: bytes. At the main shape (2 x 16 heads, n
// 1536) it reads 3 x 6.3 MB of bf16 and writes 3 x 3.1 MB of int8: 28 MB,
// 0.0085 ms at 3.35 TB/s (fp32 inputs: 47 MB, 0.0141 ms). The amax must be
// complete before any element of the head is quantized, and v8 is a
// transpose with a key permutation.
//
// Design: a cluster of blocks per folded head, NT tensors (2: q, k; 3: q, k,
// v) times kQSplit row ranges each (whole 128-key chunks), 512 threads a
// block. Pass 1 reads the block's rows with 16-byte loads and reduces |x| to
// its amax; the blocks of the cluster exchange their partial amaxes through
// distributed shared memory (cluster.sync, map_shared_rank), so each knows
// its tensor's a and block 0 writes c and sv, with no second launch and no
// global atomics. Pass 2 reads the rows again (the block's 96 KB at the main
// shape were read just before and are served from L2) and writes q8, k8 rows
// as 8-byte stores; v8 goes through shared memory a 128-key chunk at a time:
// each quantized row is scattered to its permuted slot in a [64][128] byte
// tile, which then leaves as 16-byte stores of whole 128-key rows (a template
// on d: at d = 128 a row is 16 loads of 8 values and the v8 tile 18 KB). It
// replaces five torch launches (the cat that folds the heads, amax, the
// scaling, the rounding and clip, the v8 transpose) that took twice kernel
// 14's time. Measured (PERF.md section 6): a third of the bound's rate;
// trial builds that were no faster or slower and not kept: four blocks a
// tensor and head (a non-portable cluster of 12), the block's rows staged in
// shared memory between the passes instead of read again from L2, unrolled
// loads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace f5 {
namespace {

constexpr int kQThreads = 512;
constexpr int kQSplit = 2;     // blocks per tensor and head: row ranges of whole 128-key chunks
constexpr int kQChunk = 128;   // keys a v8 chunk (kernel 14's key tile)
constexpr int kQTileLd = kQChunk + 16;  // bytes a row of the v8 chunk tile (16-byte aligned)

struct QuantHeadsArgs {
  const void* x[3];  // q, k, v: bf16 or fp32, all of one type
  long long sb[3], sh[3], sr[3];  // item, head and row strides of each, in elements
  int8_t* out[3];                 // q8, k8 [H, n, d]; v8 [H, d, n_pad]
  float* c;                       // [H]
  float* sv;                      // [H]
  int heads, n, n_pad;
  float c_mul, sv_mul;
};

// eight fp32 (two 16-byte loads)
__device__ __forceinline__ void load_row8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// eight bf16 (one 16-byte load) as floats
__device__ __forceinline__ void load_row8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ int quant1(float x, float scale) {
  return min(max(__float2int_rn(__fmul_rn(x, scale)), -127), 127);
}

// the slot of key r (0..127) of a chunk in kernel 14's v8 layout
__device__ __forceinline__ int v8_slot(int r) {
  const int kk = r & 31;
  return (r & ~31) + (kk & 16) + 4 * ((kk >> 1) & 3) + 2 * ((kk >> 3) & 1) + (kk & 1);
}

template <int NT, typename T, int D>
__global__ void __launch_bounds__(kQThreads)
quant_heads_kernel(const __grid_constant__ QuantHeadsArgs a) {
  constexpr int kSeg = D / 8;  // eight-value segments a row
  __shared__ float red[kQThreads / 32];
  __shared__ float part_amax;
  __shared__ float amax_of[NT];
  __shared__ __align__(16) int8_t tile[NT == 3 ? D * kQTileLd : 16];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tensor = rank / kQSplit, part = rank % kQSplit;
  const int head = blockIdx.x / (NT * kQSplit);
  const int item = head / a.heads, g = head - item * a.heads;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x[tensor]) + item * a.sb[tensor] + g * a.sh[tensor];
  const long long ld = a.sr[tensor];
  const int chunks = (a.n + kQChunk - 1) / kQChunk;
  const int c0 = part * chunks / kQSplit, c1 = (part + 1) * chunks / kQSplit;
  const int r0 = c0 * kQChunk, r1 = min(c1 * kQChunk, a.n);

  // pass 1: the amax of this block's rows, then of the head, through the cluster
  float amax = 0.f;
  for (int i = tid; i < (r1 - r0) * kSeg; i += kQThreads) {
    float v[8];
    load_row8(x + (r0 + i / kSeg) * ld + (i % kSeg) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  if (tid < 32) {
    float m = tid < kQThreads / 32 ? red[tid] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) part_amax = m;
  }
  cluster.sync();
  if (tid < NT) {
    float m = 0.f;
    for (int p = 0; p < kQSplit; ++p)
      m = fmaxf(m, *cluster.map_shared_rank(&part_amax, tid * kQSplit + p));
    amax_of[tid] = fmaxf(m, 1e-8f);
  }
  cluster.sync();  // every block has read the others' partials: none may leave before
  if (rank == 0 && tid == 0) {
    a.c[head] = __fmul_rn(__fmul_rn(amax_of[0], amax_of[1]), a.c_mul);
    a.sv[head] = NT == 3 ? __fmul_rn(amax_of[2], a.sv_mul) : 0.f;
  }
  const float scale = __fdiv_rn(127.f, amax_of[tensor]);

  // pass 2: quantize (the rows come from L2) and write
  if (NT == 2 || tensor < 2) {
    int8_t* o = a.out[tensor] + (size_t)head * a.n * D;
    for (int i = tid; i < (r1 - r0) * kSeg; i += kQThreads) {
      const int r = r0 + i / kSeg, cc = (i % kSeg) * 8;
      float v[8];
      load_row8(x + r * ld + cc, v);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e >> 2] |= (uint32_t)(quant1(v[e], scale) & 0xff) << (8 * (e & 3));
      *reinterpret_cast<uint2*>(o + (size_t)r * D + cc) = make_uint2(w[0], w[1]);
    }
    return;
  }
  int8_t* v8 = a.out[2] + (size_t)head * D * a.n_pad;
  for (int ch = c0; ch < c1; ++ch) {
    for (int i = tid; i < kQChunk * kSeg; i += kQThreads) {
      const int r = i / kSeg, cc = (i % kSeg) * 8, key = ch * kQChunk + r;
      float v[8];
      if (key < a.n) {
        load_row8(x + key * ld + cc, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      const int slot = v8_slot(r);
#pragma unroll
      for (int e = 0; e < 8; ++e) tile[(cc + e) * kQTileLd + slot] = (int8_t)quant1(v[e], scale);
    }
    __syncthreads();
    for (int i = tid; i < D * (kQChunk / 16); i += kQThreads) {
      const int d = i >> 3, seg = i & 7;
      *reinterpret_cast<uint4*>(v8 + (size_t)d * a.n_pad + ch * kQChunk + seg * 16) =
          *reinterpret_cast<const uint4*>(tile + d * kQTileLd + seg * 16);
    }
    __syncthreads();
  }
}

template <int NT, typename T, int D>
cudaError_t launch_quant_heads(const QuantHeadsArgs& args, int H, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * NT * kQSplit);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NT * kQSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quant_heads_kernel<NT, T, D>, args);
}

}  // namespace
}  // namespace f5

// q, k, v: [b, h, n, d] bf16 (f32 == 0) or fp32 (f32 != 0), d 64 or 128, with
// item, head and row strides sb*, sh*, sr* (elements; 16-byte multiples, rows
// contiguous, 16-byte aligned); q8, k8 [b * h,
// n, d] int8; pv_i8 != 0: v8 [b * h, d, n_pad] int8 (n_pad % 128 == 0,
// n_pad >= n) and v quantized, else v and v8 are not read; c, sv [b * h]
// fp32 (sv 0 without pv_i8). c_mul, sv_mul: the wrapper's fp32 constants.
extern "C" int f5_quant_heads(const void* q, const void* k, const void* v, long long sbq,
                              long long shq, long long srq, long long sbk, long long shk,
                              long long srk, long long sbv, long long shv, long long srv,
                              void* q8, void* k8, void* v8, void* c, void* sv, int b, int h,
                              int n, int n_pad, int d, int pv_i8, int f32, float c_mul,
                              float sv_mul, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || h <= 0 || n <= 0 || (d != 64 && d != 128) ||
      (long long)b * h * 3 * f5::kQSplit > 0x7fffffffLL ||
      (pv_i8 && (n_pad < n || n_pad % f5::kQChunk != 0)))
    return (int)cudaErrorInvalidValue;
  f5::QuantHeadsArgs a{};
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  const long long sb[3] = {sbq, sbk, sbv}, sh[3] = {shq, shk, shv}, sr[3] = {srq, srk, srv};
  for (int i = 0; i < 3; ++i) {
    a.sb[i] = sb[i];
    a.sh[i] = sh[i];
    a.sr[i] = sr[i];
  }
  a.out[0] = static_cast<int8_t*>(q8);
  a.out[1] = static_cast<int8_t*>(k8);
  a.out[2] = static_cast<int8_t*>(v8);
  a.c = static_cast<float*>(c);
  a.sv = static_cast<float*>(sv);
  a.heads = h;
  a.n = n;
  a.n_pad = n_pad;
  a.c_mul = c_mul;
  a.sv_mul = sv_mul;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (d == 128) {
    if (f32)
      return (int)(pv_i8 ? f5::launch_quant_heads<3, float, 128>(a, b * h, s)
                         : f5::launch_quant_heads<2, float, 128>(a, b * h, s));
    return (int)(pv_i8 ? f5::launch_quant_heads<3, bf16, 128>(a, b * h, s)
                       : f5::launch_quant_heads<2, bf16, 128>(a, b * h, s));
  }
  if (f32)
    return (int)(pv_i8 ? f5::launch_quant_heads<3, float, 64>(a, b * h, s)
                       : f5::launch_quant_heads<2, float, 64>(a, b * h, s));
  return (int)(pv_i8 ? f5::launch_quant_heads<3, bf16, 64>(a, b * h, s)
                     : f5::launch_quant_heads<2, bf16, 64>(a, b * h, s));
}

// Prefix-masked flash attention for training on fp32 operands, for Hopper
// (sm_90a): the fp32 forms of kernels 11, 12 (dq) and 13 (dk, dv). Kernel
// 10's fp32 form is kernel A's fp32 kernel with an lse output
// (flash_prefix.cu, f5_flash_prefix_f32_fwd_lse).
//
// Replaces, on fp32 inputs, the TPU kernels of
// korean_f5_tts_tpu/ops/flash_prefix.py:
//   11  _flash_prefix_dq_lsein -> _kernel_dq_lsein (dq from the forward's lse)
//   12  _flash_prefix_dq       -> _kernel_dq       (dq, recomputing the lse)
//   13  _flash_prefix_dkv      -> _kernel_dkv      (dk and dv)
// The functions are those of the bf16 forms (flash_prefix_train.cu): folded
// heads q, k, v, dO, dq, dk, dv [H, n, 64] fp32, kv_lens [H] int32, lse and
// D = rowsum(dO * o) [H, n] fp32, lse in base 2 of the scores pre-scaled by
// scale_log2 = log2(e) / sqrt(64). On fp32 inputs the TPU kernels keep "the
// exact f32 dot": cast=True rounds to k's dtype, which is fp32, so S, P, dP,
// dS, the accumulators and the outputs stay fp32 and nothing is rounded
// below it. So do these kernels: plain FFMA products on shared-memory tiles.
// The tensor cores have no fp32 product, and a single TF32 mma keeps 10
// mantissa bits, which does not hold fp32 parity (the fp32 forms of A, B and
// C made the same choice).
//
// What bounds them: at the training shape (H 128, n 1280, every key valid)
// 11 and 12 are 6 * n^2 * 64 * H = 80.5 GFLOP (1.20 ms at the 67 TFLOP/s of
// fp32 outside the tensor cores) and 13 is 8 * n^2 * 64 * H = 107 GFLOP
// (1.60 ms), against 168-252 MB of operands (0.05-0.08 ms): FFMA bound. The
// n x n scores stay out of device memory.
//
// Design, as kernel A's fp32 form: 256 threads a block as a 16 x 16 grid;
// every product is a 64 x 64 tile of which thread (ty, tx) owns rows ty * 4 +
// i and columns tx * 4 + j, its operands read as float4 from shared-memory
// tiles stored transposed ([c][row], row stride 68) where the product
// contracts over d, and as rows ([row][c]) where it contracts over the tile.
//   dq (11, 12)  one block per (head, 64 queries): q and dO sit transposed
//                for the whole sweep; each 64-key tile of K (transposed and
//                as rows) and V (transposed) is loaded, S = q.K^T and dP =
//                dO.V^T are 4 x 4 a thread, P = exp2(S * scale_log2 - lse),
//                dS = P * (dP - D) goes through shared memory, and dq += dS.K.
//                The sweep stops at ceil(kv_len / 64) tiles; keys past
//                kv_len in the last one get P = 0. kOnline (12) keeps the
//                running max and denominator instead of the lse: dq is
//                rescaled on each max update and divided by l at the end
//                (dS is linear in P), and the lse it ends with is written.
//   dk, dv (13)  one block per (head, 64 keys): K and V sit transposed; each
//                64-query tile of q and dO (transposed and as rows), lse and
//                D is loaded, S^T = K.q^T and dP^T = V.dO^T are 4 x 4 a
//                thread, P^T and dS^T go through shared memory (over the
//                transposed q and dO tiles, whose readers are done), then
//                dV += P^T.dO and dK += dS^T.q. Every query row is walked,
//                padded ones included (as the bf16 core); a query at or past
//                n gets lse +inf (P = 0). A block whose first key is at or
//                past kv_len writes zero dk and dv. A block owns its key
//                rows: no atomics, and the result does not depend on block
//                order.
// 103-104 KB of shared memory a block: two blocks an SM.
// A row with no valid key gets lse 0 and zero gradients.
#include "mma.cuh"

namespace f5 {
namespace {

constexpr int kT32 = 256;   // threads a block
constexpr int kLD32 = 68;   // row stride of every tile (floats)
constexpr int kTile32 = 64 * kLD32;
constexpr int kD32 = 64;    // head dim

// rows [row0, row0 + 64) of a [n, 64] fp32 head: transposed into t[c][row]
// and, when rows is not null, as they are into rows[row][c]; rows at or past
// n give zeros. Consecutive threads take consecutive rows: the transposed
// stores are conflict-free, and so are the row stores at stride 68.
__device__ __forceinline__ void load_tile_f32(float* t, float* rows, const float* src, int row0,
                                              int n, int tid) {
  for (int i = tid; i < 64 * (kD32 / 4); i += kT32) {
    const int r = i & 63;
    const int c = (i >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD32 + c);
    t[(c + 0) * kLD32 + r] = v.x;
    t[(c + 1) * kLD32 + r] = v.y;
    t[(c + 2) * kLD32 + r] = v.z;
    t[(c + 3) * kLD32 + r] = v.w;
    if (rows != nullptr) *reinterpret_cast<float4*>(rows + r * kLD32 + c) = v;
  }
}

// acc[i][j] += sum over c of a[c][ty * 4 + i] * b[c][tx * 4 + j]: a 64 x 64
// product contracting over the 64 rows of two transposed tiles
__device__ __forceinline__ void mm_tt(float (&acc)[4][4], const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 8
  for (int c = 0; c < kD32; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(a + c * kLD32 + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + c * kLD32 + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// acc[i][j] += sum over m of s[ty * 4 + i][m] * rows[m][tx * 4 + j]: a 64 x 64
// product contracting over the tile's 64 columns of s ([row][m]) and rows of
// `rows` ([m][c])
__device__ __forceinline__ void mm_sr(float (&acc)[4][4], const float* s, const float* rows,
                                      int ty, int tx) {
#pragma unroll 8
  for (int m = 0; m < 64; ++m) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = s[(ty * 4 + i) * kLD32 + m];
    const float4 y = *reinterpret_cast<const float4*>(rows + m * kLD32 + tx * 4);
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], yv[j], acc[i][j]);
  }
}

// sum / max over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row16_sum32(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row16_max32(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void zero44(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// dq for one (head, 64-query tile); kOnline: kernel 12 (lse recomputed and
// written to lse_out), otherwise kernel 11 (lse_in given)
template <bool kOnline>
__global__ void __launch_bounds__(kT32, 2)
flash_prefix_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ dvec, const float* __restrict__ lse_in,
                           const int* __restrict__ kv_lens, float* __restrict__ dq,
                           float* __restrict__ lse_out, int n, float scale_log2,
                           float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [c][query]
  float* sDOt = sQt + kTile32;                      // [c][query]
  float* sKt = sDOt + kTile32;                      // [c][key]
  float* sVt = sKt + kTile32;                       // [c][key]
  float* sK = sVt + kTile32;                        // [key][c]
  float* sDS = sK + kTile32;                        // [query][key]
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)head * n * kD32;
  const int kv_len = min(kv_lens[head], n);

  load_tile_f32(sQt, nullptr, q + off, q0, n, tid);
  load_tile_f32(sDOt, nullptr, dout + off, q0, n, tid);
  float dr[4], lse[4], m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    dr[i] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    lse[i] = (!kOnline && row < n) ? lse_in[(size_t)head * n + row] : 0.f;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  zero44(acc);

  const int n_tiles = kv_len > 0 ? (kv_len + 63) / 64 : 0;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * 64;
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32(sKt, sK, k + off, k0, n, tid);
    load_tile_f32(sVt, nullptr, v + off, k0, n, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero44(s);
    zero44(dp);
    mm_tt(s, sQt, sKt, ty, tx);
    mm_tt(dp, sDOt, sVt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = k0 + tx * 4 + j < kv_len ? s[i][j] * scale_log2 : -INFINITY;
      if (kOnline) {
        // tile 0 holds key 0 < kv_len: the running max is finite from then on
        const float m_new =
            fmaxf(m_run[i], row16_max32(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
        const float alpha = exp2f(m_run[i] - m_new);
        m_run[i] = m_new;
        lse[i] = m_new;  // P below is relative to the running max
        l_run[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      }
      float ps = 0.f;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - lse[i]);
        ps += p;
        ds[j] = p * (dp[i][j] - dr[i]);
      }
      if (kOnline) l_run[i] += row16_sum32(ps);
      *reinterpret_cast<float4*>(sDS + (ty * 4 + i) * kLD32 + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm_sr(acc, sDS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
    float scale = sm_scale;
    if (kOnline) {
      scale = l_run[i] > 0.f ? sm_scale / l_run[i] : 0.f;
      if (tx == 0)
        lse_out[(size_t)head * n + row] = l_run[i] > 0.f ? m_run[i] + log2f(l_run[i]) : 0.f;
    }
    *reinterpret_cast<float4*>(dq + off + (size_t)row * kD32 + tx * 4) =
        make_float4(acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale, acc[i][3] * scale);
  }
}

// dk and dv for one (head, 64-key tile)
__global__ void __launch_bounds__(kT32, 2)
flash_prefix_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ dvec, const float* __restrict__ lse,
                            const int* __restrict__ kv_lens, float* __restrict__ dk,
                            float* __restrict__ dv, int n, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sKt = reinterpret_cast<float*>(smem_raw);  // [c][key]
  float* sVt = sKt + kTile32;                       // [c][key]
  float* sQt = sVt + kTile32;                       // [c][query], then P^T [key][query]
  float* sDOt = sQt + kTile32;                      // [c][query], then dS^T [key][query]
  float* sQ = sDOt + kTile32;                       // [query][c]
  float* sDO = sQ + kTile32;                        // [query][c]
  float* sRows = sDO + kTile32;                     // the tile's lse, then its D
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t off = (size_t)head * n * kD32;
  const int kv_len = min(kv_lens[head], n);

  if (k0 >= kv_len) {  // block-uniform: every key masked, zero gradients
    for (int i = tid; i < 64 * (kD32 / 4); i += kT32) {
      const int r = k0 + (i >> 4), c = (i & 15) * 4;
      if (r < n) {
        *reinterpret_cast<float4*>(dk + off + (size_t)r * kD32 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + off + (size_t)r * kD32 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  load_tile_f32(sKt, nullptr, k + off, k0, n, tid);
  load_tile_f32(sVt, nullptr, v + off, k0, n, tid);
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) valid[i] = k0 + ty * 4 + i < kv_len;
  float dk_acc[4][4], dv_acc[4][4];
  zero44(dk_acc);
  zero44(dv_acc);

  const int q_tiles = (n + 63) / 64;
  for (int it = 0; it < q_tiles; ++it) {
    const int qb = it * 64;
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32(sQt, sQ, q + off, qb, n, tid);
    load_tile_f32(sDOt, sDO, dout + off, qb, n, tid);
    if (tid < 64) {
      const int row = qb + tid;
      sRows[tid] = row < n ? lse[(size_t)head * n + row] : INFINITY;
      sRows[64 + tid] = row < n ? dvec[(size_t)head * n + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero44(s);
    zero44(dp);
    mm_tt(s, sKt, sQt, ty, tx);   // S^T
    mm_tt(dp, sVt, sDOt, ty, tx);  // dP^T
    const float4 l4 = *reinterpret_cast<const float4*>(sRows + tx * 4);
    const float4 d4 = *reinterpret_cast<const float4*>(sRows + 64 + tx * 4);
    const float lq[4] = {l4.x, l4.y, l4.z, l4.w};
    const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
    __syncthreads();  // every read of the transposed q and dO tiles is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = valid[i] ? exp2f(s[i][j] * scale_log2 - lq[j]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - dd[j]);
      }
      *reinterpret_cast<float4*>(sQt + (ty * 4 + i) * kLD32 + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(sDOt + (ty * 4 + i) * kLD32 + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm_sr(dv_acc, sQt, sDO, ty, tx);   // dV += P^T.dO
    mm_sr(dk_acc, sDOt, sQ, ty, tx);   // dK += dS^T.q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= n) continue;
    *reinterpret_cast<float4*>(dk + off + (size_t)row * kD32 + tx * 4) =
        make_float4(dk_acc[i][0] * sm_scale, dk_acc[i][1] * sm_scale, dk_acc[i][2] * sm_scale,
                    dk_acc[i][3] * sm_scale);
    *reinterpret_cast<float4*>(dv + off + (size_t)row * kD32 + tx * 4) =
        make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
  }
}

constexpr int kDqF32Smem = 6 * kTile32 * (int)sizeof(float);
constexpr int kDkvF32Smem = (6 * kTile32 + 128) * (int)sizeof(float);

template <bool kOnline>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* dvec, const void* lse_in, const void* kv_lens, void* dq,
                          void* lse_out, int H, int n, float scale_log2, float sm_scale,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_prefix_dq_f32_kernel<kOnline>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqF32Smem);
  if (err != cudaSuccess) return err;
  flash_prefix_dq_f32_kernel<kOnline><<<dim3((n + 63) / 64, H), kT32, kDqF32Smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse_in), static_cast<const int*>(kv_lens),
      static_cast<float*>(dq), static_cast<float*>(lse_out), n, scale_log2, sm_scale);
  return cudaGetLastError();
}

int check_args_f32(int device, int H, int n, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535 || d != kD32) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
}  // namespace f5

// kernel 11's fp32 form
extern "C" int f5_flash_prefix_f32_dq_lsein(const void* q, const void* k, const void* v,
                                            const void* dout, const void* dvec, const void* lse,
                                            const void* kv_lens, void* dq, int H, int n, int d,
                                            float scale_log2, float sm_scale, int device,
                                            void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  return (int)f5::launch_dq_f32<false>(q, k, v, dout, dvec, lse, kv_lens, dq, nullptr, H, n,
                                       scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 12's fp32 form
extern "C" int f5_flash_prefix_f32_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* dvec, const void* kv_lens,
                                      void* dq, void* lse_out, int H, int n, int d,
                                      float scale_log2, float sm_scale, int device,
                                      void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  return (int)f5::launch_dq_f32<true>(q, k, v, dout, dvec, nullptr, kv_lens, dq, lse_out, H, n,
                                      scale_log2, sm_scale, static_cast<cudaStream_t>(stream));
}

// kernel 13's fp32 form
extern "C" int f5_flash_prefix_f32_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* dvec, const void* lse,
                                       const void* kv_lens, void* dk, void* dv, int H, int n,
                                       int d, float scale_log2, float sm_scale, int device,
                                       void* stream) {
  if (int err = f5::check_args_f32(device, H, n, d)) return err;
  cudaError_t err = cudaFuncSetAttribute(f5::flash_prefix_dkv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         f5::kDkvF32Smem);
  if (err != cudaSuccess) return (int)err;
  f5::flash_prefix_dkv_f32_kernel<<<dim3((n + 63) / 64, H), f5::kT32, f5::kDkvF32Smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(dvec),
      static_cast<const float*>(lse), static_cast<const int*>(kv_lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, scale_log2, sm_scale);
  return (int)cudaGetLastError();
}

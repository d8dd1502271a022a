// Prefix-masked flash attention with int8 scores on fp32 operands, "qk" mode,
// forward, for Hopper (sm_90a): kernel 14's fp32 form in "qk".
//
// Replaces, on fp32 inputs with pv_i8=False, the TPU kernel
// korean_f5_tts_tpu/ops/flash_prefix.py:_flash_prefix_folded_i8 ->
// _kernel_i8 (via flash_prefix_attention_i8, whose out_dtype is v's dtype,
// :939 and :944). Per folded head h:
//   s   = float(q8 . k8^T) * c[h]           exact integer product, base-2 domain
//   keys at or past kv_lens[h] masked; online max m and sum l in fp32,
//   l adding p = exp2(s - m)
//   acc = acc * alpha + p . v               fp32 p times fp32 v, as the JAX
//                                           kernel does on fp32 (:846)
//   out = acc * (1 / l), fp32
// The quantization pass (quant_heads.cu) reads the fp32 q, k, v as they
// are. "qkpv" on fp32 inputs runs on the attention core's int8 form with an
// fp32 output (flash_prefix_int8.cu, kAttnI8QkpvF32): its products are int8
// there, and this kernel exists for the fp32 p.v the core cannot do.
//
// What bounds it on the card: S, 2 * H * n * kv * 64 integer operations (8.7
// GOP at the main shape, H 32, n 1536, 1376 valid keys: 0.0044 ms at the
// 1,979 TOP/s of int8), and P.V, as many fp32-accurate flops (8.7 GFLOP:
// 0.053 ms at the tensor cores' TF32 rate taken three times, 494.7 / 3
// TFLOP/s): 0.057 ms, against 3.1 MB of q8, k8, 12.6 MB of fp32 v in and
// 12.6 MB of fp32 out (0.0085 ms).
//
// Design: kernel A's split 3xTF32 forward (flash_prefix.cu:
// flash_prefix_fwd_tf32_kernel, attn_tf32.cuh) with S on the int8 tensor
// cores. 256 threads, eight warps of 16 queries, 128 queries a block,
// 64-key tiles; grid (ceil(n / 128), H), 12 x 32 = 384 blocks at the main
// shape.
//   S    mma.sync m16n8k32 .s32.s8.s8 (mma.cuh): exact by construction, the
//        function's own integer product (|q8 . k8| <= 127^2 * 64 < 2^31).
//        A warp's q8 A fragments (16 rows x 64 bytes, two k32 steps) are
//        read from device memory once, into registers, for the whole sweep;
//        each K tile lands as int8 [key][80 bytes] (k8 is [key][c]: already
//        the [n][k] B operand; the 16-byte pad puts the eight row segments
//        of one ldmatrix phase into distinct bank groups). The s32
//        accumulator has the .tf32 one's layout, so float(s) * c[h] is
//        masked and turned into P = exp2(s - m) in place, as in kernel A.
//   P.V  split 3xTF32 (attn_tf32.cuh:mm_acc): P straight from the
//        accumulator as the A fragment with its columns in the order 2t,
//        2t + 1, split once in registers; the V tile split into hi and lo
//        tf32 tiles as it is stored, the next tile's K (16 bytes a thread)
//        and V rows (16 floats) loaded into registers while this tile's
//        products run. Each tile's P.V goes into an accumulator of its own,
//        zeroed per tile, and o = o * alpha + that in fp32: the tensor
//        cores' fp32 accumulation truncates (probe_hopper.cu's accumulation
//        probe), and one chain over a 1376-key sweep would carry that bias
//        into o; a tile's chain is 24 products deep.
//   key tile  the key chunk (I8_KEY_CHUNK = 512, the JAX default bkv) is
//        part of the function only in "qkpv", where p8 sees the running
//        max; here p stays fp32 and the chunk changes only where the online
//        softmax rounds, so this kernel keeps its own tiles and is held to
//        the plain version (ops/flash_prefix.py:_i8_attention_plain at its
//        512-key chunk) at the fp32 attention bound. 64 keys as in kernel
//        A: one mm_acc a tile, the accumulators of S, P.V and o 96
//        registers a thread.
//   edges  the sweep stops at ceil(kv_len / 64) tiles; keys past kv_len get
//        P = 0 (so +-1e4 planted there never reaches o); K and V rows past n
//        and q rows past n are zero-filled, and rows past n are never
//        stored; a head with kv_len 0 gets zeros.
// 39 KB of static shared memory (the K tile 5 KB, V hi and lo 34 KB) and
// 198 registers a thread (ptxas): one block an SM. Two blocks an SM would
// cap a thread at 128 registers, and the accumulators alone take 96.
#include "attn_tf32.cuh"

namespace f5 {
namespace {

constexpr int kQkRows = 128;       // queries a block
constexpr int kQkTile = 64;        // keys a tile
constexpr int kQkLd8 = 64 + 16;    // bytes between the rows of the int8 K tile

// the 16 bytes thread tid holds of a 64-row int8 tile: row tid / 4, bytes
// 16 (tid % 4) ..; rows at or past n give zeros
__device__ __forceinline__ int4 k8_load(const int8_t* k8, int row0, int n, int tid) {
  const int row = row0 + (tid >> 2);
  return row < n ? *reinterpret_cast<const int4*>(k8 + (size_t)row * 64 + (tid & 3) * 16)
                 : make_int4(0, 0, 0, 0);
}

// one 32-bit word of a q8 A fragment: row `row` (zero at or past n), bytes
// byte .. byte + 3
__device__ __forceinline__ uint32_t q8_word(const int8_t* q8, int row, int byte, int n) {
  return row < n ? *reinterpret_cast<const uint32_t*>(q8 + (size_t)row * 64 + byte) : 0u;
}

// warp w owns queries q0 + 16w .. + 15; lane (g, t) holds rows 16w + g and
// 16w + g + 8, columns 8j + 2t, 8j + 2t + 1 of S and of o
__global__ void __launch_bounds__(kT32, 1)
flash_prefix_i8_qk_tf32_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                               const float* __restrict__ v, const float* __restrict__ cs,
                               const int* __restrict__ kv_lens, float* __restrict__ out, int n) {
  __shared__ __align__(16) int8_t sK8[kQkTile * kQkLd8];
  __shared__ __align__(16) uint32_t sVh[kQkTile * kLD32];
  __shared__ __align__(16) uint32_t sVl[kQkTile * kLD32];
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kQkRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t off = (size_t)head * n * kD32;
  const int kv_len = min(kv_lens[head], n);
  const float c = cs[head];

  // this warp's q8 rows as the A fragments of the two k32 steps
  uint32_t qa[2][4];
  {
    const int8_t* qh = q8 + off;
    const int r = q0 + wr + g;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = q8_word(qh, r, ks * 32 + 4 * t, n);
      qa[ks][1] = q8_word(qh, r + 8, ks * 32 + 4 * t, n);
      qa[ks][2] = q8_word(qh, r, ks * 32 + 16 + 4 * t, n);
      qa[ks][3] = q8_word(qh, r + 8, ks * 32 + 16 + 4 * t, n);
    }
  }
  float o[8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  zero84(o);

  const int n_tiles = kv_len > 0 ? (kv_len + kQkTile - 1) / kQkTile : 0;
  int4 kr = make_int4(0, 0, 0, 0);
  HeadRows<kQkTile, false> vr;
  if (n_tiles > 0) {
    kr = k8_load(k8 + off, 0, n, tid);
    head_load(vr, v + off, kD32, 0, n, tid);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kQkTile;
    __syncthreads();  // the previous tile's readers are done
    *reinterpret_cast<int4*>(sK8 + (tid >> 2) * kQkLd8 + (tid & 3) * 16) = kr;
    head_split(sVh, sVl, vr, tid);
    __syncthreads();
    if (jt + 1 < n_tiles) {  // the next tile's rows load while this one's products run
      kr = k8_load(k8 + off, k0 + kQkTile, n, tid);
      head_load(vr, v + off, kD32, k0 + kQkTile, n, tid);
    }
    // S = q8 . k8^T, exact
    int si[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, i8_b_nk_addr(sK8 + np * 16 * kQkLd8 + ks * 32, kQkLd8, lane));
        mma_s8_16832(si[2 * np], qa[ks], b[0], b[1]);
        mma_s8_16832(si[2 * np + 1], qa[ks], b[2], b[3]);
      }
    // online softmax of this tile; tile 0 holds key 0 < kv_len, so the
    // running max is finite from then on
    float s[8][4], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kv_len ? __fmul_rn((float)si[j][e], c)
                                                          : -INFINITY;
          mx = fmaxf(mx, s[j][e]);
        }
      const float m_new = fmaxf(m_run[h], quad_max(mx));
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          rs += s[j][e];
        }
      l_run[h] = l_run[h] * alpha[h] + quad_sum(rs);
    }
    float pv[8][4];  // this tile's P.V, a chain of its own
    zero84(pv);
    mm_acc(pv, s, sVh, sVl, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= n) continue;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;  // kv_len == 0: zeros
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<float2*>(out + off + (size_t)row * kD32 + nd * 8 + 2 * t) =
          make_float2(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
  }
}

}  // namespace
}  // namespace f5

// q8, k8: [H, n, 64] int8; v: fp32 [H, n, 64]; c: [H] fp32; kv_lens: [H]
// int32; out: [H, n, 64] fp32. All 16-byte aligned.
extern "C" int f5_flash_prefix_i8_qk_f32_fwd(const void* q8, const void* k8, const void* v,
                                             const void* c, const void* kv_lens, void* out,
                                             int H, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= 0 || n <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  f5::flash_prefix_i8_qk_tf32_kernel<<<dim3((n + f5::kQkRows - 1) / f5::kQkRows, H), f5::kT32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const float*>(v), static_cast<const float*>(c),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

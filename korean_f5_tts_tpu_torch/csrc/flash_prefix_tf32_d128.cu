// Kernels A, 10 and 18 at head dim 128 on fp32 operands, for Hopper
// (sm_90a): split 3xTF32 products on the tensor cores.
//
// Replaces, on fp32 inputs at d = 128, the TPU kernels
// korean_f5_tts_tpu/ops/flash_prefix.py:_flash_prefix_folded ->
// _kernel_nomax_hn (A), _flash_prefix_folded_lse -> _kernel_lse (10) and
// _flash_prefix_rope_call -> _kernel_rope (18), which the JAX dispatch takes
// at d in (64, 128) (ops/attention.py:260, :296) and which keep "the exact
// f32 dot" on fp32 inputs. The function is that of the d = 64 fp32 forms
// (flash_prefix.cu): folded heads q, k, v, out [H, n, 128] fp32 (18: the
// contiguous split heads [B, heads, n, 128] as [B * heads, n, 128], kv_lens
// per item, q and k of the heads g < n_rope rotated in fp32 by the fp32
// tables cos, sin [n, 64], partners c and c + 64, each product and the sum
// rounded once: ops/flash_prefix.py:rope_reference on fp32 to the bit, so
// that 18 equals A on roped inputs to the bit); keys at or past kv_len get P
// = 0, the sweep stops at ceil(kv_len / tile), rows past n are zero-filled
// and never stored, a head with kv_len 0 gives zeros. Entry points:
// f5_flash_prefix_f32_fwd and f5_flash_prefix_f32_fwd_lse at d = 128
// (flash_prefix.cu) and f5_flash_prefix_rope_d128_fwd with f32
// (flash_prefix_d128.cu), through d128::tf32. f5_flash_prefix_f32_d128_fwd_ffma
// runs A, 10 and 18 on the FFMA kernel this one replaced, for timing.
//
// Kernel 10 is the kLse instantiation: after the sweep each row's base-2
// logsumexp lse = m + log2(l) of the scores pre-scaled by scale_log2 is
// written by lane t == 0 of the row's quad (l_run is already the quad's sum),
// 0 for a row with no valid key (whose o is 0); a row past n is not stored.
// It reuses m_run and l_run after the loop: nothing changes in the loop and
// no shared memory is added, so 10's o is A's to the bit. At the training
// shape (H 64, n 1280, every key valid) 10 is 53.7 GFLOP, 0.326 ms at the
// 3xTF32 rate; the grid is 10 x 64 = 640 blocks, 4.85 waves on 132 SMs.
//
// What bounds it: at the serving shape (16 folded heads, n 1536, 1376 keys)
// 17.3 GFLOP of fp32-accurate products, 0.105 ms at the tensor cores' TF32
// rate taken three times (494.7 / 3 TFLOP/s); the FFMA kernel was bounded by
// the 67 TFLOP/s of fp32 outside them (0.258 ms).
//
// Design: flash_prefix_fwd_tf32_kernel (flash_prefix.cu, d = 64) carried to
// twice the width. x = hi + lo by cvt.rna, a.b ~ hi.hi + hi.lo + lo.hi on
// mma.sync m16n8k8 .tf32 (mma.cuh: mma_3xtf32); 256 threads, eight warps of
// 16 queries, 128 queries a block, one block an SM; q split into hi and lo
// tiles in shared memory once for the whole sweep; S = q.K^T contracting
// over 128 columns (16 k8 steps), masked, scaled by scale_log2 and turned
// into P = exp2(S - m) in place; P taken as the A fragment of P.V with its
// columns in the order 2t, 2t + 1 (mma.cuh), split in registers; running
// max and sum in fp32. Each tile's P.V goes into an accumulator of its own
// and is added to o in fp32 (o = o * alpha + pv): the tensor cores' fp32
// accumulation truncates (probe_hopper.cu's accumulation probe), and a
// chain over every key would carry that bias into o. o is 16 x 128 a warp
// (64 floats a thread), so P.V runs a 64-column half at a time into a
// 32-float accumulator, folded into o before the next half.
//
// Shared memory: rows of 128 words at a stride of 132 (4 mod 32, as 68 is
// at d = 64), so that the ldmatrix reads and the scalar B reads of P.V are
// conflict-free. The d = 64 layout at D = 128 (q hi + lo at 128 rows, a
// 64-key K and V hi + lo) would take 270,336 bytes, over the 232,448 a block
// may have. Two layouts fit in 202,752 bytes (one block an SM):
//   (i)   q, K, V all stored split, 32-key K/V tiles (hi + lo 33,792 B
//         each), loaded into registers a tile ahead while this tile's
//         products run and split as they are stored, two barriers a tile;
//         S is 16 x 32 a warp, P.V four k8 steps a half. KEPT.
//   (iii) q stored split, 64-key K and V tiles stored unsplit (33,792 B
//         each) by cp.async, K(j + 1) in flight during softmax(j) and
//         P.V(j), V(j + 1) during S(j + 1), four barriers a tile, every warp
//         splitting each K and V fragment as it reads it: half the
//         shared-memory reads a product of (i), twice the splits.
// Under one timer at the serving shape (chip_smoke.py --phases 1,2 of a
// build that had both, (iii) for A alone; NVIDIA H100 80GB HBM3, 700.00 W) A
// took 0.4014 ms on (i) and 0.4839 on (iii), the FFMA kernel 0.7155. (iii)'s
// rope form (each thread rotating its own copies in place from table rows
// held in registers a tile ahead) spilled in a trial build. (iii) is not
// kept; nor is a trial of (i) with V stored as (hi, lo) pairs read 64 bits
// at a time, which was slower and spilled. (i) runs at 253-255 registers
// without a spill (chip_smoke.py phase 1).
#include <atomic>

#include "gemm_bf16.cuh"   // allow_smem, kMaxDevices
#include "flash_prefix_d128.cuh"
#include "tf32_d128.cuh"   // t128_qk, t128_pv, t128_load, t128_split

namespace f5 {
namespace {

constexpr int kTRows = 128;   // queries a block: eight warps of 16
constexpr int kTKeys = 32;    // keys a K/V tile
// q, K and V, each as a hi and a lo tile
constexpr int kTSmem = (2 * kTRows + 4 * kTKeys) * kTLd * (int)sizeof(uint32_t);
static_assert(kTSmem == 202752 && kTSmem <= kTSmemMax, "the tiles do not fit a block");
static_assert((2 * kTRows + 4 * 64) * kTLd * (int)sizeof(uint32_t) > kTSmemMax,
              "the d = 64 layout at D = 128 (270,336 bytes) would fit after all");

// one tile's online softmax on the S accumulator (NT n-tiles of 8 keys, keys
// k0 ..): masked, scaled, P = exp2(S - m) in place; alpha rescales o and l.
// Tile 0 holds key 0 < kv_len, so the running max is finite from then on.
template <int NT>
__device__ __forceinline__ void t128_softmax(float (&s)[NT][4], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0,
                                             int kv_len, float scale_log2, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kv_len ? s[j][e] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j][e]);
      }
    const float m_new = fmaxf(m_run[h], quad_max(mx));
    alpha[h] = exp2f(m_run[h] - m_new);
    m_run[h] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[j][e] = exp2f(s[j][e] - m_new);
        rs += s[j][e];
      }
    l_run[h] = l_run[h] * alpha[h] + quad_sum(rs);
  }
}

// o (16 x 128) = o * alpha + P.V of this tile, a 64-column half at a time,
// each half's product in an accumulator of its own
template <int KT>
__device__ __forceinline__ void t128_fold_pv(float (&o)[16][4], const float (&p)[KT][4],
                                             const float (&alpha)[2], const uint32_t* vh,
                                             const uint32_t* vl, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float pv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
    t128_pv<KT>(pv, p, vh, vl, 64 * half, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[8 * half + j][e] = fmaf(o[8 * half + j][e], alpha[e >> 1], pv[j][e]);
  }
}

// warp w owns queries q0 + 16w .. + 15; lane (g, t) holds rows 16w + g and
// 16w + g + 8, columns 8j + 2t, 8j + 2t + 1 of S and of o. kRope: block y =
// item * heads + g, kv_lens per item, heads g < n_rope rotate. kLse (kernel
// 10, without kRope): also lse [H, n] fp32.
template <bool kRope, bool kLse>
__global__ void __launch_bounds__(kTThreads, 1)
flash_prefix_tf32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ kv_lens,
                              float* __restrict__ out, float* __restrict__ lse, int n,
                              float scale_log2, int heads, int n_rope,
                              const float* __restrict__ cos, const float* __restrict__ sin) {
  static_assert(!(kRope && kLse), "the lse form is kernel 10's, without rope");
  constexpr int NT = kTKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQh = reinterpret_cast<uint32_t*>(smem_raw);  // [128][132] each
  uint32_t* sQl = sQh + kTRows * kTLd;
  uint32_t* sKh = sQl + kTRows * kTLd;  // [32][132] each
  uint32_t* sKl = sKh + kTKeys * kTLd;
  uint32_t* sVh = sKl + kTKeys * kTLd;
  uint32_t* sVl = sVh + kTKeys * kTLd;
  const int head = blockIdx.y;
  const int item = kRope ? head / heads : head;
  const bool rot = kRope && head - item * heads < n_rope;  // block-uniform
  const int q0 = blockIdx.x * kTRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t off = (size_t)head * n * kTD;
  const int kv_len = min(kv_lens[item], n);
  const int n_tiles = kv_len > 0 ? (kv_len + kTKeys - 1) / kTKeys : 0;

#pragma unroll
  for (int half = 0; half < 2; ++half) {  // q in two 64-row halves: 32 registers each
    Rows128<64, kRope> r;
    t128_load(r, q + off, q0 + 64 * half, n, tid, rot, cos, sin);
    t128_split(sQh + 64 * half * kTLd, sQl + 64 * half * kTLd, r, tid, rot);
  }
  float o[16][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  Rows128<kTKeys, kRope> kr;
  Rows128<kTKeys, false> vr;
  if (n_tiles > 0) {
    t128_load(kr, k + off, 0, n, tid, rot, cos, sin);
    t128_load(vr, v + off, 0, n, tid, false, nullptr, nullptr);
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kTKeys;
    __syncthreads();  // the previous tile's readers (and the q stores) are done
    t128_split(sKh, sKl, kr, tid, rot);
    t128_split(sVh, sVl, vr, tid, false);
    __syncthreads();
    if (jt + 1 < n_tiles) {  // the next tile's rows load while this one's products run
      t128_load(kr, k + off, k0 + kTKeys, n, tid, rot, cos, sin);
      t128_load(vr, v + off, k0 + kTKeys, n, tid, false, nullptr, nullptr);
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    t128_qk<NT>(s, sQh, sQl, sKh, sKl, wr, lane);
    float alpha[2];
    t128_softmax<NT>(s, m_run, l_run, alpha, k0, kv_len, scale_log2, t);
    t128_fold_pv<NT>(o, s, alpha, sVh, sVl, lane);
  }

  float* dst = out + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= n) continue;
    const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;  // kv_len == 0: zeros
    if (kLse && t == 0)  // base 2, of the scaled scores; 0 for a row with no valid key
      lse[(size_t)head * n + row] = l_run[h] > 0.f ? m_run[h] + log2f(l_run[h]) : 0.f;
#pragma unroll
    for (int nd = 0; nd < 16; ++nd)
      *reinterpret_cast<float2*>(dst + (size_t)row * kTD + nd * 8 + 2 * t) =
          make_float2(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
  }
}

template <bool kRope, bool kLse>
cudaError_t launch_tf32_d128(const void* q, const void* k, const void* v, const void* kv_lens,
                             const void* cos, const void* sin, void* out, void* lse, int H,
                             int heads, int n, int n_rope, float scale_log2,
                             cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t err =
      allow_smem(flash_prefix_tf32_d128_kernel<kRope, kLse>, kTSmem, ready);
  if (err != cudaSuccess) return err;
  flash_prefix_tf32_d128_kernel<kRope, kLse>
      <<<dim3((n + kTRows - 1) / kTRows, H), kTThreads, kTSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const int*>(kv_lens),
          static_cast<float*>(out), static_cast<float*>(lse), n, scale_log2, heads, n_rope,
          static_cast<const float*>(cos), static_cast<const float*>(sin));
  return cudaGetLastError();
}

}  // namespace

namespace d128 {

cudaError_t tf32(const void* q, const void* k, const void* v, const void* kv_lens,
                 const void* cos, const void* sin, void* out, void* lse, int H, int heads,
                 int n, int n_rope, float scale_log2, cudaStream_t stream) {
  if (cos == nullptr)
    return lse ? launch_tf32_d128<false, true>(q, k, v, kv_lens, nullptr, nullptr, out, lse, H,
                                               1, n, 0, scale_log2, stream)
               : launch_tf32_d128<false, false>(q, k, v, kv_lens, nullptr, nullptr, out,
                                                nullptr, H, 1, n, 0, scale_log2, stream);
  if (lse != nullptr || heads <= 0 || H % heads != 0) return cudaErrorInvalidValue;
  return launch_tf32_d128<true, false>(q, k, v, kv_lens, cos, sin, out, nullptr, H, heads, n,
                                       n_rope, scale_log2, stream);
}

}  // namespace d128
}  // namespace f5

// The split 3xTF32 building blocks of the fp32 attention kernels: the
// forward (flash_prefix.cu: the fp32 forms of A, 10, 18 and 19) and the
// backward (flash_prefix_train_f32.cu: the fp32 forms of 11, 12 and 13).
//
// A block is 256 threads, eight warps of 16 rows each. Every operand tile
// is [rows][64] fp32 in device memory, loaded into registers (head_load)
// and stored into shared memory split into a hi and a lo tf32 tile
// (head_split; mma.cuh: x = hi + lo), row stride 68 words, so that the
// ldmatrix reads of the A and [n][k] B fragments and the scalar B reads of
// the second product are conflict-free. The two products every kernel is
// built from:
//   mm_rows  acc (16 x 64) += rows of a . b^T over the 64 columns (d): S = q.K^T,
//            dP = dO.V^T, and their transposes in the backward;
//   mm_acc   acc (16 x 64) += x . b, x an accumulator of mm_rows taken as
//            the A fragment with its columns in the order 2t, 2t + 1
//            (mma.cuh), split once in registers: P.V, dS.K, P^T.dO, dS^T.q.
#pragma once

#include "mma.cuh"

namespace f5 {

constexpr int kT32 = 256;   // threads a block: eight warps
constexpr int kLD32 = 68;   // row stride of every tile (words)
constexpr int kD32 = 64;    // head dim

// A fragment of rows [row0, row0 + 16) x columns [k0, k0 + 8) of a tile
__device__ __forceinline__ void lda_tf32(uint32_t (&a)[4], const uint32_t* t, int row0, int k0,
                                         int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(a, t + (row0 + (mi & 1) * 8 + (lane & 7)) * kLD32 + k0 + (mi >> 1) * 4);
}

// B fragments of rows [n0, n0 + 16) (two 8-row n-tiles) x columns [k0, k0 +
// 8) of a tile stored [n][k]: {b0, b1} of n-tile 0 in b[0], b[1], of n-tile
// 1 in b[2], b[3]
__device__ __forceinline__ void ldb2_tf32(uint32_t (&b)[4], const uint32_t* t, int n0, int k0,
                                          int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(b, t + (n0 + (mi >> 1) * 8 + (lane & 7)) * kLD32 + k0 + (mi & 1) * 4);
}

// acc[j] (16 x 64: eight n-tiles) += rows [row0, row0 + 16) of a . the 64
// rows of b^T, contracting over the 64 columns of both (d)
__device__ __forceinline__ void mm_rows(float (&acc)[8][4], const uint32_t* ah_t,
                                        const uint32_t* al_t, const uint32_t* bh_t,
                                        const uint32_t* bl_t, int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < kD32 / 8; ++ks) {
    uint32_t ah[4], al[4];
    lda_tf32(ah, ah_t, row0, ks * 8, lane);
    lda_tf32(al, al_t, row0, ks * 8, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bh[4], bl[4];
      ldb2_tf32(bh, bh_t, np * 16, ks * 8, lane);
      ldb2_tf32(bl, bl_t, np * 16, ks * 8, lane);
      mma_3xtf32(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc[j] (16 x 64 of d) += x (16 x 64, accumulator layout) . rows of the
// [64][68] tile b, contracting over x's columns = b's rows, taken in the
// order 2t, 2t + 1 (mma.cuh); x is split here, once
__device__ __forceinline__ void mm_acc(float (&acc)[8][4], const float (&x)[8][4],
                                       const uint32_t* bh_t, const uint32_t* bl_t, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(x[ks][0], ah[0], al[0]);
    split_tf32(x[ks][2], ah[1], al[1]);
    split_tf32(x[ks][1], ah[2], al[2]);
    split_tf32(x[ks][3], ah[3], al[3]);
    const int r0 = (ks * 8 + 2 * t) * kLD32 + g;
#pragma unroll
    for (int nd = 0; nd < kD32 / 8; ++nd) {
      const int at = r0 + nd * 8;
      mma_3xtf32(acc[nd], ah, al, bh_t[at], bh_t[at + kLD32], bl_t[at], bl_t[at + kLD32]);
    }
  }
}

__device__ __forceinline__ void zero84(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// rows [row0, row0 + ROWS) of a [n, 64] head whose rows lie ld floats apart
// (64 for the folded heads; strided in the fp32 forms of 18 and 19), held in
// registers until head_split stores them (loaded ahead of their tile while
// the previous tile's products run): thread tid holds the columns c .. c + 3
// and c + 32 .. c + 35 of row (tid + it * 256) / 8, c = 4 * (tid % 8), the
// two halves of a rotation pair; rows at or past n give zeros. kRot (rotated
// heads, when `rot`) also holds the row's cos and sin [32] at c.
template <int ROWS, bool kRot = false>
struct HeadRows {
  float4 x[ROWS / 32][2];
  float4 cs[kRot ? ROWS / 32 : 1][2];
};

template <int ROWS, bool kRot>
__device__ __forceinline__ void head_load(HeadRows<ROWS, kRot>& r, const float* src, long long ld,
                                          int row0, int n, int tid, bool rot = false,
                                          const float* cos = nullptr,
                                          const float* sin = nullptr) {
#pragma unroll
  for (int it = 0; it < ROWS / 32; ++it) {
    const int i = tid + it * kT32;
    const int row = row0 + (i >> 3), c = (i & 7) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x[it][0] = r.x[it][1] = z;
    if (kRot) r.cs[it][0] = r.cs[it][1] = z;
    if (row < n) {
      const float* p = src + row * ld + c;
      r.x[it][0] = *reinterpret_cast<const float4*>(p);
      r.x[it][1] = *reinterpret_cast<const float4*>(p + 32);
      if (kRot && rot) {
        r.cs[it][0] = *reinterpret_cast<const float4*>(cos + (size_t)row * 32 + c);
        r.cs[it][1] = *reinterpret_cast<const float4*>(sin + (size_t)row * 32 + c);
      }
    }
  }
}

// out[c] = x[c] cos[c] - x[c + 32] sin[c], out[c + 32] = x[c + 32] cos[c] +
// x[c] sin[c], each product and the sum rounded once, as the plain
// version's torch ops (ops/flash_prefix.py:rope_reference on fp32)
__device__ __forceinline__ void rotate_pair(float& x1, float& x2, float cs, float sn) {
  const float a = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
  x2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
  x1 = a;
}

// v split into hi and lo tf32 words at hi + at, lo + at
__device__ __forceinline__ void split4(uint32_t* hi, uint32_t* lo, int at, float4 v) {
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + at) = h;
  *reinterpret_cast<uint4*>(lo + at) = l;
}

// the registers of head_load (rotated first when kRot and rot), split into
// hi and lo tf32 tiles [ROWS][68]; eight consecutive threads store one row's
// 32 words, so the stores are conflict-free
template <int ROWS, bool kRot>
__device__ __forceinline__ void head_split(uint32_t* hi, uint32_t* lo,
                                           const HeadRows<ROWS, kRot>& r, int tid,
                                           bool rot = false) {
#pragma unroll
  for (int it = 0; it < ROWS / 32; ++it) {
    const int i = tid + it * kT32;
    const int at = (i >> 3) * kLD32 + (i & 7) * 4;
    float4 a = r.x[it][0], b = r.x[it][1];
    if (kRot && rot) {
      const float4 cs = r.cs[it][0], sn = r.cs[it][1];
      rotate_pair(a.x, b.x, cs.x, sn.x);
      rotate_pair(a.y, b.y, cs.y, sn.y);
      rotate_pair(a.z, b.z, cs.z, sn.z);
      rotate_pair(a.w, b.w, cs.w, sn.w);
    }
    split4(hi, lo, at, a);
    split4(hi, lo, at + 32, b);
  }
}

}  // namespace f5

// The split 3xTF32 building blocks of the fp32 attention kernels at head dim
// 128: the forward (flash_prefix_tf32_d128.cu: A and 18) and the backward
// (flash_prefix_train_tf32_d128.cu: 11, 12 and 13). attn_tf32.cuh's at
// twice the width: 256 threads a block, eight warps of 16 rows; tiles of 128
// columns at a row stride of 132 words (4 mod 32, as 68 is at d = 64), so
// that the ldmatrix reads and the scalar B reads of the second product are
// conflict-free; rows loaded a tile ahead into registers (t128_load) and
// split into a hi and a lo tf32 tile as they are stored (t128_split).
#pragma once

#include "attn_tf32.cuh"  // split4, mma_3xtf32, rotate_pair

namespace f5 {

constexpr int kTD = 128;           // head dim
constexpr int kTLd = 132;          // row stride of every tile (words)
constexpr int kTThreads = 256;     // threads a block: eight warps
constexpr int kTSmemMax = 232448;  // dynamic shared memory a block may take

// ldmatrix row addresses (mma.cuh's .tf32 fragments) at the stride kTLd: A
// of rows [row0, row0 + 16) x columns [k0, k0 + 8); B of rows [n0, n0 + 16)
// (two n-tiles) of a tile stored [n][k]
__device__ __forceinline__ const uint32_t* t128_a(const uint32_t* t, int row0, int k0, int lane) {
  const int mi = lane >> 3;
  return t + (row0 + (mi & 1) * 8 + (lane & 7)) * kTLd + k0 + (mi >> 1) * 4;
}

__device__ __forceinline__ const uint32_t* t128_b(const uint32_t* t, int n0, int k0, int lane) {
  const int mi = lane >> 3;
  return t + (n0 + (mi >> 1) * 8 + (lane & 7)) * kTLd + k0 + (mi & 1) * 4;
}

// s[j] (16 x 8 NT) += rows [row0, row0 + 16) of a . rows [0, 8 NT) of b^T,
// contracting over the 128 columns, b as hi and lo tiles; a as hi and lo
// tiles too, or with kRawA one tile of unsplit fp32 words (ah; al unused)
// whose fragments are split in registers as they are read
template <int NT, bool kRawA = false>
__device__ __forceinline__ void t128_qk(float (&s)[NT][4], const uint32_t* ah_t,
                                        const uint32_t* al_t, const uint32_t* bh_t,
                                        const uint32_t* bl_t, int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < kTD / 8; ++ks) {
    uint32_t ah[4], al[4];
    ldmatrix_x4(ah, t128_a(ah_t, row0, ks * 8, lane));
    if (kRawA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __uint_as_float(ah[e]);
        split_tf32(x, ah[e], al[e]);
      }
    } else {
      ldmatrix_x4(al, t128_a(al_t, row0, ks * 8, lane));
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, t128_b(bh_t, np * 16, ks * 8, lane));
      ldmatrix_x4(bl, t128_b(bl_t, np * 16, ks * 8, lane));
      mma_3xtf32(s[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(s[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// pv[nd] (16 x 64: columns col0 + 8 nd ..) += P (16 x 8 KT, an accumulator
// of t128_qk) . rows [0, 8 KT) of V (hi and lo tiles); P split here, its
// columns in the order 2t, 2t + 1 (so B's rows 2t and 2t + 1, scalar reads)
template <int KT>
__device__ __forceinline__ void t128_pv(float (&pv)[8][4], const float (&p)[KT][4],
                                        const uint32_t* vh, const uint32_t* vl, int col0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(p[ks][0], ah[0], al[0]);
    split_tf32(p[ks][2], ah[1], al[1]);
    split_tf32(p[ks][1], ah[2], al[2]);
    split_tf32(p[ks][3], ah[3], al[3]);
    const int r0 = (ks * 8 + 2 * t) * kTLd + col0 + g;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int at = r0 + nd * 8;
      mma_3xtf32(pv[nd], ah, al, vh[at], vh[at + kTLd], vl[at], vl[at + kTLd]);
    }
  }
}

// Rows [row0, row0 + ROWS) of a [n, 128] head held in registers until
// t128_split stores them: item it of thread tid is row (tid + 256 it) / 16,
// columns c .. c + 3 and c + 64 .. c + 67 with c = 4 ((tid + 256 it) % 16),
// the two halves of a rotation pair; rows at or past n give zeros. kRot also
// holds the row's cos and sin at c (tables [n, 64]) when `rot`.
template <int ROWS, bool kRot>
struct Rows128 {
  float4 x[ROWS / 16][2];
  float4 cs[kRot ? ROWS / 16 : 1][2];
};

template <int ROWS, bool kRot>
__device__ __forceinline__ void t128_load(Rows128<ROWS, kRot>& r, const float* src, int row0, int n,
                                          int tid, bool rot, const float* cos, const float* sin) {
#pragma unroll
  for (int it = 0; it < ROWS / 16; ++it) {
    const int i = tid + it * kTThreads;
    const int row = row0 + (i >> 4), c = (i & 15) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x[it][0] = r.x[it][1] = z;
    if (kRot) r.cs[it][0] = r.cs[it][1] = z;
    if (row < n) {
      const float* p = src + (size_t)row * kTD + c;
      r.x[it][0] = *reinterpret_cast<const float4*>(p);
      r.x[it][1] = *reinterpret_cast<const float4*>(p + 64);
      if (kRot && rot) {
        r.cs[it][0] = *reinterpret_cast<const float4*>(cos + (size_t)row * 64 + c);
        r.cs[it][1] = *reinterpret_cast<const float4*>(sin + (size_t)row * 64 + c);
      }
    }
  }
}

__device__ __forceinline__ void rotate4(float4& a, float4& b, const float4& cs, const float4& sn) {
  rotate_pair(a.x, b.x, cs.x, sn.x);
  rotate_pair(a.y, b.y, cs.y, sn.y);
  rotate_pair(a.z, b.z, cs.z, sn.z);
  rotate_pair(a.w, b.w, cs.w, sn.w);
}

// the registers of t128_load (rotated first when kRot and rot), split into
// hi and lo tiles [ROWS][132]; eight consecutive threads store 128
// contiguous bytes of a row, so the stores are conflict-free
template <int ROWS, bool kRot>
__device__ __forceinline__ void t128_split(uint32_t* hi, uint32_t* lo, const Rows128<ROWS, kRot>& r,
                                           int tid, bool rot) {
#pragma unroll
  for (int it = 0; it < ROWS / 16; ++it) {
    const int i = tid + it * kTThreads;
    const int at = (i >> 4) * kTLd + (i & 15) * 4;
    float4 a = r.x[it][0], b = r.x[it][1];
    if (kRot && rot) rotate4(a, b, r.cs[it][0], r.cs[it][1]);
    split4(hi, lo, at, a);
    split4(hi, lo, at + 64, b);
  }
}

}  // namespace f5

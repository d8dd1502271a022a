"""A numpy mirror of the split 3xTF32 products of the port's fp32 kernels
(korean_f5_tts_tpu_torch/csrc/mma.cuh, attn_tf32.cuh, gemm_f32.cuh): the
tf32 rounding and split, mma.sync m16n8k8 .tf32 and ldmatrix on 32-bit
words as the PTX ISA lays them out, the fragment addresses of the attention
kernels' padded tiles, and the 128-byte swizzle of the fp32 product core's
TMA tiles. The CPU tests hold the kernels' index arithmetic and numerics to
it (tests/test_torch_fp32_attn_paths.py, tests/test_torch_fp32_tf32_core.py).
"""

from __future__ import annotations

import numpy as np


def tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from
    zero (the sign-magnitude bits plus half of the dropped range, then the
    13 low bits cleared); finite inputs."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(np.asarray(x, np.float32) - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels compute it: hi.hi + hi.lo + lo.hi, each product
    of tf32 values exact in fp32, summed in fp32"""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (al @ bh) + (ah @ bl) + (ah @ bh)


# --- the attention kernels' fragment arithmetic -----------------------------------

LD = 68  # the kernels' row stride, words (d = 64)
LD128 = 132  # the row stride of the d = 128 forward's tiles (flash_prefix_tf32_d128.cu)


def _lanes():
    lane = np.arange(32)
    return lane, lane >> 2, lane & 3


def trunc_f32(x):
    """float64 -> the fp32 value next to it toward zero: the tensor cores'
    fp32 accumulation, which truncates (probe_hopper.cu's accumulation
    probe: products worth 0.75 ulp add nothing to an accumulator of 1)."""
    x = np.asarray(x, np.float64)
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f).astype(np.float64)


def mma_1688(a, b, c, f32=False, trunc=False):
    """mma.sync.m16n8k8 .tf32 on per-lane registers: a [32, 4], b [32, 2], c
    [32, 4] -> d [32, 4] (PTX ISA fragment layouts; exact in float64, or with
    f32 the sum rounded to fp32 once, as fp32 accumulation would, or with
    trunc truncated toward zero, as the card's accumulation does). Leading
    dimensions (several warps at once) broadcast: a [..., 32, 4] etc."""
    _, g, tt = _lanes()
    a, b, c = (np.asarray(x) for x in (a, b, c))
    lead = np.broadcast_shapes(a.shape[:-2], b.shape[:-2], c.shape[:-2])
    A, B, C = np.zeros(lead + (16, 8)), np.zeros(lead + (8, 8)), np.zeros(lead + (16, 8))
    A[..., g, tt], A[..., g + 8, tt], A[..., g, tt + 4], A[..., g + 8, tt + 4] = np.moveaxis(
        np.broadcast_to(a, lead + (32, 4)), -1, 0)
    B[..., tt, g], B[..., tt + 4, g] = np.moveaxis(np.broadcast_to(b, lead + (32, 2)), -1, 0)
    (C[..., g, 2 * tt], C[..., g, 2 * tt + 1], C[..., g + 8, 2 * tt],
     C[..., g + 8, 2 * tt + 1]) = np.moveaxis(np.broadcast_to(c, lead + (32, 4)), -1, 0)
    D = A @ B + C
    if trunc:
        D = trunc_f32(D)
    elif f32:
        D = D.astype(np.float32).astype(np.float64)
    return np.stack([D[..., g, 2 * tt], D[..., g, 2 * tt + 1], D[..., g + 8, 2 * tt],
                     D[..., g + 8, 2 * tt + 1]], -1)


def mma_3x(ah, al, bh, bl, c, one=False, trunc=False):
    """mma.cuh:mma_3xtf32, the small terms first, each product summed in
    fp32 (rounded, or with trunc truncated); one: the single TF32 product
    hi.hi alone (the control)."""
    if not one:
        c = mma_1688(al, bh, c, True, trunc)
        c = mma_1688(ah, bl, c, True, trunc)
    return mma_1688(ah, bh, c, True, trunc)


def mma_16832_s8(a, b, c):
    """mma.sync.m16n8k32 .s32.s8.s8 on per-lane registers (mma.cuh): a [32,
    4], b [32, 2] 32-bit words of four int8 each, the lowest byte the lowest
    k; c [32, 4] int -> d [32, 4], exact (int64 here)."""
    _, g, tt = _lanes()
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    C = np.zeros((16, 8), np.int64)
    ab, bb = bytes_s8(a), bytes_s8(b)  # [32, regs, 4]
    for i in range(4):
        A[g, 4 * tt + i], A[g + 8, 4 * tt + i] = ab[:, 0, i], ab[:, 1, i]
        A[g, 16 + 4 * tt + i], A[g + 8, 16 + 4 * tt + i] = ab[:, 2, i], ab[:, 3, i]
        B[4 * tt + i, g], B[16 + 4 * tt + i, g] = bb[:, 0, i], bb[:, 1, i]
    C[g, 2 * tt], C[g, 2 * tt + 1], C[g + 8, 2 * tt], C[g + 8, 2 * tt + 1] = c.T
    D = A @ B + C
    return np.stack([D[g, 2 * tt], D[g, 2 * tt + 1], D[g + 8, 2 * tt], D[g + 8, 2 * tt + 1]], 1)


def bytes_s8(words):
    """32-bit words -> their four int8 values, lowest byte first: [..., 4]"""
    return np.asarray(words, np.uint32).view(np.int8).reshape(*np.shape(words), 4)


def ldmatrix_x4(mem, addr):
    """ldmatrix.x4 (b16) on 32-bit words: lane l gives the row address (in
    words) of row l % 8 of matrix l / 8 and receives word l % 4 of row l / 4
    of each matrix. addr [..., 32]: several warps at once."""
    lane, _, _ = _lanes()
    addr = np.asarray(addr)
    return np.stack([mem[addr[..., 8 * i + (lane >> 2)] + (lane & 3)] for i in range(4)], -1)


def lda_addr(row0, k0, ld=LD):
    lane, _, _ = _lanes()
    mi = lane >> 3
    return (row0 + (mi & 1) * 8 + (lane & 7)) * ld + k0 + (mi >> 1) * 4


def ldb2_addr(n0, k0, ld=LD):
    lane, _, _ = _lanes()
    mi = lane >> 3
    return (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 + (mi & 1) * 4


def _tile(x, ld=LD):
    """[rows, 64] (or [rows, 128] at ld LD128) -> the flat [rows][ld] words
    of a padded shared tile"""
    out = np.zeros((x.shape[0], ld))
    out[:, :x.shape[1]] = x
    return out.reshape(-1)


def mm_rows(a_rows, b_rows, row0):
    """attn_tf32.cuh:mm_rows: rows [row0, row0 + 16) of a . b^T,
    contracting over the 64 columns, in the accumulator layout [8][32, 4]"""
    A, B = _tile(a_rows), _tile(b_rows)
    acc = np.zeros((8, 32, 4))
    for ks in range(8):
        af = ldmatrix_x4(A, lda_addr(row0, ks * 8))
        for np_ in range(4):
            bf = ldmatrix_x4(B, ldb2_addr(np_ * 16, ks * 8))
            acc[2 * np_] = mma_1688(af, bf[:, 0:2], acc[2 * np_])
            acc[2 * np_ + 1] = mma_1688(af, bf[:, 2:4], acc[2 * np_ + 1])
    return acc


def mm_acc(x, b_rows):
    """attn_tf32.cuh:mm_acc: x (16 x 64, accumulator layout) . the 64 rows
    of b, columns taken in the order 2t, 2t + 1; scalar B reads"""
    B = _tile(b_rows)
    _, g, tt = _lanes()
    acc = np.zeros((8, 32, 4))
    for ks in range(8):
        a = x[ks][:, [0, 2, 1, 3]]
        r0 = (ks * 8 + 2 * tt) * LD + g
        for nd in range(8):
            at = r0 + nd * 8
            acc[nd] = mma_1688(a, np.stack([B[at], B[at + LD]], 1), acc[nd])
    return acc


def mm_rows_3x(a_rows, b_rows, row0, one=False, ld=LD):
    """attn_tf32.cuh:mm_rows on the hi and lo tiles of fp32 a and b (split
    as they are stored), the three products of each fragment pair summed in
    fp32, contracting over the columns of a and b; one n-tile a row octet of
    b (64 rows at d = 64); one: hi.hi alone. ld LD128: the d = 128 forms'
    t128_qk (128 columns, a 32-row tile of b: four n-tiles). row0 an array
    [W]: W warps at once, acc [n-tiles][W, 32, 4]. Every n-tile of a k8
    step at once: n-tile 2 np + j is columns 2j, 2j + 1 of pair np's B."""
    (ah, al), (bh, bl) = (tuple(_tile(t, ld) for t in split_tf32(x)) for x in (a_rows, b_rows))
    r0 = np.asarray(row0)
    nt = b_rows.shape[0] // 8
    acc = np.zeros((nt,) + r0.shape + (32, 4))
    r0 = r0[..., None]
    n0 = 16 * np.arange(nt // 2)[:, None]
    b_shape = (nt,) + (1,) * (acc.ndim - 3) + (32, 2)

    def tiles(b):  # [pairs, 32, 4] -> [n-tiles, (1,) * warp dims, 32, 2]
        return b.reshape(nt // 2, 32, 2, 2).transpose(0, 2, 1, 3).reshape(b_shape)

    for ks in range(a_rows.shape[1] // 8):
        afh = ldmatrix_x4(ah, lda_addr(r0, ks * 8, ld))
        afl = ldmatrix_x4(al, lda_addr(r0, ks * 8, ld))
        bfh = tiles(ldmatrix_x4(bh, ldb2_addr(n0, ks * 8, ld)))
        bfl = tiles(ldmatrix_x4(bl, ldb2_addr(n0, ks * 8, ld)))
        acc = mma_3x(afh, afl, bfh, bfl, acc, one)
    return acc


def mm_acc_3x(x, b_rows, one=False, trunc=False, ld=LD, col0=0, acc=None):
    """attn_tf32.cuh:mm_acc on the hi and lo tiles of fp32 b: x (an fp32
    accumulator, one k8 step an n-tile of it) split once in registers, its
    columns in the order 2t, 2t + 1, against columns col0 .. col0 + 63 of
    b; one: hi.hi alone; trunc: the card's truncating accumulation. ld
    LD128, col0 0 or 64: one half of the d = 128 forms' t128_pv. acc: the
    accumulator the products chain into (zeros when None); x [k-steps][...,
    32, 4]: several warps at once. The eight n-tiles of a k8 step at once."""
    bh, bl = (_tile(t, ld) for t in split_tf32(b_rows))
    _, g, tt = _lanes()
    x = np.asarray(x)
    acc = np.zeros((8,) + x.shape[1:]) if acc is None else np.array(acc, np.float64)
    b_shape = (8,) + (1,) * (acc.ndim - 3) + (32, 2)
    nd = 8 * np.arange(8)[:, None]
    for ks in range(len(x)):
        ah, al = split_tf32(x[ks][..., [0, 2, 1, 3]])
        at = (ks * 8 + 2 * tt) * ld + col0 + g + nd
        acc = mma_3x(ah.astype(np.float64), al.astype(np.float64),
                     np.stack([bh[at], bh[at + ld]], -1).reshape(b_shape),
                     np.stack([bl[at], bl[at + ld]], -1).reshape(b_shape), acc, one, trunc)
    return acc


def from_acc(acc):
    """the epilogue's stores: acc[nd][lane] holds (g, 8nd + 2t .. +1) and
    (g + 8, ...), written as float2 at those places of a [16, 8 len(acc)]
    block (64 columns, or 128 at d = 128)"""
    _, g, tt = _lanes()
    out = np.full((16, 8 * len(acc)), np.nan)
    for nd in range(len(acc)):
        for h in range(2):
            out[g + 8 * h, nd * 8 + 2 * tt] = acc[nd][:, 2 * h]
            out[g + 8 * h, nd * 8 + 2 * tt + 1] = acc[nd][:, 2 * h + 1]
    return out


# --- the fp32 product core's swizzled tiles (csrc/gemm_f32.cuh, hopper.cuh) --------

ROW_WORDS = 32  # fp32 words of a 128-byte swizzled row


def swz_word(row, col):
    """The word of a 128-byte-swizzled fp32 tile that holds logical (row,
    col), col < 32: 16-byte chunk col / 4 of the row sits at chunk (col / 4)
    ^ (row % 8) (hopper.cuh:swz_chunk_addr)."""
    return row * ROW_WORDS + (((col >> 2) ^ (row & 7)) << 2) + (col & 3)


def swizzle(x):
    """[rows, 32] fp32 -> the flat words of its swizzled tile"""
    rows = x.shape[0]
    out = np.zeros(rows * ROW_WORDS, dtype=x.dtype)
    r, c = np.meshgrid(np.arange(rows), np.arange(ROW_WORDS), indexing="ij")
    out[swz_word(r, c)] = x
    return out

"""The split 3xTF32 forms of the fp32 attention forward (kernels A, 10, 18,
19 on fp32 operands: csrc/flash_prefix.cu:flash_prefix_fwd_tf32_kernel) and
of the fp32 product core (kernels B, 7, 8 on fp32 operands: csrc/
gemm_f32.cuh), on the CPU. The kernels run on the card only
(tests/test_torch_cuda.py, chip_smoke.py phase 2); here, with the mirror of
tests/_tf32_mirror.py:

- the forward of one 128-query block at the fragment level: S = q.K^T by
  mm_rows on hi and lo tiles, its accumulator masked, scaled and turned into
  P in place, taken as the A fragment of P.V with its columns in the order
  2t, 2t + 1, the online max and denominator over 64-key tiles, each tile's
  P.V in an accumulator of its own, the lse = m + log2(l); against the same
  function in float64 within 1e-5 (the card's bound for o and lse), while
  one TF32 product in place of the three misses that bound; and the same at
  d = 128 (kernels A and 18 on fp32 operands: csrc/flash_prefix_tf32_d128.cu
  at the tiling it keeps: hi and lo tiles of 128 columns at the stride 132,
  32-key tiles, P.V a 64-column half at a time, each half of each tile in an
  accumulator of its own);
- the product core's split: y (kernel 7 and B's first product: LN and the
  modulation in fp32) split into hi and lo by cvt.rna, the weight likewise,
  a stage's twelve k8 products (the eight small terms first) summed in fp32
  into an accumulator of their own and added to the tile's: within 1e-5 of
  float64 (the card's bound is 1e-4), one TF32 product past 1e-4;
- the index arithmetic of the .tf32 shared-memory layout: the fp32 TMA box
  that probe_hopper.py holds the card to is the mirror's swizzled tile, the
  consumers' ldmatrix addresses into it give .tf32's A fragments, the
  descriptor's 32-byte step per k8 step reads the weight's k columns
  through the address-bit swizzle, the split commutes with the swizzle, and
  the row loader of every fp32 attention kernel (attn_tf32.cuh:head_load /
  head_split, and flash_prefix_tf32_d128.cu:t128_load / t128_split at d =
  128) stores every column of a row once;
- the epilogue of the bf16 attention core's D = 128 lse form (kernel 10 at
  d = 128: attn_wgmma.cuh:attn_fwd_d128_wgmma_kernel<true, false>) writes
  each row's lse exactly once.
"""

import math

import numpy as np
import pytest
import torch

from _tf32_mirror import (
    LD,
    LD128,
    ROW_WORDS,
    _lanes,
    _tile,
    from_acc,
    lda_addr,
    ldmatrix_x4,
    mm_acc_3x,
    mma_3x,
    mma_16832_s8,
    mm_rows_3x,
    split_tf32,
    swizzle,
    swz_word,
    tf32_rna,
)
from korean_f5_tts_tpu_torch.ops import flash_prefix, grouped_conv
from korean_f5_tts_tpu_torch.scripts.probe_hopper import swizzled_box

F32_ATTN_REL = 1e-5  # chip_smoke.py: the fp32 forms' o and lse
F32_REL = 1e-4       # chip_smoke.py: the fp32 forms of A, B, 7, 8, 18, 19
LOG2E = 1.4426950408889634


def _rng(seed):
    return np.random.default_rng(seed)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def attention_fp64(q, k, v, kv_len):
    """Kernel A's / 10's function in float64: o [n, d] and the base-2 lse of
    the scores scaled by 1 / sqrt(d); zeros and lse 0 for kv_len 0."""
    n, d = q.shape
    if kv_len == 0:
        return np.zeros((n, d)), np.zeros(n)
    s = (q.astype(np.float64) @ k[:kv_len].astype(np.float64).T) / math.sqrt(d)
    m = s.max(1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(1, keepdims=True)
    return (p @ v[:kv_len].astype(np.float64)) / l, (m + np.log(l))[:, 0] * LOG2E


def _quad(x, op):
    """reduce over the four lanes of a quad (lanes 4g .. 4g + 3), per lane"""
    return np.repeat(op(x.reshape(8, 4, *x.shape[1:]), axis=1), 4, axis=0)


def forward_tf32(q, k, v, kv_len, one=False):
    """flash_prefix_fwd_tf32_kernel on one block of 128 queries (n <= 128):
    returns o [n, 64] and lse [n] as the kernel stores them. one: a single
    TF32 product in place of each split one (the control)."""
    n = q.shape[0]
    f32 = np.float32
    scale_log2 = f32(LOG2E / 8.0)
    n_tiles = -(-kv_len // 64)
    qp = np.zeros((128, 64), f32)
    qp[:n] = q
    kp, vp = (np.zeros((64 * max(n_tiles, 1), 64), f32) for _ in range(2))
    kp[:n], vp[:n] = k[:64 * max(n_tiles, 1)], v[:64 * max(n_tiles, 1)]
    _, g, tt = _lanes()
    o_rows, lse_rows = np.zeros((128, 64)), np.zeros(128)
    for w in range(8):
        o = np.zeros((8, 32, 4), f32)
        m = np.full((32, 2), -np.inf, f32)
        l = np.zeros((32, 2), f32)
        for jt in range(n_tiles):
            k0 = 64 * jt
            s = mm_rows_3x(qp, kp[k0:k0 + 64], 16 * w, one).astype(f32)
            key = k0 + 8 * np.arange(8)[:, None, None] + 2 * tt[None, :, None] + (
                np.arange(4) & 1)[None, None, :]
            s = np.where(key < kv_len, s * scale_log2, f32(-np.inf)).astype(f32)
            halves = s.reshape(8, 32, 2, 2)           # [j][lane][h][e & 1]
            m_new = np.maximum(m, _quad(halves.max(axis=(0, 3)), np.max)).astype(f32)
            alpha = np.exp2(m - m_new).astype(f32)
            p = np.exp2(halves - m_new[None, :, :, None]).astype(f32)
            l = (l * alpha + _quad(p.sum(axis=(0, 3), dtype=f32), np.sum)).astype(f32)
            m = m_new
            pv = mm_acc_3x(p.reshape(8, 32, 4), vp[k0:k0 + 64], one).astype(f32)
            o = (o * np.repeat(alpha, 2, axis=1)[None] + pv).astype(f32)
        inv = np.where(l > 0, f32(1) / np.where(l > 0, l, 1), 0).astype(f32)
        o_rows[16 * w:16 * w + 16] = from_acc(o * np.repeat(inv, 2, axis=1)[None])
        lse = np.where(l > 0, m + np.log2(np.where(l > 0, l, 1)), 0).astype(f32)
        for h in range(2):
            lse_rows[16 * w + g + 8 * h] = lse[:, h]
    return o_rows[:n], lse_rows[:n]


@pytest.mark.parametrize("n,kv_len", [(128, 128), (100, 77), (65, 65), (128, 1), (50, 0)])
def test_forward_split_holds_fp32_accuracy(n, kv_len):
    rng = _rng(40 + n + kv_len)
    q, k, v = (rng.standard_normal((n, 64)).astype(np.float32) for _ in range(3))
    o, lse = forward_tf32(q, k, v, kv_len)
    o64, lse64 = attention_fp64(q, k, v, kv_len)
    if kv_len == 0:  # the kernels' convention: zeros, lse 0
        assert not o.any() and not lse.any()
        return
    assert rel_err(o, o64) <= F32_ATTN_REL
    assert rel_err(lse, lse64) <= F32_ATTN_REL
    # the port's plain version (fp32) computes the same function
    want = flash_prefix.prefix_attention_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v)), torch.tensor([kv_len]))[0]
    assert rel_err(want.numpy(), o64) <= 1e-6


def test_forward_with_one_tf32_product_misses_the_bound():
    rng = _rng(47)
    q, k, v = (rng.standard_normal((128, 64)).astype(np.float32) for _ in range(3))
    o64, lse64 = attention_fp64(q, k, v, 100)
    o, lse = forward_tf32(q, k, v, 100)
    o1, _ = forward_tf32(q, k, v, 100, one=True)
    assert rel_err(o, o64) <= F32_ATTN_REL
    assert rel_err(o1, o64) > F32_ATTN_REL


KEYS128 = 32  # keys a K/V tile of the d = 128 forward (flash_prefix_tf32_d128.cu, kept)


def forward_tf32_d128(q, k, v, kv_len, one=False):
    """flash_prefix_tf32_d128_kernel<32, ...> on one block of 128 queries (n
    <= 128), d = 128: q, each 32-key K and V tile split into hi and lo tiles
    [rows][132]; S (16 x 32 a warp) by t128_qk over 16 k8 steps, masked,
    scaled, P = exp2(S - m) in place; P.V a 64-column half at a time (t128_pv
    at columns 0 and 64), each half's product of each tile in an accumulator
    of its own, folded into o as o * alpha + pv; returns o [n, 128] and,
    as kernel 10's kLse epilogue writes it from the same m and l, lse [n]
    (m + log2(l), 0 for a row with no valid key). one: a single TF32
    product in place of each split one (the control)."""
    n = q.shape[0]
    f32 = np.float32
    scale_log2 = f32(LOG2E / math.sqrt(128))
    n_tiles = -(-kv_len // KEYS128)
    rows = KEYS128 * max(n_tiles, 1)
    qp = np.zeros((128, 128), f32)
    qp[:n] = q
    kp, vp = (np.zeros((rows, 128), f32) for _ in range(2))
    m_ = min(n, rows)  # rows past n are zero-filled
    kp[:m_], vp[:m_] = k[:m_], v[:m_]
    _, g, tt = _lanes()
    nt = KEYS128 // 8
    o_rows, lse_rows = np.zeros((128, 128)), np.zeros(128)
    for w in range(8):
        o = np.zeros((16, 32, 4), f32)
        m = np.full((32, 2), -np.inf, f32)
        l = np.zeros((32, 2), f32)
        for jt in range(n_tiles):
            k0 = KEYS128 * jt
            s = mm_rows_3x(qp, kp[k0:k0 + KEYS128], 16 * w, one, ld=LD128).astype(f32)
            key = k0 + 8 * np.arange(nt)[:, None, None] + 2 * tt[None, :, None] + (
                np.arange(4) & 1)[None, None, :]
            s = np.where(key < kv_len, s * scale_log2, f32(-np.inf)).astype(f32)
            halves = s.reshape(nt, 32, 2, 2)          # [j][lane][h][e & 1]
            m_new = np.maximum(m, _quad(halves.max(axis=(0, 3)), np.max)).astype(f32)
            alpha = np.exp2(m - m_new).astype(f32)
            p = np.exp2(halves - m_new[None, :, :, None]).astype(f32)
            l = (l * alpha + _quad(p.sum(axis=(0, 3), dtype=f32), np.sum)).astype(f32)
            m = m_new
            for half in (0, 1):
                pv = mm_acc_3x(p.reshape(nt, 32, 4), vp[k0:k0 + KEYS128], one, ld=LD128,
                               col0=64 * half).astype(f32)
                part = slice(8 * half, 8 * half + 8)
                o[part] = (o[part] * np.repeat(alpha, 2, axis=1)[None] + pv).astype(f32)
        inv = np.where(l > 0, f32(1) / np.where(l > 0, l, 1), 0).astype(f32)
        o_rows[16 * w:16 * w + 16] = from_acc(o * np.repeat(inv, 2, axis=1)[None])
        lse = np.where(l > 0, m + np.log2(np.where(l > 0, l, 1)), 0).astype(f32)
        for h in range(2):
            lse_rows[16 * w + g + 8 * h] = lse[:, h]
    return o_rows[:n], lse_rows[:n]


# (n, kv_len): full, ragged, one key, none, and around the 32-key tile's edge
@pytest.mark.parametrize("n,kv_len", [(128, 128), (100, 77), (65, 65), (128, 1), (50, 0),
                                      (127, 31), (128, 32), (100, 33)])
def test_forward_split_holds_fp32_accuracy_at_d128(n, kv_len):
    rng = _rng(140 + n + kv_len)
    q, k, v = (rng.standard_normal((n, 128)).astype(np.float32) for _ in range(3))
    o, _ = forward_tf32_d128(q, k, v, kv_len)
    o64, _ = attention_fp64(q, k, v, kv_len)
    if kv_len == 0:  # the kernels' convention: zeros
        assert not o.any()
        return
    assert rel_err(o, o64) <= F32_ATTN_REL
    # the port's plain version (fp32) computes the same function
    want = flash_prefix.prefix_attention_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v)), torch.tensor([kv_len]))[0]
    assert rel_err(want.numpy(), o64) <= 1e-6


def test_forward_with_one_tf32_product_misses_the_bound_at_d128():
    rng = _rng(147)
    q, k, v = (rng.standard_normal((128, 128)).astype(np.float32) for _ in range(3))
    o64, _ = attention_fp64(q, k, v, 100)
    assert rel_err(forward_tf32_d128(q, k, v, 100)[0], o64) <= F32_ATTN_REL
    assert rel_err(forward_tf32_d128(q, k, v, 100, one=True)[0], o64) > F32_ATTN_REL


# kernel 10's fp32 form at d = 128: the split 3xTF32 kernel's kLse epilogue
# (flash_prefix_tf32_d128.cu) on one block, full, ragged, around the 32-key
# tile's edge, one key and none
@pytest.mark.parametrize("n,kv_len", [(128, 128), (100, 77), (128, 31), (128, 32), (100, 33),
                                      (128, 1), (50, 0)])
def test_forward_lse_epilogue_holds_fp32_accuracy_at_d128(n, kv_len):
    rng = _rng(240 + n + kv_len)
    q, k, v = (rng.standard_normal((n, 128)).astype(np.float32) for _ in range(3))
    o, lse = forward_tf32_d128(q, k, v, kv_len)
    o64, lse64 = attention_fp64(q, k, v, kv_len)
    if kv_len == 0:  # the kernels' convention: zeros and lse 0
        assert not o.any() and not lse.any()
        return
    assert rel_err(lse, lse64) <= F32_ATTN_REL and rel_err(o, o64) <= F32_ATTN_REL
    # the port's plain version (fp32) computes the same lse
    want = flash_prefix.prefix_attention_lse_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v)), torch.tensor([kv_len]))[1][0]
    assert rel_err(want.numpy(), lse64) <= 1e-6


def test_forward_lse_form_with_one_tf32_product_misses_the_bound_at_d128():
    """The control of the lse form: with one TF32 product in place of three
    its o misses F32_ATTN_REL (4e-4 here). Its lse reads ~1e-5 too, about
    300x the split's, but an lse of ~7 (log2 of 100 keys plus the max)
    dilutes the scores' error: the o, not the lse, tells the two apart."""
    rng = _rng(247)
    q, k, v = (rng.standard_normal((128, 128)).astype(np.float32) for _ in range(3))
    o64, lse64 = attention_fp64(q, k, v, 100)
    o, lse = forward_tf32_d128(q, k, v, 100)
    o1, lse1 = forward_tf32_d128(q, k, v, 100, one=True)
    assert rel_err(o, o64) <= F32_ATTN_REL and rel_err(lse, lse64) <= F32_ATTN_REL
    assert rel_err(o1, o64) > F32_ATTN_REL
    assert rel_err(lse1, lse64) > 100 * rel_err(lse, lse64)


# --- kernels 11, 12 and 13 at d = 128 on fp32: csrc/flash_prefix_train_tf32_d128.cu ---

F32_GRAD_REL = 1e-4  # chip_smoke.py: the fp32 forms' gradients
DQ_KEYS128 = 32      # keys a K/V tile of the d = 128 dq kernel (kept)
DKV_KEYS128 = 64     # keys a d = 128 dkv block
DKV_QUERIES128 = 32  # queries a q/dO tile of the d = 128 dkv kernel
XLD = 40             # row stride of the dkv kernel's exchange tiles (words)
WARPS = np.arange(8)


def grads_fp64(q, k, v, do, kv_len):
    """Kernels 10-13's function in float64: the base-2 lse, D = rowsum(dO *
    o), dq, dk and dv (dS = P (dP - D), dq = dS.K / sqrt(d), dk = dS^T.q /
    sqrt(d), dv = P^T.dO); zeros, lse 0 and D 0 for kv_len 0."""
    n, d = q.shape
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    lse, dvec, dq, dk, dv = np.zeros(n), np.zeros(n), np.zeros((n, d)), np.zeros((n, d)), \
        np.zeros((n, d))
    if kv_len == 0:
        return lse, dvec, dq, dk, dv
    kl, vl = k[:kv_len], v[:kv_len]
    s = q @ kl.T / math.sqrt(d)
    m = s.max(1, keepdims=True)
    e = np.exp(s - m)
    l = e.sum(1, keepdims=True)
    p = e / l
    dvec = (do * (p @ vl)).sum(1)
    ds = p * (do @ vl.T - dvec[:, None])
    dq = ds @ kl / math.sqrt(d)
    dk[:kv_len] = ds.T @ q / math.sqrt(d)
    dv[:kv_len] = p.T @ do
    return (m + np.log(l))[:, 0] * LOG2E, dvec, dq, dk, dv


def _quad_lanes(x, op):
    """reduce over the four lanes of a quad, x [W, 32, ...] (warps, lanes)"""
    w = x.shape[0]
    return np.repeat(op(x.reshape(w, 8, 4, *x.shape[2:]), axis=2), 4, axis=1)


def _pad_rows(x, rows, start, n):
    """rows [start, start + rows) of x [n, 128] as a zero-filled fp32 tile"""
    out = np.zeros((rows, 128), np.float32)
    m = max(0, min(n, start + rows) - start)
    out[:m] = x[start:start + m]
    return out


def dq_tf32_d128(q, k, v, do, dvec, lse, kv_len, online=False, one=False):
    """flash_prefix_dq_tf32_d128_kernel<online> on one block of 128 queries (n
    <= 128), d = 128, the eight warps at once: q and dO unsplit (each warp's
    A fragments split as read: the same values as a split tile), 32-key K
    and V tiles split; S and dP (16 x 32 a warp) by t128_qk, masked, scaled,
    P = exp2(S - lse) and dS = P (dP - D) in fp32, dq += dS.K as t128_pv at
    columns 0 and 64 chained over the sweep under the card's truncating
    accumulation; online (12): the running max and sum per row, dq rescaled
    on each max update, divided by l and the lse written. Returns dq [n,
    128] and (online) lse [n] as the kernel stores them. one: a single TF32
    product in place of each split one (the control)."""
    n = q.shape[0]
    f32 = np.float32
    scale_log2, sm_scale = f32(LOG2E / math.sqrt(128)), f32(1 / math.sqrt(128))
    n_tiles = -(-kv_len // DQ_KEYS128)
    qp, op = _pad_rows(q, 128, 0, n), _pad_rows(do, 128, 0, n)
    _, g, tt = _lanes()
    row = (16 * WARPS[:, None] + g)[..., None] + 8 * np.arange(2)  # [W, 32, 2]
    live = row < n
    dr = np.where(live, np.pad(dvec, (0, 128 - n))[np.minimum(row, 127)], 0).astype(f32)
    lse_r = np.zeros((8, 32, 2), f32)
    if not online:
        lse_r = np.where(live, np.pad(lse, (0, 128 - n))[np.minimum(row, 127)], 0).astype(f32)
    m = np.full((8, 32, 2), -np.inf, f32)
    l = np.zeros((8, 32, 2), f32)
    acc = [np.zeros((8, 8, 32, 4)) for _ in range(2)]  # [half][nd][W, 32, 4]
    nt = DQ_KEYS128 // 8
    key_e = 8 * np.arange(nt)[:, None, None, None] + 2 * tt[None, None, :, None] + (
        np.arange(4) & 1)
    for jt in range(n_tiles):
        k0 = DQ_KEYS128 * jt
        kt, vt = _pad_rows(k, DQ_KEYS128, k0, n), _pad_rows(v, DQ_KEYS128, k0, n)
        s = mm_rows_3x(qp, kt, 16 * WARPS, one, ld=LD128).astype(f32)   # [j][W, 32, 4]
        dp = mm_rows_3x(op, vt, 16 * WARPS, one, ld=LD128).astype(f32)
        s = np.where(k0 + key_e < kv_len, s * scale_log2, f32(-np.inf)).astype(f32)
        if online:
            halves = s.reshape(nt, 8, 32, 2, 2)       # [j][W][lane][h][e & 1]
            m_new = np.maximum(m, _quad_lanes(halves.max(axis=(0, 4)), np.max)).astype(f32)
            alpha = np.exp2(m - m_new).astype(f32)
            m, lse_r = m_new, m_new
            l = (l * alpha).astype(f32)
            acc = [(a * np.repeat(alpha, 2, axis=-1)).astype(f32) for a in acc]
        p = np.exp2(s - np.repeat(lse_r, 2, axis=-1)).astype(f32)
        if online:
            ps = p.reshape(nt, 8, 32, 2, 2).sum(axis=(0, 4), dtype=f32)
            l = (l + _quad_lanes(ps, np.sum)).astype(f32)
        ds = (p * (dp - np.repeat(dr, 2, axis=-1))).astype(f32)
        acc = [mm_acc_3x(ds, kt, one, trunc=True, ld=LD128, col0=64 * half, acc=acc[half])
               for half in (0, 1)]
    if online:
        scale = np.where(l > 0, sm_scale / np.where(l > 0, l, 1), 0).astype(f32)
        lse_o = np.where(l > 0, m + np.log2(np.where(l > 0, l, 1)), 0).astype(f32)
    else:
        scale, lse_o = np.full((8, 32, 2), sm_scale, f32), np.zeros((8, 32, 2), f32)
    full = np.concatenate(acc, axis=0)  # [16 n-tiles][W, 32, 4]: columns 0-63, then 64-127
    dq, lse_rows = np.zeros((128, 128)), np.zeros(128)
    for w in range(8):
        dq[16 * w:16 * w + 16] = from_acc((full[:, w] * np.repeat(scale[w], 2, axis=-1))
                                          .astype(f32))
        for h in range(2):
            lse_rows[16 * w + g + 8 * h] = lse_o[w, :, h]
    return dq[:n], lse_rows[:n]


def dkv_tf32_d128(q, k, v, do, dvec, lse, kv_len, one=False):
    """flash_prefix_dkv_tf32_d128_kernel on every 64-key block of a head (n <=
    128), d = 128: K and V split, each 32-query tile of q and dO split with
    its lse (+inf past n) and D; the key groups' S^T (warps 0-3) and dP^T
    (warps 4-7) by t128_qk, 16 keys x 32 queries each, P^T = exp2(S^T
    scale_log2 - lse) for valid keys, dS^T = P^T (dP^T - D) (the exchange
    moves fp32 words: test_dkv_exchange_tiles_at_d128 holds its indices),
    then each warp's column half hf of dV += P^T.dO and dK += dS^T.q as
    t128_pv at columns 64 hf, chained over the query sweep under the card's
    truncating accumulation; dk scaled by sm_scale at the store. Returns dk,
    dv [n, 128] as the kernel stores them."""
    n = q.shape[0]
    f32 = np.float32
    scale_log2, sm_scale = f32(LOG2E / math.sqrt(128)), f32(1 / math.sqrt(128))
    _, g, tt = _lanes()
    kg = np.arange(4)
    q_e = 8 * np.arange(4)[:, None, None, None] + 2 * tt[None, None, :, None] + (np.arange(4) & 1)
    dk, dv = np.zeros((n, 128)), np.zeros((n, 128))
    for k0 in range(0, n, DKV_KEYS128):
        if k0 >= kv_len:  # the block writes zeros
            continue
        kb, vb = _pad_rows(k, DKV_KEYS128, k0, n), _pad_rows(v, DKV_KEYS128, k0, n)
        key = k0 + (16 * kg[:, None] + g)[..., None] + 8 * (np.arange(4) >> 1)  # [4, 32, 4]
        valid = key < kv_len
        dk_acc = [np.zeros((8, 4, 32, 4)) for _ in range(2)]  # [hf][nd][kg, 32, 4]
        dv_acc = [np.zeros((8, 4, 32, 4)) for _ in range(2)]
        for qb in range(0, n, DKV_QUERIES128):
            qt, ot = _pad_rows(q, DKV_QUERIES128, qb, n), _pad_rows(do, DKV_QUERIES128, qb, n)
            qi = qb + q_e
            lq = np.where(qi < n, np.pad(lse, (0, 160))[qi], np.inf).astype(f32)
            dq_ = np.where(qi < n, np.pad(dvec, (0, 160))[qi], 0).astype(f32)
            st = mm_rows_3x(kb, qt, 16 * kg, one, ld=LD128).astype(f32)   # [j][kg, 32, 4]
            dpt = mm_rows_3x(vb, ot, 16 * kg, one, ld=LD128).astype(f32)
            pt = np.where(valid, np.exp2((st * scale_log2).astype(f32) - lq), 0).astype(f32)
            dst = (pt * (dpt - dq_)).astype(f32)
            for hf in (0, 1):
                dv_acc[hf] = mm_acc_3x(pt, ot, one, trunc=True, ld=LD128, col0=64 * hf,
                                       acc=dv_acc[hf])
                dk_acc[hf] = mm_acc_3x(dst, qt, one, trunc=True, ld=LD128, col0=64 * hf,
                                       acc=dk_acc[hf])
        for j in kg:
            rows = slice(k0 + 16 * j, min(n, k0 + 16 * j + 16))
            m = rows.stop - rows.start
            if m <= 0:
                continue
            dka = np.concatenate([a[:, j] for a in dk_acc], axis=0)
            dva = np.concatenate([a[:, j] for a in dv_acc], axis=0)
            dk[rows] = from_acc((dka * sm_scale).astype(f32))[:m]
            dv[rows] = from_acc(dva.astype(f32))[:m]
    return dk, dv


def _bwd_inputs(n, kv_len, seed):
    rng = _rng(seed)
    q, k, v, do = (rng.standard_normal((n, 128)).astype(np.float32) for _ in range(4))
    lse, dvec, *want = grads_fp64(q, k, v, do, kv_len)
    return (q, k, v, do), lse.astype(np.float32), dvec.astype(np.float32), lse, want


def _held(got, want, bound, kv_len):
    """rel_err within bound; with one valid key, where dq and dk are
    identically zero (dS = P (dP - D) = 0) and both sides hold rounding
    noise, |got| <= 1e-5 (chip_smoke.py's compare, zero=True)"""
    if kv_len == 1:
        return float(np.abs(got).max()) <= 1e-5
    return rel_err(got, want) <= bound


# (n, kv_len): full, ragged, one key, none, and around the 32-key tile's edge
BWD128_CASES = [(128, 128), (100, 77), (65, 65), (128, 1), (50, 0), (127, 31), (128, 32),
                (100, 33)]


@pytest.mark.parametrize("n,kv_len", BWD128_CASES)
def test_dq_split_holds_fp32_accuracy_at_d128(n, kv_len):
    """Kernels 11 and 12 at d = 128 (the kept tiling) within F32_GRAD_REL of
    float64, 12's lse within F32_ATTN_REL; the port's plain version within
    1e-6 of float64."""
    (q, k, v, do), lse, dvec, lse64, (dq64, _, _) = _bwd_inputs(n, kv_len, 240 + n + kv_len)
    dq11, _ = dq_tf32_d128(q, k, v, do, dvec, lse, kv_len)
    dq12, lse12 = dq_tf32_d128(q, k, v, do, dvec, None, kv_len, online=True)
    if kv_len == 0:  # the kernels' convention: zeros, lse 0
        assert not dq11.any() and not dq12.any() and not lse12.any()
        return
    for got in (dq11, dq12):
        assert _held(got, dq64, F32_GRAD_REL, kv_len)
    assert rel_err(lse12, lse64) <= F32_ATTN_REL
    want = flash_prefix.flash_prefix_dq_lsein_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v, do, dvec, lse)), torch.tensor([kv_len]))[0]
    assert _held(want.numpy(), dq64, 1e-6, kv_len)


@pytest.mark.parametrize("n,kv_len", BWD128_CASES)
def test_dkv_split_holds_fp32_accuracy_at_d128(n, kv_len):
    """Kernel 13 at d = 128 (the kept tiling, the pairs' split by product)
    within F32_GRAD_REL of float64; the port's plain version within 1e-6."""
    (q, k, v, do), lse, dvec, _, (_, dk64, dv64) = _bwd_inputs(n, kv_len, 340 + n + kv_len)
    dk, dv = dkv_tf32_d128(q, k, v, do, dvec, lse, kv_len)
    if kv_len == 0:  # the kernels' convention: zeros
        assert not dk.any() and not dv.any()
        return
    assert _held(dk, dk64, F32_GRAD_REL, kv_len)
    assert rel_err(dv, dv64) <= F32_GRAD_REL
    dk_p, dv_p = flash_prefix.flash_prefix_dkv_reference(
        *(torch.from_numpy(x)[None] for x in (q, k, v, do, dvec, lse)), torch.tensor([kv_len]))
    assert _held(dk_p[0].numpy(), dk64, 1e-6, kv_len)
    assert rel_err(dv_p[0].numpy(), dv64) <= 1e-6


def test_backward_with_one_tf32_product_misses_the_bound_at_d128():
    (q, k, v, do), lse, dvec, _, (dq64, dk64, dv64) = _bwd_inputs(128, 100, 247)
    dq, _ = dq_tf32_d128(q, k, v, do, dvec, lse, 100, one=True)
    dk, dv = dkv_tf32_d128(q, k, v, do, dvec, lse, 100, one=True)
    for got, want in ((dq, dq64), (dk, dk64), (dv, dv64)):
        assert rel_err(got, want) > F32_GRAD_REL


def test_dkv_exchange_tiles_at_d128():
    """flash_prefix_dkv_tf32_d128_kernel's exchange: warp w (key group kg = w
    & 3, role hf = w >> 2) stores its 16 x 32 tile (S^T made P^T by hf 0,
    dP^T by hf 1) as float2 at tile hf, row 16 kg + g + 8 h, column 8 j + 2
    t; after the pair's barrier, its partner (w ^ 4) reads that tile back at
    the same places into the same accumulator slots [j][2 h + (e & 1)],
    which t128_pv takes as the A fragment in the order 2t, 2t + 1: every
    element of both tiles is written once, by the pair that reads it, and
    read once, by the other warp of the pair, as the element (key, query)
    it holds; the float2 stores and loads are conflict-free at the stride
    40 words."""
    writes = np.zeros((2, 64, 32), int)
    reads = np.zeros((2, 64, 32), int)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for w in range(8):
        kg, hf = w & 3, w >> 2
        for j in range(4):
            for h in range(2):
                word = (16 * kg + g + 8 * h) * XLD + 8 * j + 2 * t
                key, query = word // XLD, word % XLD
                assert (key == 16 * kg + g + 8 * h).all() and (query == 8 * j + 2 * t).all()
                np.add.at(writes[hf], (key, query), 1)
                np.add.at(writes[hf], (key, query + 1), 1)
                np.add.at(reads[1 - hf], (key, query), 1)  # the partner's tile, read by w
                np.add.at(reads[1 - hf], (key, query + 1), 1)
                for half in (slice(0, 16), slice(16, 32)):  # a half-warp's float2 access
                    banks = np.stack([word[half] % 32, (word[half] + 1) % 32]).ravel()
                    assert len(set(banks.tolist())) == 32
    assert (writes == 1).all() and (reads == 1).all()
    # the slot [j][2h + (e & 1)] holds (key g + 8h, query 8j + 2t + (e & 1)): the
    # accumulator layout of t128_qk, so t128_pv's a0 = [j][0], a1 = [j][2], a2 =
    # [j][1], a3 = [j][3] are (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
    x = np.arange(16 * 32, dtype=np.float64).reshape(16, 32)
    slots = np.stack([np.stack([x[g, 8 * j + 2 * t], x[g, 8 * j + 2 * t + 1],
                                x[g + 8, 8 * j + 2 * t], x[g + 8, 8 * j + 2 * t + 1]], -1)
                      for j in range(4)])
    np.testing.assert_array_equal(from_acc(slots), x)


def product_core(y, w, one=False):
    """gemm_f32.cuh:tf_consume on y [M, K] and w [N, K] fp32: hi and lo of
    both by cvt.rna; per 32-deep stage the four k8 steps' lo.hi and hi.lo
    products, then their hi.hi, each summed in fp32 into the stage's own
    accumulator, which is added to the tile's in fp32. one: hi.hi alone."""
    f32 = np.float32
    K = y.shape[1]
    pad = -(-K // 32) * 32 - K  # TMA's zero fill past K
    (ah, al), (bh, bl) = (tuple(t.astype(np.float64) for t in split_tf32(
        np.pad(x, ((0, 0), (0, pad))))) for x in (y, w))
    acc = np.zeros((y.shape[0], w.shape[0]), f32)
    for k0 in range(0, K + pad, 32):
        part = np.zeros_like(acc)
        steps = [slice(k0 + 8 * kk, k0 + 8 * kk + 8) for kk in range(4)]
        for sl in steps if not one else ():
            part = (part + al[:, sl] @ bh[:, sl].T).astype(f32)
            part = (part + ah[:, sl] @ bl[:, sl].T).astype(f32)
        for sl in steps:
            part = (part + ah[:, sl] @ bh[:, sl].T).astype(f32)
        acc = (acc + part).astype(f32)
    return acc


def ln_mod(h, sc, sh, eps=1e-6):
    """kernel 7's and B's operand, as tf_consume forms it from ln_stats_kernel's
    two-pass fp32 statistics"""
    f32 = np.float32
    mu = h.mean(1, dtype=f32, keepdims=True)
    rstd = (f32(1) / np.sqrt(((h - mu) ** 2).mean(1, dtype=f32, keepdims=True) + f32(eps)))
    return (((h - mu) * rstd).astype(f32) * (f32(1) + sc) + sh).astype(f32)


@pytest.mark.parametrize("form,K", [("ln_mod", 256), ("ln_mod", 96), ("gated", 512),
                                    ("gated", 80)])
def test_product_core_split_holds_fp32_accuracy(form, K):
    rng = _rng(50 + K)
    x = rng.standard_normal((64, K)).astype(np.float32)
    w = (rng.uniform(-1, 1, (128, K)) * K ** -0.5).astype(np.float32)
    if form == "ln_mod":
        sc, sh = (rng.uniform(-0.3, 0.3, K).astype(np.float32) for _ in range(2))
        x = ln_mod(x, sc, sh)
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    assert rel_err(product_core(x, w), exact) <= F32_ATTN_REL
    assert rel_err(product_core(x, w, one=True), exact) > F32_REL


def test_fp32_tma_box_is_the_mirrors_swizzled_tile():
    """probe_hopper.py's expectation for the fp32 box (32 fp32 a 128-byte
    row) and the mirror the layout tests below address lie the same way."""
    x = torch.arange(100 * 200, dtype=torch.float32).reshape(100, 200)
    for row, col in ((8, 32), (72, 184)):
        box = swizzled_box(x, row, col).numpy().reshape(-1)
        part = np.zeros((64, 32), np.float32)
        tile = x[row:row + 64, col:col + 32].numpy()
        part[:tile.shape[0], :tile.shape[1]] = tile
        np.testing.assert_array_equal(box, swizzle(part))


def test_tf32_smem_layout_gives_the_fragments_and_k_columns():
    rng = _rng(55)
    a = rng.integers(-1000, 1000, (128, 32)).astype(np.float32)
    w = rng.integers(-1000, 1000, (128, 32)).astype(np.float32)
    mem = swizzle(a)
    lane, g, t = _lanes()
    for warp in range(8):
        for kk in range(4):
            # tf_consume: swz_chunk_addr(tile_a, 16 warp + (lane & 15), 2 kk + (lane >> 4))
            rows = 16 * warp + (lane & 15)
            addr = rows * ROW_WORDS + (((2 * kk + (lane >> 4)) ^ (rows & 7)) << 2)
            frag = ldmatrix_x4(mem, addr)
            r0, c = 16 * warp + g, 8 * kk + t  # .tf32's A: (g, t) (g+8, t) (g, t+4) (g+8, t+4)
            want = np.stack([a[r0, c], a[r0 + 8, c], a[r0, c + 4], a[r0 + 8, c + 4]], 1)
            np.testing.assert_array_equal(frag, want)
    # the B descriptor of k8 step kk starts 32 * kk bytes into the tile; the
    # hardware swizzles the address bits 4-6 by bits 7-9 (rows of 128 bytes)
    wmem = swizzle(w)
    n, k = np.meshgrid(np.arange(128), np.arange(8), indexing="ij")
    for kk in range(4):
        addr = n * 128 + 32 * kk + 4 * k
        phys = addr ^ (((addr >> 7) & 7) << 4)
        np.testing.assert_array_equal(phys // 4, swz_word(n, 8 * kk + k))
        np.testing.assert_array_equal(wmem[phys // 4], w[:, 8 * kk:8 * kk + 8])
    # the splitter works element by element on the swizzled words: its hi and
    # lo tiles are the swizzled hi and lo of the weight
    wf = rng.standard_normal((128, 32)).astype(np.float32)
    for got, want in zip(split_tf32(swizzle(wf)), split_tf32(wf)):
        np.testing.assert_array_equal(got, swizzle(want))
    assert np.all(tf32_rna(wf).view(np.uint32) & 0x1FFF == 0)


@pytest.mark.parametrize("rows", [64, 128])
def test_head_rows_store_every_column_once(rows):
    """attn_tf32.cuh:head_load / head_split: thread tid's item it is row
    (tid + 256 it) / 8, columns c .. c + 3 and c + 32 .. c + 35 with c = 4 *
    (tid % 8) (a rotation pair), stored at row * 68 + c and + 32."""
    seen = np.zeros((rows, 64), int)
    for tid in range(256):
        for it in range(rows // 32):
            i = tid + 256 * it
            row, c = i >> 3, (i & 7) * 4
            at = (i >> 3) * LD + (i & 7) * 4
            for half in (0, 32):
                for e in range(4):
                    assert at + half + e == row * LD + c + half + e
                    seen[row, c + half + e] += 1
    assert (seen == 1).all()
    assert math.gcd(LD, 32) == 4  # the 68-word stride the fragment reads rely on


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("rot", [False, True])
def test_head_rows_store_every_column_once_at_d128(rows, rot):
    """flash_prefix_tf32_d128.cu:t128_load / t128_split (32-row K and V tiles,
    q in 64-row halves): thread tid's item it is row (tid + 256 it) / 16,
    columns c .. c + 3 and c + 64 .. c + 67 with c = 4 ((tid + 256 it) %
    16), stored at row * 132 + c and + 64; with the rotation, each item holds
    both partners of its pairs (c + e, c + 64 + e) and the tables' column c
    + e < 64 of its row."""
    seen = np.zeros((rows, 128), int)
    for tid in range(256):
        for it in range(rows // 16):
            i = tid + 256 * it
            row, c = i >> 4, (i & 15) * 4
            at = (i >> 4) * LD128 + (i & 15) * 4
            for e in range(4):
                if rot:  # rotate_pair(x[c + e], x[c + 64 + e], cos[row, c + e], sin[row, c + e])
                    assert c + e < 64 and (c + e) + 64 == c + 64 + e
                for half in (0, 64):
                    assert at + half + e == row * LD128 + c + half + e
                    seen[row, c + half + e] += 1
    assert (seen == 1).all()
    assert math.gcd(LD128, 32) == 4  # the 132-word stride: ldmatrix and P.V reads conflict-free
    # t128_pv's scalar B reads: lane (g, t) at (8 ks + 2 t) * 132 + col0 + g + 8 nd
    lane = np.arange(32)
    for col0 in (0, 64):
        banks = ((2 * (lane & 3)) * LD128 + col0 + (lane >> 2)) % 32
        assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1280, 1537])
def test_d128_core_lse_epilogue_writes_every_row_once(n):
    """attn_wgmma.cuh:attn_fwd_d128_wgmma_kernel<true, false> (kernel 10 at d
    = 128 in bf16): blocks of 128 rows (q0 = 128 x), the two consumer
    warpgroups' threads 0-255 (the producer warpgroup's writes nothing):
    warpgroup wg = warp / 4, row = 16 (warp % 4) + lane / 4, and each row r
    of the pair writes lse[q0 + 64 wg + row + 8 r] from the quad's thread t
    = lane % 4 == 0 when it is < n: each row in [0, n) exactly once."""
    count = np.zeros(n, int)
    for bx in range(-(-n // 128)):
        q0 = 128 * bx
        for tid in range(256):
            warp, lane = tid >> 5, tid & 31
            wg, g8, t = warp >> 2, lane >> 2, lane & 3
            row = (warp & 3) * 16 + g8
            for r in (0, 1):
                grow = q0 + wg * 64 + row + 8 * r
                if t == 0 and grow < n:
                    count[grow] += 1
    assert (count == 1).all()


# --- kernel C's fp32 form: csrc/grouped_conv.cu:grouped_conv_tf32_kernel ---------

LDW = 72  # the kernel's weight tile row stride (words)


def mish_f32(x):
    """grouped_conv.cu:mish in fp32: softplus as logaddexp(x, 0)"""
    x = np.asarray(x, np.float32)
    sp = (np.maximum(x, np.float32(0)) + np.log1p(np.exp(-np.abs(x)))).astype(np.float32)
    return (x * np.tanh(sp)).astype(np.float32)


def conv_fp64(x, w, b, fuse_mish):
    """kernel C's function in float64 on one group: x [N, 64], w [k, 64,
    64] (w[t, i, o]), b [64] or None, SAME padding"""
    N, taps = x.shape[0], w.shape[0]
    xp = np.pad(x.astype(np.float64), ((taps // 2, taps // 2), (0, 0)))
    y = sum(xp[t:t + N] @ w[t].astype(np.float64) for t in range(taps))
    if b is not None:
        y = y + b
    return y * np.tanh(np.logaddexp(y, 0.0)) if fuse_mish else y


def conv_tf32(x, w, b, fuse_mish, one=False, chain=False):
    """grouped_conv_tf32_kernel on one item and one group of 64 channels, N
    <= 128 (one block): the window [128 + k - 1][68] split once into hi and
    lo tiles, zeros outside [0, N); tap t's weights split into [64][72] hi
    and lo tiles; warp w's 32 rows x 32 channels (rows 32 (w / 2), channels
    32 (w % 2)) with A by ldmatrix at row offset t and B as scalar words
    (rows t and t + 4 of a k8 step, column g); per k8 step three TF32
    products under the card's truncating accumulation, into the tap's own
    accumulator, which is added to the running sum in fp32; bias and Mish in
    fp32. one: hi.hi alone (the control); chain: every tap's products in
    the one running accumulator, a 744-deep chain."""
    f32 = np.float32
    N, taps = x.shape[0], w.shape[0]
    rows = 128 + taps - 1
    win = np.zeros((rows, 64), f32)
    pos = np.arange(rows) - taps // 2
    inside = (pos >= 0) & (pos < N)
    win[inside] = x[pos[inside]]
    win_h, win_l = (_tile(t) for t in split_tf32(win))
    wtiles = []
    for t in range(taps):
        pair = []
        for part in split_tf32(w[t]):
            tile = np.zeros((64, LDW))
            tile[:, :64] = part
            pair.append(tile.reshape(-1))
        wtiles.append(pair)
    _, g, tq = _lanes()
    out = np.full((N, 64), np.nan)
    for warp in range(8):
        r0, cb = (warp >> 1) * 32, (warp & 1) * 32
        if r0 >= N:
            continue
        acc = np.zeros((2, 4, 32, 4))
        for t in range(taps):
            bh_t, bl_t = wtiles[t]
            part = acc if chain else np.zeros((2, 4, 32, 4))
            for ks in range(8):
                ah = [ldmatrix_x4(win_h, lda_addr(r0 + 16 * mt + t, ks * 8)) for mt in (0, 1)]
                al = [ldmatrix_x4(win_l, lda_addr(r0 + 16 * mt + t, ks * 8)) for mt in (0, 1)]
                for nt in range(4):
                    at = (ks * 8 + tq) * LDW + cb + 8 * nt + g
                    bh = np.stack([bh_t[at], bh_t[at + 4 * LDW]], 1)
                    bl = np.stack([bl_t[at], bl_t[at + 4 * LDW]], 1)
                    for mt in (0, 1):
                        part[mt, nt] = mma_3x(ah[mt], al[mt], bh, bl, part[mt, nt], one,
                                              trunc=True)
            acc = part if chain else (acc + part).astype(f32).astype(np.float64)
        for mt in (0, 1):
            for nt in range(4):
                for h in (0, 1):
                    row = r0 + 16 * mt + g + 8 * h
                    for e in (0, 1):
                        col = cb + 8 * nt + 2 * tq + e
                        keep = row < N
                        val = acc[mt, nt][:, 2 * h + e].astype(f32)
                        if b is not None:
                            val = (val + b[col]).astype(f32)
                        out[row[keep], col[keep]] = (mish_f32(val) if fuse_mish else val)[keep]
    return out


def _conv_inputs(rng, N, taps=31, bias=True):
    x = rng.standard_normal((N, 64)).astype(np.float32)
    w = (rng.uniform(-1, 1, (taps, 64, 64)) * (64 * taps) ** -0.5).astype(np.float32)
    b = (rng.uniform(-1, 1, 64) * (64 * taps) ** -0.5).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("N,bias,fuse_mish", [(64, True, True), (37, False, False),
                                              (1, True, False)])
def test_conv_tap_loop_holds_fp32_accuracy(N, bias, fuse_mish):
    """Kernel C's fp32 form at the fragment level (B 1, one group, k 31)
    against float64 within 1e-5 (the card's bound is 1e-4), rows past N
    never written; the port's plain version computes the same function."""
    rng = _rng(60 + N)
    x, w, b = _conv_inputs(rng, N, bias=bias)
    got = conv_tf32(x, w, b, fuse_mish)
    want = conv_fp64(x, w, b, fuse_mish)
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= F32_ATTN_REL
    plain = grouped_conv.grouped_conv1d_mish_reference(
        torch.from_numpy(x)[None], torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        groups=1, fuse_mish=fuse_mish)[0]
    assert rel_err(plain.numpy(), want) <= 1e-6


def test_conv_one_tf32_product_or_one_chain_reads_worse():
    """The per-tap accumulator is what keeps the 3xTF32 conv at ~1e-7 under
    truncating accumulation: one chain over all 31 taps (744 products deep)
    reads visibly worse, and a single TF32 product misses the fp32 bound."""
    rng = _rng(70)
    x, w, b = _conv_inputs(rng, 64)
    want = conv_fp64(x, w, b, False)
    per_tap = rel_err(conv_tf32(x, w, b, False), want)
    chained = rel_err(conv_tf32(x, w, b, False, chain=True), want)
    one = rel_err(conv_tf32(x, w, b, False, one=True), want)
    assert per_tap <= F32_ATTN_REL
    assert chained > 3 * per_tap
    assert one > F32_REL


# --- kernel 14's fp32 "qk" form: csrc/flash_prefix_int8_f32.cu --------------------

LD8 = 80  # bytes between the rows of the kernel's int8 K tile


def scores_i8(q8, k8, warp):
    """flash_prefix_i8_qk_tf32_kernel's S for warp `warp` of a block: q8
    [128, 64] int8 (the block's rows), k8 [64, 64] int8 (one key tile). The
    A fragments are 32-bit words of q8's rows (q8_word: bytes ks * 32 + 4t
    and + 16), the B fragments ldmatrix_x4 at i8_b_nk_addr on the [64][80
    bytes] tile; mma.m16n8k32 .s32.s8.s8. Returns [8][32, 4] int64 in the
    accumulator layout."""
    lane, g, t = _lanes()
    qw = np.ascontiguousarray(q8).view(np.uint32)  # [128, 16] words
    r = 16 * warp + g
    qa = [np.stack([qw[r, ks * 8 + t], qw[r + 8, ks * 8 + t], qw[r, ks * 8 + 4 + t],
                    qw[r + 8, ks * 8 + 4 + t]], 1) for ks in (0, 1)]
    tile = np.zeros((64, LD8), np.int8)
    tile[:, :64] = k8
    mem = tile.reshape(-1).view(np.uint32)
    acc = np.zeros((8, 32, 4), np.int64)
    for ks in (0, 1):
        for np_ in range(4):
            addr = ((np_ * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD8 + ks * 32
                    + ((lane >> 3) & 1) * 16)
            b = ldmatrix_x4(mem, addr // 4)
            acc[2 * np_] = mma_16832_s8(qa[ks], b[:, 0:2], acc[2 * np_])
            acc[2 * np_ + 1] = mma_16832_s8(qa[ks], b[:, 2:4], acc[2 * np_ + 1])
    return acc


@pytest.mark.parametrize("draw", ["+-127", "127", "uniform"])
def test_int8_scores_are_the_integer_product(draw):
    """S on the int8 tensor cores equals q8 . k8^T to the bit, every
    operand at +-127 included (|s| up to 127^2 * 64), in the .tf32
    accumulator's (g, 2t) layout that the softmax and P.V read."""
    rng = _rng(80)
    if draw == "uniform":
        q8, k8 = (rng.integers(-127, 128, (r, 64)).astype(np.int8) for r in (128, 64))
    elif draw == "127":
        q8, k8 = np.full((128, 64), 127, np.int8), np.full((64, 64), 127, np.int8)
    else:
        q8, k8 = (rng.choice(np.array([-127, 127], np.int8), (r, 64)) for r in (128, 64))
    want = q8.astype(np.int64) @ k8.astype(np.int64).T
    for warp in range(8):
        np.testing.assert_array_equal(from_acc(scores_i8(q8, k8, warp)),
                                      want[16 * warp:16 * warp + 16])


def forward_i8_qk(q8, k8, v, c, kv_len, one=False):
    """flash_prefix_i8_qk_tf32_kernel on one block (n <= 128): S by
    scores_i8 per 64-key tile, float(S) * c masked at kv_len, the online
    softmax of kernel A's fp32 form, P from that accumulator fed to mm_acc
    with its columns in the order 2t, 2t + 1, each tile's P.V under
    truncating accumulation in an accumulator of its own. one: a single
    TF32 product for P.V (the control)."""
    n = q8.shape[0]
    f32 = np.float32
    n_tiles = -(-kv_len // 64)
    qp = np.zeros((128, 64), np.int8)
    qp[:n] = q8
    kp, vp = np.zeros((64 * max(n_tiles, 1), 64), np.int8), np.zeros((64 * max(n_tiles, 1), 64), f32)
    kp[:min(n, len(kp))], vp[:min(n, len(vp))] = k8[:len(kp)], v[:len(vp)]
    _, g, tt = _lanes()
    o_rows = np.zeros((128, 64))
    for w in range(8):
        o = np.zeros((8, 32, 4), f32)
        m = np.full((32, 2), -np.inf, f32)
        l = np.zeros((32, 2), f32)
        for jt in range(n_tiles):
            k0 = 64 * jt
            s = (scores_i8(qp, kp[k0:k0 + 64], w).astype(f32) * f32(c)).astype(f32)
            key = k0 + 8 * np.arange(8)[:, None, None] + 2 * tt[None, :, None] + (
                np.arange(4) & 1)[None, None, :]
            s = np.where(key < kv_len, s, f32(-np.inf)).astype(f32)
            halves = s.reshape(8, 32, 2, 2)
            m_new = np.maximum(m, _quad(halves.max(axis=(0, 3)), np.max)).astype(f32)
            alpha = np.exp2(m - m_new).astype(f32)
            p = np.exp2(halves - m_new[None, :, :, None]).astype(f32)
            l = (l * alpha + _quad(p.sum(axis=(0, 3), dtype=f32), np.sum)).astype(f32)
            m = m_new
            pv = mm_acc_3x(p.reshape(8, 32, 4), vp[k0:k0 + 64], one, trunc=True)
            o = (o * np.repeat(alpha, 2, axis=1)[None] + pv).astype(f32)
        inv = np.where(l > 0, f32(1) / np.where(l > 0, l, 1), 0).astype(f32)
        o_rows[16 * w:16 * w + 16] = from_acc(o * np.repeat(inv, 2, axis=1)[None])
    return o_rows[:n]


def i8_qk_fp64(q8, k8, v, c, kv_len):
    """kernel 14's "qk" function in float64: softmax2(float(q8 . k8^T) c)
    over keys [0, kv_len) times v; zeros for kv_len 0"""
    if kv_len == 0:
        return np.zeros((q8.shape[0], 64))
    s = (q8.astype(np.float64) @ k8[:kv_len].astype(np.float64).T) * c
    p = np.exp2(s - s.max(1, keepdims=True))
    return (p @ v[:kv_len].astype(np.float64)) / p.sum(1, keepdims=True)


@pytest.mark.parametrize("n,kv_len,past", [(128, 128, False), (100, 77, True), (65, 65, False),
                                           (128, 1, True), (50, 0, False)])
def test_int8_qk_forward_holds_fp32_accuracy(n, kv_len, past):
    """Kernel 14's fp32 "qk" form on one block against float64 and against
    the port's plain version (ops/flash_prefix.py:_i8_attention_plain at its
    512-key chunk) within the fp32 attention bound 1e-5; +-1e4 in V rows
    past kv_len never reaches o; kv_len 0 gives zeros."""
    rng = _rng(90 + n + kv_len)
    q8, k8 = (rng.integers(-127, 128, (n, 64)).astype(np.int8) for _ in range(2))
    v = rng.standard_normal((n, 64)).astype(np.float32)
    if past:
        v[kv_len:] = 1e4 * np.sign(rng.standard_normal((n - kv_len, 64)))
    c = np.float32(1.0 / 127.0 ** 2 * LOG2E / 8.0 * 3.5 ** 2)  # q, k amax 3.5
    got = forward_i8_qk(q8, k8, v, c, kv_len)
    if kv_len == 0:
        assert not got.any()
        return
    assert rel_err(got, i8_qk_fp64(q8, k8, v, c, kv_len)) <= F32_ATTN_REL
    t8 = [torch.from_numpy(a)[None] for a in (q8, k8, v)]
    plain = flash_prefix._i8_attention_plain(
        *t8, torch.tensor([c]), torch.zeros(1), torch.tensor([kv_len], dtype=torch.int32),
        False, flash_prefix.I8_KEY_CHUNK)[0]
    assert rel_err(got, plain.numpy()) <= F32_ATTN_REL


def test_int8_qk_forward_with_one_tf32_pv_misses_the_bound():
    rng = _rng(99)
    q8, k8 = (rng.integers(-127, 128, (128, 64)).astype(np.int8) for _ in range(2))
    v = rng.standard_normal((128, 64)).astype(np.float32)
    c = np.float32(1.0 / 127.0 ** 2 * LOG2E / 8.0 * 3.5 ** 2)
    want = i8_qk_fp64(q8, k8, v, c, 100)
    assert rel_err(forward_i8_qk(q8, k8, v, c, 100), want) <= F32_ATTN_REL
    assert rel_err(forward_i8_qk(q8, k8, v, c, 100, one=True), want) > F32_ATTN_REL

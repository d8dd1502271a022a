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
  one TF32 product in place of the three misses that bound;
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
  head_split) stores every column of a row once.
"""

import math

import numpy as np
import pytest
import torch

from _tf32_mirror import (
    LD,
    ROW_WORDS,
    _lanes,
    from_acc,
    ldmatrix_x4,
    mm_acc_3x,
    mm_rows_3x,
    split_tf32,
    swizzle,
    swz_word,
    tf32_rna,
)
from korean_f5_tts_tpu_torch.ops import flash_prefix
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
    """Kernel A's / 10's function in float64: o [n, 64] and the base-2 lse of
    the scores scaled by 1 / sqrt(64); zeros and lse 0 for kv_len 0."""
    n = q.shape[0]
    if kv_len == 0:
        return np.zeros((n, 64)), np.zeros(n)
    s = (q.astype(np.float64) @ k[:kv_len].astype(np.float64).T) / 8.0
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

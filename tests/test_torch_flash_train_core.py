"""The references that kernels 10 (forward + lse, on the attention core), 11
(dq from the lse) and 13 (dk and dv, both on the attention backward core)
are held to on the card, against the JAX package's Pallas kernels in
interpret mode on the CPU.

The plain versions (flash_prefix_folded_lse and flash_prefix_dkv on CPU
tensors) meet the JAX kernels at the edges the Hopper tiles introduce:
kernel 10 takes 192 query rows a block and 128-key tiles, kernel 11 128
query rows a block and 128-key tiles, kernel 13 128 keys a block and 64-query
tiles. So n is 100, 200 or 301 (for 11 also 64 and 129) and kv_len 1, 63, 64, 65,
127, 128, 129 or n (those <= n), 2-4 folded heads a case and one head of
each case at kv_len n. At n = 301 a row of the [H, n] fp32 lse and D starts
at no 16-byte boundary (1,204 bytes a head): the backward core stages those
rows with plain loads, not a TMA map.

Padding the JAX side. Its kernels take n in multiples of 128, so their
inputs are zero-padded to the next multiple. For kernel 10 the padded keys
lie past every kv_len and are masked, so its first n rows are the function at
n. For kernel 13, q, dO, lse and D are padded with zeros: a padded query then
has P = 1 on the valid keys but dO = 0 and D = 0, so it adds nothing to dk or
dv, and the first n rows are the function at n. For kernel 11 the padded
queries get lse 0 and D 0 and their rows are dropped; the padded keys lie
past every kv_len.

Tolerances, as tests/test_torch_flash_bwd.py: fp32 1e-5 for o and lse, 1e-4
absolute and relative for the gradients (summation order; the scale meets
the scores at another point); bf16 inputs 4 bf16 ulps at the output's scale
(2**-6 * max|want|: the JAX kernels round P and dS to bf16 before their
products and the outputs to bf16, the plain versions keep fp32 to the end),
lse 1e-2 absolute and relative.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_port_util import t
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

D = 64
SCALE = 1.0 / math.sqrt(D)

# (n, kv_lens): every kv_len of the list at each n, one head at n in each case
EDGE_CASES = [
    (100, [1, 63, 64, 100]),
    (100, [65, 100]),
    (200, [1, 63, 64, 200]),
    (200, [65, 127, 128, 200]),
    (200, [129, 200]),
    (301, [1, 63, 64, 301]),
    (301, [65, 127, 128, 301]),
    (301, [129, 301]),
]
# no case is heavy (the slowest, n = 301 padded to 384 rows, takes ~1 s on
# one CPU core; the file ~20 s with its imports), so none is marked slow
CASES = [pytest.param(n, lens, dtype, id=f"n{n}-kv{'_'.join(map(str, lens))}-{dtype}")
         for n, lens in EDGE_CASES for dtype in ("float32", "bfloat16")]


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def _inputs(n, lens, dtype):
    """q, k, v, dO [H, n, 64] in `dtype` (seeded numpy, rounded once), the
    same as JAX arrays zero-padded to a multiple of 128 rows, and kv_lens."""
    rng = np.random.default_rng(1000 * n + len(lens))
    x = [rng.standard_normal((len(lens), n, D)).astype(np.float32) for _ in range(4)]
    n_pad = -(-n // 128) * 128
    jx = [jnp.asarray(np.pad(a, ((0, 0), (0, n_pad - n), (0, 0)))).astype(dtype) for a in x]
    tx = [t(np.asarray(a.astype(jnp.float32))[:, :n]).to(getattr(torch, dtype)) for a in jx]
    return tx, jx, np.asarray(lens, np.int32)


def _close(got, want, dtype, fp32_tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=fp32_tol, rtol=fp32_tol)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)


def _jax_forward(jx, lens):
    """The JAX kernel 10 on the padded inputs: (o, lse [H, n_pad, 1])."""
    q, k, v, _ = jx
    return jfp._flash_prefix_folded_lse(q, k, v, jnp.asarray(lens), SCALE, bq=128, ck=128,
                                        prune=False)


@pytest.mark.parametrize("n,lens,dtype", CASES)
def test_kernel_10_reference_at_the_core_tile_edges(n, lens, dtype):
    (tq, tk, tv, _), jx, lens_np = _inputs(n, lens, dtype)
    o_j, lse_j = _jax_forward(jx, lens_np)
    o_p, lse_p = fp.flash_prefix_folded_lse(tq, tk, tv, t(lens_np))
    _close(o_p.float().numpy(), o_j.astype(jnp.float32)[:, :n], dtype, 1e-5)
    lse_tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[:, :n, 0], atol=lse_tol,
                               rtol=lse_tol)


@pytest.mark.parametrize("n,lens,dtype", CASES)
def test_kernel_13_reference_at_the_backward_core_tile_edges(n, lens, dtype):
    (tq, tk, tv, tdo), jx, lens_np = _inputs(n, lens, dtype)
    q, k, v, do = jx
    o_j, lse_j = _jax_forward(jx, lens_np)
    # both sides take D and lse from the same numbers (the JAX ones); the JAX
    # side's padded queries get lse 0 and D 0 (and dO 0)
    rows = np.arange(q.shape[1]) < n
    dvec = np.asarray(jnp.sum(do.astype(jnp.float32) * o_j.astype(jnp.float32), axis=-1))
    lse = np.asarray(lse_j)[..., 0]
    dvec, lse = (np.where(rows, a, 0.0).astype(np.float32) for a in (dvec, lse))
    dk_j, dv_j = jfp._flash_prefix_dkv(q, k, v, do, jnp.asarray(dvec[:, None, :]),
                                       jnp.asarray(lse[:, None, :]), jnp.asarray(lens_np),
                                       SCALE, bkv=128, cq=128, cast=True)
    dk_p, dv_p = fp.flash_prefix_dkv(tq, tk, tv, tdo, t(dvec[:, :n]), t(lse[:, :n]),
                                     t(lens_np))
    _close(dk_p.float().numpy(), np.asarray(dk_j.astype(jnp.float32))[:, :n], dtype, 1e-4)
    _close(dv_p.float().numpy(), np.asarray(dv_j.astype(jnp.float32))[:, :n], dtype, 1e-4)
    # keys at or past kv_len get no gradient on either side
    dk_j, dv_j = np.asarray(dk_j.astype(jnp.float32)), np.asarray(dv_j.astype(jnp.float32))
    for h, length in enumerate(lens):
        assert not dk_p[h, length:].any() and not dv_p[h, length:].any()
        assert not dk_j[h, length:n].any() and not dv_j[h, length:n].any()


# kernel 11's core besides CASES: a single query block that ends at its 64th
# row, and one whose last key tile holds a single key
DQ_CASES = CASES + [pytest.param(n, lens, dtype, id=f"n{n}-kv{'_'.join(map(str, lens))}-{dtype}")
                    for n, lens in ((64, [1, 63, 64]), (129, [1, 128, 129]))
                    for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("n,lens,dtype", DQ_CASES)
def test_kernel_11_reference_at_the_dq_core_tile_edges(n, lens, dtype):
    (tq, tk, tv, tdo), jx, lens_np = _inputs(n, lens, dtype)
    q, k, v, do = jx
    o_j, lse_j = _jax_forward(jx, lens_np)
    rows = np.arange(q.shape[1]) < n
    dvec = np.asarray(jnp.sum(do.astype(jnp.float32) * o_j.astype(jnp.float32), axis=-1))
    lse = np.asarray(lse_j)[..., 0]
    dvec, lse = (np.where(rows, a, 0.0).astype(np.float32) for a in (dvec, lse))
    dq_j = jfp._flash_prefix_dq_lsein(q, k, v, do, jnp.asarray(dvec[..., None]),
                                      jnp.asarray(lse[..., None]), jnp.asarray(lens_np), SCALE,
                                      bq=128, ck=128, cast=True)
    dq_p = fp.flash_prefix_dq_lsein(tq, tk, tv, tdo, t(dvec[:, :n]), t(lse[:, :n]), t(lens_np))
    assert dq_p.dtype == tq.dtype
    _close(dq_p.float().numpy(), np.asarray(dq_j.astype(jnp.float32))[:, :n], dtype, 1e-4)


def kernel12_schedule(q, k, v, do, dvec, kv_lens, after_product: bool = True):
    """Kernel 12 (attn_bwd_wgmma.cuh, attn_dq_wgmma_kernel<true>) in torch,
    head by head: ceil(kv_len / 128) key tiles of 128 (rows past n zero, as
    TMA fills them); per tile x = S * scale_log2 with keys at or past kv_len
    at -inf, m_new = max(m, row max), alpha = exp2(m - m_new), p = exp2(x -
    m_new), l = alpha l + rowsum(p), dS = p (dP - D) rounded to bf16. The
    product dS.K of tile i - 1 is in flight while tile i's alpha is found:
    the kernel adds it first and rescales after (after_product); the other
    order is the race the kernel avoids. At the end dq * 1/sqrt(64) / l (l
    = 0 read as 1), lse = m + log2(l) (0 without a valid key). fp32 [H, n,
    64] in (values of the card's bf16 operands), (dq, lse) out."""
    H, n, d = q.shape
    scale_log2 = jfp.LOG2E * SCALE
    dq, lse = torch.zeros((H, n, d)), torch.zeros((H, n))
    for h in range(H):
        kv_len = min(int(kv_lens[h]), n)
        n_tiles = -(-kv_len // 128)
        pad = (0, 0, 0, n_tiles * 128 - n) if n_tiles * 128 > n else (0, 0, 0, 0)
        kh, vh = (torch.nn.functional.pad(x[h], pad) for x in (k, v))
        m, l = torch.full((n,), -math.inf), torch.zeros(n)
        acc, pending = torch.zeros((n, d)), None
        for i in range(n_tiles):
            kt, vt = kh[i * 128:(i + 1) * 128], vh[i * 128:(i + 1) * 128]
            x = (q[h] @ kt.T) * scale_log2
            x = x.masked_fill(torch.arange(i * 128, (i + 1) * 128)[None, :] >= kv_len, -math.inf)
            m_new = torch.maximum(m, x.amax(dim=-1))  # finite: the tile holds a valid key
            alpha = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(x - m[:, None])
            l = l * alpha + p.sum(dim=-1)
            ds = (p * (do[h] @ vt.T - dvec[h][:, None])).to(torch.bfloat16).float()
            if after_product:
                acc = (acc if pending is None else acc + pending) * alpha[:, None]
            else:
                acc = acc * alpha[:, None] + (0 if pending is None else pending)
            pending = ds @ kt
        if pending is not None:
            acc = acc + pending
        dq[h] = acc * torch.where(l > 0, 1.0 / l, torch.ones_like(l))[:, None] * SCALE
        lse[h] = torch.where(l > 0, m + torch.log2(l), torch.zeros_like(l))
    return dq, lse


# (n, kv_lens, keys past kv_len at +-1e4): n 1 (dq identically zero), kv_len
# 0, the 128-key tiles' edges, two JAX chunks of 512 at n 640
DQ12_CASES = [(1, [1], False), (300, [300, 0, 129, 128, 1], False), (300, [300, 200, 129], True),
              (640, [640, 600, 512, 513], False), (640, [600, 257], True)]


@pytest.mark.parametrize("n,lens,past", DQ12_CASES,
                         ids=[f"n{n}-kv{'_'.join(map(str, lens))}{'-past' if p else ''}"
                              for n, lens, p in DQ12_CASES])
def test_kernel_12_schedule_against_the_tpu_kernel_at_its_default_chunk(n, lens, past):
    """The recomputing dq sweep on the dq core's 128-key tiles against
    _kernel_dq at its default chunk (512; the JAX side zero-padded to a
    multiple of 128 rows, fp32 operands of bf16 values): dq within 1e-2 and
    lse within 1e-5 (relative L2). The TPU kernel keeps its max per chunk,
    the mirror per tile: p is in [0, 1] either way, and the rounding that
    sees the max, bf16(dS), is relative. A head with kv_len 0 is held to the
    port's convention (zero dq, lse 0; the TPU kernel, whose mask is finite,
    averages every key there); at n 1 dq is identically zero (dS = P (dP -
    D) = 0 for the one key) and is held to |dq| <= 1e-5, as on the card."""
    H = len(lens)
    rng = np.random.default_rng(7 * n + H)
    x = [rng.standard_normal((H, n, D)).astype(np.float32) for _ in range(4)]
    if past:  # keys past kv_len along q's mean direction: they would win every max
        for h, length in enumerate(lens):
            x[1][h, length:] = 1e4 * np.sign(x[0][h].mean(0))
    q, k, v, do = (t(a).to(torch.bfloat16).float() for a in x)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    o = fp.prefix_attention_reference(q, k, v, lens_t)
    dvec = (do * o).sum(-1)
    dq, lse = kernel12_schedule(q, k, v, do, dvec, lens_t)
    n_pad = -(-n // 128) * 128
    jq, jk, jv, jdo = (jnp.asarray(np.pad(a.numpy(), ((0, 0), (0, n_pad - n), (0, 0))))
                       for a in (q, k, v, do))
    jd = jnp.asarray(np.pad(dvec.numpy(), ((0, 0), (0, n_pad - n)))[..., None])
    dq_j, lse_j = jfp._flash_prefix_dq(jq, jk, jv, jdo, jd, jnp.asarray(lens), SCALE, bq=128)
    dq_j, lse_j = np.asarray(dq_j)[:, :n], np.asarray(lse_j)[:, :n, 0]
    live = np.asarray(lens) > 0
    assert not dq[~live].any() and not lse[~live].any()
    assert np.abs(lse[live].numpy() - lse_j[live]).max() <= 1e-5 * np.abs(lse_j[live]).max()
    assert np.linalg.norm(lse[live].numpy() - lse_j[live]) <= 1e-5 * np.linalg.norm(lse_j[live])
    if n == 1:
        assert dq.abs().max().item() <= 1e-5
        return
    err = np.linalg.norm(dq[live].numpy() - dq_j[live]) / np.linalg.norm(dq_j[live])
    assert err <= 1e-2, err
    # the rescale before tile i - 1's product has landed misses it (0.2-0.5)
    bad, _ = kernel12_schedule(q, k, v, do, dvec, lens_t, after_product=False)
    err_bad = np.linalg.norm(bad[live].numpy() - dq_j[live]) / np.linalg.norm(dq_j[live])
    assert err_bad > 1e-2, err_bad

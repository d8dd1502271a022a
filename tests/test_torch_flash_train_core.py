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

"""The training attention of the port (kernels 10-13 and the autograd
Function, on the CPU their plain versions) against the JAX package's Pallas
kernels in interpret mode and jax.vjp of its flash_prefix_attention.

Seeded numpy inputs, 4 folded heads of n = 256, d = 64, mixed kv_lens (one
head of a single key); the JAX side runs with bq = ck = 128 (its kernels
need n % 128 == 0).

Tolerances. fp32: 1e-5 for o and lse, 1e-4 absolute and relative for the
gradients (dv reaches ~36: the head of one key collects every query's dO):
the two sides differ in summation order and in
where the scale meets the scores (the JAX dq kernels scale q first,
flash_prefix.py:987, 1047). bf16 inputs: the JAX kernels round q * scale and
dS (cast=True) to bf16 before their products and the outputs to bf16, the
plain versions keep fp32 to the end, so the bound is 4 bf16 ulps at the
output's scale (2**-6 * max|want|); lse 1e-2 absolute (~1e-3 relative; its
scores come from the bf16-rounded q * scale on the JAX side).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import t
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

H, N, D = 4, 256, 64
LENS = [256, 131, 64, 1]
SCALE = 1.0 / math.sqrt(D)


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def _inputs(seed, shape=(H, N, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _close(got, want, dtype, fp32_tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=fp32_tol, rtol=fp32_tol)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_10_to_13_match_the_interpret_kernels(dtype):
    q, k, v, do = (jnp.asarray(a).astype(dtype) for a in _inputs(0))
    kv = jnp.asarray(LENS, jnp.int32)
    tq, tk, tv, tdo = (t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                       for a in (q, k, v, do))
    tkv = torch.tensor(LENS, dtype=torch.int32)

    # kernel 10: o and lse
    o_j, lse_j = jfp._flash_prefix_folded_lse(q, k, v, kv, SCALE, bq=128, ck=128, prune=False)
    o_p, lse_p = fp.flash_prefix_folded_lse(tq, tk, tv, tkv)
    _close(o_p.float().numpy(), o_j.astype(jnp.float32), dtype, 1e-5)
    lse_tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0], atol=lse_tol,
                               rtol=lse_tol)

    # both sides take D and lse from the same numbers (the JAX ones)
    dvec = jnp.sum(do.astype(jnp.float32) * o_j.astype(jnp.float32), axis=-1, keepdims=True)
    tdvec, tlse = t(np.asarray(dvec)[..., 0]), t(np.asarray(lse_j)[..., 0])

    # kernel 11: dq from the forward's lse
    dq_j = jfp._flash_prefix_dq_lsein(q, k, v, do, dvec, lse_j, kv, SCALE, bq=128, ck=128,
                                      cast=True)
    dq_p = fp.flash_prefix_dq_lsein(tq, tk, tv, tdo, tdvec, tlse, tkv)
    _close(dq_p.float().numpy(), dq_j.astype(jnp.float32), dtype, 1e-4)

    # kernel 12: dq and the recomputed lse
    dq12_j, lse12_j = jfp._flash_prefix_dq(q, k, v, do, dvec, kv, SCALE, bq=128, ck=128,
                                           prune=False, cast=True)
    dq12_p, lse12_p = fp.flash_prefix_dq(tq, tk, tv, tdo, tdvec, tkv)
    _close(dq12_p.float().numpy(), dq12_j.astype(jnp.float32), dtype, 1e-4)
    np.testing.assert_allclose(lse12_p.numpy(), np.asarray(lse12_j)[..., 0], atol=lse_tol,
                               rtol=lse_tol)

    # kernel 13: dk and dv from [H, 1, n] rows of D and lse
    dk_j, dv_j = jfp._flash_prefix_dkv(q, k, v, do, dvec.transpose(0, 2, 1),
                                       lse_j.transpose(0, 2, 1), kv, SCALE, bkv=128, cq=128,
                                       cast=True)
    dk_p, dv_p = fp.flash_prefix_dkv(tq, tk, tv, tdo, tdvec, tlse, tkv)
    _close(dk_p.float().numpy(), dk_j.astype(jnp.float32), dtype, 1e-4)
    _close(dv_p.float().numpy(), dv_j.astype(jnp.float32), dtype, 1e-4)
    # keys at or past kv_len get no gradient on either side
    assert not dk_p[3, 1:].any() and not dv_p[2, 64:].any()


def test_function_matches_jax_vjp_of_flash_prefix_attention():
    # the JAX custom_vjp in interpret mode runs kernel 10 forward, then D,
    # kernel 11 and kernel 13: the path the Function mirrors
    b, h = 2, 2
    q, k, v, g = _inputs(1, (b, h, N, D))
    lens = np.asarray([256, 131], np.int32)
    out_j, vjp = jax.vjp(lambda a, b_, c: jfp.flash_prefix_attention(
        a, b_, c, jnp.asarray(lens), 128, 128, False), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out_p = fp.flash_prefix_attention(*leaves, t(lens))
    grads_p = torch.autograd.grad(out_p, leaves, t(g))
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    for got, want in zip(grads_p, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_bwd_without_lse_takes_the_recomputing_dq_sweep():
    # lse=None: JAX runs kernel A for o, then kernel 12 (dq + lse) and 13
    b, h = 1, 4
    q, k, v, g = _inputs(2, (b, h, N, D))
    lens = np.asarray([200], np.int32)
    want = jfp.flash_prefix_attention_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                                          jnp.asarray(lens), jnp.asarray(g), bq=128, bkv=128)
    got = fp.flash_prefix_attention_bwd(t(q), t(k), t(v), t(lens), t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    # and it is the same function as the Function's lse-given path
    o, lse = fp.flash_prefix_folded_lse(*(t(a).reshape(h, N, D) for a in (q, k, v)),
                                        torch.full((h,), 200, dtype=torch.int32))
    again = fp.flash_prefix_attention_bwd(t(q), t(k), t(v), t(lens), t(g), o=o, lse=lse)
    for a, w in zip(again, got):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_grad_mode_picks_the_function_and_inference_kernel_a():
    q, k, v, _ = (t(a) for a in _inputs(3, (1, 2, 64, D)))
    lens = torch.tensor([50])
    with torch.no_grad():
        plain = fp.flash_prefix_attention(q, k, v, lens)
    leaf = q.clone().requires_grad_(True)
    out = fp.flash_prefix_attention(leaf, k, v, lens)
    node = out.grad_fn.next_functions[0][0]  # under the reshape to [b, h, n, d]
    assert type(node).__name__ == "FlashPrefixAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)

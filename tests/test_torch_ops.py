"""The port's kernel modules (plain versions on the CPU) against the JAX package.

Same seeded numpy inputs through the JAX function and the port's wrapper; on
CPU tensors a wrapper runs its kernel's plain version. The JAX side runs its
Pallas kernels in interpret mode (as the JAX package's own kernel tests do)
and its XLA reference formulations. Tolerances are fp32: 1e-5 absolute for
single ops, where the two sides differ only in summation order (the
attention's static-max vs online-max softmax is the same function in exact
arithmetic).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_port_util import t
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import grouped_conv as jgc
from korean_f5_tts_tpu.ops.attention import _xla_sdpa
from korean_f5_tts_tpu_torch.ops import (
    KERNELS,
    ff_block,
    flash_prefix,
    grouped_conv,
    launch_counts,
    reset_launch_counts,
)
from korean_f5_tts_tpu_torch.ops.attention import sdpa

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jff._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET, jff._INTERPRET = old


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- kernel A: prefix attention ---------------------------------------------


@pytest.mark.parametrize("lens", [[256, 256], [1, 200], [37, 129]])
def test_prefix_attention_matches_xla_reference(lens):
    b, h, n, d = 2, 4, 256, 64
    q, k, v = (_randn((b, h, n, d), s) for s in (1, 2, 3))
    kv = np.asarray(lens, np.int32)
    want = jfp._xla_prefix_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(kv))
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), t(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_prefix_attention_matches_interpret_kernel_mixed_lens():
    # b*h = 8 heads: the TPU default runs its 8-heads-per-instance kernel
    b, h, n, d = 2, 4, 256, 64
    assert (b * h) % jfp.resolve_flash_heads(n) == 0
    q, k, v = (_randn((b, h, n, d), s) for s in (4, 5, 6))
    kv = np.asarray([100, 256], np.int32)
    want = jfp.flash_prefix_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(kv), bq=128, bkv=128)
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), t(kv))
    # rows past the prefix are well defined on both sides: compare all of them
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_folded_heads_and_broadcast_lens():
    b, h, n, d = 3, 2, 64, 64
    q, k, v = (_randn((b, h, n, d), s) for s in (7, 8, 9))
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), torch.tensor([40]))
    want = jfp._xla_prefix_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.full((b,), 40, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    plain = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), torch.tensor([40]),
                                                kernels=False)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_unmasked_sdpa_is_the_kernel_with_full_lens():
    b, h, n, d = 2, 2, 96, 64
    q, k, v = (_randn((b, h, n, d), s) for s in (10, 11, 12))
    want = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    got = sdpa(t(q), t(k), t(v), prefix_lens=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# --- kernel B: FF half-block -------------------------------------------------


def _ff_inputs(m=128, d=128, dff=256, seed=0):
    rng = np.random.default_rng(seed)

    def u(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    h = rng.standard_normal((1, m, d)).astype(np.float32)
    return (h, u((d,), 0.3), u((d,), 0.3), u((d,), 1.0), u((d, dff), d ** -0.5),
            u((dff,), 0.1), u((dff, d), dff ** -0.5), u((d,), 0.1))


def _ff_port(h, sc, sh, gate, w1, b1, w2, b2, dtype=torch.float32):
    # the port's weights are torch-layout: w1 [dff, d], w2 [d, dff]
    args = [t(h), t(sc), t(sh), t(gate), t(w1.T), t(b1), t(w2.T), t(b2)]
    return ff_block.ff_block_fused(*(a.to(dtype) for a in args))


def test_ff_block_matches_interpret_kernel_and_xla_reference():
    args = _ff_inputs()
    got = _ff_port(*args).numpy()
    h, sc, sh, gate, w1, b1, w2, b2 = (jnp.asarray(a) for a in args)
    kernel = jff._ff_block_call(h, sc, sh, gate, w1, b1, w2, b2, bm=64, eps=1e-6)
    xla = jff._xla_reference(h, sc, sh, gate, w1, b1, w2, b2)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=RTOL)


def test_ff_block_bf16_follows_the_kernel_rounding_points():
    # bf16 in, same rounding points as the TPU kernel: the two differ only in
    # fp32 summation order, which can flip a bf16 rounding of y, z or the
    # output, so the bound is 2 bf16 ulps of the output's scale (2**-7 each)
    args = _ff_inputs(seed=1)
    got = _ff_port(*args, dtype=torch.bfloat16).float().numpy()
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    want = np.asarray(jff._ff_block_call(*jargs, bm=64, eps=1e-6).astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2 * 2.0 ** -7 * scale, rtol=0)


# --- kernel C: grouped conv1d + Mish -----------------------------------------


@pytest.mark.parametrize("fuse_mish,bias", [(True, True), (False, False)])
def test_grouped_conv_matches_interpret_kernel(fuse_mish, bias):
    c, groups, k = 128, 16, 31
    assert jgc.pallas_conv_supported(c, groups, k)
    x = _randn((2, 64, c), 20)
    rng = np.random.default_rng(21)
    bound = (c // groups * k) ** -0.5
    w = rng.uniform(-bound, bound, (k, c // groups, c)).astype(np.float32)
    b = rng.uniform(-bound, bound, (c,)).astype(np.float32) if bias else None
    want = jgc.grouped_conv1d_mish(jnp.asarray(x), jnp.asarray(w),
                                   None if b is None else jnp.asarray(b), groups=groups,
                                   fuse_mish=fuse_mish, interpret=True)
    got = grouped_conv.grouped_conv1d_mish(t(x), t(w), None if b is None else t(b),
                                           groups, fuse_mish)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

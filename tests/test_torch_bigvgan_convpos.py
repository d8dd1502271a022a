"""BigVGAN, conv-pos at group widths no kernel takes, and the parameter
counter of the port against the JAX package, on the CPU.

BigVGAN: the tiny config of tests/test_vocoders_eval2.py, weights built by
the JAX package (snake parameters drawn away from zero) and handed over
through the converter; fp32 relative L2 1e-5 (convolutions summed in
another order).

Conv-pos: at 48 channels a group (dim 768, 16 groups: F5TTS_Small and
E2TTS_Small) the TPU kernel's predicate fails, so the JAX package convolves
with XLA (modules.py:313-320) and the port takes its plain grouped conv by
the same shape rule, on any device; fp32 relative L2 1e-5.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models import bigvgan as jbv
from korean_f5_tts_tpu.models import modules as jmod
from korean_f5_tts_tpu.ops.grouped_conv import pallas_conv_supported as jax_supported
from korean_f5_tts_tpu.scripts import count_params_gflops as jcount
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.models import bigvgan as pbv
from korean_f5_tts_tpu_torch.models import modules as pmod
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import grouped_conv as gc
from korean_f5_tts_tpu_torch.scripts import count_params_gflops as pcount
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY_BV = dict(num_mels=8, upsample_initial_channel=32, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),))


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _bigvgan(seed: int, **flags):
    jcfg, pcfg = jbv.BigVGANConfig(**TINY_BV, **flags), pbv.BigVGANConfig(**TINY_BV, **flags)
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jbv.init_bigvgan(jax.random.PRNGKey(seed), jcfg)).items()}
    rng = np.random.default_rng(seed)
    for k in flat:  # log-scale snake parameters away from 0 (alpha = beta = 1)
        if "alpha" in k or "beta" in k:
            flat[k] = rng.uniform(-0.5, 0.5, flat[k].shape).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jp, params_from_jax(flat, device="cpu")


@pytest.mark.parametrize("anti_aliasing", [True, False])
@pytest.mark.parametrize("frames", [16, 37])
def test_bigvgan_decode_matches_jax(anti_aliasing, frames):
    jcfg, pcfg, jp, pp = _bigvgan(0, use_anti_aliasing=anti_aliasing)
    mel = np.random.default_rng(1).standard_normal((2, 8, frames)).astype(np.float32)
    want = np.asarray(jbv.bigvgan_decode(jp, jnp.asarray(mel), jcfg))
    got = pbv.bigvgan_decode(pp, t(mel), pcfg)
    assert got.shape == want.shape == (2, frames * 8)
    assert np.abs(want).max() > 1e-2
    assert rel_err(got.numpy(), want) < 1e-5


def test_bigvgan_pieces_match_jax():
    """The Kaiser-sinc filter to the bit, snake-beta, and the transposed
    convolution ([k, c_out, c_in] applied flipped with lhs dilation in JAX,
    F.conv_transpose1d here)."""
    np.testing.assert_array_equal(pbv._FILTER, jbv._UP_FILTER)
    np.testing.assert_array_equal(pbv._FILTER, jbv._DOWN_FILTER)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    alpha, beta = (rng.uniform(-1, 1, 6).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(pbv.snake_beta(t(x), t(alpha), t(beta)).numpy(),
                               np.asarray(jbv.snake_beta(jnp.asarray(x), jnp.asarray(alpha),
                                                         jnp.asarray(beta))), rtol=1e-6, atol=1e-6)
    for stride, k in ((4, 8), (2, 4)):
        p = {"w": rng.standard_normal((k, 5, 6)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
        want = np.asarray(jbv._conv_transpose1d({n: jnp.asarray(v) for n, v in p.items()},
                                                jnp.asarray(x), stride, k))
        got = pbv._conv_transpose1d({n: t(v) for n, v in p.items()}, t(x), stride, k)
        assert got.shape == want.shape == (2, 13 * stride, 5)
        assert rel_err(got.numpy(), want) < 1e-6
    for up in (True, False):
        want = np.asarray((jbv._upsample2 if up else jbv._downsample2)(
            jnp.asarray(x), jbv._UP_FILTER))
        assert rel_err(pbv._resample(t(x), up).numpy(), want) < 1e-6


def test_bigvgan_default_config_and_init_tree():
    assert dataclasses.asdict(pbv.BigVGANConfig()) == dataclasses.asdict(jbv.BigVGANConfig())
    jcfg, pcfg = jbv.BigVGANConfig(**TINY_BV), pbv.BigVGANConfig(**TINY_BV)
    want = {k: v.shape for k, v in
            flatten_tree(jbv.init_bigvgan(jax.random.PRNGKey(0), jcfg)).items()}
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax

    got = {k: v.shape for k, v in params_to_jax(pbv.init_bigvgan(pcfg, device="cpu")).items()}
    assert got == want


def test_bigvgan_is_not_behind_load_vocoder():
    from korean_f5_tts_tpu_torch.api import load_vocoder

    with pytest.raises(NotImplementedError, match="bigvgan"):
        load_vocoder("bigvgan", device="cpu")


# --- conv-pos at 48 channels a group ---------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_conv_pos_at_48_channels_a_group_matches_jax(masked, monkeypatch):
    rng = np.random.default_rng(3)
    dim, n = 768, 70
    p = jmod.conv_position_embedding_init(jax.random.PRNGKey(4), dim)
    flat = {k: np.asarray(v) for k, v in flatten_tree(p).items()}
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray([70, 45])[:, None] if masked else None
    want = np.asarray(jmod.conv_position_embedding(
        unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}), jnp.asarray(x),
        mask=None if mask is None else jnp.asarray(mask)))
    pp = params_from_jax(flat, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("kernel C or its plain version ran at 48 channels a group")

    # the shape rule, not the device, picks the plain convolution
    monkeypatch.setattr(gc, "grouped_conv1d_mish", refuse)
    monkeypatch.setattr(gc, "grouped_conv1d_mish_reference", refuse)
    for kernels in (True, False):
        got = pmod.conv_position_embedding(pp, t(x), mask=None if mask is None else t(mask),
                                           kernels=kernels)
        assert rel_err(got.numpy(), want) < 1e-5


def test_conv_predicate_is_the_jax_one():
    for c in (64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072):
        for groups in (1, 4, 8, 16, 32):
            for k in (30, 31):
                assert gc.pallas_conv_supported(c, groups, k) == jax_supported(c, groups, k)
    assert not gc.pallas_conv_supported(768, 16, 31)  # 48 a group
    # every preset width the predicate takes at 16 groups from 16 channels up has a kernel
    for dim in (256, 512, 1024, 2048):
        assert gc.pallas_conv_supported(dim, 16, 31) and dim // 16 in gc.KERNEL_GROUP_WIDTHS


# --- scripts/count_params_gflops.py ----------------------------------------------------


def test_count_params_gflops_prints_the_jax_numbers(capsys):
    jcount.main(["--duration", "20", "--text_length", "150"])
    want = capsys.readouterr().out
    pcount.main(["--duration", "20", "--text_length", "150"])
    got = capsys.readouterr().out
    assert got == want and "UNetT E2TTS_Base: Params: 333.2 M" in got and "MMDiT:" in got

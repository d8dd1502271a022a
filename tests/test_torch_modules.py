"""The port's modules, mel front-end and vocoder against the JAX package (fp32).

Same seeded numpy inputs through both; 1e-5 absolute for single ops (fp32
summation order is the only difference), 1e-4 relative for composites.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import rel_err, t, tiny_dit, tiny_vocos
from korean_f5_tts_tpu.models import modules as jm
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops import mel as jmel
from korean_f5_tts_tpu_torch.models import modules as pm
from korean_f5_tts_tpu_torch.models.vocos import vocos_decode
from korean_f5_tts_tpu_torch.ops import mel as pmel
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_from_jax

ATOL = 1e-5


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("variant", ["vocos", "bigvgan"])
def test_log_mel_prepadded(variant):
    cfg_j = jmel.MelConfig(mel_spec_type=variant)
    cfg_p = pmel.MelConfig(mel_spec_type=variant)
    np.testing.assert_array_equal(pmel.mel_filterbank(cfg_p), jmel.mel_filterbank(cfg_j))
    frames = 40
    wav = 0.1 * _randn((2, (frames - 1) * 256 + 1024), 0)
    want = jmel.log_mel_prepadded(jnp.asarray(wav), cfg_j, frames + 8)
    got = pmel.log_mel_prepadded(t(wav), cfg_p, frames + 8)
    assert got.shape == (2, frames + 8, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("center", [True, False])
def test_istft_and_overlap_add(center):
    re, im = _randn((2, 513, 12), 1), _randn((2, 513, 12), 2)
    want = jmel.istft(jnp.asarray(re), jnp.asarray(im), 1024, 256, 1024, center=center)
    got = pmel.istft(t(re), t(im), 1024, 256, 1024, center=center)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    frames = _randn((3, 5, 1024), 3)
    np.testing.assert_allclose(pmel.overlap_add(t(frames), 256).numpy(),
                               np.asarray(jmel.overlap_add(jnp.asarray(frames), 256)),
                               atol=ATOL)


@pytest.mark.parametrize("padding", ["center", "same"])
def test_vocos_decode(padding):
    jcfg, jparams, pcfg, pparams = tiny_vocos()
    jcfg = dataclasses.replace(jcfg, padding=padding)
    pcfg = dataclasses.replace(pcfg, padding=padding)
    mel = _randn((2, 100, 24), 4)
    want = jax_vocos_decode(jparams, jnp.asarray(mel), jcfg)
    got = vocos_decode(pparams, t(mel), pcfg)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) < 1e-4


def test_rope_and_timestep_embedding():
    x = _randn((2, 3, 10, 16), 5)
    cos, sin = pm.rope_cos_sin(10, 16)
    np.testing.assert_array_equal(cos, jm.rope_cos_sin(10, 16)[0])
    for pe in (None, 1):
        want = jm.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), pe)
        got = pm.apply_rope(t(x), t(cos), t(sin), pe)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(pm.precompute_freqs_cis(32, 50),
                                  jm.precompute_freqs_cis(32, 50))
    jparams, pparams, _ = tiny_dit()
    ts = np.asarray([0.0, 0.25, 0.9], np.float32)
    want = jm.timestep_embedding(jparams["time_embed"], jnp.asarray(ts))
    got = pm.timestep_embedding(pparams["time_embed"], t(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


def test_attention_masks_survive_the_port():
    """pad_mask masks the logits when attn_mask_enabled is False; the per-item
    duration mask still zeroes output rows (modules.py:485-488, 565-566)."""
    jparams, pparams, _ = tiny_dit()
    ja, pa = jparams["blocks"][0]["attn"], pparams["blocks"][0]["attn"]
    n = 48
    x = _randn((2, n, 64), 6)
    cos, sin = pm.rope_cos_sin(n, 16)
    mask = np.arange(n)[None, :] < np.asarray([30, 41])[:, None]
    pad = (np.arange(n) < 41)[None, :]
    for enabled in (False, True):
        want = jm.attention(ja, jnp.asarray(x), 4, mask=jnp.asarray(mask),
                            rope=(jnp.asarray(cos), jnp.asarray(sin)),
                            attn_mask_enabled=enabled, pad_mask=jnp.asarray(pad))
        got = pm.attention(pa, t(x), 4, mask=t(mask), rope=(t(cos), t(sin)),
                           attn_mask_enabled=enabled, pad_mask=t(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
        assert np.all(got.numpy()[0, 30:] == 0)  # duration-masked rows are zero


def test_conv_position_embedding_and_convnext():
    jparams, pparams, _ = tiny_dit()
    x = _randn((2, 40, 64), 7)
    mask = np.arange(40)[None, :] < np.asarray([40, 25])[:, None]
    want = jm.conv_position_embedding(jparams["conv_pos_embed"], jnp.asarray(x),
                                      mask=jnp.asarray(mask))
    got = pm.conv_position_embedding(pparams["conv_pos_embed"], t(x), mask=t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    blk_j = jparams["text_embed"]["blocks"][0]
    # give GRN non-trivial gamma/beta (they init to zero)
    rng = np.random.default_rng(8)
    blk_j = {**blk_j, "grn": {k: jnp.asarray(rng.uniform(-1, 1, (1, 1, 64)).astype(np.float32))
                              for k in ("gamma", "beta")}}
    blk_p = params_from_jax(flatten_tree(jax.tree_util.tree_map(np.asarray, blk_j)))
    xt = _randn((2, 40, 32), 9)
    valid = (np.arange(40) < 33)[None, :, None]
    want = jm.convnext_v2_block(blk_j, jnp.asarray(xt), valid_mask=jnp.asarray(valid))
    got = pm.convnext_v2_block(blk_p, t(xt), valid_mask=t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_feedforward_activations_and_the_unfused_half_block():
    jparams, pparams, _ = tiny_dit()
    x = _randn((2, 20, 64), 10)
    want = jm.feedforward(jparams["blocks"][1]["ff"], jnp.asarray(x))
    got = pm.feedforward(pparams["blocks"][1]["ff"], t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    for jf, pf in ((jm.mish, pm.mish), (jm.gelu_tanh, pm.gelu_tanh),
                   (jm.gelu_exact, pm.gelu_exact)):
        np.testing.assert_allclose(pf(t(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                   atol=ATOL, rtol=1e-6)
    # kernel B's plain version is the unfused half-block of the JAX model
    from korean_f5_tts_tpu_torch.ops.ff_block import ff_block_reference

    rng = np.random.default_rng(11)
    sc, sh, gate = (rng.uniform(-0.5, 0.5, 64).astype(np.float32) for _ in range(3))
    norm = jm.layernorm({}, jnp.asarray(x)) * (1 + sc) + sh
    want = jnp.asarray(x) + gate * jm.feedforward(jparams["blocks"][1]["ff"], norm)
    ff = pparams["blocks"][1]["ff"]
    got = ff_block_reference(t(x), t(sc), t(sh), t(gate), ff["in"]["w"], ff["in"]["b"],
                             ff["out"]["w"], ff["out"]["b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)

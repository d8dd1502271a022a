"""qk-norm DiTs (qk_norm="rms_norm") of the port against the JAX package, on
the CPU.

A tiny DiT (dim 128, depth 2, 2 heads x 64) with the per-head q/k RMSNorm
is built by the JAX package, its AdaLN-zero layers re-drawn and its q/k norm
gains drawn away from 1, and handed to the port through the converter. The
norm sits after the head split and before rope (modules.py:540-542), so
"qkv_kernel" and "rope_in_kernel" step aside to torch rope + kernel A, and
the fused half-blocks (kernels 5/6, 7/8) are not taken (dit.py:374): every
attn_path computes the default path's function. The JAX side sets the
matching switches with its kernels in interpret mode. Tolerances as the DiT
tests': fp32 relative L2 1e-4 (two blocks, sums in another order); int8
attention as tests/test_torch_attn_int8.py's model level.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import quant as pquant
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.attention import ATTN_PATHS
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
            text_num_embeds=50, qk_norm="rms_norm")
JAX_SWITCH = {"linear_fused": "F5_TTS_ATTN_LINEAR_FUSED", "rope_in_kernel": "F5_TTS_ROPE_IN_KERNEL",
              "qkv_kernel": "F5_TTS_QKV_KERNEL"}
JAX_INT8 = {"qk": "qk", "qkpv": "1"}
INT8_REL = {"qkpv": 2e-3, "qk": 5e-3}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("F5_TTS_PREFIX_BKV", raising=False)
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


@functools.lru_cache(maxsize=2)
def _tiny(int8: bool = False):
    jcfg, pcfg = JaxDiTConfig(**TINY), DiTConfig(**TINY)
    flat = flatten_tree(jdit.init_dit(jax.random.PRNGKey(0), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 7)
    rng = np.random.default_rng(8)
    for k in flat:
        if k.endswith(("q_norm/g", "k_norm/g")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    pparams = params_from_jax(flat, device="cpu")
    if int8:
        jparams, pparams = jquant.quantize_params(jparams), pquant.quantize_params(pparams)
    return jcfg, pcfg, jparams, pparams


def _step_inputs(batch):
    n = 128
    rng = np.random.default_rng(6)
    durs = np.asarray([128, 100][:batch])
    dur_mask = np.arange(n)[None, :] < durs[:, None]
    mask = dur_mask if batch > 1 else None
    pad_mask = (np.arange(n) < durs.max())[None, :]
    y0 = np.where(dur_mask[..., None], rng.standard_normal((batch, n, 100)), 0).astype(np.float32)
    cond = np.where(np.arange(n)[None, :, None] < 30, rng.standard_normal((batch, n, 100)),
                    0).astype(np.float32)
    text = rng.integers(0, 49, (batch, 40)).astype(np.int32)
    return n, durs, mask, pad_mask, y0, cond, text


def _jax_step(batch, int8=False):
    jcfg, _, jp, _ = _tiny(int8)
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(batch)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=dr,
                              pad_mask=jnp.asarray(pad_mask)) for dr in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray([0.4], jnp.float32))
    want = np.asarray(jdit.dit_forward_cfg_premod(
        jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te, mods[0], mod_final[0], 2.0,
        mask=None if mask is None else jnp.asarray(mask), pad_mask=jnp.asarray(pad_mask)))
    return np.concatenate([want[i, :d] for i, d in enumerate(durs)])


def _port_step(batch, attn_path="default", attn_int8=None, int8=False, kernels=True):
    _, pcfg, _, pp = _tiny(int8)
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(batch)
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(text), n, drop_text=dr,
                              pad_mask=t(pad_mask)) for dr in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, torch.tensor([0.4]))
    with torch.inference_mode():
        out = pdit.dit_forward_cfg_premod(
            pp, pcfg, t(y0), t(cond), *tp, pmods[0], pfinal[0], 2.0,
            mask=None if mask is None else t(mask), pad_mask=t(pad_mask), kernels=kernels,
            attn_path=attn_path, attn_int8=attn_int8).numpy()
    return np.concatenate([out[i, :d] for i, d in enumerate(durs)])


def test_dit_forward_matches_jax():
    jcfg, pcfg, jp, pp = _tiny()
    rng = np.random.default_rng(2)
    b, n = 2, 96
    lens = np.asarray([96, 61])
    x, cond = (rng.standard_normal((b, n, 100)).astype(np.float32) for _ in range(2))
    text = rng.integers(0, 49, (b, 30)).astype(np.int32)
    time = rng.uniform(size=b).astype(np.float32)
    mask = np.arange(n)[None, :] < lens[:, None]
    want = jdit.dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                            jnp.asarray(time), mask=jnp.asarray(mask))
    got = pdit.dit_forward(pp, pcfg, t(x), t(cond), t(text), t(time), mask=t(mask))
    valid = lambda a: np.concatenate([np.asarray(a)[i, :d] for i, d in enumerate(lens)])  # noqa: E731
    assert np.abs(valid(got.numpy())).max() > 0.1
    assert rel_err(valid(got.numpy()), valid(want)) < 1e-4
    # the norms are on: the same tree without them is another function
    plain = {**pp, "blocks": [dict(blk, attn={k: v for k, v in blk["attn"].items()
                                              if not k.endswith("_norm")})
                              for blk in pp["blocks"]]}
    other = pdit.dit_forward(plain, pcfg, t(x), t(cond), t(text), t(time), mask=t(mask))
    assert rel_err(valid(other.numpy()), valid(got.numpy())) > 1e-3


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("attn_path", ATTN_PATHS)
def test_cfg_step_matches_jax_under_each_attn_path(attn_path, batch, monkeypatch):
    if attn_path != "default":
        monkeypatch.setenv(JAX_SWITCH[attn_path], "1")
    got = _port_step(batch, attn_path)
    assert np.abs(got).max() > 0.1
    assert rel_err(got, _jax_step(batch)) < 1e-4
    # every path steps aside to the default path's function
    np.testing.assert_array_equal(got, _port_step(batch, "default"))
    np.testing.assert_array_equal(got, _port_step(batch, attn_path, kernels=False))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32_weights", "int8_weights"])
def test_fused_half_blocks_are_not_taken(int8, monkeypatch):
    """dit.py:374: the fused attention half-block has no place for the q/k
    norms, so a qk-norm DiT never takes it, whatever the weights and
    attn_path (the JAX dispatch requires cfg.qk_norm is None)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused attention half-block ran on a qk-norm DiT")

    monkeypatch.setattr(pdit, "attention_half_fused", refuse)
    got = _port_step(1, "linear_fused", int8=int8)
    want = _jax_step(1, int8=int8)
    assert rel_err(got, want) < (4e-3 if int8 else 1e-4)  # int8: a few rounding ties


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_cfg_step_with_int8_attention_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("F5_TTS_INT8_ATTN", JAX_INT8[mode])
    want = _jax_step(1)
    got = _port_step(1, attn_int8=mode)
    assert rel_err(got, want) < INT8_REL[mode]
    assert 1e-5 < rel_err(got, _port_step(1)) < 0.2  # the int8 branch ran


def test_converter_round_trip_keeps_the_norm_gains(tmp_path):
    """dit_state_dict writes the gains in the interleaved rope layout and the
    converter permutes them back (never a second time)."""
    from korean_f5_tts_tpu.utils.torch_ckpt import convert_dit_state_dict as jax_convert
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax
    from korean_f5_tts_tpu_torch.utils import torch_ckpt

    _, pcfg, _, pp = _tiny()
    flat = params_to_jax(pp)
    tree = unflatten_tree(flat)
    sd = torch_ckpt.dit_state_dict(tree, pcfg.heads, pcfg.dim_head)
    assert "transformer_blocks.0.attn.q_norm.weight" in sd
    for conv in (torch_ckpt.convert_dit_state_dict, jax_convert):
        back = flatten_tree(conv(sd, pcfg.heads, pcfg.dim_head, pcfg.depth, pcfg.conv_layers))
        assert back.keys() == flat.keys()
        for k in flat:
            np.testing.assert_array_equal(np.asarray(back[k]), flat[k], err_msg=k)

"""The port's DiT (text embedding, one CFG step) and weight converter against
the JAX package, in fp32.

A tiny DiT (depth 2, dim 64) built by the JAX package goes to the port
through the converter; seeded numpy inputs go to both. On the CPU the JAX
side takes its XLA paths and the port its plain versions. Tolerance:
relative 1e-4 for composites (fp32 summation order). Only valid rows
[0, duration) are compared: bucket-tail rows are never zeroed per block, in
either package.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port_util import rel_err, t, tiny_configs, tiny_dit
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.config import MelConfig, ModelConfig
from korean_f5_tts_tpu_torch.infer.model import load_model
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax, params_to_jax

REL = 1e-4
N, LENS, DURS = 128, np.asarray([30, 41]), np.asarray([100, 120])


@pytest.fixture(scope="module")
def case():
    """Inputs of one batch of 2 with per-item durations, for the DiT."""
    rng = np.random.default_rng(0)
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    ar = np.arange(N)
    cond_mask = ar[None, :] < LENS[:, None]
    dur_mask = ar[None, :] < DURS[:, None]
    cond = rng.standard_normal((2, 160, 100)).astype(np.float32)  # bucketed ref mels
    step_cond = np.where(cond_mask[..., None], cond[:, :N], 0.0).astype(np.float32)
    text = np.full((2, 64), -1, np.int32)
    text[0, :20] = rng.integers(0, 49, 20)
    text[1, :33] = rng.integers(0, 49, 33)
    y0 = np.where(dur_mask[..., None], rng.standard_normal((2, N, 100)), 0.0).astype(np.float32)
    pad_mask = (ar < DURS.max())[None, :]
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams, pparams=pparams, cond=cond,
                step_cond=step_cond, text=text, y0=y0, dur_mask=dur_mask,
                pad_mask=pad_mask, cond_mask=cond_mask)


def _valid(x):
    return np.concatenate([x[i, :d] for i, d in enumerate(DURS)])


def test_text_embedding(case):
    for drop in (False, True):
        want = jdit.text_embedding(case["jparams"]["text_embed"], case["jcfg"],
                                   jnp.asarray(case["text"]), N, drop_text=drop,
                                   pad_mask=jnp.asarray(case["pad_mask"]))
        got = pdit.text_embedding(case["pparams"]["text_embed"], case["pcfg"],
                                  t(case["text"]), N, drop_text=drop,
                                  pad_mask=t(case["pad_mask"]))
        assert rel_err(got.numpy()[:, :DURS.max()], np.asarray(want)[:, :DURS.max()]) < REL


def test_dit_forward_cfg_premod_one_step(case):
    jp, pp, jcfg, pcfg = case["jparams"], case["pparams"], case["jcfg"], case["pcfg"]
    ts = np.asarray([0.3], np.float32)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(case["text"]), N,
                              drop_text=d, pad_mask=jnp.asarray(case["pad_mask"]))
          for d in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray(ts))
    want = jdit.dit_forward_cfg_premod(
        jp, jcfg, jnp.asarray(case["y0"]), jnp.asarray(case["step_cond"]), *te,
        mods[0], mod_final[0], 2.0, mask=jnp.asarray(case["dur_mask"]),
        pad_mask=jnp.asarray(case["pad_mask"]))
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(case["text"]), N, drop_text=d,
                              pad_mask=t(case["pad_mask"])) for d in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, t(ts))
    np.testing.assert_allclose(pmods.numpy(), np.asarray(mods), atol=1e-5, rtol=1e-5)
    got = pdit.dit_forward_cfg_premod(
        pp, pcfg, t(case["y0"]), t(case["step_cond"]), *tp, pmods[0], pfinal[0], 2.0,
        mask=t(case["dur_mask"]), pad_mask=t(case["pad_mask"]))
    assert np.abs(_valid(got.numpy())).max() > 0.1  # not gated off
    assert rel_err(_valid(got.numpy()), _valid(np.asarray(want))) < REL


def test_converter_round_trip_and_init_layout(tmp_path):
    jcfg, pcfg = tiny_configs()
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jdit.init_dit(jax.random.PRNGKey(3), jcfg)).items()}
    port = params_from_jax(flat, device="cpu")
    # linear weights transpose to torch [out, in]; conv and embedding stay
    np.testing.assert_array_equal(port["input_proj"]["w"].numpy(), flat["input_proj/w"].T)
    np.testing.assert_array_equal(port["conv_pos_embed"]["conv1"]["w"].numpy(),
                                  flat["conv_pos_embed/conv1/w"])
    np.testing.assert_array_equal(port["text_embed"]["embed"]["w"].numpy(),
                                  flat["text_embed/embed/w"])
    back = params_to_jax(port)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # the port's own init builds the same tree with the same shapes
    init = params_to_jax(pdit.init_dit(pcfg, seed=0, device="cpu"))
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in flat.items()}
    assert not init["blocks/0/attn_norm/linear/w"].any()  # AdaLN-zero
    # and load_model reads a JAX .npz checkpoint (EMA subtree preferred)
    path = os.path.join(tmp_path, "ckpt.npz")
    np.savez(path, **{f"ema_params/{k}": v for k, v in flat.items()},
             **{f"params/{k}": np.zeros_like(v) for k, v in flat.items()})
    model = load_model(ModelConfig(arch=pcfg, mel=MelConfig()), ckpt_path=path, device="cpu")
    np.testing.assert_array_equal(
        model.params["blocks"][1]["ff"]["out"]["w"].numpy(), flat["blocks/1/ff/out/w"].T)

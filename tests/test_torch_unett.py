"""The port's UNetT backbone (E2-TTS) against the JAX package, on the CPU.

Tiny UNetTs (dim 64, depth 2 and 4, 4 heads x 16) are built by the JAX
package and handed to the port through the converter; seeded numpy inputs go
to both. On the CPU the JAX side takes its XLA paths and the port the plain
versions of its kernels, so the launch counters stay 0. fp32 throughout:
relative L2 1e-5 (the same arithmetic, sums in another order), on the
valid rows where a mask cuts the sequence.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.config import UNetTConfig as JaxUNetTConfig
from korean_f5_tts_tpu.models import unett as junett
from korean_f5_tts_tpu.models.dit import text_embedding as jax_text_embedding
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import UNetTConfig
from korean_f5_tts_tpu_torch.models import unett as punett
from korean_f5_tts_tpu_torch.models.dit import text_embedding as port_text_embedding
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as pflatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax
from korean_f5_tts_tpu_torch.train.checkpoint import unflatten_tree as punflatten

REL = 1e-5
TINY_UNETT = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_num_embeds=50,
                  text_mask_padding=False)
B, N = 2, 96
LENS = np.asarray([96, 70])


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


def unett_pair(seed: int = 0, **flags):
    """(jax config, port config, jax params, port params) of one tiny UNetT."""
    kw = dict(TINY_UNETT, **flags)
    jcfg, pcfg = JaxUNetTConfig(**kw), UNetTConfig(**kw)
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(junett.init_unett(jax.random.PRNGKey(seed), jcfg)).items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu")


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    text = np.full((B, 40), -1, np.int32)
    text[0, :31] = rng.integers(0, 49, 31)
    text[1, :17] = rng.integers(0, 49, 17)
    time = rng.uniform(size=B).astype(np.float32)
    return x, cond, text, time


def _valid(x, lens=LENS):
    x = np.asarray(x)
    return np.concatenate([x[i, :d] for i, d in enumerate(lens)])


@pytest.mark.parametrize("skip", ["concat", "add", "none"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("depth", [2, 4])
def test_unett_forward_matches_jax(skip, masked, depth):
    jcfg, pcfg, jp, pp = unett_pair(skip_connect_type=skip, depth=depth)
    x, cond, text, time = _inputs()
    mask = np.arange(N)[None, :] < LENS[:, None] if masked else None
    drops = (jnp.asarray(1.0), jnp.asarray(0.0))
    want = junett.unett_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                jnp.asarray(time), mask=None if mask is None else jnp.asarray(mask),
                                drop_audio_cond=drops[0], drop_text=drops[1])
    got = punett.unett_forward(pp, pcfg, t(x), t(cond), t(text), t(time),
                               mask=None if mask is None else t(mask),
                               drop_audio_cond=torch.tensor(1.0), drop_text=torch.tensor(0.0))
    assert np.abs(got.numpy()).max() > 0.1
    lens = LENS if masked else [N, N]
    assert rel_err(_valid(got.numpy(), lens), _valid(want, lens)) < REL
    if skip == "concat":  # the second half's layers carry skip_proj
        assert all(("skip_proj" in layer) == (i >= depth // 2)
                   for i, layer in enumerate(pp["layers"]))


@pytest.mark.parametrize("batch_mask", ["duration", "pad", "none"])
def test_unett_forward_cfg_matches_jax(batch_mask):
    """The CFG step: the port packs both halves before the input embedding,
    the JAX step embeds them apart: the same function."""
    jcfg, pcfg, jp, pp = unett_pair(seed=2, qk_norm="rms_norm")
    x, cond, text, time = _inputs(3)
    mask = np.arange(N)[None, :] < LENS[:, None] if batch_mask == "duration" else None
    pad_mask = (np.arange(N) < 80)[None] if batch_mask == "pad" else None
    te = [jax_text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), N, drop_text=dr,
                             pad_mask=None if pad_mask is None else jnp.asarray(pad_mask))
          for dr in (False, True)]
    want = junett.unett_forward_cfg(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), *te,
                                    jnp.asarray(time), 2.0,
                                    mask=None if mask is None else jnp.asarray(mask),
                                    pad_mask=None if pad_mask is None else jnp.asarray(pad_mask))
    tp = [port_text_embedding(pp["text_embed"], pcfg, t(text), N, drop_text=dr,
                              pad_mask=None if pad_mask is None else t(pad_mask))
          for dr in (False, True)]
    got = punett.unett_forward_cfg(pp, pcfg, t(x), t(cond), *tp, t(time), 2.0,
                                   mask=None if mask is None else t(mask),
                                   pad_mask=None if pad_mask is None else t(pad_mask))
    lens = {"duration": LENS, "pad": [80, 80], "none": [N, N]}[batch_mask]
    assert rel_err(_valid(got.numpy(), lens), _valid(want, lens)) < REL
    # the plain versions through the same dispatch: one function on the CPU
    plain = punett.unett_forward_cfg(pp, pcfg, t(x), t(cond), *tp, t(time), 2.0,
                                     mask=None if mask is None else t(mask),
                                     pad_mask=None if pad_mask is None else t(pad_mask),
                                     kernels=False)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_unett_dropout_is_the_same_under_remat():
    """Each block's dropout generator is made inside the checkpointed
    function: the recompute draws the masks the forward drew."""
    _, pcfg, _, pp = unett_pair(seed=4)
    remat = dataclasses.replace(pcfg, checkpoint_activations=True)
    x, cond, text, time = _inputs(5)
    grads = []
    for cfg in (pcfg, remat):
        flat = pflatten(pp)
        leaf = flat["layers/0/ff/in/w"] = flat["layers/0/ff/in/w"].clone().requires_grad_(True)
        out = punett.unett_forward(punflatten(flat), cfg, t(x), t(cond), t(text), t(time),
                                   dropout_seed=9)
        grads.append((out.detach(), torch.autograd.grad(out.square().sum(), leaf)[0]))
    np.testing.assert_array_equal(grads[0][0].numpy(), grads[1][0].numpy())
    assert rel_err(grads[1][1].numpy(), grads[0][1].numpy()) < 1e-6
    # and dropout is on: another seed draws other masks
    other = punett.unett_forward(pp, pcfg, t(x), t(cond), t(text), t(time), dropout_seed=10)
    assert rel_err(other.detach().numpy(), grads[0][0].numpy()) > 1e-3


def test_odd_depth_raises():
    with pytest.raises(ValueError, match="even"):
        punett.init_unett(UNetTConfig(**dict(TINY_UNETT, depth=3)), device="cpu")

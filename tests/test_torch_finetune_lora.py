"""LoRA in the port against the JAX package, on the CPU.

A tiny DiT (dim 64, depth 2, AdaLN-zero layers re-drawn) and the JAX
package's init_lora adapters, with b re-drawn non-zero (b = 0 makes every
adapter the identity, and a zero b gives a and scale no gradient), cross to
the port through params_from_jax and lora_from_jax. The training steps take
the JAX package's own draws (tests/test_torch_train.py:_jax_draws) with
dropout off on both sides. Tolerances: the adapted forward relative 1e-5
(fp32); a, b and scale (and the text embedding with train_text_embed) after
1 and 3 steps relative 1e-5 each; merge_lora equal to the bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from _torch_port_util import TINY, redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import lora as jlora
from korean_f5_tts_tpu.train import train_lora as jtl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree as jflatten
from korean_f5_tts_tpu.train.checkpoint import unflatten_tree as junflatten
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import lora as plora
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train import train_lora as ptl
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_from_jax, params_to_jax
from korean_f5_tts_tpu_torch.train.step import PlainAdamW
from test_torch_train import _jax_draws

REL = 1e-5
LR = 1e-4  # the LoRA command line's default
B, N = 2, 128
LENS = np.asarray([128, 101], np.int32)
FLAGS = dict(dropout=0.0, pe_attn_head=1, text_mask_padding=False)  # F5TTS_Base, no dropout


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _case(seed: int = 0):
    """(jax cfg, port cfg, flat base params, JAX adapters with b re-drawn)."""
    jcfg = JaxDiTConfig(**TINY, **FLAGS)
    flat = jflatten(jdit.init_dit(jax.random.PRNGKey(seed), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    adapters = jlora.init_lora(jax.random.PRNGKey(seed + 1), junflatten(flat))
    rng = np.random.default_rng(seed + 2)
    adapters = {path: {"a": np.asarray(ad["a"]),
                       "b": (0.05 * rng.standard_normal(ad["b"].shape)).astype(np.float32),
                       "scale": np.asarray(ad["scale"])} for path, ad in adapters.items()}
    return jcfg, DiTConfig(**TINY, **FLAGS), flat, adapters


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    mel[1, LENS[1]:] = 0.0
    text = np.full((B, 32), -1, np.int32)
    text[0, :25] = rng.integers(0, 49, 25)
    text[1, :19] = rng.integers(0, 49, 19)
    return {"mel": mel, "text": text, "lens": LENS}


def test_targets_and_init_match_jax():
    _, pcfg, flat, jad = _case()
    port = plora.init_lora(params_from_jax(flat, device="cpu"), seed=0)
    assert port.keys() == jad.keys() == {
        *(f"blocks/{i}/attn/{n}" for i in range(TINY["depth"])
          for n in ("to_q", "to_k", "to_v", "to_out")), "input_proj"}
    for path, ad in port.items():
        assert ad["a"].shape == jad[path]["a"].shape and ad["b"].shape == jad[path]["b"].shape
        assert not ad["b"].any() and float(ad["scale"]) == float(jad[path]["scale"])
    assert float(port["input_proj"]["scale"]) == 2.0 and port["input_proj"]["a"].shape[1] == 64


def test_adapted_forward_matches_jax():
    jcfg, pcfg, flat, jad = _case()
    jp = jlora.apply_lora(jax.tree_util.tree_map(jnp.asarray, junflatten(flat)),
                          jax.tree_util.tree_map(jnp.asarray, jad))
    pp = plora.apply_lora(params_from_jax(flat, device="cpu"),
                          plora.lora_from_jax(jad, device="cpu"))
    rng = np.random.default_rng(3)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    time = rng.uniform(size=B).astype(np.float32)
    mask = np.arange(N)[None, :] < LENS[:, None]
    text = _batch()["text"]
    want = np.asarray(jdit.dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond),
                                       jnp.asarray(text), jnp.asarray(time),
                                       mask=jnp.asarray(mask)))
    got = pdit.dit_forward(pp, pcfg, t(x), t(cond), t(text), t(time), mask=t(mask)).numpy()
    base = pdit.dit_forward(params_from_jax(flat, device="cpu"), pcfg, t(x), t(cond), t(text),
                            t(time), mask=t(mask)).numpy()
    assert rel_err(got, base) > 1e-2  # the adapters change the output
    assert rel_err(got, want) < REL


def test_merge_lora_matches_jax():
    _, _, flat, jad = _case()
    want = {k: np.asarray(v) for k, v in jflatten(jlora.merge_lora(
        jax.tree_util.tree_map(jnp.asarray, junflatten(flat)),
        jax.tree_util.tree_map(jnp.asarray, jad))).items()}
    got = params_to_jax(plora.merge_lora(params_from_jax(flat, device="cpu"),
                                         plora.lora_from_jax(jad, device="cpu")))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    moved = {k for k in want if not np.array_equal(got[k], flat[k])}
    assert moved == {f"{p}/w" for p in jad}
    back = plora.lora_to_jax(plora.lora_from_jax(jad, device="cpu"))
    for path in jad:
        for leaf in ("a", "b", "scale"):
            np.testing.assert_array_equal(back[path][leaf], jad[path][leaf])


def _gather(adapters: dict, leaf: str) -> np.ndarray:
    return np.concatenate([np.asarray(adapters[p][leaf]).ravel() for p in sorted(adapters)])


STEPS = 3
JOPT = optax.adamw(LR)  # one object, so that jit compiles each step once per process


@functools.lru_cache(maxsize=2)
def _jax_run(train_text_embed: bool):
    """STEPS JAX lora_train_steps; (adapters, text_embed flat) after each."""
    jcfg, _, flat, jad = _case()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    jbase = jax.tree_util.tree_map(jnp.asarray, junflatten(flat))
    jads = jax.tree_util.tree_map(jnp.asarray, jad)
    trainable = {"adapters": jads}
    if train_text_embed:
        trainable["text_embed"] = jbase["text_embed"]
    jstate = JOPT.init(trainable)
    out = []
    for i in range(STEPS):
        jads, jbase, jstate, loss = jtl.lora_train_step(
            jbase, jads, jstate, batch, jax.random.PRNGKey(40 + i), jcfg, JOPT,
            train_text_embed=train_text_embed)
        out.append((jax.tree_util.tree_map(np.asarray, jads),
                    {k: np.asarray(v) for k, v in jflatten(jbase["text_embed"]).items()},
                    float(loss)))
    return out


def _port_run(train_text_embed: bool, freeze_scale: bool = False):
    """The same steps in the port on the JAX draws; (adapters, text_embed
    flat, loss) after each. freeze_scale holds every scale at alpha / r."""
    _, pcfg, flat, jad = _case()
    pbase = params_from_jax(flat, device="cpu")
    pads = plora.lora_from_jax(jad, device="cpu")
    popt = PlainAdamW(learning_rate=LR)
    pstate = popt.init(ptl.trainable_leaves(pbase, pads, train_text_embed))
    pbatch = {k: t(v) for k, v in _batch().items()}
    frozen = {k: v.clone() for k, v in flatten_tree(pbase).items()}
    out = []
    for i in range(STEPS):
        draws = _jax_draws(jax.random.PRNGKey(40 + i), (B, N, 100), LENS)
        pads, pbase, pstate, loss = ptl.lora_train_step(
            pbase, pads, pstate, pbatch, 0, pcfg, popt, train_text_embed=train_text_embed,
            draws=draws)
        if freeze_scale:
            for path in pads:
                pads[path]["scale"].fill_(float(jad[path]["scale"]))
        out.append((plora.lora_to_jax(pads),
                    {k: v.copy() for k, v in params_to_jax(pbase["text_embed"]).items()},
                    loss.item()))
    # the base tensors are untouched (but the text embedding when it trains)
    for k, v in flatten_tree(pbase).items():
        if not (train_text_embed and k.startswith("text_embed/")):
            torch.testing.assert_close(v, frozen[k], rtol=0, atol=0)
    assert pstate["count"] == STEPS
    return out


@pytest.mark.parametrize("train_text_embed", [False, True], ids=["adapters", "text_embed"])
def test_lora_train_steps_match_jax(train_text_embed):
    """After 1 and after 3 steps: the loss within 1e-5, each of a, b, scale
    (and the text embedding) moved by more than the bound and within it of
    the JAX package's."""
    _, _, flat, ad0 = _case()
    te0 = {k[len("text_embed/"):]: v for k, v in flat.items() if k.startswith("text_embed/")}
    port = _port_run(train_text_embed)
    for step in (1, STEPS):
        (jads, jte, jloss), (pads, pte, ploss) = _jax_run(train_text_embed)[step - 1], \
            port[step - 1]
        np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
        for leaf in ("a", "b", "scale"):
            want, got, init = (_gather(x, leaf) for x in (jads, pads, ad0))
            assert rel_err(want, init) > REL, (step, leaf)  # it moved
            assert rel_err(got, want) < REL, (step, leaf)
        keys = sorted(jte)
        want, got, init = (np.concatenate([x[k].ravel() for k in keys]) for x in (jte, pte, te0))
        if train_text_embed:
            assert rel_err(want, init) > REL and rel_err(got, want) < REL, step
        else:
            np.testing.assert_array_equal(got, init)
            np.testing.assert_array_equal(want, init)


def test_the_scale_bound_sees_an_untrained_scale():
    """The control: the same steps with each scale held at alpha / r miss the
    bound on scale by step 3, so the bound does see scale being trained."""
    jads, _, _ = _jax_run(False)[STEPS - 1]
    pads, _, _ = _port_run(False, freeze_scale=True)[STEPS - 1]
    assert rel_err(_gather(pads, "scale"), _gather(jads, "scale")) > REL


def test_base_tensors_take_no_gradient():
    """apply_lora leaves the base tensors as they are: no requires_grad, and
    only the adapters' leaves reach the loss's graph."""
    _, pcfg, flat, jad = _case()
    base = params_from_jax(flat, device="cpu")
    pads = {p: {k: v.requires_grad_(True) for k, v in ad.items()}
            for p, ad in plora.lora_from_jax(jad, device="cpu").items()}
    merged = plora.apply_lora(base, pads)
    assert not any(v.requires_grad for v in flatten_tree(base).values())
    grad_leaves = {k for k, v in flatten_tree(merged).items() if v.requires_grad}
    assert grad_leaves == {f"{p}/w" for p in pads}

"""The port's MMDiT backbone and joint attention against the JAX package, on
the CPU.

Tiny MMDiTs (dim 64, depth 2: the last block context_pre_only, 4 heads x 16)
are built by the JAX package, their AdaLN-zero layers re-drawn, and handed
to the port through the converter. Joint attention has two forms in the
port: the text-first prefix form (kernel A's plain version on the CPU, one
valid length per item) and the JAX order with an explicit boolean key mask
(kernels=False); both are held to the JAX joint_attention and to each other.
fp32 throughout: relative L2 1e-5 on the valid rows.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.config import MMDiTConfig as JaxMMDiTConfig
from korean_f5_tts_tpu.models import mmdit as jmmdit
from korean_f5_tts_tpu.models import modules as jmod
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import MMDiTConfig
from korean_f5_tts_tpu_torch.models import mmdit as pmmdit
from korean_f5_tts_tpu_torch.models import modules as pmod
from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

REL = 1e-5
TINY_MMDIT = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_num_embeds=50)
ZERO_INIT = ("attn_norm_x/linear/", "attn_norm_c/linear/", "norm_out/linear/", "proj_out/")
B, N, NT = 2, 96, 24
LENS = np.asarray([96, 70])


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


def mmdit_pair(seed: int = 0, **flags):
    """(jax config, port config, jax params, port params) of one tiny MMDiT,
    its AdaLN-zero layers re-drawn uniform +-1/sqrt(d_in)."""
    kw = dict(TINY_MMDIT, **flags)
    jcfg, pcfg = JaxMMDiTConfig(**kw), MMDiTConfig(**kw)
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jmmdit.init_mmdit(jax.random.PRNGKey(seed), jcfg)).items()}
    rng = np.random.default_rng(seed + 100)
    for k, v in flat.items():
        if any(z in k for z in ZERO_INIT):
            d_in = flat[k[:-1] + "w"].shape[0]
            flat[k] = rng.uniform(-1, 1, v.shape).astype(np.float32) / math.sqrt(d_in)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu")


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    text = np.full((B, NT), -1, np.int32)
    text[0, :NT] = rng.integers(0, 49, NT)
    text[1, :13] = rng.integers(0, 49, 13)
    time = rng.uniform(size=B).astype(np.float32)
    return x, cond, text, time


def _valid(x, lens):
    x = np.asarray(x)
    return np.concatenate([x[i, :d] for i, d in enumerate(lens)])


def _opt(x, conv=t):
    return None if x is None else conv(x)


# --- joint attention ----------------------------------------------------------


@pytest.mark.parametrize("mask_kind", ["duration", "pad", "none"])
@pytest.mark.parametrize("context_pre_only", [False, True])
@pytest.mark.parametrize("qk_norm", [None, "rms_norm"])
def test_joint_attention_forms_match_jax(mask_kind, context_pre_only, qk_norm):
    rng = np.random.default_rng(5)
    d, heads, dh, nx, nc = 64, 4, 16, 40, 11
    p = jmod.attention_init(jax.random.PRNGKey(3), d, heads, dh, qk_norm=qk_norm, context_dim=d,
                            context_pre_only=context_pre_only)
    flat = {k: np.asarray(v) for k, v in flatten_tree(p).items()}
    for k in flat:  # the qk-norm gains away from 1
        if k.endswith("norm/g"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    pp = params_from_jax(flat, device="cpu")
    x = rng.standard_normal((2, nx, d)).astype(np.float32)
    c = rng.standard_normal((2, nc, d)).astype(np.float32)
    mask = {"duration": np.arange(nx)[None] < np.asarray([40, 23])[:, None],
            "pad": (np.arange(nx) < 31)[None], "none": None}[mask_kind]
    rope = [np.asarray(a) for a in jmod.rope_cos_sin(nx, dh)]
    c_rope = [np.asarray(a) for a in jmod.rope_cos_sin(nc, dh)]
    jx, jc = jmod.joint_attention(jp, jnp.asarray(x), jnp.asarray(c), heads,
                                  mask=_opt(mask, jnp.asarray),
                                  rope=tuple(map(jnp.asarray, rope)),
                                  c_rope=tuple(map(jnp.asarray, c_rope)),
                                  context_pre_only=context_pre_only)
    outs = {}
    for kernels in (True, False):
        outs[kernels] = pmod.joint_attention(pp, t(x), t(c), heads, mask=_opt(mask),
                                             rope=tuple(map(t, rope)), c_rope=tuple(map(t, c_rope)),
                                             context_pre_only=context_pre_only, kernels=kernels)
    lens = {"duration": [40, 23], "pad": [31, 31], "none": [nx, nx]}[mask_kind]
    for px, pc in outs.values():
        assert rel_err(_valid(px.numpy(), lens), _valid(jx, lens)) < REL
        assert rel_err(pc.numpy(), np.asarray(jc)) < REL
        assert pc.shape[-1] == (heads * dh if context_pre_only else d)
    # text-first prefix form and explicit-mask form against each other
    assert rel_err(_valid(outs[True][0].numpy(), lens), _valid(outs[False][0].numpy(), lens)) < REL
    assert rel_err(outs[True][1].numpy(), outs[False][1].numpy()) < REL
    if mask is not None:  # masked audio rows are zero in both forms
        for px, _ in outs.values():
            assert px.numpy()[~np.broadcast_to(mask, (2, nx))].max(initial=0) == 0


# --- the backbone -----------------------------------------------------------


@pytest.mark.parametrize("mask_kind", ["duration", "pad", "none"])
@pytest.mark.parametrize("qk_norm", [None, "rms_norm"])
def test_mmdit_forward_matches_jax(mask_kind, qk_norm):
    jcfg, pcfg, jp, pp = mmdit_pair(qk_norm=qk_norm)
    x, cond, text, time = _inputs()
    mask = np.arange(N)[None, :] < LENS[:, None] if mask_kind == "duration" else None
    pad_mask = (np.arange(N) < 80)[None] if mask_kind == "pad" else None
    want = jmmdit.mmdit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                                jnp.asarray(time), mask=_opt(mask, jnp.asarray),
                                drop_audio_cond=jnp.asarray(0.0), drop_text=jnp.asarray(1.0),
                                pad_mask=_opt(pad_mask, jnp.asarray))
    for kernels in (True, False):
        got = pmmdit.mmdit_forward(pp, pcfg, t(x), t(cond), t(text), t(time), mask=_opt(mask),
                                   drop_audio_cond=torch.tensor(0.0), drop_text=torch.tensor(1.0),
                                   pad_mask=_opt(pad_mask), kernels=kernels)
        lens = {"duration": LENS, "pad": [80, 80], "none": [N, N]}[mask_kind]
        assert np.abs(_valid(got.numpy(), lens)).max() > 0.1
        assert rel_err(_valid(got.numpy(), lens), _valid(want, lens)) < REL


@pytest.mark.parametrize("mask_kind", ["duration", "pad", "none"])
def test_mmdit_forward_cfg_matches_jax(mask_kind):
    jcfg, pcfg, jp, pp = mmdit_pair(seed=2)
    x, cond, text, time = _inputs(3)
    mask = np.arange(N)[None, :] < LENS[:, None] if mask_kind == "duration" else None
    pad_mask = (np.arange(N) < 80)[None] if mask_kind == "pad" else None
    te = [jmmdit.mmdit_text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), drop_text=dr)
          for dr in (False, True)]
    want = jmmdit.mmdit_forward_cfg(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), *te,
                                    jnp.asarray(time), 2.0, mask=_opt(mask, jnp.asarray),
                                    pad_mask=_opt(pad_mask, jnp.asarray))
    tp = [pmmdit.mmdit_text_embedding(pp["text_embed"], pcfg, t(text), drop_text=dr)
          for dr in (False, True)]
    for a, b in zip(tp, te):
        assert rel_err(a.numpy(), np.asarray(b)) < 1e-6
    got = pmmdit.mmdit_forward_cfg(pp, pcfg, t(x), t(cond), *tp, t(time), 2.0, mask=_opt(mask),
                                   pad_mask=_opt(pad_mask))
    lens = {"duration": LENS, "pad": [80, 80], "none": [N, N]}[mask_kind]
    assert rel_err(_valid(got.numpy(), lens), _valid(want, lens)) < REL


def test_text_positions_past_the_table_take_its_last_row():
    jcfg, pcfg, jp, pp = mmdit_pair()
    text = np.random.default_rng(0).integers(0, 49, (1, 1030)).astype(np.int32)
    want = jmmdit.mmdit_text_embedding(jp["text_embed"], jcfg, jnp.asarray(text))
    got = pmmdit.mmdit_text_embedding(pp["text_embed"], pcfg, t(text))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-6


def test_fresh_mmdit_is_gated_off_and_redraw_opens_it():
    """AdaLN-zero (mmdit.py:66-74): a fresh MMDiT's flow is exactly zero;
    redraw_zero_init re-draws every block's two AdaLN layers, norm_out and
    proj_out."""
    pcfg = MMDiTConfig(**TINY_MMDIT)
    pp = pmmdit.init_mmdit(pcfg, seed=0, device="cpu")
    x, cond, text, time = _inputs()
    zero = pmmdit.mmdit_forward(pp, pcfg, t(x), t(cond), t(text), t(time))
    assert zero.abs().max() == 0
    for blk in pp["blocks"]:
        assert all(blk[n]["linear"]["w"].abs().max() == 0 for n in ("attn_norm_x", "attn_norm_c"))
    redraw_zero_init(pp, seed=1)
    for blk in pp["blocks"]:
        assert all(blk[n]["linear"]["w"].abs().max() > 0 for n in ("attn_norm_x", "attn_norm_c"))
    assert pmmdit.mmdit_forward(pp, pcfg, t(x), t(cond), t(text), t(time)).abs().max() > 0.1
    # the last block is context_pre_only: no ff_c, no to_out_c, a 2-way AdaLN
    last = pp["blocks"][-1]
    assert "ff_c" not in last and "to_out_c" not in last["attn"]
    assert last["attn_norm_c"]["linear"]["w"].shape == (2 * pcfg.dim, pcfg.dim)

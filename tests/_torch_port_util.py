"""Shared fixtures of the torch-port parity tests: one tiny model, built once
in the JAX package and handed to the port through the weight converter.

The AdaLN-zero layers are re-drawn (numpy, seeded) before anything is
compared: freshly initialised they gate every block off and make the mel
exactly zero, so a wrong port would still match.
"""

from __future__ import annotations

import functools
import math

import jax
import numpy as np
import torch

from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.vocos import VocosConfig as JaxVocosConfig
from korean_f5_tts_tpu.models.vocos import init_vocos as jax_init_vocos
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.vocos import VocosConfig
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32,
            conv_layers=2, text_num_embeds=50)
TINY_VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
ZERO_INIT = ("attn_norm/linear/", "norm_out/linear/", "proj_out/")


def tiny_configs():
    return JaxDiTConfig(**TINY), DiTConfig(**TINY)


def redraw_zero_layers(flat: dict, seed: int) -> dict:
    """Uniform +-1/sqrt(d_in) for every AdaLN-zero leaf (JAX [d_in, d_out])."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    weights = {k: v for k, v in flat.items() if k.endswith("/w")}
    for k, v in flat.items():
        if any(z in k for z in ZERO_INIT):
            d_in = weights[k[:-1] + "w"].shape[0]
            bound = 1.0 / math.sqrt(d_in)
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=4)
def tiny_dit(seed: int = 0):
    """(jax params, port params, flat numpy params) of one tiny DiT; cached, so
    callers must not modify them."""
    jcfg, _ = tiny_configs()
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    return jparams, params_from_jax(flat), flat


@functools.lru_cache(maxsize=2)
def tiny_vocos(seed: int = 1):
    """(jax config, jax params, port config, port params) of one tiny Vocos."""
    jcfg = JaxVocosConfig(**TINY_VOCOS)
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jax_init_vocos(jax.random.PRNGKey(seed), jcfg)).items()}
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    return jcfg, jparams, VocosConfig(**TINY_VOCOS), params_from_jax(flat)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def t(x) -> torch.Tensor:
    """numpy -> torch (copy)."""
    return torch.from_numpy(np.array(x))

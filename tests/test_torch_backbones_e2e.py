"""The three backbones' samplers in the port against the JAX package, on the
CPU: the 16-step sampler in bf16 and the generic CFG step in fp32
(tests/test_torch_backbones_loss.py: the training loss and its gradients;
tests/test_torch_backbones_entry.py: checkpoints, configs, entry points).

Tiny models (dim 64, depth 2, 4 heads x 16) are built by the JAX package,
their AdaLN-zero layers re-drawn, and handed over through the converter.

Tolerances, with their reasons:
  - cfm_sample in bf16, 16 steps with CFG (EPSS, sway -1): relative L2 2e-2
    on the valid rows, the bf16 bound of the port's sampler-step tests
    (tests/test_torch_attn_paths.py BF16_REL): XLA on the CPU rounds bf16 at
    other points than PyTorch (measured 5e-3 to 6e-3 here, against 7e-3
    between JAX's own bf16 and fp32 samplers);
  - the sampler in fp32: relative 1e-4 (8 steps, sums in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import BACKBONE_ARCH as TINY_ARCH
from _torch_port_util import backbone_pair as pair
from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts

BACKBONES = sorted(TINY_ARCH)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


def _valid(x, durs):
    x = np.asarray(x, np.float32)
    return np.concatenate([x[i, :d] for i, d in enumerate(durs)])


# --- sampling -----------------------------------------------------------------


@pytest.mark.parametrize("backbone", BACKBONES)
def test_cfm_sample_bf16_16_steps_matches_jax(backbone, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    jcfg, pcfg, jp, pp, _ = pair(backbone)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    pp16 = cast_params(pp, torch.bfloat16)
    rng = np.random.default_rng(3)
    durs, lens = np.asarray([100, 120]), np.asarray([30, 24])
    cond = rng.standard_normal((2, 30, 100)).astype(np.float32)
    text = np.full((2, 21), -1, np.int32)
    text[0, :21] = rng.integers(0, 49, 21)
    text[1, :12] = rng.integers(0, 49, 12)
    y0 = rng.standard_normal((2, 128, 100)).astype(np.float32)
    kw = dict(lens=lens, steps=16, cfg_strength=2.0, sway_sampling_coef=-1.0)
    want, _ = jcfm.cfm_sample(jp16, jcfg, jnp.asarray(cond, jnp.bfloat16), text, durs,
                              y0=jnp.asarray(y0, jnp.bfloat16), **kw)
    got, _ = pcfm.cfm_sample(pp16, pcfg, cond, text, durs, y0=t(y0), duration_bucket=128, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.abs(_valid(got.float().numpy(), durs)).max() > 0.1
    assert rel_err(_valid(got.float().numpy(), durs), _valid(want, durs)) < 2e-2


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
@pytest.mark.parametrize("use_cfg", [True, False])
def test_sample_core_fp32_matches_jax(backbone, use_cfg):
    """The generic CFG step (and the step without CFG) over 8 Euler steps
    under a duration mask and a bucket-tail mask, fp32: relative 1e-4."""
    jcfg, pcfg, jp, pp, _ = pair(backbone, seed=1)
    rng = np.random.default_rng(4)
    n, durs = 128, np.asarray([128, 101])
    dur_mask = np.arange(n)[None] < durs[:, None]
    pad_mask = (np.arange(n) < durs.max())[None]
    step_cond = np.where(np.arange(n)[None, :, None] < 30,
                         rng.standard_normal((2, n, 100)), 0).astype(np.float32)
    text = rng.integers(0, 49, (2, 17)).astype(np.int32)
    y0 = np.where(dur_mask[..., None], rng.standard_normal((2, n, 100)), 0).astype(np.float32)
    cfg = 2.0 if use_cfg else 0.0
    want = jcfm._sample_core(jp, jcfg, jnp.asarray(step_cond), jnp.asarray(text),
                             jnp.asarray(dur_mask), jnp.asarray(pad_mask), jnp.asarray(y0),
                             jnp.asarray(cfg), jnp.asarray(-1.0), steps=8, use_cfg=use_cfg,
                             use_sway=True, use_epss=True)
    got = pcfm._sample_core(pp, pcfg, t(step_cond), t(text), t(dur_mask), t(pad_mask), t(y0),
                            cfg, -1.0, steps=8, use_cfg=use_cfg, use_sway=True, use_epss=True)
    assert rel_err(_valid(got.numpy(), durs), _valid(want, durs)) < 1e-4


def test_mmdit_text_is_never_bucketed():
    """An MMDiT's attention sees every text position, so serve_sample and
    cfm_sample keep its text length (cfm.py:328, :574-578); DiT and UNetT
    pad to the text bucket."""
    text = np.zeros((1, 21), np.int32)
    for backbone in BACKBONES:
        arch = pconfig.BACKBONE_CONFIGS[backbone](**TINY_ARCH[backbone])
        want = 21 if backbone == "MMDiT" else 64
        assert pcfm.bucket_text(text, 64, arch).shape[1] == want

"""The port's sampler and serving glue against the JAX package, end to end, in fp32.

A tiny DiT (depth 2, dim 64) built by the JAX package goes to the port
through the converter; seeded numpy inputs and noise go to both. On the CPU
the JAX side takes its XLA paths and the port its plain versions, so this
holds the port's algorithm to the JAX one; fp32 keeps the comparison tight
(relative 1e-4 for composites: fp32 summation order over 16 Euler steps).
Only valid rows [0, duration) are compared: bucket-tail rows are never
zeroed per block, in either package.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_port_util import rel_err, t, tiny_configs, tiny_dit, tiny_vocos
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.utils.timesteps import make_schedule

REL = 1e-4
N, LENS, DURS = 128, np.asarray([30, 41]), np.asarray([100, 120])


@pytest.fixture(scope="module")
def case():
    """Inputs of one batch of 2 with per-item durations, and the JAX mel."""
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
    mel = jcfm._sample_core(jparams, jcfg, jnp.asarray(step_cond), jnp.asarray(text),
                            jnp.asarray(dur_mask), jnp.asarray(pad_mask), jnp.asarray(y0),
                            jnp.asarray(2.0), jnp.asarray(-1.0), steps=16, use_cfg=True,
                            use_sway=True, use_epss=True)
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams, pparams=pparams, cond=cond,
                step_cond=step_cond, text=text, y0=y0, dur_mask=dur_mask,
                pad_mask=pad_mask, cond_mask=cond_mask, jax_mel=np.asarray(mel))


def _valid(x):
    return np.concatenate([x[i, :d] for i, d in enumerate(DURS)])


def test_sample_core_16_nfe_epss_sway(case):
    reset_launch_counts()
    got = pcfm._sample_core(case["pparams"], case["pcfg"], t(case["step_cond"]),
                            t(case["text"]), t(case["dur_mask"]), t(case["pad_mask"]),
                            t(case["y0"]), 2.0, -1.0, steps=16, use_cfg=True,
                            use_sway=True, use_epss=True)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert rel_err(_valid(got.numpy()), _valid(case["jax_mel"])) < REL
    # the schedule is the JAX package's EPSS table
    from korean_f5_tts_tpu.utils.timesteps import make_schedule as jax_schedule

    np.testing.assert_array_equal(make_schedule(16, sway_sampling_coef=-1.0),
                                  jax_schedule(16, sway_sampling_coef=-1.0))


def test_serve_sample_with_injected_noise_matches_jax_composition(case):
    """serve_sample's glue (masks, cond padding, splice, replicate pad, Vocos,
    RMS restore, int16) against the same steps composed from JAX functions."""
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    scale = np.asarray([1.0, 0.5], np.float32)
    out = np.where(case["cond_mask"][..., None], case["step_cond"], case["jax_mel"])
    out_v = np.concatenate([out, out[:, -1:]], axis=1)
    wav = np.asarray(jax_vocos_decode(jvparams, jnp.asarray(out_v.transpose(0, 2, 1)), jvcfg))
    want = np.round(np.clip(wav * scale[:, None], -1, 1) * 32767.0).astype(np.int16)
    got, durs = pcfm.serve_sample(
        case["pparams"], case["pcfg"], t(case["cond"]), case["text"], DURS, LENS,
        vocoder_fused=(pvparams, pvcfg), seed=0, wav_scale=scale, duration_bucket=128,
        y0=t(case["y0"]))
    np.testing.assert_array_equal(durs, DURS)
    assert got.dtype == torch.int16 and got.shape == want.shape == (2, N * 256)
    got = got.numpy()
    for i, d in enumerate(DURS):
        diff = np.abs(got[i, : d * 256].astype(np.int32) - want[i, : d * 256].astype(np.int32))
        assert diff.max() <= 2, diff.max()  # fp32 agreement, int16 rounding
        assert np.abs(got[i, LENS[i] * 256: d * 256]).mean() > 0


def test_seeded_noise_is_shared_by_identical_seeds():
    noise = pcfm.draw_noise([5, 5, 6], 64, 100, "cpu", torch.float32)
    torch.testing.assert_close(noise[0], noise[1], rtol=0, atol=0)
    assert not torch.equal(noise[0], noise[2])

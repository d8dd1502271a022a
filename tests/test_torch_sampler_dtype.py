"""The sampler's compute dtype against the JAX package's rule, on the CPU:
cond's dtype wins. cfm_sample on fp32 cond beside bf16 weights (or int8
weights over bf16) runs fp32 activations on the weights widened once per
call (models/cfm.py:weights_at), the text embedding in its table's dtype,
as the JAX sampler casts each weight to the activation's dtype where it
uses it (modules.py:47-55, dit.py:217-229); serve_sample alone runs the
whole graph in bf16 (cfm.py:250-257).

Tiny models of the three backbones (tests/_torch_port_util.py:
backbone_pair: dim 64, depth 2, 4 heads of 16) built by the JAX package.

Tolerances, with their reasons (relative L2 on the valid rows):
  - bf16 or int8 weights on fp32 cond against JAX's cfm_sample: the DiT
    2e-3, the bound of tests/test_torch_flagship_parity.py: its ConvNeXt
    text blocks run in the table's bf16, where XLA on the CPU rounds at
    other points than PyTorch (it keeps the exact GELU's erfc argument in
    fp32 and rounds a product before adding its bias; measured 5.5e-5 bf16,
    2.1e-4 int8); the UNetT and the MMDiT here have no text blocks, so
    nothing rounds below fp32 but the weights, alike in both: 1e-5
    (measured 2e-7, as fp32 weights);
  - serve_sample, all-bf16, against JAX's _sample_core on bf16 inputs: 2e-2,
    the bf16 bound of tests/test_torch_backbones_e2e.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import backbone_pair, rel_err, t, tiny_vocos
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.quant import quantize_params
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts

DURS, LENS, N = np.asarray([100, 120]), np.asarray([30, 24]), 128
BOUNDS = {"DiT": 2e-3, "UNetT": 1e-5, "MMDiT": 1e-5}
SAMPLER = dict(lens=LENS, steps=16, cfg_strength=2.0, sway_sampling_coef=-1.0)


@pytest.fixture(autouse=True)
def _no_launches():
    torch.set_num_threads(2)
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


def _inputs():
    """A batch of 2 under the duration mask: cond [2, 30, 100] with lens 30
    and 24, text of 21 and 12 ids, durations 100 and 120, noise [2, 128, 100]."""
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((2, 30, 100)).astype(np.float32)
    text = np.full((2, 21), -1, np.int32)
    text[0, :21] = rng.integers(0, 49, 21)
    text[1, :12] = rng.integers(0, 49, 12)
    return cond, text, rng.standard_normal((2, N, 100)).astype(np.float32)


def _valid(x):
    x = np.asarray(x, np.float32)
    return np.concatenate([x[i, :d] for i, d in enumerate(DURS)])


def _bf16(jp, pp):
    return (jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp),
            cast_params(pp, torch.bfloat16))


@pytest.mark.parametrize("weights,backbone", [
    ("bf16", "DiT"), ("bf16", "UNetT"), ("bf16", "MMDiT"), ("int8", "DiT")])
def test_narrow_weights_on_fp32_cond_match_the_jax_sampler(weights, backbone, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    jcfg, pcfg, jp, pp, _ = backbone_pair(backbone)
    jp, pp = _bf16(jp, pp)
    if weights == "int8":
        jp, pp = jquant.quantize_params(jp), quantize_params(pp)
    cond, text, y0 = _inputs()
    want, _ = jcfm.cfm_sample(jp, jcfg, cond, text, DURS, y0=jnp.asarray(y0), **SAMPLER)
    got, _ = pcfm.cfm_sample(pp, pcfg, cond, text, DURS, y0=t(y0), duration_bucket=N, **SAMPLER)
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(_valid(got.numpy())).max() > 0.1
    assert rel_err(_valid(got.numpy()), _valid(want)) < BOUNDS[backbone]


def test_weights_widen_once_per_call_and_the_text_table_keeps_its_dtype(monkeypatch):
    """A batch in two duration buckets samples each group with one tree:
    the block weights widened to fp32 once for the call, the text
    embedding's table left bf16, int8 weights and their scales kept."""
    _, pcfg, _, pp, _ = backbone_pair("DiT")
    tree = quantize_params(cast_params(pp, torch.bfloat16))
    seen = []
    real = pcfm._sample_core

    def spy(params, *args, **kw):
        seen.append(params)
        return real(params, *args, **kw)

    monkeypatch.setattr(pcfm, "_sample_core", spy)
    cond, text, _ = _inputs()
    out, _ = pcfm.cfm_sample(tree, pcfg, cond, text, np.asarray([100, 250]), steps=2,
                             cfg_strength=2.0, seed=0, duration_bucket=N)
    assert len(seen) == 2 and seen[0] is seen[1] and out.dtype == torch.float32
    wide = seen[0]
    assert {v.dtype for v in pcfm._leaves(wide["text_embed"])} == {torch.bfloat16}
    blk = wide["blocks"][0]
    assert blk["attn"]["to_q"]["w_int8"].dtype == torch.int8
    assert blk["attn"]["to_q"]["w_scale"].dtype == torch.float32
    assert blk["attn"]["to_q"]["b"].dtype == torch.float32
    assert blk["attn_norm"]["linear"]["w"].dtype == torch.float32
    assert wide["conv_pos_embed"]["conv1"]["w"].dtype == torch.float32
    # nothing to widen: the tree itself, no copy
    assert pcfm.weights_at(pp, torch.float32) is pp
    assert pcfm.weights_at(tree, torch.bfloat16) is tree


def test_serve_sample_stays_all_bf16_and_matches_jax(monkeypatch):
    """serve_sample casts cond and noise to bf16 beside bf16 weights (the
    served headline mode, JAX cfm.py:250-257): its sampler sees bf16 only,
    and its mel matches JAX's _sample_core on the same bf16 inputs."""
    jcfg, pcfg, jp, pp, _ = backbone_pair("DiT")
    jp, pp = _bf16(jp, pp)
    _, _, pvcfg, pvparams = tiny_vocos()
    cond, text, y0 = _inputs()
    cond_b = np.zeros((2, N, 100), np.float32)
    cond_b[:, :30] = cond
    seen = {}
    real = pcfm._sample_core_vocos

    def spy(params, voc, arch, step_cond, text_t, mask, pad_mask, y0_t, *args, **kw):
        mel, wav = real(params, voc, arch, step_cond, text_t, mask, pad_mask, y0_t, *args, **kw)
        seen.update(step_cond=step_cond, y0=y0_t, mel=mel)
        return mel, wav

    monkeypatch.setattr(pcfm, "_sample_core_vocos", spy)
    wav, _ = pcfm.serve_sample(pp, pcfg, t(cond_b), text, DURS, LENS,
                               vocoder_fused=(cast_params(pvparams, torch.bfloat16), pvcfg),
                               seed=0, duration_bucket=N, y0=t(y0))
    assert wav.dtype == torch.int16
    assert seen["step_cond"].dtype == seen["y0"].dtype == torch.bfloat16
    assert seen["mel"].dtype == torch.bfloat16
    ar = np.arange(N)
    dur_mask = ar[None, :] < DURS[:, None]
    want = jcfm._sample_core(
        jp, jcfg, jnp.asarray(seen["step_cond"].float().numpy(), jnp.bfloat16),
        jnp.asarray(np.pad(text, ((0, 0), (0, 64 - text.shape[1])), constant_values=-1)),
        jnp.asarray(dur_mask), jnp.asarray((ar < DURS.max())[None, :]),
        jnp.asarray(seen["y0"].float().numpy(), jnp.bfloat16), jnp.asarray(2.0, jnp.bfloat16),
        jnp.asarray(-1.0, jnp.bfloat16), steps=16, use_cfg=True, use_sway=True,
        use_epss=True)
    assert want.dtype == jnp.bfloat16
    # _sample_core_vocos returns the mel with cond spliced back
    want = np.where((ar[None, :] < LENS[:, None])[..., None], seen["step_cond"].float().numpy(),
                    np.asarray(want.astype(jnp.float32)))
    assert rel_err(_valid(seen["mel"].float().numpy()), _valid(want)) < 2e-2


def test_long_skip_dit_samples_as_jax(monkeypatch):
    """A DiT with long_skip_connection through cfm_sample's CFG step, whose
    backbone (dit_backbone_premod) concatenates the block stack's input to
    its output and projects it back, as dit.py:340, :522-523: fp32, the
    sampler's bound 1e-4 (tests/test_torch_sampler.py)."""
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    jcfg, pcfg, jp, pp, _ = backbone_pair("DiT", long_skip_connection=True)
    assert "long_skip" in pp
    cond, text, y0 = _inputs()
    want, _ = jcfm.cfm_sample(jp, jcfg, cond, text, DURS, y0=jnp.asarray(y0), **SAMPLER)
    got, _ = pcfm.cfm_sample(pp, pcfg, cond, text, DURS, y0=t(y0), duration_bucket=N, **SAMPLER)
    assert rel_err(_valid(got.numpy()), _valid(want)) < 1e-4

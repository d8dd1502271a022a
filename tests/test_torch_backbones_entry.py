"""The three backbones' entry points in the port against the JAX package, on
the CPU: the reference-checkpoint route of load_model (bit-exact), the
configs and presets, the int8 patterns, F5TTS per backbone and the inits'
default device. Tiny models (dim 64, depth 2, 4 heads x 16) are built by
the JAX package and handed over through the converter.
"""

import dataclasses

import numpy as np
import pytest

import torch

from _torch_port_util import BACKBONE_ARCH as TINY_ARCH
from _torch_port_util import backbone_pair as pair
from korean_f5_tts_tpu import config as jconfig
from korean_f5_tts_tpu.infer.model import load_checkpoint_into_pytree as jax_load_tree
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.infer.model import load_model
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as pflatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax
from korean_f5_tts_tpu_torch.utils import torch_ckpt

BACKBONES = sorted(TINY_ARCH)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions


# --- checkpoints ------------------------------------------------------------------


def _write_pt(path, sd: dict) -> str:
    torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": torch.from_numpy(np.array(v))
                                         for k, v in sd.items()}}, str(path))
    return str(path)


@pytest.mark.parametrize("skip", ["concat", "add"])
@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_load_model_takes_a_reference_unett_checkpoint(skip, suffix, tmp_path):
    """A reference-format UNetT file (unett_state_dict of seeded weights, q/k
    in the interleaved rope layout) through load_model equals the .npz route
    to the bit, and the JAX package's converter reads the same tree."""
    from safetensors.numpy import save_file

    jcfg, pcfg, _, _, flat = pair("UNetT", seed=3, qk_norm="rms_norm", skip_connect_type=skip)
    sd = torch_ckpt.unett_state_dict(unflatten_tree(flat), pcfg.heads, pcfg.dim_head)
    if suffix == ".pt":
        path = _write_pt(tmp_path / "e2.pt", sd)
    else:
        path = str(tmp_path / "e2.safetensors")
        save_file({f"ema_model.transformer.{k}": np.ascontiguousarray(v) for k, v in sd.items()},
                  path)
    npz = tmp_path / "e2.npz"
    np.savez(npz, **{f"ema_params/{k}": v for k, v in flat.items()})
    mcfg = pconfig.ModelConfig(name="tiny", backbone="UNetT", arch=pcfg)
    got = pflatten(load_model(mcfg, ckpt_path=path, device="cpu").params)
    ref = pflatten(load_model(mcfg, ckpt_path=str(npz), device="cpu").params)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    jtree = flatten_tree(jax_load_tree(path, jcfg, "UNetT"))
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(jtree[k]), v, err_msg=k)


def test_mmdit_torch_checkpoint_raises_as_in_jax(tmp_path):
    jcfg, pcfg, _, _, _ = pair("MMDiT")
    path = _write_pt(tmp_path / "mm.pt", {"proj_out.weight": np.zeros((100, 64), np.float32)})
    mcfg = pconfig.ModelConfig(name="tiny", backbone="MMDiT", arch=pcfg)
    with pytest.raises(ValueError, match="not implemented for backbone MMDiT"):
        load_model(mcfg, ckpt_path=path, device="cpu")
    with pytest.raises(ValueError, match="not implemented for backbone MMDiT"):
        jax_load_tree(path, jcfg, "MMDiT")
    with pytest.raises(ValueError, match="backbone"):  # a config whose arch is another's
        load_model(pconfig.ModelConfig(backbone="DiT", arch=pcfg), device="cpu")


@pytest.mark.parametrize("backbone", BACKBONES)
def test_load_model_initialises_every_backbone_with_the_jax_tree(backbone):
    jcfg, pcfg, _, _, flat = pair(backbone)
    model = load_model(pconfig.ModelConfig(name="tiny", backbone=backbone, arch=pcfg),
                       device="cpu", seed=5)
    got = params_to_jax(model.params)
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert got[k].shape == v.shape, k


# --- configs, presets, int8 patterns ----------------------------------------------


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match_jax(name):
    want, got = jconfig.preset_model_config(name), pconfig.preset_model_config(name)
    assert got.backbone == want.backbone and type(got.arch).__name__ == type(want.arch).__name__
    assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
    assert sorted(pconfig.PRESETS) == sorted(jconfig.PRESETS)


@pytest.mark.parametrize("name", ["E2TTS_Base", "E2TTS_Small", "F5TTS_Small", "F5TTS_v1_Base"])
def test_yaml_configs_match_jax(name):
    want = jconfig.load_model_config(f"configs/{name}.yaml")
    got = pconfig.load_model_config(f"configs/{name}.yaml")
    assert got.backbone == want.backbone and got.name == want.name
    assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_quantize_patterns_match_jax(backbone):
    """DEFAULT_QUANT_PATTERNS rewrite the same linears in both packages: a
    UNetT's attention and FF, an MMDiT's attention projections of the audio
    stream only (ff_x/in is not ff/in)."""
    from korean_f5_tts_tpu.models.quant import quantize_params as jquant
    from korean_f5_tts_tpu_torch.models.quant import quantize_params as pquant

    _, _, jp, pp, _ = pair(backbone)
    jq = {k for k in flatten_tree(jquant(jp)) if k.endswith("w_int8")}
    pq = {k for k in flatten_tree(pquant(pp)) if k.endswith("w_int8")}
    assert jq == pq and jq
    if backbone == "MMDiT":
        assert not any("ff_" in k or "_c/" in k for k in pq)
    else:
        assert any("/ff/in/" in k for k in pq)


# --- the entry points -------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["UNetT", "MMDiT"])
def test_f5tts_infers_with_each_backbone_on_the_cpu(backbone, tmp_path):
    """api.F5TTS on a tiny yaml of each new backbone, once with int8 weights
    (quantize=True: kernel 9's plain version per matched linear)."""
    import yaml
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch import api as papi

    cfg = tmp_path / "tiny.yaml"
    yaml.safe_dump({"model": {"name": "tiny", "backbone": backbone,
                              "arch": dict(TINY_ARCH[backbone], text_num_embeds=256),
                              "tokenizer": "byte"}}, open(cfg, "w"))
    sr = 24_000
    tt = np.arange(int(2.0 * sr)) / sr
    ref = tmp_path / "ref.wav"
    wavfile.write(ref, sr, (0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * tt) * tt) * 32767)
                  .astype(np.int16))
    for quantize in (False, True):
        tts = papi.F5TTS(str(cfg), device="cpu", quantize=quantize, seed=2)
        assert tts.ema_model.arch == pconfig.BACKBONE_CONFIGS[backbone](
            **dict(TINY_ARCH[backbone], text_num_embeds=256))
        int8 = [k for k in pflatten(tts.ema_model.params) if k.endswith("w_int8")]
        assert bool(int8) == quantize
        wav, out_sr, spec = tts.infer(str(ref), "A reference.", "Say this.", nfe_step=2, seed=1,
                                      show_info=lambda m: None)
        assert out_sr == sr and np.isfinite(wav).all() and np.abs(wav).max() > 0
        assert spec.shape[0] == 100


@pytest.mark.parametrize("backbone", BACKBONES)
def test_inits_default_to_the_card(backbone):
    """Each backbone's init runs on the card unless told otherwise; without
    one it raises (the CPU only when named)."""
    from korean_f5_tts_tpu_torch.infer.model import _INIT_FNS

    arch = pconfig.BACKBONE_CONFIGS[backbone](**TINY_ARCH[backbone])
    assert _INIT_FNS[backbone](arch, device="cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _INIT_FNS[backbone](arch)

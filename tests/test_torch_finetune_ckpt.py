"""Reference torch checkpoints into the port, against the JAX package, on the CPU.

Tiny DiTs (dim 64, depth 2) shaped as F5TTS_v1_Base and as F5TTS_Base
(pe_attn_head 1, no text mask padding) are drawn by the JAX package
(AdaLN-zero layers re-drawn) and written in the reference's names and
layouts by this file's own reverse map (the inverse of
tests/test_ckpt_convert_studio.py:_torch_style_state_dict, q/k columns back
to the interleaved rope layout): a plain state dict, an EMA one
("ema_model.transformer.*" inside ema_model_state_dict, with "initted" and
"step"), and one carrying PEFT LoRA pairs, each saved as .pt and as
.safetensors. Both packages load each file; their trees must be equal leaf
for leaf (the same numpy converter runs in both), and one CFG step of the
port on its tree must agree with the JAX step on the JAX tree within
relative 1e-5 (fp32; summation order). A Vocos state dict goes through both
convert_vocoder scripts: the .npz files are equal and one decode through
each load_vocoder agrees within relative 1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

from _torch_port_util import TINY, TINY_VOCOS, redraw_zero_layers, rel_err, t, tiny_vocos
from korean_f5_tts_tpu import api as japi
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.infer.model import load_checkpoint_into_pytree as jax_load_tree
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.scripts import convert_vocoder as jconv
from korean_f5_tts_tpu.train.checkpoint import flatten_tree as jflatten
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch.config import DiTConfig, ModelConfig
from korean_f5_tts_tpu_torch.infer.model import load_checkpoint_into_pytree, load_model
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import convert_vocoder as pconv
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_to_jax, unflatten_tree
from korean_f5_tts_tpu_torch.utils import torch_ckpt

REL = 1e-5
SHAPES = {  # the two published DiT configurations, at the tiny size
    "v1_base": dict(text_mask_padding=True, pe_attn_head=None),
    "base": dict(text_mask_padding=False, pe_attn_head=1),
}
LORA_RANK = 4


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@functools.lru_cache(maxsize=8)
def _tree(shape: str, seed: int = 0):
    """(jax config, port config, flat numpy JAX-layout params) of one tiny DiT;
    cached, so callers must not modify it."""
    jcfg = JaxDiTConfig(**TINY, **SHAPES[shape])
    flat = jflatten(jdit.init_dit(jax.random.PRNGKey(seed), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    return jcfg, DiTConfig(**TINY, **SHAPES[shape]), flat


def reference_state_dict(flat: dict, heads: int, dim_head: int) -> dict:
    """A JAX-layout tree (flat) -> the reference DiT's state dict, written
    here independently of utils/torch_ckpt.py."""
    tree = unflatten_tree(flat)
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T.copy()
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"]).copy()

    def conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(2, 1, 0).copy()
        sd[f"{name}.bias"] = np.asarray(p["b"]).copy()

    lin("time_embed.time_mlp.0", tree["time_embed"]["mlp1"])
    lin("time_embed.time_mlp.2", tree["time_embed"]["mlp2"])
    sd["text_embed.text_embed.weight"] = tree["text_embed"]["embed"]["w"].copy()
    for i, blk in enumerate(tree["text_embed"]["blocks"]):
        pre = f"text_embed.text_blocks.{i}"
        conv(f"{pre}.dwconv", blk["dwconv"])
        sd[f"{pre}.norm.weight"] = blk["norm"]["g"].copy()
        sd[f"{pre}.norm.bias"] = blk["norm"]["b"].copy()
        lin(f"{pre}.pwconv1", blk["pw1"])
        sd[f"{pre}.grn.gamma"] = blk["grn"]["gamma"].copy()
        sd[f"{pre}.grn.beta"] = blk["grn"]["beta"].copy()
        lin(f"{pre}.pwconv2", blk["pw2"])
    lin("input_embed.proj", tree["input_proj"])
    conv("input_embed.conv_pos_embed.conv1d.0", tree["conv_pos_embed"]["conv1"])
    conv("input_embed.conv_pos_embed.conv1d.2", tree["conv_pos_embed"]["conv2"])
    inv = np.argsort(np.concatenate([np.arange(0, dim_head, 2), np.arange(1, dim_head, 2)]))
    full = np.concatenate([h * dim_head + inv for h in range(heads)])
    for i, blk in enumerate(tree["blocks"]):
        pre = f"transformer_blocks.{i}"
        lin(f"{pre}.attn_norm.linear", blk["attn_norm"]["linear"])
        for name in ("to_q", "to_k"):  # half-split -> interleaved, per head
            sd[f"{pre}.attn.{name}.weight"] = blk["attn"][name]["w"][:, full].T.copy()
            sd[f"{pre}.attn.{name}.bias"] = blk["attn"][name]["b"][full].copy()
        lin(f"{pre}.attn.to_v", blk["attn"]["to_v"])
        lin(f"{pre}.attn.to_out.0", blk["attn"]["to_out"])
        lin(f"{pre}.ff.ff.0.0", blk["ff"]["in"])
        lin(f"{pre}.ff.ff.2", blk["ff"]["out"])
    lin("norm_out.linear", tree["norm_out"]["linear"])
    lin("proj_out", tree["proj_out"])
    return sd


def with_lora(sd: dict, seed: int = 3) -> dict:
    """The state dict as PEFT saves a LoRA-wrapped transformer: every key
    under base_model.model., the adapted linears (to_q, to_k, to_v,
    to_out.0) as base_layer + lora_A [r, in] + lora_B [out, r], B non-zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        mod, _, leaf = k.rpartition(".")
        if any(mod.endswith(f"attn.{n}") for n in ("to_q", "to_k", "to_v", "to_out.0")):
            out[f"base_model.model.{mod}.base_layer.{leaf}"] = v
            if leaf == "weight":
                d_out, d_in = v.shape
                out[f"base_model.model.{mod}.lora_A.weight"] = (
                    rng.standard_normal((LORA_RANK, d_in)) / np.sqrt(d_in)).astype(np.float32)
                out[f"base_model.model.{mod}.lora_B.weight"] = (
                    0.1 * rng.standard_normal((d_out, LORA_RANK))).astype(np.float32)
        else:
            out[f"base_model.model.{k}"] = v
    return out


def write(sd: dict, path, form: str) -> str:
    """Save a state dict as the reference does: .pt with the EMA wrapper
    (ema_model_state_dict of ema_model.transformer.* plus initted and step,
    and an update count) or a plain model_state_dict; .safetensors flat,
    with the EMA prefix."""
    ema = {f"ema_model.transformer.{k}": v for k, v in sd.items()}
    if form == "ema.pt":
        ema.update({"ema_model.initted": np.ones(1, np.float32),
                    "ema_model.step": np.asarray([7.0], np.float32)})
        torch.save({"ema_model_state_dict": {k: torch.from_numpy(np.array(v))
                                             for k, v in ema.items()}, "update": 7},
                   str(path))
    elif form == "model.pt":
        torch.save({"model_state_dict": {f"transformer.{k}": torch.from_numpy(np.array(v))
                                         for k, v in sd.items()}}, str(path))
    else:
        save_file({k: np.ascontiguousarray(v) for k, v in ema.items()}, str(path))
    return str(path)


FORMS = ("ema.pt", "model.pt", "ema.safetensors")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_reference_checkpoint_loads_as_in_jax(tmp_path, shape, form, lora):
    jcfg, pcfg, flat = _tree(shape)
    sd = reference_state_dict(flat, TINY["heads"], TINY["dim_head"])
    if lora:
        sd = with_lora(sd)
    path = write(sd, tmp_path / f"ckpt.{form}", form)
    want = {k: np.asarray(v) for k, v in jflatten(jax_load_tree(path, jcfg, "DiT")).items()}
    model = load_model(ModelConfig(arch=pcfg), ckpt_path=path, device="cpu")
    got = params_to_jax(model.params)
    assert got.keys() == want.keys() == flat.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not lora:  # the converter inverts the reverse map exactly: no second permutation
        for k in flat:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    else:  # the merge moved exactly the adapted projections
        moved = {k for k in flat if not np.array_equal(got[k], flat[k])}
        assert moved == {f"blocks/{i}/attn/{n}/w" for i in range(TINY["depth"])
                         for n in ("to_q", "to_k", "to_v", "to_out")}


def _cfg_step(jcfg, jtree, pcfg, pparams, seed=0):
    """One CFG step (dit_forward_cfg_premod, as the sampler runs it) of both
    packages on the same numpy inputs; returns (port, jax) outputs."""
    rng = np.random.default_rng(seed)
    n, lens = 96, np.asarray([80, 96])
    text = np.full((2, 32), -1, np.int32)
    text[0, :20] = rng.integers(0, 49, 20)
    text[1, :27] = rng.integers(0, 49, 27)
    y0 = rng.standard_normal((2, n, 100)).astype(np.float32)
    cond = np.where((np.arange(n)[None, :] < 30)[..., None], rng.standard_normal((2, n, 100)),
                    0.0).astype(np.float32)
    mask = np.arange(n)[None, :] < lens[:, None]
    ts = np.asarray([0.4], np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, jtree)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=d)
          for d in (False, True)]
    mods, fin, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray(ts))
    want = jdit.dit_forward_cfg_premod(jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te,
                                       mods[0], fin[0], 2.0, mask=jnp.asarray(mask))
    tp = [pdit.text_embedding(pparams["text_embed"], pcfg, t(text), n, drop_text=d)
          for d in (False, True)]
    pmods, pfin, _ = pdit.precompute_step_modulations(pparams, pcfg, t(ts))
    got = pdit.dit_forward_cfg_premod(pparams, pcfg, t(y0), t(cond), *tp, pmods[0], pfin[0],
                                      2.0, mask=t(mask))
    valid = np.concatenate([np.arange(lens[0]), n + np.arange(lens[1])])
    flat_got = got.numpy().reshape(2 * n, -1)[valid]
    flat_want = np.asarray(want).reshape(2 * n, -1)[valid]
    return flat_got, flat_want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_cfg_step_on_a_reference_checkpoint_matches_jax(tmp_path, shape, lora):
    jcfg, pcfg, flat = _tree(shape, seed=1)
    sd = reference_state_dict(flat, TINY["heads"], TINY["dim_head"])
    path = write(with_lora(sd) if lora else sd, tmp_path / "ckpt.ema.pt", "ema.pt")
    model = load_model(ModelConfig(arch=pcfg), ckpt_path=path, device="cpu")
    got, want = _cfg_step(jcfg, jax_load_tree(path, jcfg, "DiT"), pcfg, model.params)
    assert np.abs(got).max() > 0.1  # not gated off
    assert rel_err(got, want) < REL


def test_the_port_inverse_equals_the_reference_map_and_round_trips():
    """utils/torch_ckpt.py:dit_state_dict (what chip_smoke.py writes its
    checkpoint with) is the reverse map above, and the converter undoes it."""
    for shape in SHAPES:
        _, _, flat = _tree(shape, seed=2)
        want = reference_state_dict(flat, TINY["heads"], TINY["dim_head"])
        got = torch_ckpt.dit_state_dict(unflatten_tree(flat), TINY["heads"], TINY["dim_head"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        back = flatten_tree(torch_ckpt.convert_dit_state_dict(
            got, TINY["heads"], TINY["dim_head"], TINY["depth"], TINY["conv_layers"]))
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_npz_and_torch_files_give_one_tree(tmp_path):
    """load_checkpoint_into_pytree: the .npz route prefers ema_params, the
    torch route converts; both give the JAX tree."""
    jcfg, pcfg, flat = _tree("v1_base", seed=4)
    npz = tmp_path / "a.npz"
    np.savez(npz, **{f"ema_params/{k}": v for k, v in flat.items()},
             **{f"params/{k}": np.zeros_like(v) for k, v in flat.items()})
    pt = write(reference_state_dict(flat, TINY["heads"], TINY["dim_head"]),
               tmp_path / "a.pt", "ema.pt")
    for path in (str(npz), pt):
        tree = flatten_tree(load_checkpoint_into_pytree(path, pcfg))
        want = jflatten(jax_load_tree(path, jcfg, "DiT"))
        assert tree.keys() == want.keys() == flat.keys()
        for k in flat:
            np.testing.assert_array_equal(tree[k], flat[k])
            np.testing.assert_array_equal(np.asarray(want[k]), flat[k])
    # an MMDiT has no torch-checkpoint route in either package
    for load, cfg in ((load_checkpoint_into_pytree, pcfg), (jax_load_tree, jcfg)):
        with pytest.raises(ValueError, match="not implemented for backbone MMDiT"):
            load(pt, cfg, "MMDiT")


def test_f5tts_takes_a_reference_checkpoint(tmp_path):
    """api.F5TTS(ckpt_file=.pt) holds the converted tree."""
    import yaml

    _, pcfg, flat = _tree("base", seed=5)
    arch = {k: v for k, v in dataclasses.asdict(pcfg).items()
            if k in (*TINY, *SHAPES["base"])}
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": arch,
                              "tokenizer": "byte"}}, open(tmp_path / "tiny.yaml", "w"))
    pt = write(reference_state_dict(flat, TINY["heads"], TINY["dim_head"]),
               tmp_path / "m.safetensors", "ema.safetensors")
    tts = papi.F5TTS(str(tmp_path / "tiny.yaml"), ckpt_file=pt, device="cpu")
    got = params_to_jax(tts.ema_model.params)
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])


def reference_vocos_state_dict(flat: dict) -> dict:
    """A Vocos tree (flat, JAX layouts) -> charactr/vocos-mel-24khz names."""
    tree = unflatten_tree(flat)
    sd = {}

    def put(name, p, conv=False):
        w = np.asarray(p["w"])
        sd[f"{name}.weight"] = (w.transpose(2, 1, 0) if conv else w.T).copy()
        sd[f"{name}.bias"] = np.asarray(p["b"]).copy()

    def norm(name, p):
        sd[f"{name}.weight"] = np.asarray(p["g"]).copy()
        sd[f"{name}.bias"] = np.asarray(p["b"]).copy()

    put("backbone.embed", tree["embed"], conv=True)
    norm("backbone.norm", tree["norm"])
    for i, blk in enumerate(tree["blocks"]):
        pre = f"backbone.convnext.{i}"
        put(f"{pre}.dwconv", blk["dwconv"], conv=True)
        norm(f"{pre}.norm", blk["norm"])
        put(f"{pre}.pwconv1", blk["pw1"])
        put(f"{pre}.pwconv2", blk["pw2"])
        sd[f"{pre}.gamma"] = np.asarray(blk["gamma"]).copy()
    norm("backbone.final_layer_norm", tree["final_norm"])
    put("head.out", tree["head"])
    return sd


@pytest.mark.parametrize("suffix", [".bin", ".safetensors"])
def test_convert_vocoder_matches_jax(tmp_path, suffix):
    _, jparams, _, _ = tiny_vocos()
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    sd = reference_vocos_state_dict(flat)
    got_sd = torch_ckpt.vocos_state_dict(unflatten_tree(flat))
    assert got_sd.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got_sd[k], sd[k])
    src = str(tmp_path / f"vocos{suffix}")
    if suffix == ".bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    else:
        save_file(sd, src)
    layers = TINY_VOCOS["num_layers"]
    jconv.convert(src, str(tmp_path / "j.npz"), num_layers=layers)
    pconv.main(["--input", src, "--output", str(tmp_path / "p.npz"), "--num_layers",
                str(layers)])
    j, p = (dict(np.load(tmp_path / f"{w}.npz")) for w in ("j", "p"))
    assert j.keys() == p.keys() == flat.keys()
    for k in j:
        np.testing.assert_array_equal(p[k], j[k])
        np.testing.assert_array_equal(p[k], flat[k])
    mel = np.random.default_rng(0).standard_normal((1, 100, 40)).astype(np.float32)
    want = np.asarray(japi.load_vocoder(is_local=True, local_path=str(tmp_path / "j.npz"))(
        jnp.asarray(mel)))
    got = papi.load_vocoder(is_local=True, local_path=str(tmp_path / "p.npz"),
                            device="cpu")(t(mel)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    assert rel_err(got, want) < REL

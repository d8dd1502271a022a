"""The port's three training command lines and vocab_extend, on the CPU.

Each command line runs in a temporary working directory on a dataset that
the port's prepare.py builds from seeded noise wavs, at a tiny DiT (dim 64,
depth 2): the presets the LoRA and fine-tune command lines name are made
tiny for the test (monkeypatch of the port's config.PRESETS), train.py takes
the tiny arch from its YAML. Each takes 2 updates and writes a
model_last.npz that the JAX package's load_checkpoint_into_pytree reads;
the LoRA command line runs a copy of configs/F5TTS_Base_ft_Lora.yaml pointed
into the directory, with flags overriding it. vocab_extend's outputs equal
the JAX package's.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.infer.model import load_checkpoint_into_pytree as jax_load_tree
from korean_f5_tts_tpu.train import checkpoint as jckpt
from korean_f5_tts_tpu.train import vocab_extend as jve
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import finetune_cli, train, train_lora
from korean_f5_tts_tpu_torch.train import vocab_extend as pve
from korean_f5_tts_tpu_torch.train.datasets import prepare
from korean_f5_tts_tpu_torch.utils import torch_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=2)
TEXTS = ["hello there", "a quiet river", "the lazy dog", "one two three", "four five"]


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory holding data/tiny_char (prepare.py on seeded noise
    wavs), with every preset the command lines name made tiny."""
    corpus = tmp_path / "corpus"
    os.makedirs(corpus / "wavs")
    rng = np.random.default_rng(0)
    for i, text in enumerate(TEXTS):
        wav = (0.3 * rng.standard_normal(int((0.6 + 0.2 * i) * 24_000))).astype(np.float32)
        wavfile.write(corpus / "wavs" / f"{i}.wav", 24_000, wav)
    (corpus / "metadata.csv").write_text(
        "".join(f"{i}.wav|{t}\n" for i, t in enumerate(TEXTS)), encoding="utf-8")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("F5_TTS_DATA_DIR", raising=False)
    prepare.prepare(str(corpus), "tiny", "char", corpus_format="csv")
    for name in pconfig.PRESETS:
        preset = pconfig.PRESETS[name]
        monkeypatch.setitem(pconfig.PRESETS, name, dict(preset, arch=dict(preset["arch"], **ARCH)))
    vocab = (tmp_path / "data" / "tiny_char" / "vocab.txt").read_text(encoding="utf-8")
    return tmp_path, len(vocab.splitlines())


def _seeded_tree(n_vocab: int, **flags) -> dict:
    """A tiny DiT in the JAX layouts (AdaLN-zero layers re-drawn)."""
    arch = DiTConfig(**ARCH, text_num_embeds=n_vocab + 1, **flags)
    return pckpt.unflatten_tree(pckpt.params_to_jax(
        redraw_zero_init(init_dit(arch, seed=5, device="cpu"), seed=6)))


def _write_pt(path, tree) -> str:
    sd = torch_ckpt.dit_state_dict(tree, ARCH["heads"], ARCH["dim_head"])
    torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": torch.from_numpy(v)
                                         for k, v in sd.items()}}, str(path))
    return str(path)


def _jax_reads(path: str, n_vocab: int, update: int) -> dict:
    """model_last.npz through the JAX package's loader: the tiny tree."""
    jarch = JaxDiTConfig(**ARCH, text_num_embeds=n_vocab + 1)
    tree = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jax_load_tree(path, jarch,
                                                                          "DiT")).items()}
    shapes = {k: v.shape for k, v in pckpt.params_to_jax(
        init_dit(DiTConfig(**ARCH, text_num_embeds=n_vocab + 1), device="cpu")).items()}
    assert {k: v.shape for k, v in tree.items()} == shapes
    assert all(np.isfinite(v).all() for v in tree.values())
    assert int(np.load(path)["update"]) == update
    return tree


def test_train_cli(workdir, capsys):
    tmp_path, n_vocab = workdir
    cfg = {"model": {"name": "tiny", "backbone": "DiT", "tokenizer": "char", "arch": ARCH},
           "datasets": {"name": "tiny", "batch_size_per_gpu": 100, "max_samples": 2},
           "optim": {"epochs": 10, "learning_rate": "1e-4", "num_warmup_updates": 1,
                     "grad_accumulation_steps": 2},
           "ckpts": {"save_dir": str(tmp_path / "run"), "logger": None,
                     "pretrained_path": str(tmp_path / "missing.pt")}}
    yaml.safe_dump(cfg, open(tmp_path / "train.yaml", "w"))
    train.main(["-c", str(tmp_path / "train.yaml"), "--max_updates", "2", "--device", "cpu",
                "datasets.batch_size_per_gpu=4800", "ckpts.last_per_updates=1"])
    out = capsys.readouterr().out
    assert "WARNING: ckpts.pretrained_path" in out and "done at update 2" in out
    path = str(tmp_path / "run" / "model_last.npz")
    _jax_reads(path, n_vocab, 2)
    data = dict(np.load(path))
    n = sum(k.startswith("params/") for k in data)
    assert sum(k.startswith("opt_leaves/") for k in data) == 3 * n + 4  # MultiSteps
    # tensor parallelism needs a process a shard (two processes:
    # tests/test_torch_parallel_train.py); one process cannot hold a 1 x 2 mesh
    with pytest.raises(ValueError, match="does not cover"):
        train.main(["-c", str(tmp_path / "train.yaml"), "--n_model_shards", "2",
                    "--device", "cpu"])


def test_finetune_cli_from_a_reference_checkpoint(workdir, capsys):
    tmp_path, n_vocab = workdir
    tree = _seeded_tree(n_vocab)
    pt = _write_pt(tmp_path / "model_1200.pt", tree)
    finetune_cli.main(["--exp_name", "F5TTS_v1_Base", "--dataset_name", "tiny",
                       "--tokenizer", "char", "--pretrain", pt, "--batch_size_per_gpu", "200",
                       "--max_samples", "2", "--max_updates", "2", "--num_warmup_updates", "1",
                       "--learning_rate", "1e-4", "--logger", "none", "--device", "cpu"])
    run = tmp_path / "ckpts" / "F5TTS_v1_Base_char_tiny"
    assert (run / "pretrained_model_1200.pt").exists()
    assert "finetune done at update 2" in capsys.readouterr().out
    got = _jax_reads(str(run / "model_last.npz"), n_vocab, 2)
    start = pckpt.flatten_tree(tree)
    moved = [not np.array_equal(got[k], start[k]) for k in start]
    assert any(moved) and max(np.abs(got[k] - start[k]).max() for k in start) < 1e-2


def test_lora_cli_on_a_recipe_copy(workdir, capsys):
    tmp_path, n_vocab = workdir
    tree = _seeded_tree(n_vocab, pe_attn_head=1, text_mask_padding=False)
    pt = _write_pt(tmp_path / "pretrained.pt", tree)
    with open(os.path.join(ROOT, "configs", "F5TTS_Base_ft_Lora.yaml"), encoding="utf-8") as f:
        recipe = yaml.safe_load(f)
    recipe["datasets"]["load_path"] = str(tmp_path / "data" / "tiny_char")
    recipe["datasets"]["name"] = "tiny"
    recipe["model"]["tokenizer_path"] = str(tmp_path / "data" / "tiny_char" / "vocab.txt")
    recipe["ckpts"]["pretrained_path"] = pt
    yaml.safe_dump(recipe, open(tmp_path / "lora.yaml", "w"))
    train_lora.main(["--config", str(tmp_path / "lora.yaml"), "--learning_rate", "1e-3",
                     "--epochs", "3", "--max_updates", "2", "--device", "cpu"])
    assert "lora done at update 2" in capsys.readouterr().out
    got = _jax_reads(str(tmp_path / "ckpts" / "lora_F5TTS_Base_tiny" / "model_last.npz"),
                     n_vocab, 2)
    start = pckpt.flatten_tree(tree)
    moved = {k for k in start if not np.array_equal(got[k], start[k])}
    # the merged adapters, and nothing else
    assert moved == {f"blocks/{i}/attn/{n}/w" for i in range(ARCH["depth"])
                     for n in ("to_q", "to_k", "to_v", "to_out")} | {"input_proj/w"}


def test_lora_keeps_the_init_where_the_checkpoint_shape_differs(workdir):
    """train_lora.py:143-151: a text embedding of another vocab size keeps
    its seeded init; every other leaf is the checkpoint's."""
    tmp_path, n_vocab = workdir
    tree = _seeded_tree(n_vocab - 2)
    pt = _write_pt(tmp_path / "small_vocab.pt", tree)
    arch = DiTConfig(**ARCH, text_num_embeds=n_vocab + 1)
    got = pckpt.params_to_jax(train_lora.load_base_params(pt, arch, "cpu"))
    init = pckpt.params_to_jax(init_dit(arch, seed=666, device="cpu"))
    for k, v in pckpt.flatten_tree(tree).items():
        np.testing.assert_array_equal(got[k], init[k] if k == "text_embed/embed/w" else v)


def test_vocab_extend_matches_jax(tmp_path):
    tree = _seeded_tree(6)
    flat = pckpt.flatten_tree(tree)
    pckpt.save_checkpoint(str(tmp_path / "base.npz"), pckpt.params_from_jax(flat, device="cpu"),
                          ema_params=pckpt.params_from_jax(flat, device="cpu"), update=11)
    (tmp_path / "vocab.txt").write_text("".join(f"{c}\n" for c in " abcde"), encoding="utf-8")
    new_tokens = ["f", "a", "", "g", "f", "ㄱ"]
    sizes = {}
    for name, mod in (("jax", jve), ("port", pve)):
        sizes[name] = mod.extend_checkpoint(str(tmp_path / "base.npz"),
                                            str(tmp_path / f"{name}.npz"),
                                            str(tmp_path / "vocab.txt"), new_tokens,
                                            str(tmp_path / f"{name}_vocab.txt"))
        mod.prune_checkpoint(str(tmp_path / f"{name}.npz"), str(tmp_path / f"{name}_pruned.npz"))
    assert sizes["port"] == sizes["jax"] == 9
    assert (tmp_path / "port_vocab.txt").read_text() == (tmp_path / "jax_vocab.txt").read_text()
    for kind in ("", "_pruned"):
        got, want = (dict(np.load(tmp_path / f"{n}{kind}.npz")) for n in ("port", "jax"))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    emb = dict(np.load(tmp_path / "port.npz"))["ema_params/text_embed/embed/w"]
    old = flat["text_embed/embed/w"]  # 6 + 1 ids and the filler row
    assert old.shape[0] == 8 and emb.shape[0] == 10 and np.array_equal(emb[:8], old)

"""Data- and tensor-parallel training of the port, on the CPU, against one
process and against the JAX package.

The mirror of tests/test_train_parallel.py::TestMesh and
tests/test_multihost.py. The port side runs two gloo processes
(tests/_torch_parallel_worker.py, started once for the module), each with
its share of the weights (shard_params) and its data rank's rows: a data x
model mesh of 1 x 2 (tensor parallel) or 2 x 1 (data parallel). The JAX side
runs make_mesh + shard_params on the 8 forced CPU devices of
tests/conftest.py with the same mesh shape.

What is held, with its bound:
  - a step's loss, gradient and AdamW first moment (the clipped gradient:
    the global-norm clip bites) against one process of the port on the same seed, dropout on:
    the draws and dropout masks are made at the global shape, so the sharded
    step is the same function; fp32, relative L2 1e-5 (sums in another
    order: the all-reduces);
  - the same step on the JAX draws against the JAX package's sharded step:
    loss 1e-5, the first moment 1e-4 (tests/test_torch_train.py's bound);
  - equalize_padded_dims, pad_rows and a sharded checkpoint round trip: to
    the bit;
  - the Trainer and the train CLI over two processes against one process.
"""

import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import jax_draws, redraw_zero_layers, rel_err, run_two_processes, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from korean_f5_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from korean_f5_tts_tpu.parallel.mesh import shard_params as jax_shard_params
from korean_f5_tts_tpu.train import step as jstep
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.train import train as ptrain
from korean_f5_tts_tpu_torch.train.datasets import prepare
from korean_f5_tts_tpu_torch.train.trainer import Trainer

ARCH = dict(dim=128, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=8, text_num_embeds=20,
            text_dim=16, conv_layers=1, pe_attn_head=1)
B, N = 4, 128
REL, UPDATE_REL = 1e-5, 1e-4
CLI_ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=2)
TEXTS = ["hello there", "a quiet river", "the lazy dog", "one two three", "four five"]
STEPS = {  # name -> (mesh shape, the step's options)
    "tp": ((1, 2), {}),
    "dp": ((2, 1), {}),
    "tp_linear_fused": ((1, 2), {"attn_path": "linear_fused"}),
    "tp_dots": ((1, 2), {"remat": "dots"}),
}


def _flat(seed: int = 0, **flags) -> dict:
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), JaxDiTConfig(**ARCH, **flags)))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)


def _batch() -> dict:
    rng = np.random.default_rng(1)
    lens = np.array([128, 97, 128, 60], np.int32)
    mel = rng.standard_normal((B, N, ARCH["mel_dim"])).astype(np.float32)
    mel = np.where((np.arange(N)[None, :] < lens[:, None])[..., None], mel, 0.0)
    text = np.full((B, 24), -1, np.int32)
    for i, n in enumerate((20, 14, 24, 9)):
        text[i, :n] = rng.integers(0, 19, n)
    return {"mel": mel.astype(np.float32), "text": text, "lens": lens}


def _arch(opts: dict, dropout: float = 0.1) -> dict:
    remat = opts.get("remat")
    return dict(ARCH, dropout=dropout, checkpoint_activations=remat is not None,
                remat_policy=remat or "full")


def _one_process_step(flat, arch, batch, seed=5, draws=None, attn_path="default"):
    params = pckpt.params_from_jax(flat, device="cpu")
    loss, grads = pstep.loss_and_grads(params, {k: t(v) for k, v in batch.items()}, seed,
                                       DiTConfig(**arch), draws=draws, attn_path=attn_path)
    opt = pstep.make_optimizer(learning_rate=1e-3, warmup_updates=1, total_updates=100,
                               max_grad_norm=0.5)
    state = pstep.init_train_state(params, opt)
    pstep.apply_updates(state, grads, opt)
    paths = list(pckpt.flatten_tree(params))
    return {"loss": float(loss), "grads": {p: g.numpy() for p, g in zip(paths, grads)},
            "mu": {k: v.numpy() for k, v in pckpt.flatten_tree(state.opt_state["mu"]).items()}}


def _reference(run, attn_path: str, draws: bool = False) -> dict:
    """One process's step on the module's weights and batch (dropout on, or
    the JAX draws with dropout off), computed once per variant."""
    key = (attn_path, draws)
    if key not in run["one"]:
        run["one"][key] = _one_process_step(
            run["flat"], _arch({}, 0.0 if draws else 0.1), run["batch"], attn_path=attn_path,
            draws={k: t(v) for k, v in run["draws"].items()} if draws else None)
    return run["one"][key]


def _jax_step(flat, batch, key, n_data, n_model):
    """JAX's sharded train_step (test_train_parallel.py:TestMesh): its loss and
    Adam's first moment, (1 - b1) times the clipped gradient (the weights
    themselves move by schedule(0) = 1e-8, below their rounding)."""
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    opt = jstep.make_optimizer(learning_rate=1e-3, warmup_updates=1, total_updates=100,
                               max_grad_norm=0.5)
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model)
    with mesh:
        state = jstep.init_train_state(jax_shard_params(params, mesh), opt)
        new, loss = jstep.train_step(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh), key,
            JaxDiTConfig(**ARCH, dropout=0.0), opt)
        out = {k: np.asarray(v) for k, v in flatten_tree(new.opt_state[1][0].mu).items()}
    return float(loss), out


def _dataset_items() -> list:
    rng = np.random.default_rng(0)
    return [{"mel_spec": rng.standard_normal((ARCH["mel_dim"], 24 + 4 * (i % 3))).astype(
        np.float32), "text": [1 + (i % 5), 2, 3]} for i in range(12)]


class _Data:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def get_frame_len(self, i):
        return self.items[i]["mel_spec"].shape[1]

    def __getitem__(self, i):
        return self.items[i]


def _cli_workdir(root) -> tuple[str, dict]:
    """data/tiny_char from seeded noise wavs (prepare.py), and a train yaml
    (tests/test_torch_finetune_cli.py's recipe)."""
    corpus = os.path.join(root, "corpus")
    os.makedirs(os.path.join(corpus, "wavs"))
    rng = np.random.default_rng(0)
    for i, text in enumerate(TEXTS):
        wav = (0.3 * rng.standard_normal(int((0.6 + 0.2 * i) * 24_000))).astype(np.float32)
        wavfile.write(os.path.join(corpus, "wavs", f"{i}.wav"), 24_000, wav)
    with open(os.path.join(corpus, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("".join(f"{i}.wav|{x}\n" for i, x in enumerate(TEXTS)))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        prepare.prepare(corpus, "tiny", "char", corpus_format="csv")
    finally:
        os.chdir(cwd)
    cfg = {"model": {"name": "tiny", "backbone": "DiT", "tokenizer": "char", "arch": CLI_ARCH},
           "datasets": {"name": "tiny", "batch_size_per_gpu": 4800, "max_samples": 4},
           "optim": {"epochs": 10, "learning_rate": "1e-4", "num_warmup_updates": 1},
           "ckpts": {"save_dir": "run", "logger": None, "last_per_updates": 1}}
    with open(os.path.join(root, "train.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    return os.path.join(root, "train.yaml"), cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    flat, batch, cases = _flat(), _batch(), []
    for name, (shape, opts) in STEPS.items():
        cases.append((name, "step", dict(mesh_shape=shape, flat=flat, arch=_arch(opts),
                                         batch=batch, seed=5,
                                         attn_path=opts.get("attn_path", "default"))))
    key = jax.random.PRNGKey(7)
    draws = {k: v.numpy() for k, v in jax_draws(key, (B, N, ARCH["mel_dim"]),
                                                 batch["lens"]).items()}
    cases.append(("jax_draws", "step", dict(mesh_shape=(1, 2), flat=flat, arch=_arch({}, 0.0),
                                            batch=batch, draws=draws)))
    cases.append(("orbax", "orbax_round_trip", dict(flat=flat, ckpt_dir=str(base / "orbax"))))
    rng = np.random.default_rng(2)
    batches = [{"mel": rng.standard_normal((b, n, 8)).astype(np.float32),
                "text": rng.integers(0, 9, (b, nt)).astype(np.int32),
                "lens": np.full((b,), n, np.int32)} for b, n, nt in ((2, 30, 5), (1, 41, 7))]
    cases.append(("equalize", "equalize", dict(mesh_shape=(2, 1), batches=batches)))
    items = _dataset_items()
    tflat = _flat(1, dropout=0.0)
    cases.append(("trainer_tp", "trainer", dict(
        flat=tflat, arch=dict(ARCH, dropout=0.0), items=items, ckpt_dir=str(base / "tp"))))
    cases.append(("trainer_dp_orbax", "trainer", dict(
        mesh_shape=(2, 1), flat=tflat, arch=dict(ARCH, dropout=0.0), items=items,
        ckpt_dir=str(base / "dp"), ckpt_format="orbax")))
    cli_dir = str(base / "cli")
    os.makedirs(cli_dir)
    yaml_path, _ = _cli_workdir(cli_dir)
    cli_argv = ["-c", yaml_path, "--max_updates", "2", "--device", "cpu"]
    cases.append(("train_cli", "train_cli", dict(workdir=cli_dir, arch=CLI_ARCH,
                                                 argv=cli_argv + ["--n_model_shards", "2"])))
    ranks = run_two_processes(str(base / "job"), cases)
    return {"ranks": ranks, "flat": flat, "batch": batch, "draws": draws, "key": key, "one": {},
            "batches": batches, "items": items, "tflat": tflat, "base": base,
            "cli": (cli_dir, cli_argv)}


def _close(got: dict, want: dict, bound: float):
    assert got.keys() == want.keys()
    assert rel_err(np.concatenate([got[k].ravel() for k in want]),
                   np.concatenate([want[k].ravel() for k in want])) < bound
    for k in want:  # and no leaf on its own is off
        assert rel_err(got[k], want[k]) < max(bound, 1e-4) or np.abs(want[k]).max() < 1e-7, k


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_equals_one_process(run, name):
    """Loss, gradient and the clipped gradient in Adam's first moment of a
    1 x 2 (tensor) or 2 x 1 (data) step against one process on the same
    seed, dropout on; under "linear_fused" (kernels 7, 8 per rank around 10,
    11, 13) and "dots"."""
    shape, opts = STEPS[name]
    want = _reference(run, opts.get("attn_path", "default"))
    r0, r1 = run["ranks"]
    assert r0[name]["loss"] == r1[name]["loss"]  # the global loss on every rank
    assert abs(r0[name]["loss"] - want["loss"]) <= REL * abs(want["loss"])
    for r in (r0, r1):
        _close(r[name]["grads"], want["grads"], REL)
        _close(r[name]["mu"], want["mu"], REL)


def test_sharded_step_matches_jax(run):
    """TestMesh: the port's 1 x 2 step on the JAX draws against JAX's train_step
    on a 1 x 2 mesh, and against one process of the port."""
    got = run["ranks"][0]["jax_draws"]
    loss, mu = _jax_step(run["flat"], run["batch"], run["key"], 1, 2)
    assert abs(got["loss"] - loss) <= REL * abs(loss)
    port_mu = pckpt.params_to_jax(pckpt.unflatten_tree({k: torch.from_numpy(v) for k, v in
                                                        got["mu"].items()}))
    assert port_mu.keys() == mu.keys()
    assert rel_err(np.concatenate([port_mu[k].ravel() for k in mu]),
                   np.concatenate([mu[k].ravel() for k in mu])) < UPDATE_REL
    one = _reference(run, "default", draws=True)
    assert abs(got["loss"] - one["loss"]) <= REL * abs(one["loss"])


def test_sharded_checkpoint_round_trip_is_exact(run):
    """save_checkpoint_orbax / load_checkpoint_orbax (torch.distributed.checkpoint)
    over the 1 x 2 mesh: each rank reads back its own slices, to the bit."""
    for r in run["ranks"]:
        got = r["orbax"]
        assert got["same"] and got["update"] == 11 and got["count"] == 7
        assert got["local_shape"] == (ARCH["heads"] * ARCH["dim_head"] // 2, ARCH["dim"])
    assert os.path.exists(run["base"] / "orbax" / ".metadata")


def test_equalize_padded_dims_and_pad_rows_are_exact(run):
    """Two processes with other row counts and lengths: each pads mel with 0
    and text with -1 to the global maxima, then to 3 rows of length 0."""
    for rank in (0, 1):
        got = run["ranks"][rank]["equalize"]
        src = run["batches"][rank]
        b, n = src["mel"].shape[:2]
        mel = np.zeros((3, 41, 8), np.float32)
        mel[:b, :n] = src["mel"]
        text = np.full((3, 7), -1, np.int32)
        text[:b, :src["text"].shape[1]] = src["text"]
        lens = np.zeros(3, np.int32)
        lens[:b] = src["lens"]
        for k, v in (("mel", mel), ("text", text), ("lens", lens)):
            np.testing.assert_array_equal(got["local"][k], v)
        assert got["global_rows"] == 6 and got["placed_equal"]


def test_trainer_on_a_tensor_parallel_mesh_equals_one_process(run, tmp_path):
    """Trainer(mesh=1 x 2) over three packed batches against Trainer() on one
    process: the same losses and weights; process 0 alone writes the npz."""
    got = [r["trainer_tp"] for r in run["ranks"]]
    one = Trainer(pckpt.params_from_jax(run["tflat"], device="cpu"),
                  DiTConfig(**ARCH, dropout=0.0), epochs=1, learning_rate=1e-3,
                  num_warmup_updates=2, batch_size_per_gpu=96, batch_size_type="frame",
                  max_samples=4, checkpoint_path=str(tmp_path), save_per_updates=1000,
                  last_per_updates=1000, logger=None, tokenize_fn=lambda x: x)
    res = one.train(_Data(run["items"]), resumable_with_seed=666, max_updates=3, log_every=1)
    assert got[0]["losses"] == got[1]["losses"] and len(got[0]["losses"]) == 3
    np.testing.assert_allclose(got[0]["losses"], res["losses"], rtol=REL)
    _close(got[0]["params"], {k: v.numpy() for k, v in
                              pckpt.flatten_tree(one.state.params).items()}, REL)
    assert got[0]["files"] == ["model_last.npz"]


def test_trainer_on_a_data_parallel_mesh_with_sharded_checkpoints(run):
    """test_multihost.py: two processes each feed their rows of every packed
    batch; the loss is one global value on both; ckpt_format="orbax" writes
    one torch.distributed.checkpoint directory, and a new Trainer resumes from
    it at the update it was written, with the same weights."""
    got = [r["trainer_dp_orbax"] for r in run["ranks"]]
    assert got[0]["losses"] == got[1]["losses"] and len(got[0]["losses"]) == 3
    assert all(np.isfinite(got[0]["losses"]))
    assert got[0]["files"] == ["model_last_orbax"]
    assert all(g["resumed_at"] == 3 and g["resumed_equal"] for g in got)
    for k, v in got[0]["params"].items():  # the data ranks hold one model
        np.testing.assert_array_equal(got[1]["params"][k], v)


def test_train_cli_with_two_model_shards(run, monkeypatch):
    """train.py --n_model_shards 2 under two processes writes the model_last.npz
    of one process's run."""
    cli_dir, argv = run["cli"]
    assert run["ranks"][0]["train_cli"] == ["model_last.npz"]
    tp = dict(np.load(os.path.join(cli_dir, "run", "model_last.npz")))
    for name, preset in pconfig.PRESETS.items():
        monkeypatch.setitem(pconfig.PRESETS, name, dict(preset, arch=dict(preset["arch"],
                                                                           **CLI_ARCH)))
    monkeypatch.chdir(cli_dir)
    ptrain.main([*argv, "ckpts.save_dir=one"])
    one = dict(np.load(os.path.join(cli_dir, "one", "model_last.npz")))
    assert tp.keys() == one.keys() and int(tp["update"]) == int(one["update"]) == 2
    params = [k for k in one if k.startswith("params/")]
    assert rel_err(np.concatenate([tp[k].ravel() for k in params]),
                   np.concatenate([one[k].ravel() for k in params])) < REL

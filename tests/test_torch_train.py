"""The port's training path against the JAX package's, on the CPU.

Tiny DiTs (dim 64, depth 2) are built by the JAX package and handed to the
port through the converter (AdaLN-zero layers re-drawn); the loss's random
draws are made with the JAX package's own jax.random calls (cfm.py:96-117)
and handed to the port as tensors. On the CPU the JAX side takes its XLA
paths and the port its plain versions, so the kernel launch counters stay 0.

Tolerances, with their reasons:
  - fp32 forward and loss: relative 1e-4 / 1e-5 (fp32 summation order);
  - fp32 train_step over 3 steps: mu, nu and the parameters' change
    relative L2 1e-4 (Adam divides by sqrt(nu), so an element with a
    gradient near zero moves its change more than its gradient);
  - bf16 compute: loss relative 2e-2, mu and the parameters' change relative
    L2 5e-2, nu 1e-1 (XLA on the CPU rounds bf16 at other points than
    PyTorch, and nu squares the gradient's error);
  - the EMA, which moves by 1e-3 of the change per step, near fp32's rounding
    of the weights: its values, relative L2 1e-6;
  - checkpoints and resumed runs: exact.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from scipy.io import wavfile

from _torch_port_util import TINY, redraw_zero_layers, rel_err, t
from _torch_port_util import jax_draws as _jax_draws
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.data import dataset as jds
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.train import checkpoint as jckpt
from korean_f5_tts_tpu.train import step as jstep
from korean_f5_tts_tpu.train.trainer import Trainer as JaxTrainer
from korean_f5_tts_tpu.utils.misc import mask_from_frac_lengths as jax_mask_from_frac_lengths
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.data import dataset as pds
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import bench_train
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.train.trainer import Trainer
from korean_f5_tts_tpu_torch.utils.misc import (
    mask_from_frac_lengths,
    mask_from_start_end_indices,
    span_start_end,
)

B, N = 2, 128
LENS = np.asarray([128, 97], np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _pair(**flags):
    """(jax config, port config, jax params, port params) of one tiny DiT."""
    jcfg, pcfg = JaxDiTConfig(**TINY, **flags), DiTConfig(**TINY, **flags)
    flat = jckpt.flatten_tree(jdit.init_dit(jax.random.PRNGKey(0), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 100)
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_tree(flat))
    return jcfg, pcfg, jparams, pckpt.params_from_jax(flat, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    mel[1, LENS[1]:] = 0.0
    text = np.full((B, 40), -1, np.int32)
    text[0, :31] = rng.integers(0, 49, 31)
    text[1, :17] = rng.integers(0, 49, 17)
    return {"mel": mel, "text": text, "lens": LENS}


def _f32(x) -> torch.Tensor:
    return t(np.asarray(jnp.asarray(x).astype(jnp.float32)))


# --- DiT forward --------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    dict(long_skip_connection=True, text_embedding_average_upsampling=True),
    dict(),  # the F5TTS_v1_Base flags
], ids=["long_skip+avg_upsampling", "v1_base_flags"])
@pytest.mark.parametrize("drops", [(0.0, 0.0), (1.0, 1.0), (1.0, 0.0)])
def test_dit_forward_matches_jax(flags, drops):
    jcfg, pcfg, jp, pp = _pair(**flags)
    batch = _batch(1)
    rng = np.random.default_rng(2)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    time = rng.uniform(size=B).astype(np.float32)
    mask = np.arange(N)[None, :] < LENS[:, None]
    da, dt = drops
    want = jdit.dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond),
                            jnp.asarray(batch["text"]), jnp.asarray(time), mask=jnp.asarray(mask),
                            drop_audio_cond=jnp.asarray(da), drop_text=jnp.asarray(dt))
    got = pdit.dit_forward(pp, pcfg, t(x), t(cond), t(batch["text"]), t(time), mask=t(mask),
                           drop_audio_cond=torch.tensor(da), drop_text=torch.tensor(dt))
    assert np.abs(got.numpy()).max() > 0.1  # not gated off
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-4


def test_remat_dots_policy_is_not_ported():
    """The "dots" policy is ported now (dit.py:252-268): the name stays, the
    check is that it runs and gives the gradient of "full" remat, bit for
    bit on the CPU (it keeps products, never changes them)."""
    grads = {}
    for policy in ("full", "dots"):
        _, pcfg, _, pp = _pair(checkpoint_activations=True, remat_policy=policy)
        leaves = {k: v.requires_grad_(True) for k, v in pckpt.flatten_tree(pp).items()}
        h = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (1, 8, TINY["dim"])).astype(np.float32))
        out = pdit.dit_backbone(pckpt.unflatten_tree(leaves), pcfg, h,
                                torch.ones((1, TINY["dim"])), dropout_seed=5)
        out.square().sum().backward()
        grads[policy] = {k: v.grad for k, v in leaves.items()}
    for k, g in grads["full"].items():
        torch.testing.assert_close(grads["dots"][k], g, rtol=0, atol=0)


# --- CFM loss -----------------------------------------------------------------


def _seed_with(drop_text: bool, drop_audio: bool) -> int:
    """The first key whose draws have these drop bits."""
    for seed in range(64):
        d = _jax_draws(jax.random.PRNGKey(seed), (B, N, 100), LENS)
        if (bool(d["drop_text"]), bool(d["drop_audio"])) == (drop_text, drop_audio):
            return seed
    raise AssertionError("no such key")


@pytest.mark.parametrize("drop_text,drop_audio", [(False, False), (False, True), (True, True)])
def test_cfm_loss_matches_jax(drop_text, drop_audio):
    jcfg, pcfg, jp, pp = _pair()
    batch = _batch(3)
    key = jax.random.PRNGKey(_seed_with(drop_text, drop_audio))
    loss_j, cond_j, pred_j = jcfm.cfm_loss(jp, jcfg, *(jnp.asarray(batch[k]) for k in
                                                      ("mel", "text", "lens")), key,
                                           use_dropout=False)
    draws = _jax_draws(key, (B, N, 100), LENS)
    loss_p, cond_p, pred_p = pcfm.cfm_loss_from_draws(pp, pcfg, t(batch["mel"]),
                                                      t(batch["text"]), t(LENS), draws)
    np.testing.assert_array_equal(cond_p.numpy(), np.asarray(cond_j))
    assert rel_err(pred_p.detach().numpy(), np.asarray(pred_j)) < 1e-4
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)


def test_span_masks_match_jax():
    lens = np.asarray([128, 97, 5, 300], np.int32)
    frac = np.asarray([0.7, 0.999, 0.85, 1.0], np.float32)
    key = jax.random.PRNGKey(9)
    want = jax_mask_from_frac_lengths(jnp.asarray(lens), jnp.asarray(frac), key, 320)
    rand = jax.random.uniform(key, frac.shape, dtype=jnp.float32)
    got = mask_from_start_end_indices(*span_start_end(t(lens), t(frac), _f32(rand)), 320)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own draw: spans of int(frac * len) rows inside [0, len)
    m = mask_from_frac_lengths(t(lens), t(frac), torch.Generator().manual_seed(0), 320)
    np.testing.assert_array_equal(m.sum(-1).numpy(), (frac * lens).astype(np.int32))
    assert not (m & ~(torch.arange(320)[None, :] < t(lens)[:, None])).any()


# --- train_step -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_train_step_matches_jax_over_three_steps(dtype):
    jcfg, pcfg, jp, pp = _pair(dropout=0.0)
    kw = dict(learning_rate=1e-3, warmup_updates=2, total_updates=10)
    jopt, popt = jstep.make_optimizer(**kw), pstep.make_optimizer(**kw)
    jstate = jstep.init_train_state(jp, jopt)
    pstate = pstep.init_train_state(pp, popt)
    p0 = pckpt.params_to_jax(pp)
    batch = _batch(4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: t(v) for k, v in batch.items()}
    jdt = None if dtype is None else jnp.bfloat16
    pdt = None if dtype is None else torch.bfloat16
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jstate, loss_j = jstep.train_step(jstate, jbatch, key, jcfg, jopt, compute_dtype=jdt)
        draws = _jax_draws(key, (B, N, 100), LENS, dtype=jdt or jnp.float32)
        pstate, loss_p = pstep.train_step(pstate, pbatch, 0, pcfg, popt, compute_dtype=pdt,
                                          draws=draws)
        np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5 if dtype is None
                                   else 2e-2)
    assert pstate.step == 3 and pstate.opt_state["count"] == 3
    bounds = (1e-4, 1e-4, 1e-4) if dtype is None else (5e-2, 1e-1, 5e-2)
    leaves_j = jax.tree_util.tree_leaves(jstate.opt_state)
    leaves_p = pckpt.opt_state_to_leaves(pstate.opt_state)
    n = (len(leaves_j) - 2) // 2
    assert len(leaves_p) == len(leaves_j) and int(leaves_j[0]) == 3 and int(leaves_j[-1]) == 3
    for name, sl, bound in (("mu", slice(1, n + 1), bounds[0]),
                            ("nu", slice(n + 1, 2 * n + 1), bounds[1])):
        got = np.concatenate([x.ravel() for x in leaves_p[sl]])
        want = np.concatenate([np.asarray(x).ravel() for x in leaves_j[sl]])
        assert rel_err(got, want) < bound, name
    flat_j = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jstate.params).items()}
    flat_p = pckpt.params_to_jax(pstate.params)
    assert flat_j.keys() == flat_p.keys()
    delta_p = np.concatenate([(flat_p[k] - p0[k]).ravel() for k in flat_j])
    delta_j = np.concatenate([(flat_j[k] - p0[k]).ravel() for k in flat_j])
    assert rel_err(delta_p, delta_j) < bounds[2]
    ema_j = np.concatenate([np.asarray(v).ravel() for v in
                            jckpt.flatten_tree(jstate.ema_params).values()])
    ema_p = pckpt.params_to_jax(pstate.ema_params)
    ema_p = np.concatenate([ema_p[k].ravel() for k in jckpt.flatten_tree(jstate.ema_params)])
    assert rel_err(ema_p, ema_j) < 1e-6


def test_schedule_and_clipping_match_optax():
    popt = pstep.make_optimizer(learning_rate=7.5e-5, warmup_updates=100, total_updates=1000)
    sched = optax.join_schedules([optax.linear_schedule(1e-8, 7.5e-5, 100),
                                  optax.linear_schedule(7.5e-5, 1e-8, 900)], [100])
    for c in (0, 1, 50, 99, 100, 101, 999, 1000, 5000):
        np.testing.assert_allclose(popt.schedule(c), float(sched(c)), rtol=1e-6, atol=0)
    assert popt.schedule(0) == pytest.approx(1e-8, rel=1e-3)  # fp32 rounding, as optax
    rng = np.random.default_rng(5)
    params = {"a": {"x": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": [rng.standard_normal(5).astype(np.float32)]}
    jopt = jstep.make_optimizer(learning_rate=1e-2, warmup_updates=0, total_updates=10)
    popt = pstep.make_optimizer(learning_rate=1e-2, warmup_updates=0, total_updates=10)
    for norm in (0.5, 5.0):  # below and above max_grad_norm = 1
        g = {"a": {"x": rng.standard_normal((3, 4)).astype(np.float32)},
             "b": [rng.standard_normal(5).astype(np.float32)]}
        scale = norm / np.sqrt(sum(np.sum(x ** 2) for x in jax.tree_util.tree_leaves(g)))
        g = jax.tree_util.tree_map(lambda x: (x * scale).astype(np.float32), g)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        upd, jopt_state = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jopt.init(jparams), jparams)
        new_j = optax.apply_updates(jparams, upd)
        state = pstep.init_train_state(jax.tree_util.tree_map(t, params), popt, use_ema=False)
        pstep.apply_updates(state, [t(g["a"]["x"]), t(g["b"][0])], popt)
        mu_j = jax.tree_util.tree_leaves(jopt_state)[1:3]
        np.testing.assert_allclose(state.opt_state["mu"]["a"]["x"].numpy(), mu_j[0], rtol=1e-6)
        np.testing.assert_allclose(state.opt_state["mu"]["b"][0].numpy(), mu_j[1], rtol=1e-6)
        # clipped above the bound, untouched below it
        np.testing.assert_allclose(mu_j[0], 0.1 * g["a"]["x"] / max(norm, 1.0), rtol=1e-5)
        np.testing.assert_allclose(state.params["a"]["x"].numpy(), np.asarray(new_j["a"]["x"]),
                                   rtol=1e-6)


# --- checkpoints, Trainer, data ---------------------------------------------------

TINY_T = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
              text_num_embeds=30, text_dim=16, conv_layers=1)
VOCAB = {c: i for i, c in enumerate(" abcdef")}


def _mel_rows(n=8, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        dur = float(rng.uniform(0.5, 3.0))
        rows.append({"mel_spec": rng.standard_normal((100, int(dur * 24000 / 256)))
                     .astype(np.float32), "text": "abc def", "duration": dur})
    return rows


def _trainer_kw(ckpt_dir):
    return dict(epochs=100, learning_rate=1e-4, num_warmup_updates=2,
                checkpoint_path=ckpt_dir, batch_size_per_gpu=2000, batch_size_type="frame",
                max_samples=4, last_per_updates=2, save_per_updates=1000, logger=None,
                vocab_char_map=VOCAB)


def _tiny_t_params():
    jparams = jdit.init_dit(jax.random.PRNGKey(0), JaxDiTConfig(**TINY_T))
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jparams).items()}
    return jparams, pckpt.params_from_jax(flat, device="cpu")


def test_port_resumes_a_jax_trainer_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    jparams, pparams = _tiny_t_params()
    rows = _mel_rows()
    JaxTrainer(jparams, JaxDiTConfig(**TINY_T), **_trainer_kw(ckpt_dir)).train(
        jds.CustomDataset(rows, preprocessed_mel=True), resumable_with_seed=666, max_updates=2)
    data = dict(np.load(os.path.join(ckpt_dir, "model_last.npz")))
    trainer = Trainer(pparams, DiTConfig(**TINY_T), **_trainer_kw(ckpt_dir))
    assert trainer.load_checkpoint() == 2
    state = trainer.state
    for head, tree in (("params", state.params), ("ema_params", state.ema_params)):
        for k, v in pckpt.params_to_jax(tree).items():
            np.testing.assert_array_equal(v, data[f"{head}/{k}"])
    leaves = pckpt.opt_state_to_leaves(state.opt_state)
    assert len(leaves) == sum(k.startswith("opt_leaves/") for k in data)
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf, data[f"opt_leaves/{i:05d}"])
    res = trainer.train(pds.CustomDataset(rows, preprocessed_mel=True),
                        resumable_with_seed=666, max_updates=1)
    assert res["updates"] == 3 and np.isfinite(res["losses"]).all()


def test_jax_loads_and_resumes_a_port_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    jparams, pparams = _tiny_t_params()
    rows = _mel_rows()
    trainer = Trainer(pparams, DiTConfig(**TINY_T), **_trainer_kw(ckpt_dir))
    trainer.train(pds.CustomDataset(rows, preprocessed_mel=True), resumable_with_seed=666,
                  max_updates=2)
    data = jckpt.load_checkpoint(os.path.join(ckpt_dir, "model_last.npz"))
    jopt = jstep.make_optimizer(learning_rate=1e-4, warmup_updates=2)
    structure = jax.tree_util.tree_structure(jopt.init(jparams))
    opt_state = jax.tree_util.tree_unflatten(structure, data["opt_leaves"])
    want = pckpt.opt_state_to_leaves(trainer.state.opt_state)
    for got, w in zip(jax.tree_util.tree_leaves(opt_state), want, strict=True):
        np.testing.assert_array_equal(np.asarray(got), w)
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(data["params"]).items()}
    for k, v in pckpt.params_to_jax(trainer.state.params).items():
        np.testing.assert_array_equal(flat[k], v)
    res = JaxTrainer(jparams, JaxDiTConfig(**TINY_T), **_trainer_kw(ckpt_dir)).train(
        jds.CustomDataset(rows, preprocessed_mel=True), resumable_with_seed=666, max_updates=1)
    assert res["updates"] == 3 and np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("batching", [dict(), dict(batch_size_type="sample",
                                                  batch_size_per_gpu=3)],
                         ids=["frame", "sample"])
def test_resumed_port_run_repeats_an_uninterrupted_one(tmp_path, batching):
    _, pparams = _tiny_t_params()
    ds = pds.CustomDataset(_mel_rows(), preprocessed_mel=True)
    arch = DiTConfig(**TINY_T)

    def trainer(name):
        return Trainer(pparams, arch, **dict(_trainer_kw(str(tmp_path / name)), **batching))

    whole = trainer("a").train(ds, resumable_with_seed=666, max_updates=4)
    # the first half prefetches its batches on a thread: the same batches
    first = trainer("b").train(ds, num_workers=2, resumable_with_seed=666, max_updates=2)
    resumed = trainer("b").train(ds, resumable_with_seed=666, max_updates=2)
    assert resumed["updates"] == 4
    assert first["losses"] == whole["losses"][:2]
    np.testing.assert_array_equal(resumed["losses"], whole["losses"][2:])
    # the caller's tree is never updated in place
    np.testing.assert_array_equal(pckpt.params_to_jax(pparams)["input_proj/w"],
                                  _tiny_t_params()[1]["input_proj"]["w"].numpy().T)


def _two_updates(ckpt_dir: str, **options) -> list[float]:
    _, pparams = _tiny_t_params()
    return Trainer(pparams, DiTConfig(**TINY_T), **dict(_trainer_kw(ckpt_dir), **options)).train(
        pds.CustomDataset(_mel_rows(), preprocessed_mel=True), resumable_with_seed=666,
        max_updates=2, log_every=1)["losses"]


@functools.lru_cache(maxsize=1)
def _default_two_updates() -> list[float]:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        return _two_updates(d)


@pytest.mark.parametrize("kwargs", [dict(mesh="1 x 1"), dict(ckpt_format="orbax"),
                                    dict(logger="wandb")],
                         ids=["mesh", "orbax", "wandb"])
def test_trainer_options_not_ported_raise(kwargs, tmp_path, monkeypatch):
    """The three Trainer options that raised before they were ported (a mesh,
    the sharded "orbax" checkpoint, the wandb logger) each build a Trainer
    whose two updates equal the default Trainer's; wandb stubbed (absent
    here), the mesh one of this process alone (gloo, world size 1)."""
    import sys
    import types

    import torch.distributed as dist

    from korean_f5_tts_tpu_torch.parallel.mesh import make_mesh

    logged = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: None
    stub.log = lambda d, step: logged.append((step, sorted(d)))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    if kwargs.get("mesh"):
        kwargs = {"mesh": make_mesh(1, 1, device="cpu")}
    try:
        losses = _two_updates(str(tmp_path), **kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert losses == _default_two_updates() and len(losses) == 2
    if "ckpt_format" in kwargs:
        assert (tmp_path / "model_last_orbax" / ".metadata").exists()
    if "logger" in kwargs:
        assert logged == [(1, ["loss"]), (2, ["loss"])]


def test_batches_and_collate_match_jax():
    rows = _mel_rows(20, seed=1)
    jds_, pds_ = (m.CustomDataset(rows, preprocessed_mel=True) for m in (jds, pds))
    for seed in (None, 666):
        js = jds.DynamicBatchSampler(jds_, 500, max_samples=4, random_seed=seed)
        ps = pds.DynamicBatchSampler(pds_, 500, max_samples=4, random_seed=seed)
        for epoch in (0, 3):
            js.set_epoch(epoch)
            ps.set_epoch(epoch)
            assert list(ps) == list(js)
    items = [pds_[i] for i in (0, 3, 7)]
    for vocab in (VOCAB, None):
        want = jds.collate_batch(items, vocab)
        got = pds.collate_batch(items, vocab)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_wav_rows_give_the_jax_mel(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for i, sr in enumerate((24_000, 16_000)):
        path = str(tmp_path / f"{i}.wav")
        wavfile.write(path, sr, (0.3 * rng.standard_normal(sr)).astype(np.float32))
        paths.append(path)
    rows = [{"audio_path": p, "text": "ab", "duration": 1.0} for p in paths]
    for i in range(2):
        want = jds.CustomDataset(rows)[i]["mel_spec"]
        got = pds.CustomDataset(rows)[i]["mel_spec"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# --- activation checkpointing and dropout ------------------------------------------


def test_remat_recompute_draws_the_same_dropout_masks():
    _, _, _, pp = _pair()
    batch = {k: t(v) for k, v in _batch(7).items()}
    grads = {}
    for remat, rate in ((False, 0.1), (True, 0.1), (True, 0.0)):
        arch = DiTConfig(**TINY, checkpoint_activations=remat, dropout=rate)
        grads[remat, rate] = pstep.loss_and_grads(pp, batch, 11, arch)[1]
    for a, b in zip(grads[False, 0.1], grads[True, 0.1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # and dropout is on: without it the gradient differs
    flat = [torch.cat([g.flatten() for g in grads[True, r]]) for r in (0.1, 0.0)]
    assert rel_err(flat[0].numpy(), flat[1].numpy()) > 1e-2


def test_a_training_step_after_sampling_in_the_same_process():
    """The sampler runs in inference mode and fills the caches of rope and
    text-position tables; a gradient taken afterwards at the same length reads
    those caches, so their tensors must not be inference tensors."""
    _, pcfg, _, pp = _pair()
    batch = _batch(9)
    pdit._rope_table.cache_clear()
    pdit._freqs_cis_table.cache_clear()
    mel, _ = pcfm.cfm_sample(pp, pcfg, batch["mel"][:1, :40], batch["text"][:1], N, steps=2,
                             seed=0, duration_bucket=None)
    assert mel.shape == (1, N, 100) and pdit._rope_table.cache_info().currsize > 0
    loss, grads = pstep.loss_and_grads(pp, {k: t(v) for k, v in batch.items()}, 3, pcfg)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert pdit._rope_table.cache_info().hits > 0  # the step read what the sampler cached


def test_bench_train_runs_on_the_cpu():
    out = bench_train.run(frames=256, seq_len=128, iters=1, device="cpu", dim=64, depth=1)
    assert out["metric"] == "train_frames_per_s" and out["value"] > 0 and out["step_ms"] > 0
    assert out["device"] == "cpu" and "batch 2 x 128, bf16, kernels" in out["unit"]

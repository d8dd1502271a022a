"""Data- and tensor-parallel UNetT (E2-TTS) and MMDiT of the port, in training
and in sampling, on the CPU, against one process and against the JAX package.

The port side runs two gloo processes (tests/_torch_parallel_worker.py,
started once for the module; the JAX side computes while they run), each
with its share of the weights (shard_params) and its data rank's rows: a data
x model mesh of 1 x 2 (tensor parallel) or 2 x 1 (data parallel). The JAX
side runs make_mesh + shard_params on the 8 forced CPU devices of
tests/conftest.py with the same mesh shape; its attention is XLA's there.
Each rank runs kernel A on its heads (the plain version on the CPU; MMDiT on
the text-first joint sequence), 10, 11 and 13 under autograd, 14 and its pass
under attn_int8.

Three models at dim 128, depth 2, 4 heads of 64: a UNetT with concat skips,
dropout 0.1 and pe_attn_head 1; an MMDiT; an MMDiT with qk_norm "rms_norm".
What is held, with its bound:
  - a step's loss, whole gradient and AdamW first moment at 1 x 2 and 2 x 1
    against one process of the port on the same seed, dropout on: relative
    L2 1e-5 (tests/test_torch_parallel_train.py's REL);
  - the same step on the JAX draws (dropout off) against JAX's sharded
    train_step under the same mesh shape: loss 1e-5, first moment 1e-4;
  - two CFG steps of _sample_core at 1 x 2 against JAX's under its 1 x 2
    mesh and against one process: 1e-4 (fp32); MMDiT under attn_int8="qkpv"
    against one process;
  - Trainer(mesh=1 x 2) on the UNetT, dropout on, against Trainer() on one
    process: losses and weights 1e-5;
  - the partition rules on whole UNetT and MMDiT trees against JAX's, an
    orbax round trip of an MMDiT tp-2 train state to the bit, and the raise
    where the heads do not split over the model axis.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import jax_draws, rel_err, start_two_processes, t
from korean_f5_tts_tpu import config as jconfig
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.mmdit import init_mmdit as jax_init_mmdit
from korean_f5_tts_tpu.models.quant import quantize_linear
from korean_f5_tts_tpu.models.unett import init_unett as jax_init_unett
from korean_f5_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from korean_f5_tts_tpu.parallel.mesh import param_partition_spec as jax_spec
from korean_f5_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from korean_f5_tts_tpu.parallel.mesh import shard_params as jax_shard_params
from korean_f5_tts_tpu.train import step as jstep
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.mmdit import init_mmdit
from korean_f5_tts_tpu_torch.models.modules import attention
from korean_f5_tts_tpu_torch.models.unett import init_unett
from korean_f5_tts_tpu_torch.parallel.mesh import param_partition_spec
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.train.trainer import Trainer

REL, UPDATE_REL, SAMPLER_REL = 1e-5, 1e-4, 1e-4
BASE = dict(dim=128, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=8, text_num_embeds=20)
MODELS = {  # name -> (backbone, arch)
    "unett": ("UNetT", dict(BASE, text_dim=16, conv_layers=1, pe_attn_head=1,
                            skip_connect_type="concat", dropout=0.1)),
    "mmdit": ("MMDiT", dict(BASE)),
    "mmdit_qk_norm": ("MMDiT", dict(BASE, qk_norm="rms_norm")),
}
MESHES = {"tp": (1, 2), "dp": (2, 1)}
ZERO_INIT = ("attn_norm_x/linear/", "attn_norm_c/linear/", "norm_out/linear/", "proj_out/")
B, N, DUR = 4, 128, 100
STEPS = [(m, s) for m in MODELS for s in MESHES]


def _flat(name: str, seed: int = 0) -> dict:
    """A model of MODELS from the port's init on the CPU, flat numpy in the
    JAX layout (params_to_jax; the JAX inits' tree, tests/
    test_torch_backbones_entry.py), cheaper than the JAX init's op-by-op
    dispatch; the MMDiT's AdaLN-zero layers, norm_out and proj_out re-drawn
    (else every block is gated off)."""
    init = {"UNetT": init_unett, "MMDiT": init_mmdit}[MODELS[name][0]]
    flat = pckpt.params_to_jax(init(_arch(name), seed=seed, device="cpu"))
    rng = np.random.default_rng(seed + 100)
    for k, v in flat.items():
        if any(z in k for z in ZERO_INIT):
            d_in = flat[k[:-1] + "w"].shape[0]
            flat[k] = rng.uniform(-1, 1, v.shape).astype(np.float32) / np.sqrt(d_in)
    return flat


def _arch(name: str, **kw):
    backbone, arch = MODELS[name]
    return pconfig.BACKBONE_CONFIGS[backbone](**dict(arch, **kw))


def _jax_arch(name: str, **kw):
    backbone, arch = MODELS[name]
    return jconfig.BACKBONE_CONFIGS[backbone](**dict(arch, **kw))


def _batch() -> dict:
    rng = np.random.default_rng(1)
    lens = np.array([128, 97, 128, 60], np.int32)
    mel = rng.standard_normal((B, N, BASE["mel_dim"])).astype(np.float32)
    mel = np.where((np.arange(N)[None, :] < lens[:, None])[..., None], mel, 0.0)
    text = np.full((B, 24), -1, np.int32)
    for i, n in enumerate((20, 14, 24, 9)):
        text[i, :n] = rng.integers(0, 19, n)
    return {"mel": mel.astype(np.float32), "text": text, "lens": lens}


def _sampler_inputs() -> dict:
    rng = np.random.default_rng(4)
    ar = np.arange(N)
    d = BASE["mel_dim"]
    step_cond = np.where((ar < 40)[None, :, None], rng.standard_normal((1, N, d)), 0.0)
    y0 = np.where((ar < DUR)[None, :, None], rng.standard_normal((1, N, d)), 0.0)
    text = np.full((1, 16), -1, np.int32)
    text[0, :9] = rng.integers(0, 19, 9)
    return {"step_cond": step_cond.astype(np.float32), "text": text, "mask": None,
            "pad_mask": (ar < DUR)[None, :], "y0": y0.astype(np.float32), "steps": 2}


def _one_process_step(flat, arch, batch, seed=5) -> dict:
    params = pckpt.params_from_jax(flat, device="cpu")
    loss, grads = pstep.loss_and_grads(params, {k: t(v) for k, v in batch.items()}, seed, arch)
    opt = pstep.make_optimizer(learning_rate=1e-3, warmup_updates=1, total_updates=100,
                               max_grad_norm=0.5)
    state = pstep.init_train_state(params, opt)
    pstep.apply_updates(state, grads, opt)
    paths = list(pckpt.flatten_tree(params))
    return {"loss": float(loss), "grads": {p: g.numpy() for p, g in zip(paths, grads)},
            "mu": {k: v.numpy() for k, v in pckpt.flatten_tree(state.opt_state["mu"]).items()}}


def _jax_step(flat, arch, batch, key, shape) -> tuple[float, dict]:
    """JAX's sharded train_step: its loss and Adam's first moment."""
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    opt = jstep.make_optimizer(learning_rate=1e-3, warmup_updates=1, total_updates=100,
                               max_grad_norm=0.5)
    mesh = jax_make_mesh(*shape)
    with mesh:
        state = jstep.init_train_state(jax_shard_params(params, mesh), opt)
        new, loss = jstep.train_step(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh), key, arch, opt)
        mu = {k: np.asarray(v) for k, v in flatten_tree(new.opt_state[1][0].mu).items()}
    return float(loss), mu


def _jax_sampler(flat, arch, x) -> np.ndarray:
    """JAX's sampler under its 1 x 2 mesh on the sharded weights."""
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    mesh = jax_make_mesh(1, 2)
    with mesh:
        mel = jcfm._sample_core(
            jax_shard_params(params, mesh), arch, jnp.asarray(x["step_cond"]),
            jnp.asarray(x["text"]), None, jnp.asarray(x["pad_mask"]), jnp.asarray(x["y0"]),
            jnp.asarray(2.0), jnp.asarray(-1.0), steps=x["steps"], use_cfg=True,
            use_sway=True, use_epss=True)
        return np.asarray(mel)


def _one_process_sampler(flat, arch, x, attn_int8=None) -> np.ndarray:
    return pcfm._sample_core(
        pckpt.params_from_jax(flat, device="cpu"), arch, t(x["step_cond"]), t(x["text"]), None,
        t(x["pad_mask"]), t(x["y0"]), 2.0, -1.0, steps=x["steps"], use_cfg=True, use_sway=True,
        use_epss=True, attn_int8=attn_int8).numpy()


class _Data:
    """A seeded in-memory dataset of 12 items, 24-32 frames each."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.items = [{"mel_spec": rng.standard_normal((BASE["mel_dim"], 24 + 4 * (i % 3)))
                       .astype(np.float32), "text": [1 + (i % 5), 2, 3]} for i in range(12)]

    def __len__(self):
        return len(self.items)

    def get_frame_len(self, i):
        return self.items[i]["mel_spec"].shape[1]

    def __getitem__(self, i):
        return self.items[i]


def _one_process_trainer(flat, arch, ckpt_dir) -> dict:
    """Trainer() on one process with the worker's trainer case's options."""
    tr = Trainer(pckpt.params_from_jax(flat, device="cpu"), arch, epochs=1, learning_rate=1e-3,
                 num_warmup_updates=2, batch_size_per_gpu=96, batch_size_type="frame",
                 max_samples=4, checkpoint_path=ckpt_dir, save_per_updates=1000,
                 last_per_updates=1000, logger=None, tokenize_fn=lambda x: x)
    res = tr.train(_Data(), resumable_with_seed=666, max_updates=3, log_every=1)
    return {"losses": res["losses"], "params": {k: v.numpy() for k, v in
                                                pckpt.flatten_tree(tr.state.params).items()}}


def _split_heads_inputs() -> dict:
    """One attention's weights at 3 heads of 16, with the context stream's
    (JAX layout), and the two streams' activations."""
    rng = np.random.default_rng(9)
    dim, inner = 32, 48
    lin = lambda d_in, d_out: {  # noqa: E731
        "w": (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32),
        "b": (0.1 * rng.standard_normal(d_out)).astype(np.float32)}
    attn = {n: lin(dim, inner) for n in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c")}
    attn.update(to_out=lin(inner, dim), to_out_c=lin(inner, dim))
    flat = {f"attn/{k}": v for k, v in flatten_tree(attn).items()}
    port = pckpt.params_from_jax(flat, device="cpu")["attn"]
    return {"x": rng.standard_normal((2, 20, dim)).astype(np.float32),
            "c": rng.standard_normal((2, 7, dim)).astype(np.float32), "heads": 3,
            "attn": {k: {n: v.numpy() for n, v in lp.items()} for k, lp in port.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("backbones")
    batch, x = _batch(), _sampler_inputs()
    flats = {name: _flat(name) for name in MODELS}
    key = jax.random.PRNGKey(7)
    draws = {k: v.numpy() for k, v in jax_draws(key, (B, N, BASE["mel_dim"]),
                                                 batch["lens"]).items()}
    cases = []
    for name, (backbone, arch) in MODELS.items():
        for mesh_name, shape in MESHES.items():
            cases.append((f"{name}_{mesh_name}", "step", dict(
                mesh_shape=shape, flat=flats[name], arch=arch, batch=batch, seed=5,
                backbone=backbone)))
            cases.append((f"{name}_{mesh_name}_jax_draws", "step", dict(
                mesh_shape=shape, flat=flats[name], arch=dict(arch, dropout=0.0), batch=batch,
                draws=draws, backbone=backbone)))
        cases.append((f"{name}_sampler", "sampler", dict(flat=flats[name], arch=arch, inputs=x,
                                                         backbone=backbone)))
    cases.append(("mmdit_sampler_int8_attn", "sampler", dict(
        flat=flats["mmdit"], arch=MODELS["mmdit"][1], inputs=x, backbone="MMDiT",
        attn_int8="qkpv")))
    cases.append(("mmdit_orbax", "orbax_round_trip", dict(flat=flats["mmdit"],
                                                          ckpt_dir=str(base / "orbax"))))
    cases.append(("unett_trainer", "trainer", dict(
        flat=flats["unett"], arch=MODELS["unett"][1], items=_Data().items,
        ckpt_dir=str(base / "trainer"), backbone="UNetT")))
    heads_case = _split_heads_inputs()
    cases.append(("split_heads", "split_heads", heads_case))
    wait = start_two_processes(str(base / "job"), cases)
    # the JAX side and one process of the port, while the two ranks run
    want = {}
    for name in MODELS:
        for mesh_name, shape in MESHES.items():
            want[f"{name}_{mesh_name}_jax"] = _jax_step(flats[name], _jax_arch(name, dropout=0.0),
                                                        batch, key, shape)
        want[f"{name}_one"] = _one_process_step(flats[name], _arch(name), batch)
        want[f"{name}_sampler_jax"] = _jax_sampler(flats[name], _jax_arch(name), x)
        want[f"{name}_sampler_one"] = _one_process_sampler(flats[name], _arch(name), x)
    want["mmdit_sampler_int8_attn_one"] = _one_process_sampler(flats["mmdit"], _arch("mmdit"), x,
                                                               attn_int8="qkpv")
    want["unett_trainer"] = _one_process_trainer(flats["unett"], _arch("unett"),
                                                 str(base / "one_trainer"))
    return {"ranks": wait(), "want": want, "heads_case": heads_case}


def _both(run, name):
    """Rank 0's result, after checking rank 1 holds the same (replicated)."""
    r0, r1 = run["ranks"][0][name], run["ranks"][1][name]
    np.testing.assert_array_equal(r0, r1)
    return r0


def _close(got: dict, want: dict, bound: float):
    assert got.keys() == want.keys()
    assert rel_err(np.concatenate([got[k].ravel() for k in want]),
                   np.concatenate([want[k].ravel() for k in want])) < bound
    for k in want:  # and no leaf on its own is off
        assert rel_err(got[k], want[k]) < max(bound, 1e-4) or np.abs(want[k]).max() < 1e-7, k


@pytest.mark.parametrize("name,mesh_name", STEPS)
def test_sharded_step_equals_one_process(run, name, mesh_name):
    """Loss, gradient and the clipped gradient in Adam's first moment of a
    1 x 2 (tensor) or 2 x 1 (data) step against one process on the same
    seed, dropout on (the UNetT's FF masks drawn at the global shape)."""
    want = run["want"][f"{name}_one"]
    r0, r1 = (r[f"{name}_{mesh_name}"] for r in run["ranks"])
    assert r0["loss"] == r1["loss"]  # the global loss on every rank
    assert abs(r0["loss"] - want["loss"]) <= REL * abs(want["loss"])
    for r in (r0, r1):
        _close(r["grads"], want["grads"], REL)
        _close(r["mu"], want["mu"], REL)


@pytest.mark.parametrize("name,mesh_name", STEPS)
def test_sharded_step_matches_jax(run, name, mesh_name):
    """The port's step on the JAX draws against JAX's train_step under the
    same mesh shape: the loss, and Adam's first moment in JAX's tree."""
    got = run["ranks"][0][f"{name}_{mesh_name}_jax_draws"]
    loss, mu = run["want"][f"{name}_{mesh_name}_jax"]
    assert abs(got["loss"] - loss) <= REL * abs(loss)
    port_mu = pckpt.params_to_jax(pckpt.unflatten_tree({k: torch.from_numpy(v) for k, v in
                                                        got["mu"].items()}))
    assert port_mu.keys() == mu.keys()
    assert rel_err(np.concatenate([port_mu[k].ravel() for k in mu]),
                   np.concatenate([mu[k].ravel() for k in mu])) < UPDATE_REL


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_sampler_matches_jax_and_one_process(run, name):
    """Two CFG steps of the sampler at tp 2 (kernel A on each rank's heads,
    to_out and the FF out summed over the model group) against JAX's at tp 2
    and against one process of the port."""
    got = _both(run, f"{name}_sampler")
    want = run["want"][f"{name}_sampler_jax"]
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    assert rel_err(got, want) < SAMPLER_REL
    assert rel_err(got, run["want"][f"{name}_sampler_one"]) < SAMPLER_REL


def test_tp_mmdit_sampler_with_int8_attention(run):
    """attn_int8="qkpv" at tp 2: kernel 14 and its pass on each rank's heads
    of the text-first joint sequence, equal to one process's on those heads."""
    got = _both(run, "mmdit_sampler_int8_attn")
    assert rel_err(got, run["want"]["mmdit_sampler_int8_attn_one"]) < SAMPLER_REL
    assert 1e-5 < rel_err(got, run["want"]["mmdit_sampler_one"]) < 0.2  # the int8 branch ran


@pytest.mark.parametrize("name", ["unett", "mmdit_qk_norm"])
def test_partition_specs_mirror_the_jax_rules(name):
    """param_partition_spec on a whole UNetT or MMDiT tree (the port's [out,
    in] layouts) is JAX's on [in, out]; context projections split like the
    audio ones, to_out_c like to_out; the last MMDiT block has neither
    to_out_c nor ff_c; skip_proj, audio_proj and the AdaLN linears stay
    replicated. The DiT tree's case is tests/test_torch_parallel_tp.py's
    test of this name. The rules read shapes only: the JAX init's tree by
    jax.eval_shape, as zeros."""
    init = {"UNetT": jax_init_unett, "MMDiT": jax_init_mmdit}[MODELS[name][0]]
    flat = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: init(jax.random.PRNGKey(0), _jax_arch(name)))))
    depth = BASE["depth"]
    last = f"blocks/{depth - 1}/"
    if name == "mmdit_qk_norm":
        assert not any(k.startswith(last) and ("to_out_c" in k or "ff_c" in k) for k in flat)
        q8 = quantize_linear({"w": flat[f"{last}attn/to_q_c/w"], "b": flat[f"{last}attn/to_q_c/b"]})
        flat.update({f"{last}attn/to_q_c/{k}": v for k, v in q8.items()})
    port = pckpt.flatten_tree(pckpt.params_from_jax(flat, device="cpu"))
    split = []
    for k, v in flat.items():
        js = tuple(jax_spec(tuple(jax.tree_util.DictKey(p) for p in k.split("/")), np.asarray(v)))
        ps = param_partition_spec(k, port[k])
        assert ps == (tuple(reversed(js)) if len(js) == 2 else js), (k, js, ps)
        if "model" in ps:
            split.append(k)
    assert not any(n in k for k in split for n in (
        "skip_proj", "audio_proj", "attn_norm", "norm_out", "q_norm", "k_norm"))
    if name == "unett":  # a layer's q, k, v (w, b), out w, ff in (w, b), ff out w
        assert len(split) == depth * 10
    else:  # + q_c, k_c, v_c (w, b), to_out_c w, ff_c (3) but on the last; its int8 q_c twice
        assert len(split) == 20 * (depth - 1) + 16 + 2
        assert sum("to_out_c" in k for k in split) == depth - 1


def test_trainer_on_a_tensor_parallel_mesh_trains_the_unett(run):
    """Trainer(mesh=1 x 2) over three packed batches of the UNetT, its FF
    dropout on, against Trainer() on one process: the same losses and
    weights; process 0 alone writes the npz."""
    got = [r["unett_trainer"] for r in run["ranks"]]
    want = run["want"]["unett_trainer"]
    assert got[0]["losses"] == got[1]["losses"] and len(got[0]["losses"]) == 3
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=REL)
    _close(got[0]["params"], want["params"], REL)
    assert got[0]["files"] == ["model_last.npz"]


def test_sharded_mmdit_checkpoint_round_trip_is_exact(run):
    """save_checkpoint_orbax / load_checkpoint_orbax of an MMDiT tp-2 train
    state: each rank reads back its own slices to the bit, the context
    projections and ff_c among them."""
    inner = BASE["heads"] * BASE["dim_head"]
    for r in run["ranks"]:
        got = r["mmdit_orbax"]
        assert got["same"] and got["update"] == 11 and got["count"] == 7
        shapes = got["shapes"]
        for k in ("to_q_c", "to_k_c", "to_v_c"):
            assert shapes[f"blocks/0/attn/{k}/w"] == (inner // 2, BASE["dim"])
        assert shapes["blocks/0/attn/to_out_c/w"] == (BASE["dim"], inner // 2)
        ff = BASE["dim"] * BASE["ff_mult"]
        assert shapes["blocks/0/ff_c/in/w"] == (ff // 2, BASE["dim"])
        assert shapes["blocks/0/ff_c/out/w"] == (BASE["dim"], ff // 2)
        assert "blocks/1/attn/to_out_c/w" not in shapes


def test_heads_that_the_model_axis_does_not_divide_raise(run):
    """3 heads of 16 at tp 2: attention() and joint_attention() raise,
    naming the heads and tp. What the old floor division ran instead (one
    head of 24 columns a rank) is another function than one process's."""
    got = run["ranks"][0]["split_heads"]
    for fn in ("attention", "joint_attention"):
        assert "3 heads" in got["errors"][fn] and "tp 2" in got["errors"][fn], got["errors"]
    case = run["heads_case"]
    p = {k: {n: torch.from_numpy(v) for n, v in lp.items()} for k, lp in case["attn"].items()}
    one = attention(p, t(case["x"]), 3).numpy()
    floor = [r["split_heads"]["floor_split"] for r in run["ranks"]]
    np.testing.assert_array_equal(floor[0], floor[1])
    assert rel_err(floor[0], one) > 1e-2

"""One process of the port's two-process CPU tests (tests/test_torch_parallel_*.py).

    PYTHONPATH=<repo root> python tests/_torch_parallel_worker.py JOB

JOB is a pickle {"cases": [(name, case function, kwargs), ...], "out": path}.
The process starts the gloo process group from the JAX package's variables
(F5_TTS_DIST_COORDINATOR, F5_TTS_DIST_NUM_PROCESSES, F5_TTS_DIST_PROCESS_ID;
korean_f5_tts_tpu_torch/parallel/distributed.py), runs every case in order
and pickles its results to "<out>.<rank>". It imports the port only: the
tests hold what it returns against the JAX package and against one process.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from korean_f5_tts_tpu_torch.parallel import distributed as pdist
from korean_f5_tts_tpu_torch.parallel import tp_kernels
from korean_f5_tts_tpu_torch.parallel.mesh import (
    axis_rank,
    make_mesh,
    shard_batch,
    shard_params,
    unshard_params,
)
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def flat_numpy(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in pckpt.flatten_tree(tree).items()}


def _params(flat: dict, dtype: str = "fp32"):
    """A port tree from flat JAX-layout arrays (w_int8 included)."""
    p = pckpt.params_from_jax(flat, device="cpu")
    if dtype == "bf16":
        from korean_f5_tts_tpu_torch.models.modules import cast_params

        p = cast_params(p, torch.bfloat16)
    return p


# --- tensor-parallel kernels ---------------------------------------------------


@case
def ff_block(mesh, h, sc, sh, gate, ff, int8=False):
    p = shard_params({"ff": tensors(ff)}, mesh)["ff"]
    args = (*tensors([h, sc, sh, gate]),)
    if int8:
        out = tp_kernels.ff_block_int8_tp(*args, p["in"], p["out"], mesh)
    else:
        out = tp_kernels.ff_block_tp(*args, p["in"]["w"], p["in"]["b"], p["out"]["w"],
                                     p["out"]["b"], mesh)
    return out.numpy()


@case
def attn_half(mesh, h, sc, sh, gate, attn, heads, pe_attn_head, lens):
    from korean_f5_tts_tpu_torch.models.dit import _rope_table

    ap = shard_params({"attn": tensors(attn)}, mesh)["attn"]
    inner = attn["to_q"]["w_int8" if "w_int8" in attn["to_q"] else "w"].shape[0]
    rope = _rope_table(h.shape[1], inner // heads, torch.device("cpu"))
    out = tp_kernels.attn_half_block_tp(*tensors([h, sc, sh, gate]), ap, heads, rope,
                                        pe_attn_head, torch.from_numpy(lens), mesh)
    return out.numpy()


@case
def flash(mesh, q, k, v, lens, pv_i8=None):
    hl = q.shape[1] // 2
    r = axis_rank(mesh, "model")
    q, k, v = (torch.from_numpy(x[:, r * hl:(r + 1) * hl].copy()) for x in (q, k, v))
    if pv_i8 is None:
        return tp_kernels.flash_prefix_tp(q, k, v, torch.from_numpy(lens), mesh).numpy()
    return tp_kernels.flash_prefix_i8_tp(q, k, v, torch.from_numpy(lens), pv_i8, mesh).numpy()


def _arch(backbone: str, arch: dict):
    from korean_f5_tts_tpu_torch.config import BACKBONE_CONFIGS

    return BACKBONE_CONFIGS[backbone](**arch)


@case
def sampler(mesh, flat, arch, inputs, dtype="fp32", attn_path="default", attn_int8=None,
            backbone="DiT"):
    from korean_f5_tts_tpu_torch.models.cfm import _sample_core

    p = shard_params(_params(flat, dtype), mesh)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = {k: (torch.from_numpy(v).to(td) if v.dtype == np.float32 else torch.from_numpy(v))
         if isinstance(v, np.ndarray) else v for k, v in inputs.items()}
    mel = _sample_core(p, _arch(backbone, arch), x["step_cond"], x["text"], x["mask"],
                       x["pad_mask"], x["y0"], 2.0, -1.0, steps=x["steps"], use_cfg=True,
                       use_sway=True, use_epss=True, attn_path=attn_path, attn_int8=attn_int8,
                       mesh=mesh)
    return mel.float().numpy()


# --- training -------------------------------------------------------------------


@case
def step(mesh, flat, arch, batch, seed=0, draws=None, attn_path="default", compute_dtype=None,
         backbone="DiT"):
    """loss_and_grads and one AdamW update on the mesh: the loss, the whole
    gradient and Adam's first moment after the update, (1 - b1) times the
    clipped gradient (both gathered over the model axis)."""
    from korean_f5_tts_tpu_torch.train import step as pstep

    arch = _arch(backbone, arch)
    params = shard_params(_params(flat), mesh)
    local = shard_batch(tensors(batch), mesh)
    if draws is not None:
        b, r = local["mel"].shape[0], axis_rank(mesh, "data")
        draws = {k: v[r * b:(r + 1) * b] if v.ndim else v for k, v in tensors(draws).items()}
    dt = {"bf16": torch.bfloat16, None: None}[compute_dtype]
    loss, grads = pstep.loss_and_grads(params, local, seed, arch, compute_dtype=dt,
                                       draws=draws, attn_path=attn_path, mesh=mesh)
    opt = pstep.make_optimizer(learning_rate=1e-3, warmup_updates=1, total_updates=100,
                               max_grad_norm=0.5)
    state = pstep.init_train_state(params, opt)
    pstep.apply_updates(state, grads, opt, mesh=mesh)
    g = unshard_params(pckpt.unflatten_tree(dict(zip(pckpt.flatten_tree(params), grads))), mesh)
    return {"loss": float(loss), "grads": flat_numpy(g),
            "mu": flat_numpy(unshard_params(state.opt_state["mu"], mesh))}


@case
def orbax_round_trip(mesh, flat, ckpt_dir):
    """A sharded train state written with save_checkpoint_orbax and read back
    into zeroed trees of the same shapes: bit for bit."""
    from korean_f5_tts_tpu_torch.train import step as pstep

    whole = pstep.init_train_state(_params(flat), pstep.make_optimizer())
    gen = torch.Generator().manual_seed(0)  # the same whole state on every process
    for v in pckpt.flatten_tree(whole.opt_state).values():
        if isinstance(v, torch.Tensor):
            v.copy_(torch.randn(v.shape, generator=gen))
    whole.opt_state["count"] = 7
    params = shard_params(whole.params, mesh)
    state = pstep.TrainState(params, shard_params(whole.opt_state, mesh),
                             shard_params(whole.ema_params, mesh), 0)
    pckpt.save_checkpoint_orbax(ckpt_dir, state.params, state.opt_state, state.ema_params,
                                update=11, mesh=mesh)
    zero = lambda tree: pckpt.unflatten_tree({  # noqa: E731
        k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
        for k, v in pckpt.flatten_tree(tree).items()})
    got = pckpt.load_checkpoint_orbax(ckpt_dir, zero(state.params), zero(state.opt_state),
                                      zero(state.ema_params), mesh=mesh)
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for name in ("params", "opt_state", "ema_params")
               for a, b in zip(pckpt.flatten_tree(getattr(state, name)).values(),
                               pckpt.flatten_tree(got[name]).values()))
    return {"update": got["update"], "count": got["opt_state"]["count"], "same": same,
            "local_shape": tuple(params["blocks"][0]["attn"]["to_q"]["w"].shape),
            "shapes": {k: tuple(v.shape) for k, v in pckpt.flatten_tree(params).items()}}


@case
def split_heads(mesh, x, c, attn, heads, gx, gc):
    """attention() and joint_attention() at `heads` heads whose count the
    model axis does not divide, each on this rank's shares: the replicated
    outputs, then the gradients of sum(out * gx) (+ sum(c_out * gc)) as
    whole tensors (the weights' gathered from the ranks' shares, x's and
    c's summed by copy_to_model)."""
    from korean_f5_tts_tpu_torch.models.modules import attention, joint_attention

    out = {}
    for name in ("attention", "joint_attention"):
        p = shard_params({"attn": tensors(attn)}, mesh)["attn"]
        p = {k: {n: v.detach().clone().requires_grad_() for n, v in lp.items()}
             for k, lp in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        ct = torch.from_numpy(c).requires_grad_()
        if name == "attention":
            outs = (attention(p, xt, heads, mesh=mesh),)
            loss = (outs[0] * torch.from_numpy(gx)).sum()
        else:
            outs = joint_attention(p, xt, ct, heads, mesh=mesh)
            loss = ((outs[0] * torch.from_numpy(gx)).sum()
                    + (outs[1] * torch.from_numpy(gc)).sum())
        loss.backward()
        grads = {f"{k}/{n}": v.grad for k, lp in p.items() for n, v in lp.items()
                 if v.grad is not None}
        whole = pckpt.flatten_tree(unshard_params(
            {"attn": pckpt.unflatten_tree(grads)}, mesh))
        out[name] = {"outs": [o.detach().numpy() for o in outs],
                     "grads": {k: v.numpy() for k, v in whole.items()},
                     "x": xt.grad.numpy(), "c": None if ct.grad is None else ct.grad.numpy()}
    return out


@case
def equalize(mesh, batches):
    local = batches[pdist.process_index()]
    out = pdist.pad_rows(pdist.equalize_padded_dims(local), 3)
    placed, rows = pdist.make_global_batch(out, mesh, torch.device("cpu"))
    return {"local": out, "global_rows": rows, "placed_equal": all(
        np.array_equal(placed[k].numpy(), out[k]) for k in out)}


@case
def trainer(mesh, flat, arch, items, ckpt_dir, ckpt_format="npz", max_updates=3,
            backbone="DiT"):
    """Trainer(mesh=...) over a seeded in-memory dataset; with "orbax" a
    second Trainer resumes from the last sharded checkpoint."""
    from korean_f5_tts_tpu_torch.train.trainer import Trainer

    class Data:
        def __len__(self):
            return len(items)

        def get_frame_len(self, i):
            return items[i]["mel_spec"].shape[1]

        def __getitem__(self, i):
            return items[i]

    def make():
        return Trainer(shard_params(_params(flat), mesh), _arch(backbone, arch), epochs=1,
                       learning_rate=1e-3, num_warmup_updates=2, batch_size_per_gpu=96,
                       batch_size_type="frame", max_samples=4, checkpoint_path=ckpt_dir,
                       save_per_updates=1000, last_per_updates=1000, logger=None, mesh=mesh,
                       tokenize_fn=lambda texts: texts, ckpt_format=ckpt_format)

    tr = make()
    res = tr.train(Data(), resumable_with_seed=666, max_updates=max_updates, log_every=1)
    out = {"losses": res["losses"], "updates": res["updates"],
           "params": flat_numpy(unshard_params(tr.state.params, mesh)),
           "files": sorted(os.listdir(ckpt_dir))}
    if ckpt_format == "orbax":
        again = make()
        out["resumed_at"] = again.load_checkpoint()
        out["resumed_equal"] = all(
            torch.equal(a, b) for a, b in zip(pckpt.flatten_tree(tr.state.params).values(),
                                              pckpt.flatten_tree(again.state.params).values()))
    return out


@case
def train_cli(mesh, workdir, arch, argv):
    """train/train.py's main on a 1 x 2 mesh: the presets made tiny, as
    tests/test_torch_finetune_cli.py makes them."""
    from korean_f5_tts_tpu_torch import config as pconfig
    from korean_f5_tts_tpu_torch.train import train

    for name, preset in pconfig.PRESETS.items():
        pconfig.PRESETS[name] = dict(preset, arch=dict(preset["arch"], **arch))
    os.chdir(workdir)
    train.main(argv)
    return sorted(os.listdir(os.path.join(workdir, "run")))


def main(job_path: str) -> None:
    torch.set_num_threads(2)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    assert pdist.maybe_initialize_distributed(device="cpu") is True
    results = {}
    for name, fn, kwargs in job["cases"]:
        mesh = make_mesh(*kwargs.pop("mesh_shape", (1, 2)), device="cpu")
        results[name] = CASES[fn](mesh, **kwargs)
    with open(f"{job['out']}.{pdist.process_index()}", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1])

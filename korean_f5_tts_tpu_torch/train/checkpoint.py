"""Weight converter and training checkpoints, in the JAX package's .npz format.

Counterpart of korean_f5_tts_tpu/train/checkpoint.py (flatten_tree,
unflatten_tree, save/load, rotation, resume precedence) and the .npz prefix
logic of infer/model.py:94-109. This is the one place where layouts change
between the packages:

  - linear weights: JAX [d_in, d_out] -> torch [d_out, d_in] (transposed),
    the int8 "w_int8" of a quantized linear (models/quant.py) as well;
  - the int8 linears' "w_scale" stays fp32 whatever `dtype` asks for (the
    JAX package quantizes after its dtype cast, infer/model.py:170-184);
  - embedding tables ("embed/w", 2-D): kept [num, dim];
  - conv weights (3-D "w"): kept in the JAX layout [k, c_in/groups, c_out],
    which the grouped-conv kernel reads as is;
  - every other leaf (biases, norms, grn gamma/beta, layer scales): kept.

The inverse, params_to_jax, undoes the transposes, so a checkpoint
round-trips exactly.

A training checkpoint holds "params/..." and "ema_params/..." (JAX
layouts), "update", and "opt_leaves/NNNNN": the optax state's leaves in its
own order (checkpoint.py:63-79), which for train/step.py's AdamW is the adam
count, every mu leaf, every nu leaf, the schedule count; under gradient
accumulation (step.py:MultiSteps, optax's MultiStepsState) it is mini_step,
gradient_step, those leaves, then every acc_grads leaf. Within mu, nu and
acc_grads the leaves follow jax.tree_util's order: dict keys sorted, lists
by index (so blocks/10 comes after blocks/9), in the JAX layout like the
weights they belong to. Either package's Trainer resumes from the other's,
mid-accumulation too.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from korean_f5_tts_tpu_torch.utils.misc import require_device


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/0/b": leaf} ('/'-joined paths, as the JAX .npz)."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            out[path] = node

    walk(tree, prefix)
    return out


def unflatten_tree(flat: dict[str, Any]) -> Any:
    """Inverse of flatten_tree: all-numeric key levels become lists."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[k]) for k in sorted(keys, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _is_linear_weight(path: str, ndim: int) -> bool:
    parts = path.split("/")
    return (parts[-1] in ("w", "w_int8") and ndim == 2
            and not (len(parts) > 1 and parts[-2] == "embed"))


def params_from_jax(flat: dict[str, np.ndarray], device="cuda",
                    dtype: torch.dtype | None = None) -> Any:
    """Flat JAX params ({"a/0/w": array}, as in the .npz; flatten_tree makes
    one from a tree) -> the port's tree of tensors on `device` (the card
    unless the caller names the CPU); floating leaves cast to `dtype` when
    given."""
    device = require_device(device)
    out = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if _is_linear_weight(path, arr.ndim):
            arr = arr.T  # [d_in, d_out] -> [d_out, d_in]
        t = torch.tensor(np.ascontiguousarray(arr), device=device)
        if dtype is not None and t.is_floating_point() and not path.endswith("/w_scale"):
            t = t.to(dtype)
        out[path] = t
    return unflatten_tree(out)


def params_to_jax(tree: Any) -> dict[str, np.ndarray]:
    """The port's tree -> flat {path: numpy array} in the JAX layouts."""
    out = {}
    for path, t in flatten_tree(tree).items():
        arr = t.detach().cpu().float().numpy() if t.is_floating_point() else t.cpu().numpy()
        if _is_linear_weight(path, arr.ndim):
            arr = np.ascontiguousarray(arr.T)
        out[path] = arr
    return out


def load_npz_params(path: str, use_ema: bool = True) -> dict[str, np.ndarray]:
    """Flat JAX params of a .npz checkpoint: the "ema_params/" subtree when
    asked for and present, else "params/", else the whole file."""
    data = dict(np.load(path, allow_pickle=False))
    prefix = ("ema_params/" if use_ema and any(k.startswith("ema_params/") for k in data)
              else "params/")
    sub = {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}
    return sub if sub else data


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------


def jax_leaf_order(paths) -> list[str]:
    """Flat paths in jax.tree_util's leaf order: keys sorted at every level,
    list indices numerically."""
    def key(path: str):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in path.split("/"))

    return sorted(paths, key=key)


def opt_state_to_leaves(opt_state: dict) -> list[np.ndarray]:
    """train/step.py's optimizer state -> optax's leaf list (JAX layouts)."""
    if "acc_grads" in opt_state:  # MultiSteps
        acc = params_to_jax(opt_state["acc_grads"])
        return ([np.asarray(opt_state["mini_step"], np.int32),
                 np.asarray(opt_state["gradient_step"], np.int32)]
                + opt_state_to_leaves(opt_state["inner"]) + [acc[k] for k in jax_leaf_order(acc)])
    mu, nu = params_to_jax(opt_state["mu"]), params_to_jax(opt_state["nu"])
    order = jax_leaf_order(mu)
    return ([np.asarray(opt_state["count"], np.int32)] + [mu[k] for k in order]
            + [nu[k] for k in order] + [np.asarray(opt_state["sched_count"], np.int32)])


def opt_state_from_leaves(leaves: list, params, device="cuda") -> dict:
    """optax's leaf list -> train/step.py's optimizer state for `params`'s
    tree: AdamW's 2n + 2 leaves for n parameters, or MultiSteps' 3n + 4."""
    order = jax_leaf_order(flatten_tree(params))
    n = len(order)
    if len(leaves) == 3 * n + 4:
        return {"mini_step": int(leaves[0]), "gradient_step": int(leaves[1]),
                "inner": opt_state_from_leaves(leaves[2:2 * n + 4], params, device=device),
                "acc_grads": params_from_jax(dict(zip(order, leaves[2 * n + 4:])), device=device)}
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters: want {2 * n + 2} "
                         f"(AdamW) or {3 * n + 4} (MultiSteps)")
    return {"count": int(leaves[0]),
            "mu": params_from_jax(dict(zip(order, leaves[1:n + 1])), device=device),
            "nu": params_from_jax(dict(zip(order, leaves[n + 1:2 * n + 1])), device=device),
            "sched_count": int(leaves[-1])}


def save_checkpoint(path: str, params, opt_state: dict | None = None, ema_params=None,
                    update: int = 0) -> None:
    """One .npz holding the bundle, written to a temporary file first."""
    flat = {f"params/{k}": v for k, v in params_to_jax(params).items()}
    if ema_params is not None:
        flat.update({f"ema_params/{k}": v for k, v in params_to_jax(ema_params).items()})
    if opt_state is not None:
        for i, leaf in enumerate(opt_state_to_leaves(opt_state)):
            flat[f"opt_leaves/{i:05d}"] = leaf
    flat["update"] = np.asarray(update)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda") -> dict:
    """{"update", "params", "ema_params" (when present), "opt_leaves" (numpy,
    when present)}: the trees are the port's, on `device`."""
    data = dict(np.load(path, allow_pickle=False))
    out: dict[str, Any] = {"update": int(data.pop("update", 0))}
    groups: dict[str, dict] = {}
    for k, v in data.items():
        head, _, rest = k.partition("/")
        groups.setdefault(head, {})[rest] = v
    opt_leaves = groups.pop("opt_leaves", None)
    if opt_leaves is not None:
        out["opt_leaves"] = [opt_leaves[k] for k in sorted(opt_leaves)]
    for head in ("params", "ema_params"):
        if head in groups:
            out[head] = params_from_jax(groups[head], device=device)
    return out


def _dcp_leaves(tree, mesh) -> dict:
    """A tree's tensor leaves by path, each a DTensor over the mesh (Shard
    along its parameter_partition_spec dim on "model", Replicate on "data")
    or, without a mesh, the tensor itself; other leaves (counts) as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from korean_f5_tts_tpu_torch.parallel.mesh import model_parallel, shard_dim

    out = {}
    for path, leaf in flatten_tree(tree).items():
        if mesh is None or not isinstance(leaf, torch.Tensor):
            out[path] = leaf
            continue
        dim = shard_dim(path, leaf) if model_parallel(mesh) else None
        model = Replicate() if dim is None else Shard(dim)
        out[path] = DTensor.from_local(leaf, mesh, [Replicate(), model], run_check=False)
    return out


def _dcp_state(params, opt_state, ema_params, update: int, mesh) -> dict:
    state = {"params": _dcp_leaves(params, mesh), "update": update}
    if ema_params is not None:
        state["ema_params"] = _dcp_leaves(ema_params, mesh)
    if opt_state is not None:
        state["opt_state"] = _dcp_leaves(opt_state, mesh)
    return state


def save_checkpoint_orbax(path: str, params, opt_state: dict | None = None, ema_params=None,
                          update: int = 0, mesh=None) -> None:
    """The sharded multi-process checkpoint (the JAX Trainer's "orbax"
    format, checkpoint.py:118-133), written with torch.distributed.checkpoint
    into the directory `path`: every process writes its own slices of the
    split leaves (parallel/mesh.py:param_partition_spec) and one copy of the
    replicated ones is kept, with no gather to one host. Every process of
    the mesh calls it. The trees are the port's (torch layouts), and the
    optimizer state keeps train/step.py's structure; a JAX orbax directory is
    not read."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_dcp_state(params, opt_state, ema_params, update, mesh),
             checkpoint_id=os.path.abspath(path))


def load_checkpoint_orbax(path: str, params, opt_state: dict | None = None, ema_params=None,
                          mesh=None) -> dict:
    """Read a save_checkpoint_orbax directory into copies of the given trees
    (this process's share of each, as shaped and placed): {"update",
    "params", "opt_state", "ema_params"}."""
    import torch.distributed.checkpoint as dcp

    copy = lambda tree: unflatten_tree({  # noqa: E731
        k: v.detach().clone() if isinstance(v, torch.Tensor) else v
        for k, v in flatten_tree(tree).items()})
    trees = {"params": copy(params)}
    if opt_state is not None:
        trees["opt_state"] = copy(opt_state)
    if ema_params is not None:
        trees["ema_params"] = copy(ema_params)
    state = _dcp_state(trees["params"], trees.get("opt_state"), trees.get("ema_params"), 0, mesh)
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    out = {"update": int(state["update"])}
    for name, tree in trees.items():
        loaded = {k: v.to_local() if hasattr(v, "to_local") else v
                  for k, v in state[name].items()}
        flat = flatten_tree(tree)
        for k, v in loaded.items():
            if isinstance(v, torch.Tensor):
                flat[k].copy_(v)
            else:
                flat[k] = v
        out[name] = unflatten_tree(flat)
    return out


_CKPT_RE = re.compile(r"model_(\d+)\.npz$")
_ORBAX_RE = re.compile(r"model_(\d+)_orbax$")


def resolve_resume_orbax(ckpt_dir: str, explicit: str | None = None) -> str | None:
    """The "orbax" format's precedence: explicit -> model_last_orbax ->
    highest numbered model_N_orbax."""
    if explicit:
        return explicit
    if not os.path.isdir(ckpt_dir):
        return None
    files = os.listdir(ckpt_dir)
    if "model_last_orbax" in files:
        return os.path.join(ckpt_dir, "model_last_orbax")
    numbered = sorted((int(m.group(1)), f) for f in files if (m := _ORBAX_RE.search(f)))
    return os.path.join(ckpt_dir, numbered[-1][1]) if numbered else None


def rotate_checkpoints(ckpt_dir: str, keep_last_n: int) -> None:
    """Delete the oldest numbered checkpoints beyond keep_last_n
    (checkpoint.py:100-115): < 0 keeps all, 0 keeps none; pretrained_*
    files are never rotated."""
    if keep_last_n < 0:
        return
    numbered = sorted((int(m.group(1)), f) for f in os.listdir(ckpt_dir)
                      if (m := _CKPT_RE.search(f)) and not f.startswith("pretrained_"))
    for _, f in (numbered if keep_last_n == 0 else numbered[:-keep_last_n]):
        os.remove(os.path.join(ckpt_dir, f))


def resolve_resume_checkpoint(ckpt_dir: str, explicit: str | None = None) -> str | None:
    """Load precedence (checkpoint.py:142-162): explicit -> model_last ->
    highest numbered -> pretrained."""
    if explicit:
        return explicit
    if not os.path.isdir(ckpt_dir):
        return None
    files = os.listdir(ckpt_dir)
    if "model_last.npz" in files:
        return os.path.join(ckpt_dir, "model_last.npz")
    numbered = sorted((int(m.group(1)), f) for f in files
                      if (m := _CKPT_RE.search(f)) and not f.startswith("pretrained_"))
    if numbered:
        return os.path.join(ckpt_dir, numbered[-1][1])
    pretrained = sorted(f for f in files if f.startswith("pretrained_"))
    return os.path.join(ckpt_dir, pretrained[0]) if pretrained else None

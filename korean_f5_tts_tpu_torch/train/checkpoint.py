"""Weight converter: JAX parameter trees and .npz checkpoints -> the port.

Counterpart of korean_f5_tts_tpu/train/checkpoint.py:23-60 (flatten_tree /
unflatten_tree) and the .npz prefix logic of infer/model.py:94-109. This is
the one place where layouts change between the packages:

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
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch


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


def params_from_jax(flat: dict[str, np.ndarray], device="cpu",
                    dtype: torch.dtype | None = None) -> Any:
    """Flat JAX params ({"a/0/w": array}, as in the .npz; flatten_tree makes
    one from a tree) -> the port's tree of tensors on `device`; floating
    leaves cast to `dtype` when given."""
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

"""Device mesh and sharding rules, data x model (counterpart of
korean_f5_tts_tpu/parallel/mesh.py).

One process drives one device, and the mesh is a
torch.distributed.device_mesh.DeviceMesh over every process with the dims
("data", "model"): rank = data_rank * n_model + model_rank.

  - data parallel (the reference's Accelerate DDP): each data rank holds
    its rows of the global batch (shard_batch, distributed.make_global_batch)
    and the gradients are summed over the data group (train/step.py).
  - tensor parallel (the reference's TRT-LLM head split): each model rank
    holds its columns of to_q/k/v and ff/in and its rows of to_out and
    ff/out (shard_params), runs the kernels on its heads and columns and
    all-reduces over the model group (parallel/tp_kernels.py). The heads
    must split evenly (models/modules.py:local_heads raises otherwise).

Every backbone takes both: the DiT, the UNetT (its layers' attn and ff;
skip_proj replicated) and the MMDiT (to_q_c/k_c/v_c and ff_x/in, ff_c/in
split like the audio stream's columns, to_out_c like to_out; the last
block has no to_out_c and no ff_c; audio_proj and the AdaLN linears
replicated). The mesh is an explicit `mesh=` argument of the sampler, the
backbone forwards, the loss, the training step and the Trainer; PyTorch
has no counterpart of JAX's ambient `with mesh:`. None means one device.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from korean_f5_tts_tpu_torch.utils.misc import require_device

AXES = ("data", "model")
_COL = ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c", "ff/in", "ff_x/in", "ff_c/in")
_ROW = ("to_out", "ff/out", "ff_x/out", "ff_c/out")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_data: int | None = None, n_model: int = 1, device="cuda"):
    """An (n_data, n_model) DeviceMesh over the process group, dims named
    ("data", "model"); n_data None takes every process. Without a process
    group one is started for this process alone (world size 1, NCCL on the
    card, gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = require_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} does not cover the {world} processes")
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                                rank=0)
    return init_device_mesh(device.type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along "data" or "model" (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along "data" or "model" (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def model_parallel(mesh) -> bool:
    return axis_size(mesh, "model") > 1


def param_partition_spec(path: str, leaf: torch.Tensor) -> tuple:
    """The model-axis split of a parameter, one entry per dim (mesh.py:32-54
    on the port's layouts): attention q/k/v and FF-in are column-parallel,
    attention out and FF-out row-parallel; the int8 w_int8 splits like its
    fp weight; bias and w_scale follow the columns. Linear weights are
    [out, in] here, so the JAX P(None, "model") is ("model", None)."""
    names = path.split("/")
    col = any(k in path for k in _COL)
    row = any(k in path for k in _ROW)
    if leaf.dim() == 2 and names[-1] in ("w", "w_int8"):
        if col:
            return ("model", None)
        if row:
            return (None, "model")
    if leaf.dim() == 1 and names[-1] in ("b", "w_scale") and col:
        return ("model",)
    return ()


def shard_dim(path: str, leaf) -> int | None:
    """The dim a parameter (or an optimizer leaf at the parameter's path
    under mu/, nu/, acc_grads/) splits along on the model axis, or None
    (also for the optimizer's counts)."""
    if not isinstance(leaf, torch.Tensor):
        return None
    spec = param_partition_spec(path, leaf)
    return spec.index("model") if "model" in spec else None


def shard_params(params, mesh):
    """This process's share of a parameter tree (or an optimizer state over
    one): split leaves cut to the model rank's slice, replicated leaves as
    they are (every process holds the same, identically initialised tree).
    Each slice is a contiguous copy of its own, 16-byte aligned, as the
    kernels require (and their tensor maps are cached by pointer)."""
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree

    tp, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    out = {}
    for path, leaf in flatten_tree(params).items():
        dim = shard_dim(path, leaf) if tp > 1 else None
        if dim is None:
            out[path] = leaf
            continue
        if leaf.shape[dim] % tp:
            raise ValueError(f"shard_params: {path} {tuple(leaf.shape)} does not split "
                             f"{tp} ways along dim {dim}")
        out[path] = leaf.chunk(tp, dim=dim)[r].clone(memory_format=torch.contiguous_format)
    return unflatten_tree(out)


def gather_model(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """All-gather a tensor's model-axis slices along `dim` (through the CPU
    when the group is gloo, which all-gathers host tensors only)."""
    group = axis_group(mesh, "model")
    src = t.detach().cpu() if dist.get_backend(group) == "gloo" else t.detach()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, "model"))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def unshard_params(params, mesh):
    """The whole tree from each model rank's share (shard_params' inverse);
    every process of the model group calls it."""
    from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree

    if not model_parallel(mesh):
        return params
    out = {}
    for path, leaf in flatten_tree(params).items():
        dim = shard_dim(path, leaf)
        out[path] = leaf if dim is None else gather_model(leaf, mesh, dim)
    return unflatten_tree(out)


def shard_batch(batch: dict, mesh) -> dict:
    """This data rank's rows of every leaf (the leading dim split on the
    "data" axis; the model ranks of one data group hold the same rows). The
    rows must divide evenly: pad with distributed.pad_rows first."""
    dp, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows for {dp} data ranks")
        out[k] = v.chunk(dp, dim=0)[r]
    return out

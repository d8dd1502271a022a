"""Multi-process training support on torch.distributed (counterpart of
korean_f5_tts_tpu/parallel/distributed.py).

One process drives one device. The process group is started from the JAX
package's own variables (distributed.py:29-50):

  F5_TTS_DIST_COORDINATOR   host:port of process 0 (tcp:// rendezvous)
  F5_TTS_DIST_NUM_PROCESSES world size
  F5_TTS_DIST_PROCESS_ID    this process's rank

F5_TTS_DIST_AUTO=1 takes the launcher's environment instead (torchrun's
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), as JAX takes a pod's. Each
process feeds only its own rows of the global batch: shard_rows_for_process
splits a packed batch, equalize_padded_dims and pad_rows give every process
the same local shape, make_global_batch places the rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from korean_f5_tts_tpu_torch.utils.misc import require_device


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def maybe_initialize_distributed(device="cuda", backend: str | None = None) -> bool:
    """Start the process group if the environment asks for one, and return
    True when more than one process runs.

    The backend is NCCL on the card and gloo for device="cpu"; `backend`
    overrides it (gloo on the card takes CUDA tensors for all-reduce and
    broadcast, which is what two ranks sharing one card need: NCCL refuses
    two ranks on one device). On the card each rank takes device
    rank % device_count as its current device.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    device = require_device(device)
    backend = backend or _default_backend(device)
    coord = os.environ.get("F5_TTS_DIST_COORDINATOR")
    if coord:
        world = int(os.environ["F5_TTS_DIST_NUM_PROCESSES"])
        rank = int(os.environ["F5_TTS_DIST_PROCESS_ID"])
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world,
                                rank=rank)
    elif os.environ.get("F5_TTS_DIST_AUTO") == "1":
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ["RANK"]) % torch.cuda.device_count())
        dist.init_process_group(backend)
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_rows_for_process(indices: list, rank: int, world: int) -> list:
    """Deterministic per-process row split of one packed batch: row r goes to
    process r % world (the DistributedSampler convention). Every process
    computes the same split from the same sampler stream."""
    return [idx for r, idx in enumerate(indices) if r % world == rank]


def make_global_batch(local_batch: dict, mesh, device=None) -> tuple[dict, int]:
    """This process's rows of the global batch on its device, and the global
    row count (distributed.py:68-83, where one jax.Array per leaf holds
    them all).

    The rows are the "data" axis shard of the mesh; every data rank must
    hold the same number (pad_rows), which is checked here, and the model
    ranks of one data group the same rows. Local leaves must have identical
    non-batch dims across processes (equalize_padded_dims first)."""
    from korean_f5_tts_tpu_torch.parallel.mesh import axis_size

    rows = int(local_batch["mel"].shape[0])
    counts = [None] * process_count()
    dist.all_gather_object(counts, rows)
    if len(set(counts)) != 1:
        raise ValueError(f"make_global_batch: every process needs the same row count, got {counts}")
    device = device if device is not None else torch.device(mesh.device_type)
    placed = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in local_batch.items()}
    return placed, rows * axis_size(mesh, "data")


def equalize_padded_dims(batch: dict) -> dict:
    """All-gather each process's mel and text lengths and pad to the global
    maximum, so every process's local rows have one shape
    (distributed.py:86-110): mel pads with 0, text with -1 (the tokenizer's
    pad id), lens unchanged."""
    if process_count() == 1:
        return batch
    dims = [None] * process_count()
    dist.all_gather_object(dims, (int(batch["mel"].shape[1]), int(batch["text"].shape[1])))
    n_mel, n_text = max(d[0] for d in dims), max(d[1] for d in dims)
    mel, text = batch["mel"], batch["text"]
    if mel.shape[1] < n_mel:
        mel = np.concatenate(
            [mel, np.zeros((mel.shape[0], n_mel - mel.shape[1], mel.shape[2]), mel.dtype)],
            axis=1)
    if text.shape[1] < n_text:
        text = np.concatenate(
            [text, np.full((text.shape[0], n_text - text.shape[1]), -1, text.dtype)], axis=1)
    return {**batch, "mel": mel, "text": text}


def pad_rows(batch: dict, rows: int) -> dict:
    """Pad a local batch to exactly `rows` rows with zero-length items (lens
    0: an empty loss span, nothing added to the loss or its denominator)."""
    b = batch["mel"].shape[0]
    if b >= rows:
        return batch
    pad = rows - b
    return {
        "mel": np.concatenate(
            [batch["mel"], np.zeros((pad, *batch["mel"].shape[1:]), batch["mel"].dtype)]),
        "text": np.concatenate(
            [batch["text"], np.full((pad, batch["text"].shape[1]), -1, batch["text"].dtype)]),
        "lens": np.concatenate([batch["lens"], np.zeros(pad, batch["lens"].dtype)]),
    }

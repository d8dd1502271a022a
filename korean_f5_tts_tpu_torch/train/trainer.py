"""Trainer: epochs over frame-budgeted batches, checkpoints, logging, resume
(counterpart of korean_f5_tts_tpu/train/trainer.py).

Each update runs train/step.py:train_step with a seed of
fold_in(resumable_with_seed, update), as the JAX Trainer folds the update
into its key (trainer.py:357), so a resumed run draws what an uninterrupted
one does. Checkpoints are the JAX package's .npz (train/checkpoint.py) and
cross between the packages both ways.

grad_accumulation_steps k > 1 wraps the optimizer in train/step.py:MultiSteps
(optax.MultiSteps, trainer.py:151-154): `update` counts mini-steps, as in the
JAX Trainer, and the weights move on every k-th.

`mesh` (parallel/mesh.py; trainer.py:264-324) trains on this process's
share: `params` is shard_params' output, each process loads its data rank's
rows of every packed batch (_load_local_batch: row r to data rank r %
n_data, padded with zero-length rows to one count) and train_step sums the
gradients over the data group. Checkpoints: "npz" gathers the split leaves
and process 0 writes the JAX package's file; "orbax" is the sharded
multi-process format, a torch.distributed.checkpoint directory that every
process writes its slices to (train/checkpoint.py:save_checkpoint_orbax; a
JAX orbax directory is not read). logger "wandb" logs through wandb
(imported when asked for), and log_samples with a sample_fn(ema_params,
update) -> (wav, sr) logs a sample at every save (trainer.py:374-385).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from korean_f5_tts_tpu_torch.config import CFMConfig
from korean_f5_tts_tpu_torch.data.dataset import DynamicBatchSampler, collate_batch
from korean_f5_tts_tpu_torch.infer.model import load_checkpoint_into_pytree
from korean_f5_tts_tpu_torch.parallel import distributed as dist_lib
from korean_f5_tts_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    shard_batch,
    shard_params,
    unshard_params,
)
from korean_f5_tts_tpu_torch.train import checkpoint as ckpt_lib
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.train.step import (
    MultiSteps,
    TrainState,
    init_train_state,
    make_optimizer,
    train_step,
)
from korean_f5_tts_tpu_torch.utils.misc import fold_in

class _Prefetcher:
    """Bounded background iterator: overlaps host-side batch preparation
    (audio IO, wav -> mel, collate) with the device step (trainer.py:38-74)."""

    _SENTINEL = object()

    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None

        def run():
            try:
                for item in gen:
                    self._q.put(item)
            except BaseException as e:  # raised again on the consumer side
                self._exc = e
            finally:
                self._q.put(self._SENTINEL)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


class _StaticBatches:
    """Fixed-size index chunks (batch_size_type "sample")."""

    def __init__(self, n: int, size: int):
        self.batches = [list(range(i, min(i + size, n))) for i in range(0, n, size)]

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class _WandbWriter:
    """SummaryWriter-shaped adapter over wandb (trainer.py:77-91; the
    reference logs through accelerate's wandb tracker)."""

    def __init__(self, wandb_module):
        self._wandb = wandb_module

    def add_scalar(self, tag, value, step):
        self._wandb.log({tag: value}, step=step)

    def add_audio(self, tag, audio, step, sample_rate=24_000):
        self._wandb.log({tag: self._wandb.Audio(audio, sample_rate=sample_rate)}, step=step)


class Trainer:
    def __init__(self, params: Any, arch: Any, epochs: int = 1, learning_rate: float = 7.5e-5,
                 num_warmup_updates: int = 20_000, total_updates: int = 1_200_000,
                 save_per_updates: int = 50_000, keep_last_n_checkpoints: int = -1,
                 checkpoint_path: str = "ckpts/run", batch_size_per_gpu: int = 38_400,
                 batch_size_type: str = "frame", max_samples: int = 64,
                 grad_accumulation_steps: int = 1, max_grad_norm: float = 1.0,
                 cfm: CFMConfig = CFMConfig(), ema_decay: float = 0.999,
                 last_per_updates: int = 5_000, log_dir: str | None = None,
                 logger: str | None = "tensorboard", mesh=None,
                 vocab_char_map: dict[str, int] | None = None, tokenize_fn=None,
                 log_samples: bool = False, sample_fn=None,
                 compute_dtype: torch.dtype | None = None, ckpt_format: str = "npz"):
        if ckpt_format not in ("npz", "orbax"):
            raise ValueError(f"ckpt_format must be 'npz' or 'orbax', got {ckpt_format!r}")
        self.ckpt_format = ckpt_format
        self.mesh = mesh
        self.log_samples = log_samples
        self.sample_fn = sample_fn  # (ema_params, update) -> (wav, sr) | None
        self.arch = arch
        self.epochs = epochs
        self.save_per_updates = save_per_updates
        self.last_per_updates = last_per_updates
        self.keep_last_n_checkpoints = keep_last_n_checkpoints
        self.checkpoint_path = checkpoint_path
        self.batch_size_per_gpu = batch_size_per_gpu
        self.batch_size_type = batch_size_type
        self.max_samples = max_samples
        self.cfm = cfm
        self.ema_decay = ema_decay
        self.vocab_char_map = vocab_char_map
        self.tokenize_fn = tokenize_fn
        self.compute_dtype = compute_dtype
        self.device = next(iter(flatten_tree(params).values())).device
        self.optimizer = make_optimizer(learning_rate=learning_rate,
                                        # the reference multiplies warmup by the process count
                                        warmup_updates=num_warmup_updates
                                        * axis_size(mesh, "data"),
                                        total_updates=total_updates,
                                        max_grad_norm=max_grad_norm)
        if grad_accumulation_steps > 1:
            self.optimizer = MultiSteps(self.optimizer, grad_accumulation_steps)
        self.state = init_train_state(params, self.optimizer, ema_decay=ema_decay)
        self.writer = None
        if logger == "tensorboard":
            try:  # tensorboard is optional, as in the JAX Trainer
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(log_dir or os.path.join(checkpoint_path, "tb"))
        elif logger == "wandb":
            try:  # wandb is optional too (trainer.py:165-176): no wandb, no logging
                import wandb
            except ImportError:
                wandb = None
                print("logger 'wandb': the wandb package is not installed; not logging")
            if wandb is not None:
                wandb.init(project=os.environ.get("WANDB_PROJECT", "korean-f5-tts"),
                           dir=log_dir or checkpoint_path, resume="allow")
                self.writer = _WandbWriter(wandb)

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, update: int, last: bool = False) -> str:
        """Every process of the mesh calls it: "orbax" writes each one's
        slices; "npz" gathers the split leaves and process 0 writes
        (trainer.py:193-214)."""
        os.makedirs(self.checkpoint_path, exist_ok=True)
        st = self.state
        if self.ckpt_format == "orbax":
            path = os.path.join(self.checkpoint_path,
                                "model_last_orbax" if last else f"model_{update}_orbax")
            ckpt_lib.save_checkpoint_orbax(path, st.params, opt_state=st.opt_state,
                                           ema_params=st.ema_params, update=update,
                                           mesh=self.mesh)
            return path
        path = os.path.join(self.checkpoint_path,
                            "model_last.npz" if last else f"model_{update}.npz")
        trees = [unshard_params(t, self.mesh) if t is not None else None
                 for t in (st.params, st.opt_state, st.ema_params)]
        if dist_lib.process_index() != 0:
            return ""
        ckpt_lib.save_checkpoint(path, trees[0], opt_state=trees[1], ema_params=trees[2],
                                 update=update)
        if not last:
            ckpt_lib.rotate_checkpoints(self.checkpoint_path, self.keep_last_n_checkpoints)
        return path

    def load_checkpoint(self, explicit: str | None = None) -> int:
        if self.ckpt_format == "orbax":
            path = ckpt_lib.resolve_resume_orbax(self.checkpoint_path, explicit)
            if path is None:
                return 0
            st = self.state
            data = ckpt_lib.load_checkpoint_orbax(path, st.params, st.opt_state, st.ema_params,
                                                  mesh=self.mesh)
            self.state = TrainState(data["params"], data["opt_state"], data.get("ema_params"),
                                    data["update"])
            self._log(f"resumed from {path} at update {data['update']}")
            return data["update"]
        path = ckpt_lib.resolve_resume_checkpoint(self.checkpoint_path, explicit)
        if path is None:
            return 0
        if not path.endswith(".npz"):
            # a reference .pt / .safetensors (the pretrained_* copy finetune_cli makes): its
            # weights at update 0 with a fresh optimizer and EMA, as the reference trainer
            # starts from a pretrained file
            params = ckpt_lib.params_from_jax(
                flatten_tree(load_checkpoint_into_pytree(path, self.arch)), device=self.device)
            self.state = init_train_state(shard_params(params, self.mesh), self.optimizer)
            self._log(f"started from the weights of {path}")
            return 0
        data = ckpt_lib.load_checkpoint(path, device=self.device)
        opt_state = self.state.opt_state
        if "opt_leaves" in data:
            opt_state = shard_params(ckpt_lib.opt_state_from_leaves(
                data["opt_leaves"], data["params"], device=self.device), self.mesh)
            if opt_state.keys() != self.state.opt_state.keys():
                raise ValueError(f"{path} holds the optimizer state of another "
                                 "grad_accumulation_steps setting than this Trainer's")
        ema = data.get("ema_params")
        self.state = TrainState(shard_params(data["params"], self.mesh), opt_state,
                                None if ema is None else shard_params(ema, self.mesh),
                                data["update"])
        self._log(f"resumed from {path} at update {data['update']}")
        return data["update"]

    def _log(self, msg: str) -> None:
        if dist_lib.process_index() == 0:
            print(msg)

    # -- training loop ------------------------------------------------------

    def _make_batches(self, dataset, seed: int | None):
        if self.batch_size_type == "frame":
            return DynamicBatchSampler(dataset, self.batch_size_per_gpu,
                                       max_samples=self.max_samples, random_seed=seed,
                                       drop_residual=False)
        return _StaticBatches(len(dataset), self.batch_size_per_gpu)

    def _load_local_batch(self, dataset, batch_idx) -> tuple[dict[str, np.ndarray], int | None]:
        """Host-side IO, mel and collate of this process's rows of one packed
        batch (prefetchable: no collective, no device placement;
        trainer.py:264-303). Returns the rows and, under a mesh of several
        processes, the row count every data rank pads to."""
        n_data = axis_size(self.mesh, "data")
        if n_data > 1 and dist_lib.process_count() > 1:
            rank = axis_rank(self.mesh, "data")
            local_idx = dist_lib.shard_rows_for_process(list(batch_idx), rank, n_data)
            rows = -(-len(batch_idx) // n_data)  # the same on every rank
            items = [dataset[i] for i in (local_idx or batch_idx[:1])]
            batch = collate_batch(items, self.vocab_char_map, self.tokenize_fn)
            local = {"mel": batch["mel"], "text": batch["text"], "lens": batch["mel_lengths"]}
            if not local_idx:  # a batch smaller than the data axis: one zero-length row
                local = {"mel": np.zeros_like(local["mel"][:1]),
                         "text": np.full_like(local["text"][:1], -1),
                         "lens": np.zeros(1, local["lens"].dtype)}
            return local, rows
        batch = collate_batch([dataset[i] for i in batch_idx], self.vocab_char_map,
                              self.tokenize_fn)
        return {"mel": batch["mel"], "text": batch["text"], "lens": batch["mel_lengths"]}, None

    def _place_batch(self, local: dict[str, np.ndarray],
                     rows: int | None = None) -> dict[str, torch.Tensor]:
        """Device placement, and under a mesh the collectives that give every
        process one shape (main thread only: their order must match across
        processes; trainer.py:305-324). One process under a data axis keeps
        its data rank's rows of a batch padded to a multiple of the axis."""
        if rows is not None:
            local = dist_lib.pad_rows(dist_lib.equalize_padded_dims(local), rows)
            return dist_lib.make_global_batch(local, self.mesh, self.device)[0]
        n_data = axis_size(self.mesh, "data")
        if n_data > 1:
            b = local["mel"].shape[0]
            local = shard_batch(dist_lib.pad_rows(local, b + (-b) % n_data), self.mesh)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in local.items()}

    def train(self, dataset, num_workers: int = 0, resumable_with_seed: int | None = None,
              resume_from: str | None = None, log_every: int = 10,
              max_updates: int | None = None) -> dict:
        start_update = self.load_checkpoint(resume_from)
        update = start_update
        sampler = self._make_batches(dataset, resumable_with_seed)
        batches_per_epoch = max(len(sampler), 1)
        start_epoch = start_update // batches_per_epoch
        skip_batches = start_update % batches_per_epoch
        base_seed = resumable_with_seed or 0
        losses: list[float] = []
        t0 = time.time()
        for epoch in range(start_epoch, self.epochs):
            sampler.set_epoch(epoch)

            def epoch_stream(epoch=epoch):
                for bi, batch_idx in enumerate(sampler):
                    if epoch == start_epoch and bi < skip_batches:
                        continue  # deterministic resume (trainer.py:340-347)
                    yield self._load_local_batch(dataset, batch_idx)

            stream = (_Prefetcher(epoch_stream(), depth=max(2, num_workers))
                      if num_workers > 0 else epoch_stream())
            for local, rows in stream:
                self.state, loss = train_step(
                    self.state, self._place_batch(local, rows), fold_in(base_seed, update),
                    self.arch, self.optimizer, self.cfm, ema_decay=self.ema_decay,
                    compute_dtype=self.compute_dtype, mesh=self.mesh)
                update += 1
                losses.append(float(loss))
                if update % log_every == 0:
                    dt = time.time() - t0
                    self._log(f"update {update} loss {np.mean(losses[-log_every:]):.4f} "
                              f"({log_every / max(dt, 1e-9):.2f} it/s)")
                    t0 = time.time()
                    if self.writer is not None:
                        self.writer.add_scalar("loss", losses[-1], update)
                if update % self.save_per_updates == 0:
                    self.save_checkpoint(update)
                    if self.log_samples and self.sample_fn is not None:
                        self._log_sample(update)
                if update % self.last_per_updates == 0:
                    self.save_checkpoint(update, last=True)
                if max_updates is not None and update - start_update >= max_updates:
                    self.save_checkpoint(update, last=True)
                    return {"updates": update, "losses": losses}
        self.save_checkpoint(update, last=True)
        return {"updates": update, "losses": losses}

    def _log_sample(self, update: int) -> None:
        """Periodic sample inference (trainer.py:374-385, the reference's
        trainer.py:415-457): sample_fn(ema_params, update) -> (wav, sr) or
        None, logged as audio. A failing sample_fn is reported and training
        goes on, as in the JAX Trainer."""
        try:
            out = self.sample_fn(self.state.ema_params, update)
        except Exception as e:  # the user's sampler: report it, keep training
            print(f"sample logging failed: {e!r}")
            return
        if out is not None and self.writer is not None:
            wav, sr = out
            self.writer.add_audio("sample", torch.from_numpy(
                np.asarray(wav, np.float32))[None, :], update, sample_rate=sr)

"""Training step: CFM loss, gradients, global-norm clip, AdamW, EMA, and
gradient accumulation (counterpart of korean_f5_tts_tpu/train/step.py and of
the optax transformations the JAX package builds).

The optimizers are plain tensor code that mirror optax term for term, so that
their state is optax's and checkpoints cross between the packages
(train/checkpoint.py):

  - AdamW, make_optimizer's chain (step.py:29-46):
    - clip_by_global_norm: g stays as it is when its global norm is below
      max_grad_norm, else becomes (g / norm) * max_grad_norm. (Not
      torch.nn.utils.clip_grad_norm_, which always scales by
      max_norm / (norm + 1e-6).)
    - scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, both
      bias-corrected with the incremented count; u = mu_hat / (sqrt(nu_hat) + eps).
    - add_decayed_weights: u += weight_decay * params.
    - scale_by_learning_rate: u *= -schedule(count), the count taken before
      it increments, so the first update uses schedule(0) = 1e-8.
    Its state is {"count", "mu", "nu", "sched_count"}: optax's leaves
    [1][0].count, mu, nu and [1][2].count.
  - PlainAdamW, a bare optax.adamw(lr) (what train_lora.py trains with): no
    clip, a constant lr, weight decay 1e-4. State {"count", "mu", "nu"}.
  - MultiSteps(inner, k), optax.MultiSteps(inner, k) with its defaults
    (trainer.py:151-154; optax 0.2.6 MultiSteps.update): the gradients of k
    mini-steps are averaged as a running mean, acc + (g - acc) / (mini_step
    + 1); on the k-th the inner optimizer takes that mean (clip, Adam, decay
    and schedule all see it, and only then do its counts move) and acc
    resets; on the others the update is zero. State {"mini_step",
    "gradient_step", "inner", "acc_grads"}, optax's MultiStepsState.

train_step counts every call (a mini-step under MultiSteps) and moves the
EMA on every call, as the JAX step does (step.py:105-109). Unlike the JAX
step, which donates its input state, it updates the state's tensors in
place.

Under a mesh (parallel/mesh.py) the state holds this process's share of
the parameters (shard_params) and the batch its data rank's rows. The
gradients are summed over the data group (the loss is each rank's share of
the global mean, models/cfm.py), the DDP step; the global-norm clip sums the
squares of the split leaves over the model group and counts the replicated
ones once, so the sharded step equals the single-device one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from korean_f5_tts_tpu_torch.config import CFMConfig, DiTConfig
from korean_f5_tts_tpu_torch.models.cfm import cfm_loss, cfm_loss_from_draws
from korean_f5_tts_tpu_torch.parallel.mesh import axis_group, axis_size, model_parallel, shard_dim
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree


def _aligned(tree, paths: list[str]) -> list[torch.Tensor]:
    """The leaves of a tree (or flat dict) of the given paths, in their order."""
    leaves = flatten_tree(tree)
    return [leaves[k] for k in paths]


def all_reduce_coalesced(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum a list of tensors over a process group with one all-reduce of
    their concatenation (the bucket DDP reduces)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def global_grad_norm(grads: list[torch.Tensor], paths: list[str], mesh=None) -> torch.Tensor:
    """optax.global_norm of the whole model's gradient: under a
    tensor-parallel mesh the split leaves' squares are summed over the model
    group, the replicated ones (equal on every rank) counted once."""
    sq = [torch.sum(g * g) for g in grads]
    if not model_parallel(mesh):
        return torch.sqrt(torch.stack(sq).sum())
    split = [shard_dim(p, g) is not None for p, g in zip(paths, grads)]
    local = torch.stack([s for s, m in zip(sq, split) if m]).sum()
    dist.all_reduce(local, group=axis_group(mesh, "model"))
    return torch.sqrt(local + torch.stack([s for s, m in zip(sq, split) if not m]).sum())


def _zeros_like(tree):
    return unflatten_tree({k: torch.zeros_like(v) for k, v in flatten_tree(tree).items()})


def _adamw_(params: list, grads: list, mu: list, nu: list, count: int, lr: float, b1: float,
            b2: float, eps: float, weight_decay: float) -> None:
    """scale_by_adam (count: the incremented one), add_decayed_weights,
    scale_by_learning_rate and apply_updates, in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    torch._foreach_add_(updates, params, alpha=weight_decay)
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(params, updates)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optax chain of make_optimizer: clip, AdamW, warmup/decay schedule."""
    learning_rate: float = 7.5e-5
    warmup_updates: int = 20_000
    total_updates: int = 1_200_000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01

    def schedule(self, count: int) -> float:
        """optax.join_schedules of linear 1e-8 -> lr over warmup_updates and
        lr -> 1e-8 over the rest, in float32 as optax computes it."""
        def linear(init: float, end: float, steps: int, c: int) -> np.float32:
            frac = np.float32(1) - np.float32(min(max(c, 0), steps)) / np.float32(steps)
            return np.float32(init - end) * frac + np.float32(end)

        lr = self.learning_rate
        if count < self.warmup_updates:
            return float(linear(1e-8, lr, self.warmup_updates, count))
        decay = max(self.total_updates - self.warmup_updates, 1)
        return float(linear(lr, 1e-8, decay, count - self.warmup_updates))

    def init(self, params) -> dict:
        return {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params),
                "sched_count": 0}

    def update_(self, params: list, grads: list, state: dict, paths: list[str],
                mesh=None) -> None:
        """One update of `params` (the leaves at `paths`) in place."""
        g_norm = global_grad_norm(grads, paths, mesh)
        trigger = g_norm < self.max_grad_norm
        grads = [torch.where(trigger, g, (g / g_norm) * self.max_grad_norm) for g in grads]
        count = state["count"] + 1
        _adamw_(params, grads, _aligned(state["mu"], paths), _aligned(state["nu"], paths),
                count, self.schedule(state["sched_count"]), self.b1, self.b2, self.eps,
                self.weight_decay)
        state["count"] = count
        state["sched_count"] += 1


@dataclasses.dataclass(frozen=True)
class PlainAdamW:
    """optax.adamw(learning_rate) with optax's defaults: no clip, no schedule."""
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> dict:
        return {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}

    def update_(self, params: list, grads: list, state: dict, paths: list[str],
                mesh=None) -> None:
        count = state["count"] + 1
        _adamw_(params, grads, _aligned(state["mu"], paths), _aligned(state["nu"], paths),
                count, self.learning_rate, self.b1, self.b2, self.eps, self.weight_decay)
        state["count"] = count


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """optax.MultiSteps(inner, every_k) with use_grad_mean (its default)."""
    inner: AdamW | PlainAdamW
    every_k: int

    def init(self, params) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc_grads": _zeros_like(params)}

    def update_(self, params: list, grads: list, state: dict, paths: list[str],
                mesh=None) -> None:
        acc = _aligned(state["acc_grads"], paths)
        # a 0-d tensor divisor: true division, as optax's (a Python number may
        # become a reciprocal multiply on the card)
        n = torch.tensor(state["mini_step"] + 1, dtype=torch.float32, device=acc[0].device)
        for a, g in zip(acc, grads):
            a.add_(torch.div(g - a, n))
        emit = state["mini_step"] == self.every_k - 1
        if emit:
            self.inner.update_(params, acc, state["inner"], paths, mesh)
            torch._foreach_zero_(acc)
            state["gradient_step"] += 1
        state["mini_step"] = (state["mini_step"] + 1) % self.every_k


def make_optimizer(learning_rate: float = 7.5e-5, warmup_updates: int = 20_000,
                   total_updates: int = 1_200_000, max_grad_norm: float = 1.0) -> AdamW:
    """AdamW + linear warmup/decay + global-norm clip (step.py:29-46)."""
    return AdamW(learning_rate=learning_rate, warmup_updates=warmup_updates,
                 total_updates=total_updates, max_grad_norm=max_grad_norm)


@dataclasses.dataclass
class TrainState:
    params: Any          # fp32 master weights (the port's tree)
    opt_state: dict      # the optimizer's state (its init)
    ema_params: Any | None
    step: int


def init_train_state(params, optimizer: AdamW | MultiSteps, use_ema: bool = True,
                     ema_decay: float = 0.999) -> TrainState:
    """A fresh state over a copy of `params` (the caller's tree is never
    updated in place); ema_decay is train_step's, as in the JAX signature."""
    del ema_decay
    params = unflatten_tree({k: v.detach().clone() for k, v in flatten_tree(params).items()})
    ema = (unflatten_tree({k: v.clone() for k, v in flatten_tree(params).items()})
           if use_ema else None)
    return TrainState(params=params, opt_state=optimizer.init(params), ema_params=ema, step=0)


def loss_and_grads(params, batch: dict, seed: int, arch: DiTConfig,
                   cfm: CFMConfig = CFMConfig(), compute_dtype: torch.dtype | None = None,
                   kernels: bool = True, draws: dict | None = None,
                   attn_path: str = "default",
                   mesh=None) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """fp32 loss and the gradient of every leaf of `params` (flatten_tree
    order) on a batch {mel [b, n, d], text [b, nt], lens [b]}.

    compute_dtype=torch.bfloat16 casts the fp32 leaves and the mel for the
    forward and backward (step.py:90-100); the gradients land on the fp32
    masters in fp32. `draws` (models/cfm.py:draw_cfm's dict), when given,
    replace the loss's draws from `seed`, and dropout is off. attn_path
    picks the attention kernels (ops/attention.py:ATTN_PATHS). Under a mesh
    the loss returned is the global one and the gradients are summed over
    the data group.
    """
    flat = flatten_tree(params)
    leaves = [t.detach().requires_grad_(True) for t in flat.values()]
    mel = batch["mel"]
    run = leaves
    if compute_dtype is not None:
        run = [t.to(compute_dtype) if t.dtype == torch.float32 else t for t in leaves]
        mel = mel.to(compute_dtype)
    tree = unflatten_tree(dict(zip(flat, run)))
    if draws is None:
        loss, _, _ = cfm_loss(tree, arch, mel, batch["text"], batch["lens"], seed, cfm=cfm,
                              kernels=kernels, attn_path=attn_path, mesh=mesh)
    else:
        loss, _, _ = cfm_loss_from_draws(tree, arch, mel, batch["text"], batch["lens"], draws,
                                         kernels=kernels, attn_path=attn_path, mesh=mesh)
    loss = loss.float()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach()
    if axis_size(mesh, "data") > 1:
        group = axis_group(mesh, "data")
        grads = all_reduce_coalesced(grads, group)
        dist.all_reduce(loss, group=group)
    return loss, grads


@torch.no_grad()
def apply_updates(state: TrainState, grads: list[torch.Tensor], optimizer: AdamW | MultiSteps,
                  ema_decay: float = 0.999, mesh=None) -> TrainState:
    """The optimizer's update and the EMA, in place on the state's tensors;
    grads in flatten_tree(state.params) order."""
    flat = flatten_tree(state.params)
    paths, params = list(flat), list(flat.values())
    optimizer.update_(params, grads, state.opt_state, paths, mesh)
    if state.ema_params is not None:
        ema = _aligned(state.ema_params, paths)
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
    state.step += 1
    return state


def train_step(state: TrainState, batch: dict, seed: int, arch: DiTConfig,
               optimizer: AdamW | MultiSteps, cfm: CFMConfig = CFMConfig(), ema_decay: float = 0.999,
               compute_dtype: torch.dtype | None = None, kernels: bool = True,
               draws: dict | None = None, attn_path: str = "default", mesh=None):
    """One update on a batch {mel [b, n, d], text [b, nt], lens [b]}; the
    loss's draws come from `seed` (or are `draws`, see loss_and_grads).
    Returns (state, loss), the state updated in place."""
    loss, grads = loss_and_grads(state.params, batch, seed, arch, cfm, compute_dtype, kernels,
                                 draws, attn_path=attn_path, mesh=mesh)
    return apply_updates(state, grads, optimizer, ema_decay, mesh=mesh), loss

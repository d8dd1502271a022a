"""Tensor-parallel execution of the Hopper kernels: each model rank runs the
single-device kernels on its heads and columns and all-reduces over the
model group (counterpart of korean_f5_tts_tpu/parallel/tp_kernels.py, whose
shard_map bodies run per shard what these functions run per process).

The parameters a rank holds are already its share (parallel/mesh.py:
shard_params), so the functions take local heads and local columns, and
there is no gather: what the JAX shard_map does with in_specs, the layout of
the process's own tensors does here.

Residual and bias accounting, as in JAX: a kernel that folds the residual
and the output bias into its epilogue (h + gate * (a @ w + b): kernels B, 4,
8, 6) runs per rank with b / tp, and (tp - 1) * h is subtracted after the
all-reduce, in h's dtype and in that order. The LayerNorm prologues read the
replicated h, so their statistics are exact per rank. Under int8 weights the
second quantization (kernels 4 and 6) reads each rank's own slice, so the
tensor-parallel int8 path is a different function from the single-device
one, as in JAX.

Under autograd the Megatron operators mark the region: copy_to_model
(identity forward, all-reduce backward) where a replicated value enters
per-rank products, reduce_from_model (all-reduce forward, identity
backward) after a row-parallel product. torch.distributed.nn's all_reduce
is not the second: its backward all-reduces the gradient too, which would
multiply a replicated loss's gradient by tp. reduce_residual is the fused
form: its backward hands the residual -(tp - 1) / tp of the gradient on each
rank, so that the copy_to_model sum over ranks gives h exactly one.
gather_from_model puts the ranks' q/k/v columns side by side where the heads
do not split over the model axis (models/modules.py:attention): each rank
then attends on every head, as XLA computes the whole function there.

Each function returns None where the JAX shape predicate fails (heads or
columns that do not split, JAX tp_kernels.py:208-209; rows not a multiple
of bm; a head dim or length the kernel does not take); the caller then
takes the per-rank route of plain products (models/modules.py), as JAX
takes its unfused one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from korean_f5_tts_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, gather_model


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceResidual(torch.autograd.Function):
    """all_reduce(out) - (tp - 1) * h, where every rank's out holds the
    residual h once."""

    @staticmethod
    def forward(ctx, out, h, tp, group):
        ctx.tp = tp
        s = out.contiguous().clone()
        dist.all_reduce(s, group=group)
        return s - (tp - 1) * h

    @staticmethod
    def backward(ctx, g):
        return g, g * (-(ctx.tp - 1) / ctx.tp), None, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's column slices of x side by side on every rank:
    forward, mesh.gather_model (an all-gather; through the host under gloo);
    backward, the gradient summed over the group (every rank's loss reads
    every column) and this rank's columns kept. That all-reduce moves about
    twice the bytes of a reduce-scatter, which gloo lacks; no shipped preset
    takes this path (their heads divide by 2 and 4)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank, ctx.tp = axis_rank(mesh, "model"), axis_size(mesh, "model")
        ctx.group = axis_group(mesh, "model")
        return gather_model(x, mesh, -1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        c = g.shape[-1] // ctx.tp
        return g[..., ctx.rank * c:(ctx.rank + 1) * c].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, axis_group(mesh, "model"))


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis_group(mesh, "model"))


def reduce_residual(out: torch.Tensor, h: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceResidual.apply(out, h, axis_size(mesh, "model"), axis_group(mesh, "model"))


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """[..., c] on each model rank -> [..., c * tp], the ranks' columns in
    rank order (_GatherFromModel)."""
    return _GatherFromModel.apply(x, mesh)


def model_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """This model rank's share of the last dim of a replicated x."""
    c = x.shape[-1] // axis_size(mesh, "model")
    r = axis_rank(mesh, "model")
    return x[..., r * c:(r + 1) * c]


def local_pe_attn_head(pe_attn_head: int | None, mesh, heads_local: int) -> int | None:
    """pe_attn_head counts global heads (only the first N rotate); rank r
    holds heads [r * heads_local, (r + 1) * heads_local), so its first
    pe_attn_head - r * heads_local heads rotate (tp_kernels.py:246-256).
    Kernels 18 and 19 take that count of leading heads."""
    if pe_attn_head is None:
        return None
    return max(0, min(pe_attn_head - axis_rank(mesh, "model") * heads_local, heads_local))


def _rows_ok(h: torch.Tensor, bm: int) -> bool:
    return (h.numel() // h.shape[-1]) % bm == 0


# ---------------------------------------------------------------------------
# attention core on the rank's heads
# ---------------------------------------------------------------------------


def flash_prefix_tp(q, k, v, kv_lens, mesh, kernels: bool = True):
    """Kernel A (kernels 10, 11, 13 under autograd) on this rank's heads,
    [b, h / tp, n, d] (tp_kernels.py:72-92). Attention is head-separable:
    no collective here, the all-reduce belongs to the output projection."""
    from korean_f5_tts_tpu_torch.ops.flash_prefix import flash_prefix_attention

    return flash_prefix_attention(q, k, v, kv_lens, kernels=kernels)


def flash_prefix_i8_tp(q, k, v, kv_lens, pv_i8: bool, mesh, kernels: bool = True):
    """Kernel 14 and its pass on this rank's heads (tp_kernels.py:95-114):
    the quantization is per folded head, so the result equals the
    single-device kernel's on these heads."""
    from korean_f5_tts_tpu_torch.ops.flash_prefix import flash_prefix_attention_i8

    return flash_prefix_attention_i8(q, k, v, kv_lens, pv_i8=pv_i8, kernels=kernels)


# ---------------------------------------------------------------------------
# fused FF half-block: column-parallel w1, row-parallel w2
# ---------------------------------------------------------------------------


def ff_block_tp(h, sc, sh, gate, w1, b1, w2, b2, mesh, kernels: bool = True, bm: int = 256):
    """h + gate * FF(mod_LN(h)) with this rank's w1 rows [ff / tp, d] (its
    columns in JAX's layout) and w2 columns [d, ff / tp]: kernel B per rank
    with b2 / tp, then the all-reduce minus (tp - 1) * h
    (tp_kernels.py:120-149). Serving only, as kernel B."""
    from korean_f5_tts_tpu_torch.ops.ff_block import ff_block_fused, ff_block_reference

    if not _rows_ok(h, bm):
        return None
    tp = axis_size(mesh, "model")
    dt = h.dtype
    fn = ff_block_fused if kernels else ff_block_reference
    out = fn(h, sc, sh, gate, w1.to(dt), b1.to(dt), w2.to(dt), (b2 / tp).to(dt))
    return reduce_residual(out, h, mesh)


def ff_block_int8_tp(h, sc, sh, gate, qp_in: dict, qp_out: dict, mesh, kernels: bool = True,
                     bm: int = 256):
    """The int8 FF half-block per rank (tp_kernels.py:152-187): kernel 4 on
    this rank's int8 columns and rows with qp_out's bias / tp. The first
    quantization reads the replicated mod-LN(h) and is exact per rank; the
    second quantizes this rank's own GELU slice."""
    from korean_f5_tts_tpu_torch.ops.ff_block import ff_block_fused_int8, ff_block_int8_reference

    if not _rows_ok(h, bm):
        return None
    tp = axis_size(mesh, "model")
    fn = ff_block_fused_int8 if kernels else ff_block_int8_reference
    out = fn(h, sc, sh, gate, qp_in, {**qp_out, "b": qp_out["b"] / tp})
    return reduce_residual(out, h, mesh)


# ---------------------------------------------------------------------------
# fused attention half-block: AdaLN -> qkv -> rope -> attention -> out-proj
# ---------------------------------------------------------------------------


def attn_half_block_tp(h, sc, sh, gate, ap: dict, heads: int, rope, pe_attn_head,
                       prefix_lens, mesh, kernels: bool = True, attn_int8: str | None = None,
                       bm: int = 256):
    """The fused attention half-block on this rank's heads
    (tp_kernels.py:190-293), models/modules.py:attention_half_fused with the
    mesh: kernel 7 (5 with int8 weights) on the rank's q | k | v columns, the
    head split of that local concat (so the heads stay aligned with the
    row-split to_out), rope on the heads whose global index is below
    pe_attn_head, kernel A (kernel 14 under attn_int8, which the JAX
    shard_map body does not offer), kernel 8 (6) with to_out's bias / tp,
    then the all-reduce minus (tp - 1) * h. heads is the global count."""
    from korean_f5_tts_tpu_torch.models.modules import attention_half_fused

    wkey = "w_int8" if "w_int8" in ap["to_q"] else "w"
    tp = axis_size(mesh, "model")
    n = h.shape[1]
    if heads % tp or not _rows_ok(h, bm):
        return None
    if ap["to_q"][wkey].shape[0] // (heads // tp) not in (64, 128) or n % 128:
        return None  # the prefix-attention kernel's eligibility (ops/attention.py gate)
    return attention_half_fused(ap, h, sc, sh, gate, heads, rope, pe_attn_head, prefix_lens,
                                kernels=kernels, attn_int8=attn_int8, mesh=mesh)

"""Prefix-masked attention: Hopper kernel A (serving forward), kernels 10-13
(training forward with logsumexp, the two dq sweeps, dk/dv) and their plain
versions.

Counterpart of korean_f5_tts_tpu/ops/flash_prefix.py. Every attention mask of
the model is a prefix mask, so one length per folded head describes it: head
i attends keys [0, kv_lens[i]). Kernel A (csrc/flash_prefix.cu) replaces the
TPU's _flash_prefix_folded; kernels 10-13 (csrc/flash_prefix_train.cu)
replace _flash_prefix_folded_lse, _flash_prefix_dq_lsein, _flash_prefix_dq
and _flash_prefix_dkv. The sources' notes say what bounds each kernel on the
card and how its design answers that.

Layouts: q/k/v/o and their gradients are folded [H, n, d]; lse (base 2, of
the scores pre-scaled by log2(e)/sqrt(d), the JAX convention) and
D = rowsum(dO * o) are fp32 [H, n] (the JAX arrays are [H, n, 1]). A row
with no valid key has lse 0.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise (bf16 operands only; the training kernels d = 64 only).
flash_prefix_attention takes the autograd Function (kernel 10 forward,
kernels 11 and 13 backward, as the JAX custom_vjp _fp_fwd/_fp_bwd does at
:1353-1402) when a gradient is being taken, and kernel A otherwise.
"""

from __future__ import annotations

import math

import torch

from korean_f5_tts_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
MASK_VALUE = -1e37  # the JAX reference's finite mask logit

# kernel launches by the wrappers (not plain calls)
launches = 0           # kernel A, flash_prefix_folded
launches_lse = 0       # kernel 10, flash_prefix_folded_lse
launches_dq_lsein = 0  # kernel 11, flash_prefix_dq_lsein
launches_dq = 0        # kernel 12, flash_prefix_dq
launches_dkv = 0       # kernel 13, flash_prefix_dkv


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _valid_keys(kv_lens: torch.Tensor, n: int, device) -> torch.Tensor:
    """[H, 1, n] bool: key j of head h is valid."""
    return (torch.arange(n, device=device)[None, :] < kv_lens.to(device)[:, None])[:, None, :]


def prefix_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kv_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: [H, n, d] q/k/v, [H] int kv_lens.

    Same formulation as the JAX reference _xla_prefix_attention: fp32 logits,
    fp32 softmax over the valid prefix, probabilities cast to v's dtype.
    Differentiable: autograd through it is the plain attention backward.
    """
    n, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~_valid_keys(kv_lens, n, q.device), MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _scores2(q: torch.Tensor, k: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """fp32 [H, n, n] scores in the base-2 domain, -inf at invalid keys."""
    n, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (LOG2E / math.sqrt(d))
    return s.masked_fill(~_valid_keys(kv_lens, n, q.device), -math.inf)


def _lse2(s2: torch.Tensor) -> torch.Tensor:
    """Base-2 logsumexp over the valid keys; 0 for a row with none."""
    lse = torch.logsumexp(s2 / LOG2E, dim=-1) * LOG2E
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def prefix_attention_lse_reference(q, k, v, kv_lens):
    """Plain version of kernel 10: (o [H, n, d], lse [H, n] fp32)."""
    return prefix_attention_reference(q, k, v, kv_lens), _lse2(_scores2(q, k, kv_lens))


def _probs_ds(q, k, v, do, dvec, lse, kv_lens):
    """Normalised P and dS = P * (dO.v^T - D), fp32 [H, n, n] each."""
    p = torch.exp2(_scores2(q, k, kv_lens) - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dvec.float()[..., None])


def flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens):
    """Plain version of kernel 11: dq = dS.k / sqrt(d), in fp32."""
    _, ds = _probs_ds(q, k, v, do, dvec, lse, kv_lens)
    return (torch.matmul(ds, k.float()) / math.sqrt(q.shape[-1])).to(q.dtype)


def flash_prefix_dq_reference(q, k, v, do, dvec, kv_lens):
    """Plain version of kernel 12: (dq, lse), the lse computed here."""
    lse = _lse2(_scores2(q, k, kv_lens))
    return flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens), lse


def flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv_lens):
    """Plain version of kernel 13: dk = dS^T.q / sqrt(d), dv = P^T.dO, in fp32."""
    p, ds = _probs_ds(q, k, v, do, dvec, lse, kv_lens)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) / math.sqrt(q.shape[-1])
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, q, kv_lens, others, head_dims=(64,)) -> tuple[int, int, int]:
    """Shape, dtype and device checks of a launch; returns (H, n, d)."""
    if q.dim() != 3 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{what}: q/k/v(/dO) must share one [H, n, d] shape, got "
                         f"{[tuple(t.shape) for t in (q, *others)]}")
    H, n, d = q.shape
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not supported ({head_dims})")
    if kv_lens.shape != (H,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"{what}: kv_lens must be int32 [{H}], got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes bf16 operands, got {q.dtype}; fp32 "
                        "operands are ROADMAP.md queue 2, 'fp32 operands for kernels A and "
                        "10-13'")
    cuda_build.require_cuda(what, q, *others, dtype=torch.bfloat16)
    cuda_build.require_cuda(what, q, kv_lens)
    return H, n, d


def _rows(what: str, H: int, n: int, *rows) -> None:
    for r in rows:
        if r.shape != (H, n) or r.dtype != torch.float32:
            raise ValueError(f"{what}: lse and D must be fp32 [{H}, {n}], got "
                             f"{r.dtype} {tuple(r.shape)}")
    cuda_build.require_cuda(what, *rows)


def flash_prefix_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_lens: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper: [H, n, d] bf16 q/k/v (d 64 or 128), [H] int32 kv_lens."""
    global launches
    if q.device.type == "cpu":
        return prefix_attention_reference(q, k, v, kv_lens)
    H, n, d = _check("flash_prefix", q, kv_lens, (k, v), head_dims=(64, 128))
    out = torch.empty_like(q)
    err = cuda_build.library().f5_flash_prefix_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        H, n, d, LOG2E / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_fwd")
    launches += 1
    return out


def flash_prefix_folded_lse(q, k, v, kv_lens):
    """Kernel 10 wrapper: (o [H, n, d], lse [H, n] fp32)."""
    global launches_lse
    if q.device.type == "cpu":
        return prefix_attention_lse_reference(q, k, v, kv_lens)
    H, n, d = _check("flash_prefix_lse", q, kv_lens, (k, v))
    out = torch.empty_like(q)
    lse = torch.empty((H, n), dtype=torch.float32, device=q.device)
    err = cuda_build.library().f5_flash_prefix_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        lse.data_ptr(), H, n, d, LOG2E / math.sqrt(d), q.device.index,
        cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_fwd_lse")
    launches_lse += 1
    return out, lse


def flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv_lens):
    """Kernel 11 wrapper: dq [H, n, d] from the forward's lse."""
    global launches_dq_lsein
    if q.device.type == "cpu":
        return flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens)
    H, n, d = _check("flash_prefix_dq_lsein", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dq_lsein", H, n, dvec, lse)
    dq = torch.empty_like(q)
    err = cuda_build.library().f5_flash_prefix_dq_lsein(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
        lse.data_ptr(), kv_lens.data_ptr(), dq.data_ptr(), H, n, d, LOG2E / math.sqrt(d),
        1.0 / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dq_lsein")
    launches_dq_lsein += 1
    return dq


def flash_prefix_dq(q, k, v, do, dvec, kv_lens):
    """Kernel 12 wrapper: (dq [H, n, d], lse [H, n]), the lse recomputed."""
    global launches_dq
    if q.device.type == "cpu":
        return flash_prefix_dq_reference(q, k, v, do, dvec, kv_lens)
    H, n, d = _check("flash_prefix_dq", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dq", H, n, dvec)
    dq = torch.empty_like(q)
    lse = torch.empty((H, n), dtype=torch.float32, device=q.device)
    err = cuda_build.library().f5_flash_prefix_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
        kv_lens.data_ptr(), dq.data_ptr(), lse.data_ptr(), H, n, d, LOG2E / math.sqrt(d),
        1.0 / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dq")
    launches_dq += 1
    return dq, lse


def flash_prefix_dkv(q, k, v, do, dvec, lse, kv_lens):
    """Kernel 13 wrapper: (dk, dv) [H, n, d]."""
    global launches_dkv
    if q.device.type == "cpu":
        return flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv_lens)
    H, n, d = _check("flash_prefix_dkv", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dkv", H, n, dvec, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = cuda_build.library().f5_flash_prefix_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
        lse.data_ptr(), kv_lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), H, n, d,
        LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dkv")
    launches_dkv += 1
    return dk, dv


# ---------------------------------------------------------------------------
# backward and autograd
# ---------------------------------------------------------------------------


def _folded_bwd(q, k, v, kv_lens, g, o, lse):
    """(dq, dk, dv) of folded heads: D = rowsum(dO * o) in fp32 (plain, as
    the JAX package leaves it to XLA), then kernel 11 (lse given) or 12, then
    kernel 13."""
    dvec = (g.float() * o.float()).sum(dim=-1)
    if lse is not None:
        dq = flash_prefix_dq_lsein(q, k, v, g, dvec, lse, kv_lens)
    else:
        dq, lse = flash_prefix_dq(q, k, v, g, dvec, kv_lens)
    dk, dv = flash_prefix_dkv(q, k, v, g, dvec, lse, kv_lens)
    return dq, dk, dv


def _fold(q, k, v, kv_lens):
    b, h, n, d = q.shape
    lens = kv_lens.to(device=q.device, dtype=torch.int32)
    if lens.shape[0] == 1 and b > 1:
        lens = lens.expand(b)
    fold = (b * h, n, d)
    return [t.reshape(fold).contiguous() for t in (q, k, v)], lens.repeat_interleave(h)


def flash_prefix_attention_bwd(q, k, v, kv_lens, g, o=None, lse=None):
    """(dq, dk, dv) of [b, h, n, d] prefix attention for the output gradient g
    (JAX flash_prefix_attention_bwd, :1246-1297). o: the forward output, run
    through kernel A when absent. lse: the forward's [b*h, n] logsumexp;
    given, dq takes kernel 11, absent, kernel 12, which recomputes it."""
    (qf, kf, vf), lens_h = _fold(q, k, v, kv_lens)
    gf = g.reshape(qf.shape).contiguous()
    of = flash_prefix_folded(qf, kf, vf, lens_h) if o is None else o.reshape(qf.shape)
    return tuple(t.reshape(q.shape) for t in _folded_bwd(qf, kf, vf, lens_h, gf, of, lse))


class FlashPrefixAttention(torch.autograd.Function):
    """Folded prefix attention with a kernel backward: the forward is kernel
    10 and keeps o and lse; the backward is D, kernel 11, kernel 13."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens):
        o, lse = flash_prefix_folded_lse(q, k, v, kv_lens)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        dq, dk, dv = _folded_bwd(q, k, v, kv_lens, g.contiguous(), o, lse)
        return dq, dk, dv, None


def flash_prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lens: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention where item i attends only keys [0, kv_lens[i]).

    kv_lens: [b] or [1] (broadcast) int valid-prefix lengths. Query rows past
    the prefix get well-defined output over the valid keys (callers zero or
    slice them). With a gradient being taken the kernel path is the autograd
    Function (kernels 10, 11, 13), otherwise kernel A. kernels=False runs the
    plain version on any device, and autograd differentiates it.
    """
    (qf, kf, vf), lens_h = _fold(q, k, v, kv_lens)
    if not kernels:
        out = prefix_attention_reference(qf, kf, vf, lens_h)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashPrefixAttention.apply(qf, kf, vf, lens_h)
    else:
        out = flash_prefix_folded(qf, kf, vf, lens_h)
    return out.reshape(q.shape)

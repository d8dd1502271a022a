"""Prefix-masked attention forward: Hopper kernel A and its plain version.

Counterpart of korean_f5_tts_tpu/ops/flash_prefix.py (inference forward
only). Every attention mask of the model is a prefix mask, so one length per
folded head describes it: head i attends keys [0, kv_lens[i]). The kernel
(csrc/flash_prefix.cu) replaces the TPU's _flash_prefix_folded; its source
note says what bounds it on the card and how its design answers that.
"""

from __future__ import annotations

import math

import torch

from korean_f5_tts_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
MASK_VALUE = -1e37  # the JAX reference's finite mask logit

launches = 0  # kernel launches by flash_prefix_folded (not plain calls)


def prefix_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kv_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: [H, n, d] q/k/v, [H] int kv_lens.

    Same formulation as the JAX reference _xla_prefix_attention: fp32 logits,
    fp32 softmax over the valid prefix, probabilities cast to v's dtype.
    """
    n, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    mask = torch.arange(n, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask[:, None, :], MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def flash_prefix_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_lens: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper: [H, n, d] bf16 q/k/v and [H] int32 kv_lens.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back.
    """
    global launches
    if q.device.type == "cpu":
        return prefix_attention_reference(q, k, v, kv_lens)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_prefix: q/k/v must share one [H, n, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    H, n, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash_prefix: head dim {d} not supported (64 or 128)")
    if kv_lens.shape != (H,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"flash_prefix: kv_lens must be int32 [{H}], got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
    cuda_build.require_cuda("flash_prefix", q, k, v, dtype=torch.bfloat16)
    cuda_build.require_cuda("flash_prefix", q, kv_lens)
    out = torch.empty_like(q)
    lib = cuda_build.library()
    err = lib.f5_flash_prefix_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        H, n, d, LOG2E / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_fwd")
    launches += 1
    return out


def flash_prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lens: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention where item i attends only keys [0, kv_lens[i]).

    kv_lens: [b] or [1] (broadcast) int valid-prefix lengths. Query rows past
    the prefix get well-defined output over the valid keys (callers zero or
    slice them). kernels=False runs the plain version on any device.
    """
    b, h, n, d = q.shape
    lens = kv_lens.to(device=q.device, dtype=torch.int32)
    if lens.shape[0] == 1 and b > 1:
        lens = lens.expand(b)
    lens_h = lens.repeat_interleave(h)  # [b*h]
    fold = (b * h, n, d)
    qf, kf, vf = (t.reshape(fold).contiguous() for t in (q, k, v))
    fn = flash_prefix_folded if kernels else prefix_attention_reference
    return fn(qf, kf, vf, lens_h).reshape(b, h, n, d)

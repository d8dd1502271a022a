"""Attention dispatch (counterpart of korean_f5_tts_tpu/ops/attention.py:sdpa).

What remains of the JAX dispatch on this path: every mask the model builds
is a prefix mask, so attention takes one valid length per item and runs the
prefix-attention kernel; the unmasked case is the same kernel with
kv_lens = n. There is no splash, legacy-flash, int8 or tensor-parallel
branch, and no fallback on error: a kernel that cannot run raises.
"""

from __future__ import annotations

import torch

from korean_f5_tts_tpu_torch.ops.flash_prefix import flash_prefix_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         prefix_lens: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention; prefix_lens ([b] or [1] int) marks item i's
    valid keys [0, prefix_lens[i]); None means every key is valid."""
    n = q.shape[2]
    if prefix_lens is None:
        prefix_lens = torch.full((1,), n, dtype=torch.int32, device=q.device)
    return flash_prefix_attention(q, k, v, prefix_lens, kernels=kernels)

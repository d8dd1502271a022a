"""Attention dispatch (counterpart of korean_f5_tts_tpu/ops/attention.py:
sdpa, rope_prefix_sdpa, qkv_fused_sdpa).

What remains of the JAX dispatch on this path: every mask the model builds
is a prefix mask, so attention takes one valid length per item and runs a
prefix-attention kernel; the unmasked case is the same kernel with
kv_lens = n. sdpa takes q, k after the rotary embedding (kernel A);
rope_prefix_sdpa takes them before it (kernel 18); qkv_fused_sdpa takes the
fused qkv projection output as it is (kernel 19). Which one a block runs is
the caller's `attn_path` argument (models/modules.py), not an environment
variable. There is no splash, legacy-flash, int8 or tensor-parallel branch,
and no fallback on error: a kernel that cannot run raises.
"""

from __future__ import annotations

import torch

from korean_f5_tts_tpu_torch.ops.flash_prefix import (
    flash_prefix_attention,
    flash_prefix_qkv_attention,
    flash_prefix_qkv_reference,
    flash_prefix_rope_attention,
    flash_prefix_rope_reference,
)

ATTN_PATHS = ("default", "linear_fused", "rope_in_kernel", "qkv_kernel")


def check_attn_path(attn_path: str) -> str:
    if attn_path not in ATTN_PATHS:
        raise ValueError(f"attn_path must be one of {ATTN_PATHS}, got {attn_path!r}")
    return attn_path


def _full_lens(prefix_lens: torch.Tensor | None, n: int, device) -> torch.Tensor:
    if prefix_lens is None:
        return torch.full((1,), n, dtype=torch.int32, device=device)
    return prefix_lens


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         prefix_lens: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention; prefix_lens ([b] or [1] int) marks item i's
    valid keys [0, prefix_lens[i]); None means every key is valid."""
    return flash_prefix_attention(q, k, v, _full_lens(prefix_lens, q.shape[2], q.device),
                                  kernels=kernels)


def rope_prefix_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prefix_lens: torch.Tensor | None,
                     rope: tuple[torch.Tensor, torch.Tensor],
                     pe_attn_head: int | None, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention on PRE-rope q, k: the rotary embedding is
    applied inside kernel 18 (attention.py:245-273)."""
    fn = flash_prefix_rope_attention if kernels else flash_prefix_rope_reference
    return fn(q, k, v, _full_lens(prefix_lens, q.shape[2], q.device), *rope, pe_attn_head)


def qkv_fused_sdpa(qkv: torch.Tensor, heads: int,
                   rope: tuple[torch.Tensor, torch.Tensor],
                   pe_attn_head: int | None, prefix_lens: torch.Tensor | None,
                   kernels: bool = True) -> torch.Tensor:
    """Attention (with rope) straight from the [B, n, 3 * heads * dh] qkv
    projection output, returning [B, n, heads * dh] merged: kernel 19
    (attention.py:206-242)."""
    fn = flash_prefix_qkv_attention if kernels else flash_prefix_qkv_reference
    return fn(qkv, _full_lens(prefix_lens, qkv.shape[1], qkv.device), heads, *rope, pe_attn_head)

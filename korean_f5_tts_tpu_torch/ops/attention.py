"""Attention dispatch (counterpart of korean_f5_tts_tpu/ops/attention.py:
sdpa, rope_prefix_sdpa, qkv_fused_sdpa).

What remains of the JAX dispatch on this path: every mask the model builds
is a prefix mask, so attention takes one valid length per item and runs a
prefix-attention kernel; the unmasked case is the same kernel with
kv_lens = n. sdpa takes q, k after the rotary embedding (kernel A);
rope_prefix_sdpa takes them before it (kernel 18); qkv_fused_sdpa takes the
fused qkv projection output as it is (kernel 19). Which one a block runs is
the caller's `attn_path` argument (models/modules.py), not an environment
variable. `attn_int8` ("qk" or "qkpv"; the JAX package's F5_TTS_INT8_ATTN as
an argument) makes sdpa run kernel 14 (csrc/flash_prefix_int8.cu) in place
of kernel A: int8 q.k^T, and with "qkpv" an int8 p.v as well. As in the JAX
package only sdpa has that branch, so attn_int8 raises together with the two
attn_paths that bypass sdpa; it serves only. There is no splash,
legacy-flash or tensor-parallel branch, and no fallback on error: a kernel
that cannot run raises.

Head dims, by shape as in the JAX package: the kernels run at d in
ATTENTION_KERNEL_DIMS (64, 128), JAX's `d in (64, 128)` for its rope path
and its sdpa kernels (korean_f5_tts_tpu/ops/attention.py:260, :296); at any
other d JAX runs XLA (:412-413) and here sdpa takes the plain attention in
the operands' dtype (autograd differentiates it while training), its int8
setting included, since JAX's int8 branch sits inside the same test;
rope_prefix_sdpa applies rope and goes through sdpa, as JAX's caller does
when its rope kernel steps aside. Kernel 19 takes dh 64 only (JAX:
`dh == 64`, :225-227): qkv_kernel_takes says where the caller
(models/modules.py:attention) steps aside to the unfused path. The choice is
made here and there only; the wrappers raise on a CUDA tensor of a head dim
they do not take.
"""

from __future__ import annotations

import torch

from korean_f5_tts_tpu_torch.ops.flash_prefix import (
    flash_prefix_attention,
    flash_prefix_attention_i8,
    flash_prefix_qkv_attention,
    flash_prefix_qkv_reference,
    flash_prefix_rope_attention,
    flash_prefix_rope_reference,
)

ATTN_PATHS = ("default", "linear_fused", "rope_in_kernel", "qkv_kernel")
# the head dims the attention kernels run at, JAX's `d in (64, 128)`
# (korean_f5_tts_tpu/ops/attention.py:260, :296)
ATTENTION_KERNEL_DIMS = (64, 128)


def qkv_kernel_takes(dh: int) -> bool:
    """Whether kernel 19 runs at head dim dh: JAX's qkv_fused_sdpa returns
    None unless dh == 64 (korean_f5_tts_tpu/ops/attention.py:225-227; its
    kernel asserts 2 * dh == LANES, flash_prefix.py:1632). JAX also steps
    aside at an odd head count, which kernel 19 takes (ROADMAP.md,
    deliberate differences)."""
    return dh == 64


def check_attn_path(attn_path: str) -> str:
    if attn_path not in ATTN_PATHS:
        raise ValueError(f"attn_path must be one of {ATTN_PATHS}, got {attn_path!r}")
    return attn_path


ATTN_INT8 = (None, "qk", "qkpv")


def check_attn_int8(attn_int8: str | None, attn_path: str = "default") -> str | None:
    """Validate attn_int8 (None, "qk": int8 q.k^T only, "qkpv": both products)
    against the attention path: "rope_in_kernel" and "qkv_kernel" never reach
    sdpa, the only place with an int8 branch."""
    if attn_int8 not in ATTN_INT8:
        raise ValueError(f"attn_int8 must be one of {ATTN_INT8}, got {attn_int8!r}")
    if attn_int8 is not None and check_attn_path(attn_path) in ("rope_in_kernel", "qkv_kernel"):
        raise ValueError(f"attn_int8={attn_int8!r} needs attn_path 'default' or 'linear_fused': "
                         f"{attn_path!r} applies rope inside a bf16 kernel that has no int8 form")
    return attn_int8


def _full_lens(prefix_lens: torch.Tensor | None, n: int, device) -> torch.Tensor:
    if prefix_lens is None:
        return torch.full((1,), n, dtype=torch.int32, device=device)
    return prefix_lens


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         prefix_lens: torch.Tensor | None = None, kernels: bool = True,
         attn_int8: str | None = None) -> torch.Tensor:
    """[b, h, n, d] attention; prefix_lens ([b] or [1] int) marks item i's
    valid keys [0, prefix_lens[i]); None means every key is valid. attn_int8
    runs kernel 14 instead of kernel A (inference only; it raises on an input
    that requires a gradient and on shapes the kernel does not take). At a
    head dim outside ATTENTION_KERNEL_DIMS the plain attention runs, in the
    operands' dtype whatever attn_int8 says (JAX's XLA path there)."""
    lens = _full_lens(prefix_lens, q.shape[2], q.device)
    if check_attn_int8(attn_int8) is not None and q.shape[-1] in ATTENTION_KERNEL_DIMS:
        return flash_prefix_attention_i8(q, k, v, lens, pv_i8=attn_int8 == "qkpv",
                                         kernels=kernels)
    return flash_prefix_attention(q, k, v, lens,
                                  kernels=kernels and q.shape[-1] in ATTENTION_KERNEL_DIMS)


def rope_prefix_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prefix_lens: torch.Tensor | None,
                     rope: tuple[torch.Tensor, torch.Tensor],
                     pe_attn_head: int | None, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention on PRE-rope q, k: the rotary embedding is
    applied inside kernel 18 (attention.py:245-273). At a head dim outside
    ATTENTION_KERNEL_DIMS rope is applied in the operands' dtype and sdpa
    runs, as the JAX caller does when rope_prefix_sdpa returns None
    (modules.py:549-556)."""
    if q.shape[-1] not in ATTENTION_KERNEL_DIMS:
        from korean_f5_tts_tpu_torch.models.modules import apply_rope

        cos, sin = rope
        return sdpa(apply_rope(q, cos, sin, pe_attn_head), apply_rope(k, cos, sin, pe_attn_head),
                    v, prefix_lens, kernels=kernels)
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

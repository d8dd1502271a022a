"""Building blocks as plain functions over nested dicts of tensors.

Counterpart of korean_f5_tts_tpu/models/modules.py (the pieces the serving
path uses). Parameter trees keep the JAX package's keys; layouts:
  - Linear {"w": [out, in], "b": [out]} (torch layout; the converter in
    train/checkpoint.py transposes the JAX [in, out]).
  - Conv1d {"w": [k, in/groups, out], "b": [out]}: the JAX layout, kept so
    the grouped-conv kernel reads it as is; plain convs permute a view.
  - Rotary embedding is half-split (NeoX form), as in the JAX package.
Activations are channels-last [b, n, c] throughout.

`kernels` arguments choose between a Hopper kernel's wrapper (CPU tensors
then take its plain version) and the plain version on any device; it is an
explicit argument, never an environment knob.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import grouped_conv as _gconv
from korean_f5_tts_tpu_torch.ops.attention import sdpa

# ---------------------------------------------------------------------------
# initialisers (torch defaults, as the JAX package mirrors them)
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


def linear_init(gen, d_in: int, d_out: int, device, bias: bool = True) -> dict:
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (d_out, d_in), bound, device)}
    if bias:
        p["b"] = _uniform(gen, (d_out,), bound, device)
    return p


def embedding_init(gen, num: int, dim: int, device) -> dict:
    return {"w": torch.randn((num, dim), generator=gen, device=device)}


def layernorm_init(dim: int, device) -> dict:
    return {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)}


def conv1d_init(gen, c_in: int, c_out: int, kernel: int, device, groups: int = 1) -> dict:
    bound = 1.0 / math.sqrt((c_in // groups) * kernel)
    return {"w": _uniform(gen, (kernel, c_in // groups, c_out), bound, device),
            "b": _uniform(gen, (c_out,), bound, device)}


def cast_params(tree, dtype: torch.dtype):
    """Cast every floating leaf of a parameter tree to `dtype`."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype) if "b" in p else None)


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["w"])


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if "g" in p:
        y = y * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


def _depthwise_conv1d_shifts(p: dict, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Depthwise conv1d (groups == channels) as k shifted multiply-adds in x's
    dtype, the form the JAX package computes (modules.py:102-121)."""
    w = p["w"].to(x.dtype)  # [k, 1, c]
    k = w.shape[0]
    pad = (dilation * (k - 1)) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    n = x.shape[1]
    y = None
    for t in range(k):
        term = xp[:, t * dilation: t * dilation + n] * w[t, 0]
        y = term if y is None else y + term
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv1d(p: dict, x: torch.Tensor, groups: int = 1, padding: int | None = None,
           dilation: int = 1) -> torch.Tensor:
    """x: [b, n, c_in] channels-last; w [k, c_in/groups, c_out]; padding None
    means SAME."""
    k = p["w"].shape[0]
    pad = (dilation * (k - 1)) // 2 if padding is None else padding
    if (groups == x.shape[-1] and p["w"].shape[1] == 1 and k <= 16 and k % 2 == 1
            and pad == (dilation * (k - 1)) // 2):
        return _depthwise_conv1d_shifts(p, x, dilation=dilation)
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype).permute(2, 1, 0),
                 p["b"].to(x.dtype) if "b" in p else None,
                 padding=pad, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------


def sinus_position_embedding(x: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[b] positions -> [b, dim] fp32 (modules.py:172-178)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * -emb)
    ang = scale * x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0,
                         theta_rescale_factor: float = 1.0) -> np.ndarray:
    """Absolute sinusoidal table [end, dim] = cat(cos, sin) (modules.py:181-191)."""
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    ang = np.outer(np.arange(end, dtype=np.float64), freqs)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def rope_cos_sin(seq_len: int, dim_head: int, theta: float = 10000.0):
    """Half-split rope tables cos/sin of shape [seq_len, dim_head // 2]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2).astype(np.float64) / dim_head))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               pe_attn_head: int | None = None) -> torch.Tensor:
    """Half-split rotary embedding on [b, h, n, d]; with pe_attn_head only the
    first pe_attn_head heads rotate (modules.py:211-226)."""
    d2 = x.shape[-1] // 2
    n = x.shape[2]
    cos = cos.to(x.dtype)[None, None, :n, :]
    sin = sin.to(x.dtype)[None, None, :n, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    rx = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if pe_attn_head is None:
        return rx
    head_sel = (torch.arange(x.shape[1], device=x.device) < pe_attn_head)[None, :, None, None]
    return torch.where(head_sel, rx, x)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def timestep_embedding(p: dict, t: torch.Tensor) -> torch.Tensor:
    """[b] diffusion times -> [b, dim] (modules.py:242-247)."""
    freq_embed_dim = p["mlp1"]["w"].shape[1]
    h = sinus_position_embedding(t, freq_embed_dim).to(t.dtype)
    return linear(p["mlp2"], F.silu(linear(p["mlp1"], h)))


def conv_position_embedding(p: dict, x: torch.Tensor, mask: torch.Tensor | None = None,
                            groups: int = 16, kernels: bool = True) -> torch.Tensor:
    """[b, n, d] -> [b, n, d]: two masked grouped convs, each with bias and
    Mish (modules.py:282-320). Masking commutes with the fused Mish because
    mish(0) == 0, so the kernel fuses conv + bias + Mish and the mask is
    applied around it."""
    conv = _gconv.grouped_conv1d_mish if kernels else _gconv.grouped_conv1d_mish_reference
    m = mask[..., None] if mask is not None else None
    if m is not None:
        x = x.masked_fill(~m, 0.0)
    y = conv(x, p["conv1"]["w"], p["conv1"].get("b"), groups)
    if m is not None:
        y = y.masked_fill(~m, 0.0)
    y = conv(y, p["conv2"]["w"], p["conv2"].get("b"), groups)
    if m is not None:
        y = y.masked_fill(~m, 0.0)
    return y


def grn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Global response norm over the sequence dim (modules.py:328-332)."""
    gx = torch.sqrt(torch.sum(x.float() ** 2, dim=1, keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return (p["gamma"] * (x * nx.to(x.dtype)) + p["beta"] + x).to(x.dtype)


def convnext_v2_block(p: dict, x: torch.Tensor, dilation: int = 1,
                      valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """ConvNeXt-V2 block on [b, n, d] (modules.py:346-367). valid_mask
    ([1, n, 1] bool) zeroes bucket-padding rows at the dwconv and GRN inputs."""
    residual = x
    pad = (dilation * (7 - 1)) // 2
    if valid_mask is not None:
        x = x.masked_fill(~valid_mask, 0.0)
    h = conv1d(p["dwconv"], x, groups=x.shape[-1], padding=pad, dilation=dilation)
    h = layernorm(p["norm"], h, eps=1e-6)
    h = gelu_exact(linear(p["pw1"], h))
    if valid_mask is not None:
        h = h.masked_fill(~valid_mask, 0.0)
    h = grn(p["grn"], h)
    return residual + linear(p["pw2"], h)


def feedforward(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["out"], gelu_tanh(linear(p["in"], x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention(p: dict, x: torch.Tensor, heads: int,
              mask: torch.Tensor | None = None,
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              pe_attn_head: int | None = None,
              attn_mask_enabled: bool = True,
              pad_mask: torch.Tensor | None = None,
              kernels: bool = True) -> torch.Tensor:
    """Self-attention of the DiT block (modules.py:464-571).

    mask ([b, n]): the duration mask; it masks the logits only when
    attn_mask_enabled, and always zeroes the output rows where it is False.
    pad_mask ([1, n]): bucket-tail padding, used for the logits whenever the
    duration mask is not. Every mask here is a prefix mask, so one length per
    item describes it and the prefix-attention kernel runs.
    Bucket-tail rows are not zeroed (nothing downstream mixes positions and
    callers slice them off), as in the JAX package.
    """
    attn_mask = mask if (attn_mask_enabled and mask is not None) else pad_mask
    prefix_lens = attn_mask.sum(dim=-1, dtype=torch.int32) if attn_mask is not None else None
    wqkv = torch.cat([p["to_q"]["w"], p["to_k"]["w"], p["to_v"]["w"]], dim=0).to(x.dtype)
    bqkv = torch.cat([p["to_q"]["b"], p["to_k"]["b"], p["to_v"]["b"]]).to(x.dtype)
    qkv = F.linear(x, wqkv, bqkv)
    inner = p["to_q"]["w"].shape[0]
    q = _split_heads(qkv[..., :inner], heads)
    k = _split_heads(qkv[..., inner:2 * inner], heads)
    v = _split_heads(qkv[..., 2 * inner:], heads)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, pe_attn_head)
        k = apply_rope(k, cos, sin, pe_attn_head)
    out = _merge_heads(sdpa(q, k, v, prefix_lens=prefix_lens, kernels=kernels))
    out = linear(p["to_out"], out)
    if mask is not None:
        out = out.masked_fill(~mask[..., None], 0.0)
    return out

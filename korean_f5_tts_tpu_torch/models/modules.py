"""Building blocks as plain functions over nested dicts of tensors.

Counterpart of korean_f5_tts_tpu/models/modules.py (the pieces the serving
and training paths use). Parameter trees keep the JAX package's keys; layouts:
  - Linear {"w": [out, in], "b": [out]} (torch layout; the converter in
    train/checkpoint.py transposes the JAX [in, out]); the int8 form of
    models/quant.py is {"w_int8": [out, in], "w_scale": [out] fp32, "b"}.
  - Conv1d {"w": [k, in/groups, out], "b": [out]}: the JAX layout, kept so
    the grouped-conv kernel reads it as is; plain convs permute a view.
  - Rotary embedding is half-split (NeoX form), as in the JAX package.
Activations are channels-last [b, n, c] throughout.

`kernels` arguments choose between a Hopper kernel's wrapper (CPU tensors
then take its plain version) and the plain version on any device; it is an
explicit argument, never an environment knob. So is `attn_path`, which
picks the attention half's kernels (ops/attention.py:ATTN_PATHS):
"default" (rope in torch, kernel A), "linear_fused" (kernels 7, A, 8; the
dispatch is in models/dit.py), "rope_in_kernel" (kernel 18) and
"qkv_kernel" (kernel 19).

`mesh` (parallel/mesh.py; None: one device) runs attention, joint
attention and the FF on this process's share of a tensor-parallel model:
its heads and columns, the products per rank, an all-reduce over the model
group after the row-split product (parallel/tp_kernels.py), and dropout
masks drawn at the global shape and sliced, so a sharded step equals the
single-device one. The heads must split evenly over the model axis
(local_heads raises otherwise).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.models.quant import qlinear
from korean_f5_tts_tpu_torch.ops import grouped_conv as _gconv
from korean_f5_tts_tpu_torch.ops.flash_prefix import MASK_VALUE
from korean_f5_tts_tpu_torch.ops.attention import (
    check_attn_int8,
    qkv_fused_sdpa,
    qkv_kernel_takes,
    rope_prefix_sdpa,
    sdpa,
)
from korean_f5_tts_tpu_torch.parallel.mesh import axis_rank, axis_size, model_parallel
from korean_f5_tts_tpu_torch.parallel.tp_kernels import (
    copy_to_model,
    local_pe_attn_head,
    reduce_from_model,
    reduce_residual,
)

# ---------------------------------------------------------------------------
# initialisers (torch defaults, as the JAX package mirrors them)
# ---------------------------------------------------------------------------


def make_generator(device: torch.device, seed: int) -> torch.Generator | None:
    """The initialisers' generator on `device`; None on the meta device,
    where an init builds the tree's shapes only and draws nothing."""
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)


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


def rmsnorm_init(dim: int, device) -> dict:
    return {"g": torch.ones(dim, device=device)}


def conv1d_init(gen, c_in: int, c_out: int, kernel: int, device, groups: int = 1) -> dict:
    bound = 1.0 / math.sqrt((c_in // groups) * kernel)
    return {"w": _uniform(gen, (kernel, c_in // groups, c_out), bound, device),
            "b": _uniform(gen, (c_out,), bound, device)}


def cast_params(tree, dtype: torch.dtype):
    """Cast every floating leaf of a parameter tree to `dtype`, except the
    int8 linears' w_scale, which stays fp32 (models/quant.py)."""
    if isinstance(tree, dict):
        return {k: v if k == "w_scale" else cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def linear(p: dict, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """y = x @ w^T + b; an int8 linear ({"w_int8", ...}) goes to qlinear
    (kernel 9, or its plain version with kernels=False), as modules.py:47-51."""
    if "w_int8" in p:
        return qlinear(p, x, kernels=kernels)
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


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with fp32 statistics and the gain g
    (modules.py:82-89)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["g"].float()).to(x.dtype)


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


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            mesh=None) -> torch.Tensor:
    """Inverted dropout (modules.py:160-164): keep with probability 1 - rate,
    scaled by 1 / (1 - rate); the mask comes from `gen`. Under a mesh x is
    this rank's rows (data axis) and, tensor-parallel, its last-dim columns:
    the mask is drawn at the global shape and sliced, so every element
    keeps the draw it has on one device."""
    if gen is None or rate == 0.0:
        return x
    if mesh is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    else:
        b, c = x.shape[0], x.shape[-1]
        tp = axis_size(mesh, "model")
        full = (b * axis_size(mesh, "data"), *x.shape[1:-1], c * tp)
        keep = torch.rand(full, generator=gen, device=x.device) < 1.0 - rate
        r, m = axis_rank(mesh, "data"), axis_rank(mesh, "model")
        keep = keep[r * b:(r + 1) * b, ..., m * c:(m + 1) * c]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
    applied around it.

    Which form runs is decided by the shape alone, as in the JAX package:
    where ops/grouped_conv.py:pallas_conv_supported holds (d / groups divides
    128: 64 channels a group at dim 1024) kernel C runs (its plain version
    with kernels=False); elsewhere (48 channels a group at dim 768: the
    F5TTS_Small and E2TTS_Small presets) the plain grouped conv, bias and
    Mish run in x's dtype (grouped_conv1d_mish_train), the XLA form of
    modules.py:313-320, with kernels True or False and on any device. That
    choice is never made from a failed build or launch, and kernel C's
    counter does not move on such shapes.
    """
    k = p["conv1"]["w"].shape[0]
    if not _gconv.pallas_conv_supported(x.shape[-1], groups, k):
        conv = _gconv.grouped_conv1d_mish_train
    elif kernels:
        conv = _gconv.grouped_conv1d_mish
    else:
        conv = _gconv.grouped_conv1d_mish_reference
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


def ada_layernorm(p: dict, x: torch.Tensor, emb: torch.Tensor):
    """AdaLN-zero (modules.py:374-380): the modulated x and (gate_msa,
    shift_mlp, scale_mlp, gate_mlp), each [b, dim]."""
    e = linear(p["linear"], F.silu(emb))
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = e.chunk(6, dim=-1)
    xn = layernorm({}, x, eps=1e-6) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    return xn, gate_msa, shift_mlp, scale_mlp, gate_mlp


def ada_layernorm_final(p: dict, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Final AdaLN (modules.py:387-390)."""
    scale, shift = linear(p["linear"], F.silu(emb)).chunk(2, dim=-1)
    return layernorm({}, x, eps=1e-6) * (1 + scale)[:, None, :] + shift[:, None, :]


def row_parallel_linear(p: dict, x: torch.Tensor, mesh, kernels: bool = True) -> torch.Tensor:
    """A row-split linear on this rank's input columns, summed over the
    model group: the product, the all-reduce, then the bias, as XLA places
    them (an int8 linear, whose kernel 9 adds the bias in its epilogue, adds
    bias / tp per rank instead, the fused kernels' accounting)."""
    if "w_int8" in p:
        part = qlinear({**p, "b": p["b"] / axis_size(mesh, "model")}, x, kernels=kernels)
        return reduce_from_model(part, mesh)
    out = reduce_from_model(F.linear(x, p["w"].to(x.dtype)), mesh)
    return out + p["b"].to(x.dtype) if "b" in p else out


def feedforward(p: dict, x: torch.Tensor, dropout_rate: float = 0.0,
                gen: torch.Generator | None = None, kernels: bool = True,
                mesh=None) -> torch.Tensor:
    """linear -> gelu_tanh -> dropout -> linear (modules.py:399-404); int8
    linears take kernel 9 (its plain version with kernels=False). Under a
    tensor-parallel mesh ff/in is this rank's columns and ff/out its rows."""
    if not model_parallel(mesh):
        h = dropout(gelu_tanh(linear(p["in"], x, kernels=kernels)), dropout_rate, gen, mesh)
        return linear(p["out"], h, kernels=kernels)
    x = copy_to_model(x, mesh)
    h = dropout(gelu_tanh(linear(p["in"], x, kernels=kernels)), dropout_rate, gen, mesh)
    return row_parallel_linear(p["out"], h, mesh, kernels=kernels)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def local_heads(heads: int, mesh) -> int:
    """This model rank's head count. JAX's XLA computes the whole function
    where the heads do not split (ops/attention.py:_tp_mesh_for); a rank here
    holds only its columns, so such a split would cut a head apart: it
    raises instead."""
    tp = axis_size(mesh, "model")
    if heads % tp:
        raise ValueError(f"{heads} heads do not split over the model axis (tp {tp}): a rank "
                         "would hold part of a head")
    return heads // tp


def _qk_norm_gains(p: dict, mesh, names: tuple[str, ...]) -> dict:
    """p with its replicated qk-norm gains entering this rank's heads through
    copy_to_model, so that their gradients sum over the model group."""
    return {**p, **{n: {"g": copy_to_model(p[n]["g"], mesh)} for n in names if n in p}}


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
              kernels: bool = True, attn_path: str = "default",
              attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """Self-attention of the DiT block (modules.py:464-571).

    mask ([b, n]): the duration mask; it masks the logits only when
    attn_mask_enabled, and always zeroes the output rows where it is False.
    pad_mask ([1, n]): bucket-tail padding, used for the logits whenever the
    duration mask is not. Every mask here is a prefix mask, so one length per
    item describes it and a prefix-attention kernel runs.
    Bucket-tail rows are not zeroed (nothing downstream mixes positions and
    callers slice them off), as in the JAX package.
    bf16/fp32 projections run as one fused qkv product; int8 ones
    (models/quant.py) take the per-projection path through linear, as
    modules.py:536-539 does, each a kernel-9 launch.
    attn_path (the JAX package's F5_TTS_QKV_KERNEL and F5_TTS_ROPE_IN_KERNEL
    switches as one argument): with rope tables, "qkv_kernel" runs kernel 19
    straight on the fused qkv product (bf16/fp32 projections only, as
    modules.py:519-531) and "rope_in_kernel" kernel 18 on the pre-rope split
    heads (modules.py:543-551); every other case applies rope in torch and
    runs kernel A, or kernel 14 under attn_int8 (ops/attention.py:ATTN_INT8;
    it raises together with the two in-kernel-rope paths).
    "qkv_kernel" steps aside the same way at a head dim kernel 19 does not
    take (ops/attention.py:qkv_kernel_takes, JAX's dh == 64), taking the
    unfused default path; its tables arrive in the activations' dtype
    (models/dit.py:_rope_for), the dtype JAX's apply_rope casts its fp32
    tables to, so the rotation is JAX's.
    qk-norm (a "q_norm" in p, modules.py:540-542): the per-head RMSNorm of q
    and k after the head split and before rope. As in modules.py:519 and
    :544, "qkv_kernel" and "rope_in_kernel" then step aside: rope is applied
    in torch and kernel A runs (kernel 14 under attn_int8).
    Tensor-parallel (`mesh` with a model axis > 1): p holds this rank's
    q/k/v columns and to_out rows, `heads` stays the global count and must
    split evenly over the model axis (ValueError otherwise); the rank runs
    every case above on its heads (rope on those whose global index is below
    pe_attn_head) and sums the out-projection over the model group.
    """
    check_attn_int8(attn_int8, attn_path)
    tp_on = model_parallel(mesh)
    if tp_on:
        heads = local_heads(heads, mesh)
        x = copy_to_model(x, mesh)
        pe_attn_head = local_pe_attn_head(pe_attn_head, mesh, heads)
        p = _qk_norm_gains(p, mesh, ("q_norm", "k_norm"))
    attn_mask = mask if (attn_mask_enabled and mask is not None) else pad_mask
    prefix_lens = attn_mask.sum(dim=-1, dtype=torch.int32) if attn_mask is not None else None
    out = None
    if all("w" in p[n] and "b" in p[n] for n in ("to_q", "to_k", "to_v")):
        wqkv = torch.cat([p["to_q"]["w"], p["to_k"]["w"], p["to_v"]["w"]], dim=0).to(x.dtype)
        bqkv = torch.cat([p["to_q"]["b"], p["to_k"]["b"], p["to_v"]["b"]]).to(x.dtype)
        qkv = F.linear(x, wqkv, bqkv)
        inner = p["to_q"]["w"].shape[0]
        if attn_path == "qkv_kernel" and rope is not None and "q_norm" not in p and \
                qkv_kernel_takes(inner // heads):
            out = qkv_fused_sdpa(qkv, heads, rope, pe_attn_head, prefix_lens, kernels=kernels)
        else:
            q, k, v = (_split_heads(qkv[..., i * inner:(i + 1) * inner], heads)
                       for i in range(3))
    else:
        q, k, v = (_split_heads(linear(p[n], x, kernels=kernels), heads)
                   for n in ("to_q", "to_k", "to_v"))
    if out is None:
        if "q_norm" in p:
            q, k = rmsnorm(p["q_norm"], q), rmsnorm(p["k_norm"], k)
        if attn_path == "rope_in_kernel" and rope is not None and "q_norm" not in p:
            # the kernel takes contiguous [b, h, n, d]: the head split is one copy
            q, k, v = (t.contiguous() for t in (q, k, v))
            core = rope_prefix_sdpa(q, k, v, prefix_lens, rope, pe_attn_head, kernels=kernels)
        else:
            if rope is not None:
                cos, sin = rope
                q = apply_rope(q, cos, sin, pe_attn_head)
                k = apply_rope(k, cos, sin, pe_attn_head)
            core = sdpa(q, k, v, prefix_lens=prefix_lens, kernels=kernels,
                        attn_int8=attn_int8)
        out = _merge_heads(core)
    if tp_on:
        out = row_parallel_linear(p["to_out"], out, mesh, kernels=kernels)
    else:
        out = linear(p["to_out"], out, kernels=kernels)
    if mask is not None:
        out = out.masked_fill(~mask[..., None], 0.0)
    return out


def attention_half_fused(ap: dict, h: torch.Tensor, scale, shift, gate, heads: int, rope,
                         pe_attn_head: int | None, prefix_lens, kernels: bool = True,
                         attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """h + gate * attention(LN(h) * (1 + scale) + shift) with the linears
    fused into their neighbours, as dit.py:424-467: LN, modulation and the
    q/k/v products in one launch (kernel 7, or 5 with int8 weights), rope,
    kernel A (14 under attn_int8), the out-projection folded into the gated
    residual (kernel 8, or 6). Under autograd kernels 7 and 8 run their
    autograd Functions and kernel A becomes 10, 11, 13.

    scale, shift, gate are [d] (the sampler: one modulation for the batch)
    or [b, d] (training: one per item; kernels 7 and 8 take one modulation a
    launch, so each item launches its own, and the attention runs once on
    the batch). Tensor-parallel (`mesh`), ap is
    this rank's share: its heads, to_out's bias / tp in kernel 8's epilogue,
    the replicated inputs through copy_to_model and the sum through
    reduce_residual (parallel/tp_kernels.py)."""
    from korean_f5_tts_tpu_torch.ops.fused_linears import (
        ln_mod_matmul,
        ln_mod_matmul_int8,
        ln_mod_matmul_int8_reference,
        ln_mod_matmul_reference,
        proj_gated_residual,
        proj_gated_residual_int8,
        proj_gated_residual_int8_reference,
        proj_gated_residual_reference,
    )

    if "w_int8" in ap["to_q"]:
        lmm = ln_mod_matmul_int8 if kernels else ln_mod_matmul_int8_reference
        pgr = proj_gated_residual_int8 if kernels else proj_gated_residual_int8_reference
        inner = ap["to_q"]["w_int8"].shape[0]
    else:
        lmm = ln_mod_matmul if kernels else ln_mod_matmul_reference
        pgr = proj_gated_residual if kernels else proj_gated_residual_reference
        inner = ap["to_q"]["w"].shape[0]
    po = ap["to_out"]
    tp_on = model_parallel(mesh)
    if tp_on:
        tp = axis_size(mesh, "model")
        h, scale, shift, gate = (copy_to_model(t, mesh) for t in (h, scale, shift, gate))
        po = {**po, "b": copy_to_model(po["b"], mesh) / tp}
        heads //= tp
        pe_attn_head = local_pe_attn_head(pe_attn_head, mesh, heads)
    cos, sin = rope
    qkv_p = [ap["to_q"], ap["to_k"], ap["to_v"]]
    if scale.dim() == 1:
        qkv = lmm(h, scale, shift, qkv_p)
    else:
        qkv = torch.cat([lmm(h[i:i + 1], scale[i], shift[i], qkv_p) for i in range(h.shape[0])])
    q, k, v = (_split_heads(qkv[..., i * inner:(i + 1) * inner], heads) for i in range(3))
    q = apply_rope(q, cos, sin, pe_attn_head)
    k = apply_rope(k, cos, sin, pe_attn_head)
    a = _merge_heads(sdpa(q, k, v, prefix_lens=prefix_lens, kernels=kernels, attn_int8=attn_int8))
    if gate.dim() == 1:
        out = pgr(a, h, gate, po)
    else:
        out = torch.cat([pgr(a[i:i + 1], h[i:i + 1], gate[i], po) for i in range(h.shape[0])])
    return reduce_residual(out, h, mesh) if tp_on else out


def dit_block(p: dict, x: torch.Tensor, t: torch.Tensor, heads: int,
              mask: torch.Tensor | None = None,
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              pe_attn_head: int | None = None,
              attn_mask_enabled: bool = True,
              pad_mask: torch.Tensor | None = None,
              dropout_rate: float = 0.0,
              gen: torch.Generator | None = None,
              kernels: bool = True, attn_path: str = "default",
              attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """AdaLN-zero DiT block of the training forward (modules.py:632-650). The
    FF half-block is plain products here, as in the JAX block: kernel B is
    the serving path's.

    attn_path "linear_fused" with bf16/fp32 q/k/v/out linears with biases and
    no qk-norm runs the attention half as attention_half_fused (kernels 7, A
    and 8; 7, 10, 11, 13 and 8 under autograd), one launch of 7 and of 8 per
    item; the rows the duration mask hides keep x, as the unfused half's
    zeroed output leaves them. Under a tensor-parallel mesh that is
    parallel/tp_kernels.py:attn_half_block_tp, which steps aside (None) to
    the unfused half where the JAX shape predicate fails.
    """
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = linear(
        p["attn_norm"]["linear"], F.silu(t)).chunk(6, dim=-1)
    ap = p["attn"]
    out = None
    if attn_path == "linear_fused" and rope is not None and "q_norm" not in ap and all(
            "w" in ap[n] and "b" in ap[n] for n in ("to_q", "to_k", "to_v", "to_out")):
        attn_mask = mask if (attn_mask_enabled and mask is not None) else pad_mask
        lens = attn_mask.sum(dim=-1, dtype=torch.int32) if attn_mask is not None else None
        if model_parallel(mesh):
            from korean_f5_tts_tpu_torch.parallel.tp_kernels import attn_half_block_tp

            out = attn_half_block_tp(x, scale_msa, shift_msa, gate_msa, ap, heads, rope,
                                     pe_attn_head, lens, mesh, kernels=kernels,
                                     attn_int8=attn_int8)
        else:
            out = attention_half_fused(ap, x, scale_msa, shift_msa, gate_msa, heads, rope,
                                       pe_attn_head, lens, kernels=kernels, attn_int8=attn_int8)
    if out is not None:
        x = out if mask is None else torch.where(mask[..., None], out, x)
    else:
        norm = layernorm({}, x, eps=1e-6) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        attn_out = attention(ap, norm, heads, mask=mask, rope=rope,
                             pe_attn_head=pe_attn_head, attn_mask_enabled=attn_mask_enabled,
                             pad_mask=pad_mask, kernels=kernels, attn_path=attn_path,
                             attn_int8=attn_int8, mesh=mesh)
        x = x + gate_msa[:, None] * attn_out
    norm = layernorm({}, x, eps=1e-6) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    ff_out = feedforward(p["ff"], norm, dropout_rate=dropout_rate, gen=gen, mesh=mesh)
    return x + gate_mlp[:, None] * ff_out


# ---------------------------------------------------------------------------
# UNetT and MMDiT blocks: initialisers, joint attention, the MM-DiT block
# ---------------------------------------------------------------------------


def timestep_embedding_init(gen, dim: int, device, freq_embed_dim: int = 256) -> dict:
    return {"mlp1": linear_init(gen, freq_embed_dim, dim, device),
            "mlp2": linear_init(gen, dim, dim, device)}


def conv_position_embedding_init(gen, dim: int, device, kernel_size: int = 31,
                                 groups: int = 16) -> dict:
    return {"conv1": conv1d_init(gen, dim, dim, kernel_size, device, groups=groups),
            "conv2": conv1d_init(gen, dim, dim, kernel_size, device, groups=groups)}


def feedforward_init(gen, dim: int, mult: int, device) -> dict:
    return {"in": linear_init(gen, dim, dim * mult, device),
            "out": linear_init(gen, dim * mult, dim, device)}


def attention_init(gen, dim: int, heads: int, dim_head: int, device,
                   qk_norm: str | None = None, context_dim: int | None = None,
                   context_pre_only: bool = False) -> dict:
    """The attention's projections (modules.py:420-445): to_q/k/v/out, the
    qk-norm gains with qk_norm "rms_norm", and the context stream's
    projections (and norms) of joint attention with context_dim."""
    inner = heads * dim_head
    p = {n: linear_init(gen, dim, inner, device) for n in ("to_q", "to_k", "to_v")}
    p["to_out"] = linear_init(gen, inner, dim, device)
    if qk_norm == "rms_norm":
        p["q_norm"] = rmsnorm_init(dim_head, device)
        p["k_norm"] = rmsnorm_init(dim_head, device)
    elif qk_norm is not None:
        raise ValueError(f"qk_norm must be None or 'rms_norm', got {qk_norm!r}")
    if context_dim is not None:
        for n in ("to_q_c", "to_k_c", "to_v_c"):
            p[n] = linear_init(gen, context_dim, inner, device)
        if qk_norm == "rms_norm":
            p["c_q_norm"] = rmsnorm_init(dim_head, device)
            p["c_k_norm"] = rmsnorm_init(dim_head, device)
        if not context_pre_only:
            p["to_out_c"] = linear_init(gen, inner, context_dim, device)
    return p


def _masked_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                key_mask: torch.Tensor | None) -> torch.Tensor:
    """[b, h, n, d] attention with an explicit [b, n] (or [1, n]) boolean key
    mask, any pattern: fp32 logits and softmax, probabilities cast to v's
    dtype (kernel A's plain formulation without the prefix)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_VALUE)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def joint_attention(p: dict, x: torch.Tensor, c: torch.Tensor, heads: int,
                    mask: torch.Tensor | None = None,
                    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                    c_rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                    context_pre_only: bool = False, kernels: bool = True,
                    attn_int8: str | None = None, mesh=None):
    """MM-DiT joint attention over the audio stream x [b, n_x, d] and the
    text stream c [b, n_c, d] (modules.py:574-611); returns (x_out, c_out).

    mask ([b, n_x] or [1, n_x]) marks the valid audio rows; every text key is
    valid. The JAX package concatenates [x; c], so its key mask
    pad(mask, (0, n_c), True) has holes and is no prefix mask. Rope is applied
    to each stream before the concatenation, which leaves the key order free:
    with kernels (or attn_int8) the text stream goes first, [c; x], the valid
    keys are then the prefix n_c + len_x, and kernel A (kernel 14 under
    attn_int8; kernels 10, 11, 13 under autograd) computes the same function
    with one length per item. kernels=False keeps the JAX order with the
    explicit boolean key mask (_masked_attention_reference).

    Tensor-parallel (`mesh` with a model axis > 1), as attention(): p holds
    this rank's q/k/v and q_c/k_c/v_c columns and to_out / to_out_c rows,
    `heads` is the global count and must split evenly; both streams enter
    through copy_to_model, the rank attends on its heads, and to_out (then
    to_out_c) sums over the model group. On the context_pre_only block c_out
    is this rank's heads unprojected, which mmdit_block drops: no collective
    is issued for it, so every rank issues the same ones in the same order.
    """
    check_attn_int8(attn_int8)
    tp_on = model_parallel(mesh)
    if tp_on:
        heads = local_heads(heads, mesh)
        x, c = copy_to_model(x, mesh), copy_to_model(c, mesh)
        p = _qk_norm_gains(p, mesh, ("q_norm", "k_norm", "c_q_norm", "c_k_norm"))
    n_c = c.shape[1]
    q, k, v = (_split_heads(linear(p[n], x, kernels=kernels), heads)
               for n in ("to_q", "to_k", "to_v"))
    cq, ck, cv = (_split_heads(linear(p[n], c, kernels=kernels), heads)
                  for n in ("to_q_c", "to_k_c", "to_v_c"))
    if "q_norm" in p:
        q, k = rmsnorm(p["q_norm"], q), rmsnorm(p["k_norm"], k)
    if "c_q_norm" in p:
        cq, ck = rmsnorm(p["c_q_norm"], cq), rmsnorm(p["c_k_norm"], ck)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if c_rope is not None:
        cq, ck = apply_rope(cq, *c_rope), apply_rope(ck, *c_rope)
    if kernels or attn_int8 is not None:
        lens = None if mask is None else n_c + mask.sum(dim=-1, dtype=torch.int32)
        out = sdpa(torch.cat([cq, q], dim=2), torch.cat([ck, k], dim=2),
                   torch.cat([cv, v], dim=2), prefix_lens=lens, kernels=kernels,
                   attn_int8=attn_int8)
        c_out, x_out = out[:, :, :n_c], out[:, :, n_c:]
    else:
        key_mask = None if mask is None else F.pad(mask, (0, n_c), value=True)
        out = _masked_attention_reference(torch.cat([q, cq], dim=2), torch.cat([k, ck], dim=2),
                                          torch.cat([v, cv], dim=2), key_mask)
        x_out, c_out = out[:, :, :x.shape[1]], out[:, :, x.shape[1]:]

    def out_proj(lp: dict, h: torch.Tensor) -> torch.Tensor:
        if tp_on:
            return row_parallel_linear(lp, h, mesh, kernels=kernels)
        return linear(lp, h, kernels=kernels)

    x_out = out_proj(p["to_out"], _merge_heads(x_out))
    c_out = _merge_heads(c_out)
    if not context_pre_only:
        c_out = out_proj(p["to_out_c"], c_out)
    if mask is not None:
        x_out = x_out.masked_fill(~mask[..., None], 0.0)
    return x_out, c_out


def mmdit_block_init(gen, dim: int, heads: int, dim_head: int, device, ff_mult: int = 4,
                     context_pre_only: bool = False, qk_norm: str | None = None) -> dict:
    """One MM-DiT block (modules.py:653-671), its AdaLN layers zeroed
    (AdaLN-zero, mmdit.py:66-74)."""
    width = 2 if context_pre_only else 6
    p = {
        "attn_norm_x": {"linear": linear_init(gen, dim, dim * 6, device)},
        "attn": attention_init(gen, dim, heads, dim_head, device, qk_norm=qk_norm,
                               context_dim=dim, context_pre_only=context_pre_only),
        "ff_x": feedforward_init(gen, dim, ff_mult, device),
        "attn_norm_c": {"linear": linear_init(gen, dim, dim * width, device)},
    }
    if not context_pre_only:
        p["ff_c"] = feedforward_init(gen, dim, ff_mult, device)
    for name in ("attn_norm_x", "attn_norm_c"):
        p[name]["linear"] = {k: torch.zeros_like(v) for k, v in p[name]["linear"].items()}
    return p


def mmdit_block(p: dict, x: torch.Tensor, c: torch.Tensor, t: torch.Tensor, heads: int,
                context_pre_only: bool = False, mask: torch.Tensor | None = None,
                rope=None, c_rope=None, kernels: bool = True,
                attn_int8: str | None = None, mesh=None):
    """SD3-style dual-stream block (modules.py:674-700); returns (c, x), c
    None on the context_pre_only block. Its products are plain (no FF
    kernel), as in the JAX block; the attention is joint_attention. Under a
    tensor-parallel mesh p is this rank's share: joint attention on its
    heads, ff_x and ff_c on its columns, the AdaLN layers replicated."""
    if context_pre_only:
        norm_c = ada_layernorm_final(p["attn_norm_c"], c, t)
    else:
        norm_c, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = ada_layernorm(
            p["attn_norm_c"], c, t)
    norm_x, x_gate_msa, x_shift_mlp, x_scale_mlp, x_gate_mlp = ada_layernorm(
        p["attn_norm_x"], x, t)
    x_attn, c_attn = joint_attention(p["attn"], norm_x, norm_c, heads, mask=mask, rope=rope,
                                     c_rope=c_rope, context_pre_only=context_pre_only,
                                     kernels=kernels, attn_int8=attn_int8, mesh=mesh)
    c_out = None
    if not context_pre_only:
        c = c + c_gate_msa[:, None] * c_attn
        norm_c = layernorm({}, c, eps=1e-6) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
        ff_c = feedforward(p["ff_c"], norm_c, kernels=kernels, mesh=mesh)
        c_out = c + c_gate_mlp[:, None] * ff_c
    x = x + x_gate_msa[:, None] * x_attn
    norm_x = layernorm({}, x, eps=1e-6) * (1 + x_scale_mlp[:, None]) + x_shift_mlp[:, None]
    x = x + x_gate_mlp[:, None] * feedforward(p["ff_x"], norm_x, kernels=kernels, mesh=mesh)
    return c_out, x

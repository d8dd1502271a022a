"""DiT backbone, inference path (counterpart of korean_f5_tts_tpu/models/dit.py).

Ported: init_dit, text_embedding, precompute_step_modulations,
precompute_input_static, input_embedding_premix, dit_backbone_premod and
dit_forward_cfg_premod: the functions the sampler's CFG loop runs. The FF
half-block always takes the fused kernel B (the JAX package's bf16 TPU
default); the attention-side linears stay plain matmuls, as the bf16 TPU
default leaves them (dit.py:373-379). The training forward, long skip and
average upsampling wait for later slices.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.modules import (
    _uniform,
    attention,
    cast_params,
    conv1d_init,
    conv_position_embedding,
    convnext_v2_block,
    embedding,
    embedding_init,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    precompute_freqs_cis,
    rope_cos_sin,
    timestep_embedding,
)
from korean_f5_tts_tpu_torch.ops.ff_block import ff_block_fused, ff_block_reference

PRECOMPUTE_MAX_POS = 8192  # ~87 s of 24 kHz audio at hop 256 (dit.py:44)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _convnext_v2_block_init(gen, dim: int, intermediate: int, device) -> dict:
    return {
        "dwconv": conv1d_init(gen, dim, dim, 7, device, groups=dim),
        "norm": layernorm_init(dim, device),
        "pw1": linear_init(gen, dim, intermediate, device),
        "grn": {"gamma": torch.zeros((1, 1, intermediate), device=device),
                "beta": torch.zeros((1, 1, intermediate), device=device)},
        "pw2": linear_init(gen, intermediate, dim, device),
    }


def _dit_block_init(gen, cfg: DiTConfig, device) -> dict:
    inner = cfg.heads * cfg.dim_head
    ada = linear_init(gen, cfg.dim, cfg.dim * 6, device)
    return {
        # AdaLN-zero init: every block starts gated off (modules.py:626-628)
        "attn_norm": {"linear": {k: torch.zeros_like(v) for k, v in ada.items()}},
        "attn": {name: linear_init(gen, cfg.dim, inner, device)
                 for name in ("to_q", "to_k", "to_v")}
        | {"to_out": linear_init(gen, inner, cfg.dim, device)},
        "ff": {"in": linear_init(gen, cfg.dim, cfg.dim * cfg.ff_mult, device),
               "out": linear_init(gen, cfg.dim * cfg.ff_mult, cfg.dim, device)},
    }


def init_dit(cfg: DiTConfig, seed: int = 0, device="cpu",
             dtype: torch.dtype = torch.float32) -> dict:
    """Random DiT parameters with the JAX package's tree, shapes and init
    distributions (torch layouts), drawn from a torch.Generator on `device`.
    Floating leaves are cast to `dtype`."""
    if cfg.long_skip_connection or cfg.qk_norm is not None:
        raise NotImplementedError("long skip and qk-norm DiTs are not ported yet")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    td = cfg.text_dim_
    text = {"embed": embedding_init(gen, cfg.text_num_embeds + 1, td, device)}
    if cfg.conv_layers > 0:
        text["blocks"] = [_convnext_v2_block_init(gen, td, td * cfg.conv_mult, device)
                          for _ in range(cfg.conv_layers)]
    p = {
        "time_embed": {"mlp1": linear_init(gen, 256, cfg.dim, device),
                       "mlp2": linear_init(gen, cfg.dim, cfg.dim, device)},
        "text_embed": text,
        "input_proj": linear_init(gen, cfg.mel_dim * 2 + td, cfg.dim, device),
        "conv_pos_embed": {"conv1": conv1d_init(gen, cfg.dim, cfg.dim, 31, device, groups=16),
                           "conv2": conv1d_init(gen, cfg.dim, cfg.dim, 31, device, groups=16)},
        "blocks": [_dit_block_init(gen, cfg, device) for _ in range(cfg.depth)],
        # zero-init final modulation + output projection (dit.py:82-85)
        "norm_out": {"linear": {"w": torch.zeros((cfg.dim * 2, cfg.dim), device=device),
                                "b": torch.zeros(cfg.dim * 2, device=device)}},
        "proj_out": {"w": torch.zeros((cfg.mel_dim, cfg.dim), device=device),
                     "b": torch.zeros(cfg.mel_dim, device=device)},
    }
    return cast_params(p, dtype)


def redraw_zero_init(p: dict, seed: int = 0) -> dict:
    """Re-draw the AdaLN-zero layers (every block's attn_norm.linear,
    norm_out.linear, proj_out) uniform in +-1/sqrt(d_in), in place.

    Freshly initialised, those layers gate every block off and make the mel
    exactly zero, so a wrong kernel would still agree with a right one; any
    comparison of randomly initialised models needs them re-drawn first.
    """
    ref = p["proj_out"]["w"]
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    layers = [blk["attn_norm"]["linear"] for blk in p["blocks"]]
    layers += [p["norm_out"]["linear"], p["proj_out"]]
    for lin in layers:
        bound = 1.0 / math.sqrt(lin["w"].shape[1])
        for k in ("w", "b"):
            lin[k].copy_(_uniform(gen, lin[k].shape, bound, ref.device))
    return p


# ---------------------------------------------------------------------------
# text embedding
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _freqs_cis_table(dim: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(precompute_freqs_cis(dim, PRECOMPUTE_MAX_POS)).to(device)


def text_embedding(p: dict, cfg: DiTConfig, text: torch.Tensor, seq_len: int,
                   drop_text: bool = False, pad_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[b, nt] token ids (pad = -1) -> [b, seq_len, text_dim] (dit.py:132-173).

    Ids shift by +1 (0 = filler) and are cut or padded to the mel length;
    pad_mask ([1, seq_len]) hides bucket-tail rows from the ConvNeXt stack's
    sequence statistics.
    """
    if cfg.text_embedding_average_upsampling:
        raise NotImplementedError("average upsampling is not ported yet")
    text = text + 1
    if text.shape[1] >= seq_len:
        text = text[:, :seq_len]
    else:
        text = F.pad(text, (0, seq_len - text.shape[1]))
    text_mask = (text != 0)[..., None]
    if drop_text:
        text = torch.zeros_like(text)
    h = embedding(p["embed"], text)
    if cfg.conv_layers > 0:
        valid = pad_mask[..., None] if pad_mask is not None else None
        h = h + _freqs_cis_table(cfg.text_dim_, h.device)[None, :seq_len].to(h.dtype)
        if cfg.text_mask_padding:
            h = h.masked_fill(~text_mask, 0.0)
        for blk in p["blocks"]:
            h = convnext_v2_block(blk, h, valid_mask=valid)
            if cfg.text_mask_padding:
                h = h.masked_fill(~text_mask, 0.0)
    return h


# ---------------------------------------------------------------------------
# input embedding + backbone
# ---------------------------------------------------------------------------


def precompute_input_static(p: dict, cfg: DiTConfig, cond: torch.Tensor,
                            text_emb_cond: torch.Tensor,
                            text_emb_uncond: torch.Tensor) -> torch.Tensor:
    """Loop-invariant part of the CFG input projection, computed once
    (dit.py:201-220): cond @ Wc + text @ Wt + b for the cond half, text-only
    for the uncond half. Returns [2b, n, dim]."""
    w = p["input_proj"]["w"]  # [dim, 2 * mel + text]
    m = cfg.mel_dim
    dt = cond.dtype
    wc, wt = w[:, m:2 * m].t().to(dt), w[:, 2 * m:].t().to(dt)
    b = p["input_proj"]["b"].to(dt)
    top = cond @ wc + text_emb_cond @ wt + b
    bottom = text_emb_uncond @ wt + b
    return torch.cat([top, bottom], dim=0)


def input_embedding_premix(p: dict, cfg: DiTConfig, x2: torch.Tensor,
                           static_inp: torch.Tensor,
                           audio_mask: torch.Tensor | None = None,
                           kernels: bool = True) -> torch.Tensor:
    """Per-step half of the decomposed input embedding (dit.py:223-230)."""
    wx = p["input_proj"]["w"][:, :cfg.mel_dim].t().to(x2.dtype)
    h = x2 @ wx + static_inp
    return conv_position_embedding(p["conv_pos_embed"], h, mask=audio_mask,
                                   kernels=kernels) + h


@functools.lru_cache(maxsize=32)
def _rope_table(seq_len: int, dim_head: int, device: torch.device):
    cos, sin = rope_cos_sin(seq_len, dim_head)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def precompute_step_modulations(p: dict, cfg: DiTConfig, ts: torch.Tensor):
    """AdaLN modulations for a timestep schedule, computed once (dit.py:304-320).
    Returns (mods [S, depth, 6*dim], mod_final [S, 2*dim], t_embs [S, dim])."""
    t_embs = timestep_embedding(p["time_embed"], ts)
    silu_t = F.silu(t_embs)
    mods = torch.stack([linear(blk["attn_norm"]["linear"], silu_t) for blk in p["blocks"]],
                       dim=1)
    mod_final = linear(p["norm_out"]["linear"], silu_t)
    return mods, mod_final, t_embs


def dit_backbone_premod(p: dict, cfg: DiTConfig, h: torch.Tensor,
                        mods: torch.Tensor, mod_final: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        pad_mask: torch.Tensor | None = None,
                        kernels: bool = True) -> torch.Tensor:
    """One sampling step of the backbone with precomputed modulations
    (dit.py:323-528, bf16 branches). mods: [depth, 6*dim] shared across the
    batch, mod_final: [2*dim]. Attention runs kernel A, the FF half-block
    kernel B; kernels=False runs their plain versions."""
    rope = _rope_table(h.shape[1], cfg.dim_head, h.device)
    ff = ff_block_fused if kernels else ff_block_reference
    for i, blk in enumerate(p["blocks"]):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mods[i].to(h.dtype).chunk(6))
        norm = layernorm({}, h, eps=1e-6) * (1 + scale_msa) + shift_msa
        attn_out = attention(blk["attn"], norm, cfg.heads, mask=mask, rope=rope,
                             pe_attn_head=cfg.pe_attn_head,
                             attn_mask_enabled=cfg.attn_mask_enabled,
                             pad_mask=pad_mask, kernels=kernels)
        h = h + gate_msa * attn_out
        fp = blk["ff"]
        h = ff(h, scale_mlp, shift_mlp, gate_mlp, fp["in"]["w"].to(h.dtype),
               fp["in"]["b"].to(h.dtype), fp["out"]["w"].to(h.dtype),
               fp["out"]["b"].to(h.dtype))
    scale, shift = mod_final.to(h.dtype).chunk(2)
    h = layernorm({}, h, eps=1e-6) * (1 + scale) + shift
    return linear(p["proj_out"], h)


def _double_mask(mask: torch.Tensor | None) -> torch.Tensor | None:
    """Duplicate a [b, n] mask for the CFG-packed 2b batch; [1, n] masks
    broadcast as they are."""
    if mask is None or mask.shape[0] == 1:
        return mask
    return torch.cat([mask, mask], dim=0)


def dit_forward_cfg_premod(p: dict, cfg: DiTConfig, x: torch.Tensor, cond: torch.Tensor,
                           text_emb_cond: torch.Tensor, text_emb_uncond: torch.Tensor,
                           mods: torch.Tensor, mod_final: torch.Tensor,
                           cfg_strength: float,
                           mask: torch.Tensor | None = None,
                           pad_mask: torch.Tensor | None = None,
                           static_inp: torch.Tensor | None = None,
                           kernels: bool = True) -> torch.Tensor:
    """CFG step with precomputed modulations (dit.py:539-565): the cond and
    uncond halves run packed as one batch of 2b, then
    pred + (pred - null_pred) * cfg_strength."""
    x2 = torch.cat([x, x], dim=0)
    mask2 = _double_mask(mask)
    audio_mask = mask2 if mask2 is not None else pad_mask
    if static_inp is None:
        static_inp = precompute_input_static(p, cfg, cond, text_emb_cond, text_emb_uncond)
    h = input_embedding_premix(p, cfg, x2, static_inp, audio_mask=audio_mask,
                               kernels=kernels)
    out = dit_backbone_premod(p, cfg, h, mods, mod_final, mask=mask2,
                              pad_mask=pad_mask, kernels=kernels)
    pred, null_pred = out.chunk(2, dim=0)
    return pred + (pred - null_pred) * cfg_strength


def count_params(p) -> int:
    if isinstance(p, dict):
        return sum(count_params(v) for v in p.values())
    if isinstance(p, list):
        return sum(count_params(v) for v in p)
    return int(np.prod(p.shape))

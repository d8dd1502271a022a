"""MMDiT backbone: SD3-style dual-stream joint attention (counterpart of
korean_f5_tts_tpu/models/mmdit.py).

The text stream is embedded at the text's own length (ids + 1, an absolute
sinusoidal position capped at 1024, mmdit.py:78-98), the audio stream from
(noise, cond) with a conv position embedding that zeroes bucket-tail rows
(mmdit.py:101-111). The blocks are models/modules.mmdit_block: AdaLN-zero on
both streams, joint attention (kernel A on the text-first prefix form, 10,
11, 13 under autograd, 14 under attn_int8), the last block context_pre_only;
each stream has its own rope table. The CFG step packs the two halves into
one batch of 2b before the audio embedding, so conv-pos (kernel C) runs
twice a step.

`mesh` (parallel/mesh.py; None: one device) runs each block on this
process's share of the weights (shard_params), as JAX's
param_partition_spec splits them: joint attention on the rank's heads (its
q/k/v and q_c/k_c/v_c columns, to_out and to_out_c summed over the model
group), ff_x and ff_c on its columns. The text and audio embeddings
(conv-pos included), the AdaLN layers, norm_out and proj_out stay
replicated; the MMDiT has no dropout, so its data ranks need nothing more.
"""

from __future__ import annotations

import functools

import torch

from korean_f5_tts_tpu_torch.config import MMDiTConfig
from korean_f5_tts_tpu_torch.models import dit as dit_mod
from korean_f5_tts_tpu_torch.models.modules import (
    ada_layernorm_final,
    cast_params,
    conv_position_embedding,
    conv_position_embedding_init,
    embedding,
    embedding_init,
    linear,
    linear_init,
    make_generator,
    mmdit_block,
    mmdit_block_init,
    precompute_freqs_cis,
    timestep_embedding,
    timestep_embedding_init,
)
from korean_f5_tts_tpu_torch.ops.attention import check_attn_int8
from korean_f5_tts_tpu_torch.utils.misc import require_device

MMDIT_PRECOMPUTE_MAX_POS = 1024  # mmdit.py:37


@functools.lru_cache(maxsize=4)
def _pos_table(dim: int, device: torch.device) -> torch.Tensor:
    # outside inference mode, as models/dit.py:_freqs_cis_table
    with torch.inference_mode(False):
        return torch.from_numpy(precompute_freqs_cis(dim, MMDIT_PRECOMPUTE_MAX_POS)).to(device)


def init_mmdit(cfg: MMDiTConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.float32) -> dict:
    """Random MMDiT parameters with the JAX package's tree and shapes (torch
    layouts), drawn from a torch.Generator on `device`; floating leaves cast
    to `dtype`. Every block's AdaLN layers, norm_out and proj_out start at
    zero (mmdit.py:66-74), as a DiT's do."""
    device = require_device(device)
    gen = make_generator(device, seed)
    p = {
        "time_embed": timestep_embedding_init(gen, cfg.dim, device),
        "text_embed": {"embed": embedding_init(gen, cfg.text_num_embeds + 1, cfg.dim, device)},
        "audio_proj": linear_init(gen, cfg.mel_dim * 2, cfg.dim, device),
        "conv_pos_embed": conv_position_embedding_init(gen, cfg.dim, device),
        "blocks": [mmdit_block_init(gen, cfg.dim, cfg.heads, cfg.dim_head, device,
                                    ff_mult=cfg.ff_mult, context_pre_only=i == cfg.depth - 1,
                                    qk_norm=cfg.qk_norm)
                   for i in range(cfg.depth)],
        "norm_out": {"linear": {"w": torch.zeros((cfg.dim * 2, cfg.dim), device=device),
                                "b": torch.zeros(cfg.dim * 2, device=device)}},
        "proj_out": {"w": torch.zeros((cfg.mel_dim, cfg.dim), device=device),
                     "b": torch.zeros(cfg.mel_dim, device=device)},
    }
    return cast_params(p, dtype)


def mmdit_text_embedding(p: dict, cfg: MMDiTConfig, text: torch.Tensor,
                         drop_text=False) -> torch.Tensor:
    """[b, nt] ids (pad -1) -> [b, nt, dim] with the absolute position;
    padding zeroed under text_mask_padding (mmdit.py:78-98). Positions past
    the table take its last row."""
    text = text + 1
    text_mask = (text != 0)[..., None]
    if isinstance(drop_text, torch.Tensor):
        text = torch.where(drop_text.bool(), torch.zeros_like(text), text)
    elif drop_text:
        text = torch.zeros_like(text)
    h = embedding(p["embed"], text)
    nt = text.shape[1]
    pos = torch.arange(nt, device=h.device).clamp(max=MMDIT_PRECOMPUTE_MAX_POS - 1)
    h = h + _pos_table(h.shape[-1], h.device)[pos][None].to(h.dtype)
    if cfg.text_mask_padding:
        h = h.masked_fill(~text_mask, 0.0)
    return h


def _audio_embed(p: dict, x: torch.Tensor, cond: torch.Tensor, drop_audio_cond=False,
                 pad_mask: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
    """linear(concat(noise, cond)) + its conv position embedding, bucket-tail
    rows zeroed for the convolution (mmdit.py:101-111)."""
    if isinstance(drop_audio_cond, torch.Tensor):
        cond = cond * (1.0 - drop_audio_cond).to(cond.dtype)
    elif drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = linear(p["audio_proj"], torch.cat([x, cond], dim=-1))
    return conv_position_embedding(p["conv_pos_embed"], h, mask=pad_mask, kernels=kernels) + h


def mmdit_backbone(p: dict, cfg: MMDiTConfig, h: torch.Tensor, c: torch.Tensor,
                   t_emb: torch.Tensor, mask: torch.Tensor | None = None,
                   kernels: bool = True, attn_int8: str | None = None,
                   mesh=None) -> torch.Tensor:
    """Audio [b, n, dim], text [b, nt, dim], time [b, dim] -> flow [b, n, mel]
    (mmdit.py:114-122)."""
    rope_audio = dit_mod._rope_table(h.shape[1], cfg.dim_head, h.device)
    rope_text = dit_mod._rope_table(c.shape[1], cfg.dim_head, h.device)
    for i, blk in enumerate(p["blocks"]):
        c, h = mmdit_block(blk, h, c, t_emb, cfg.heads, context_pre_only=i == cfg.depth - 1,
                           mask=mask, rope=rope_audio, c_rope=rope_text, kernels=kernels,
                           attn_int8=attn_int8, mesh=mesh)
    h = ada_layernorm_final(p["norm_out"], h, t_emb)
    return linear(p["proj_out"], h)


def mmdit_forward(p: dict, cfg: MMDiTConfig, x: torch.Tensor, cond: torch.Tensor,
                  text: torch.Tensor, time: torch.Tensor, mask: torch.Tensor | None = None,
                  drop_audio_cond=False, drop_text=False, dropout_seed: int | None = None,
                  pad_mask: torch.Tensor | None = None, kernels: bool = True,
                  attn_path: str = "default", attn_int8: str | None = None,
                  mesh=None) -> torch.Tensor:
    """Training-path forward (mmdit.py:125-138), also a sampler step without
    CFG; the arguments as models/dit.py:dit_forward's. The MMDiT has no
    dropout (dropout_seed is taken and unused, as in the JAX forward), and
    attn_path does not apply: joint attention has one path. The attention
    mask is the duration mask, else the bucket-tail mask."""
    check_attn_int8(attn_int8, attn_path)
    if time.dim() == 0:
        time = time.repeat(x.shape[0])
    t_emb = timestep_embedding(p["time_embed"], time)
    c = mmdit_text_embedding(p["text_embed"], cfg, text, drop_text=drop_text)
    h = _audio_embed(p, x, cond, drop_audio_cond=drop_audio_cond, pad_mask=pad_mask,
                     kernels=kernels)
    return mmdit_backbone(p, cfg, h, c, t_emb, mask=mask if mask is not None else pad_mask,
                          kernels=kernels, attn_int8=attn_int8, mesh=mesh)


def mmdit_forward_cfg(p: dict, cfg: MMDiTConfig, x: torch.Tensor, cond: torch.Tensor,
                      text_emb_cond: torch.Tensor, text_emb_uncond: torch.Tensor,
                      time: torch.Tensor, cfg_strength: float,
                      mask: torch.Tensor | None = None, pad_mask: torch.Tensor | None = None,
                      kernels: bool = True, attn_path: str = "default",
                      attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """CFG step (mmdit.py:141-157): both halves as one batch of 2b, then
    pred + (pred - null_pred) * cfg_strength."""
    check_attn_int8(attn_int8, attn_path)
    if time.dim() == 0:
        time = time.repeat(x.shape[0])
    t_emb = timestep_embedding(p["time_embed"], time)
    h = _audio_embed(p, torch.cat([x, x], dim=0),
                     torch.cat([cond, torch.zeros_like(cond)], dim=0), pad_mask=pad_mask,
                     kernels=kernels)
    c = torch.cat([text_emb_cond, text_emb_uncond], dim=0)
    eff_mask = dit_mod._double_mask(mask if mask is not None else pad_mask)
    out = mmdit_backbone(p, cfg, h, c, torch.cat([t_emb, t_emb], dim=0), mask=eff_mask,
                         kernels=kernels, attn_int8=attn_int8, mesh=mesh)
    pred, null_pred = out.chunk(2, dim=0)
    return pred + (pred - null_pred) * cfg_strength

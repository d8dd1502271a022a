"""UNetT backbone, E2-TTS (counterpart of korean_f5_tts_tpu/models/unett.py).

A flat UNet transformer: the time embedding is prepended to the sequence as
a token (unett.py:90-95), the first half of the blocks push their inputs as
skips that the second half pops (concat + skip_proj, add, or none,
unett.py:102-110), the blocks are RMSNorm pre-norm attention + FF, rope runs
over n + 1 positions, and the input's conv position embedding takes no mask
(unett.py:80-82, unlike DiT's and MMDiT's).

Attention goes through models/modules.attention, so a block runs kernel A
(kernels 10, 11, 13 under autograd; 18 or 19 under attn_path, kernel 14
under attn_int8, kernel 9 per projection with int8 weights) exactly as a DiT
block's unfused attention does; the FF is plain products (or kernel 9 per
int8 linear). The CFG step packs the cond and uncond halves into one batch
of 2b before the input embedding, as dit_forward_cfg does, so conv-pos
(kernel C) runs twice a step: the same function as the JAX step, which
embeds the halves apart.

`mesh` (parallel/mesh.py; None: one device) runs each block on this
process's share of the weights (shard_params), as JAX's
param_partition_spec splits them: attention() on the rank's heads and
feedforward() on its columns, each summed over the model group; the FF
dropout mask is drawn at the global shape and sliced (modules.dropout), so
a data- or tensor-parallel step equals one process's. The embeddings,
skip_proj, the RMSNorms, the time token and proj_out stay replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from korean_f5_tts_tpu_torch.config import UNetTConfig
from korean_f5_tts_tpu_torch.models import dit as dit_mod
from korean_f5_tts_tpu_torch.models.modules import (
    attention,
    attention_init,
    cast_params,
    conv_position_embedding_init,
    embedding_init,
    feedforward,
    feedforward_init,
    linear,
    linear_init,
    make_generator,
    rmsnorm,
    rmsnorm_init,
    timestep_embedding,
    timestep_embedding_init,
)
from korean_f5_tts_tpu_torch.utils.misc import fold_in, require_device


def init_unett(cfg: UNetTConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.float32) -> dict:
    """Random UNetT parameters with the JAX package's tree and shapes (torch
    layouts), drawn from a torch.Generator on `device`; floating leaves cast
    to `dtype`. The depth must be even."""
    if cfg.depth % 2:
        raise ValueError(f"UNet-Transformer's depth should be even, got {cfg.depth}")
    device = require_device(device)
    gen = make_generator(device, seed)
    td = cfg.text_dim_
    text = {"embed": embedding_init(gen, cfg.text_num_embeds + 1, td, device)}
    if cfg.conv_layers > 0:
        text["blocks"] = [dit_mod._convnext_v2_block_init(gen, td, td * cfg.conv_mult, device)
                          for _ in range(cfg.conv_layers)]
    layers = []
    for idx in range(cfg.depth):
        layer = {
            "attn_norm": rmsnorm_init(cfg.dim, device),
            "attn": attention_init(gen, cfg.dim, cfg.heads, cfg.dim_head, device,
                                   qk_norm=cfg.qk_norm),
            "ff_norm": rmsnorm_init(cfg.dim, device),
            "ff": feedforward_init(gen, cfg.dim, cfg.ff_mult, device),
        }
        if cfg.skip_connect_type == "concat" and idx >= cfg.depth // 2:
            layer["skip_proj"] = linear_init(gen, cfg.dim * 2, cfg.dim, device, bias=False)
        layers.append(layer)
    p = {
        "time_embed": timestep_embedding_init(gen, cfg.dim, device),
        "text_embed": text,
        "input_proj": linear_init(gen, cfg.mel_dim * 2 + td, cfg.dim, device),
        "conv_pos_embed": conv_position_embedding_init(gen, cfg.dim, device),
        "layers": layers,
        "norm_out": rmsnorm_init(cfg.dim, device),
        "proj_out": linear_init(gen, cfg.dim, cfg.mel_dim, device),
    }
    return cast_params(p, dtype)


def unett_backbone(p: dict, cfg: UNetTConfig, h: torch.Tensor, t_emb: torch.Tensor,
                   mask: torch.Tensor | None = None, dropout_seed: int | None = None,
                   pad_mask: torch.Tensor | None = None, kernels: bool = True,
                   attn_path: str = "default", attn_int8: str | None = None,
                   mesh=None) -> torch.Tensor:
    """Embedded [b, n, dim] + time embedding [b, dim] -> flow [b, n, mel]
    (unett.py:85-116). The time token makes the sequence n + 1 long; the
    masks get a leading True, so a prefix mask stays one of length + 1.
    Block i draws its FF dropout from fold_in(dropout_seed, i), its
    generator made inside the block's function (the remat rule of
    models/dit.py:dit_backbone)."""
    h = torch.cat([t_emb[:, None, :], h], dim=1)
    if mask is not None:
        mask = F.pad(mask, (1, 0), value=True)
    if pad_mask is not None:
        pad_mask = F.pad(pad_mask, (1, 0), value=True)
    rope = dit_mod._rope_for(attn_path, h, cfg.dim_head)
    rate = cfg.dropout if dropout_seed is not None else 0.0

    def block(layer: dict, x: torch.Tensor, seed: int | None) -> torch.Tensor:
        gen = (torch.Generator(device=x.device).manual_seed(seed)
               if seed is not None and rate > 0.0 else None)
        x = attention(layer["attn"], rmsnorm(layer["attn_norm"], x), cfg.heads, mask=mask,
                      rope=rope, pe_attn_head=cfg.pe_attn_head,
                      attn_mask_enabled=cfg.attn_mask_enabled, pad_mask=pad_mask,
                      kernels=kernels, attn_path=attn_path, attn_int8=attn_int8,
                      mesh=mesh) + x
        return feedforward(layer["ff"], rmsnorm(layer["ff_norm"], x), dropout_rate=rate,
                           gen=gen, kernels=kernels, mesh=mesh) + x

    skips = []
    for idx, layer in enumerate(p["layers"]):
        if idx < cfg.depth // 2:
            skips.append(h)
        else:
            skip = skips.pop()
            if cfg.skip_connect_type == "concat":
                h = linear(layer["skip_proj"], torch.cat([h, skip], dim=-1), kernels=kernels)
            elif cfg.skip_connect_type == "add":
                h = h + skip
        seed = fold_in(dropout_seed, idx) if dropout_seed is not None else None
        if cfg.checkpoint_activations:
            h = torch.utils.checkpoint.checkpoint(block, layer, h, seed, use_reentrant=False)
        else:
            h = block(layer, h, seed)
    h = rmsnorm(p["norm_out"], h)[:, 1:]  # the time token goes
    return linear(p["proj_out"], h)


def unett_forward(p: dict, cfg: UNetTConfig, x: torch.Tensor, cond: torch.Tensor,
                  text: torch.Tensor, time: torch.Tensor, mask: torch.Tensor | None = None,
                  drop_audio_cond=False, drop_text=False, dropout_seed: int | None = None,
                  pad_mask: torch.Tensor | None = None, kernels: bool = True,
                  attn_path: str = "default", attn_int8: str | None = None,
                  mesh=None) -> torch.Tensor:
    """Training-path forward (unett.py:119-131), also a sampler step without
    CFG; the arguments as models/dit.py:dit_forward's."""
    if time.dim() == 0:
        time = time.repeat(x.shape[0])
    t_emb = timestep_embedding(p["time_embed"], time)
    text_emb = dit_mod.text_embedding(p["text_embed"], cfg, text, x.shape[1],
                                      drop_text=drop_text, pad_mask=pad_mask)
    h = dit_mod.input_embedding(p, x, cond, text_emb, drop_audio_cond=drop_audio_cond,
                                kernels=kernels)
    return unett_backbone(p, cfg, h, t_emb, mask=mask, dropout_seed=dropout_seed,
                          pad_mask=pad_mask, kernels=kernels, attn_path=attn_path,
                          attn_int8=attn_int8, mesh=mesh)


def unett_forward_cfg(p: dict, cfg: UNetTConfig, x: torch.Tensor, cond: torch.Tensor,
                      text_emb_cond: torch.Tensor, text_emb_uncond: torch.Tensor,
                      time: torch.Tensor, cfg_strength: float,
                      mask: torch.Tensor | None = None, pad_mask: torch.Tensor | None = None,
                      kernels: bool = True, attn_path: str = "default",
                      attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """CFG step (unett.py:134-151): the cond half and the uncond half (audio
    cond dropped, the uncond text embedding) as one batch of 2b, then
    pred + (pred - null_pred) * cfg_strength."""
    if time.dim() == 0:
        time = time.repeat(x.shape[0])
    t_emb = timestep_embedding(p["time_embed"], time)
    h = dit_mod.input_embedding(p, torch.cat([x, x], dim=0),
                                torch.cat([cond, torch.zeros_like(cond)], dim=0),
                                torch.cat([text_emb_cond, text_emb_uncond], dim=0),
                                kernels=kernels)
    out = unett_backbone(p, cfg, h, torch.cat([t_emb, t_emb], dim=0),
                         mask=dit_mod._double_mask(mask), pad_mask=pad_mask, kernels=kernels,
                         attn_path=attn_path, attn_int8=attn_int8, mesh=mesh)
    pred, null_pred = out.chunk(2, dim=0)
    return pred + (pred - null_pred) * cfg_strength

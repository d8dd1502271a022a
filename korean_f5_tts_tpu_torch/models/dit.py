"""DiT backbone (counterpart of korean_f5_tts_tpu/models/dit.py).

Serving: init_dit, text_embedding, precompute_step_modulations,
precompute_input_static, input_embedding_premix, dit_backbone_premod and
dit_forward_cfg_premod, the functions the sampler's CFG loop runs, for bf16
and for int8 weights (models/quant.py). bf16: the FF half-block takes kernel
B; the attention half is chosen by `attn_path` (ops/attention.py:ATTN_PATHS):
plain products around kernel A by default, as the bf16 TPU default leaves
them (dit.py:373-379), kernels 7, A, 8 under "linear_fused", kernel 18 or 19
under "rope_in_kernel" or "qkv_kernel". int8: the dispatch of dit.py:394-509
without tensor parallelism (kernels 5, A, 6 and 4, or kernel 9 per
projection under a duration mask). `attn_int8` (ATTN_INT8) puts kernel 14,
the int8 attention, in kernel A's place, over either kind of weights.

Training: input_embedding, dit_backbone and dit_forward (dit.py:181-301),
with the long skip, average upsampling, per-block activation checkpointing
("full" or "dots") and dropout. Attention there runs kernels 10, 11 and 13
(ops/flash_prefix.py), or under autograd kernel 18 ("rope_in_kernel"), 19
("qkv_kernel") or 7 and 8 around 10, 11, 13 ("linear_fused"), and the FF
half-block plain products, as the JAX training block does.

`mesh` (parallel/mesh.py) runs either path on this process's share of a
tensor-parallel model (parallel/tp_kernels.py; the dispatch of dit.py:
351-357, 405-421, 477-499): conv-pos, the text embedding and the input
projection stay replicated, as JAX's param_partition_spec leaves them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.modules import (
    _uniform,
    ada_layernorm_final,
    attention,
    attention_half_fused,
    attention_init,
    cast_params,
    conv1d_init,
    conv_position_embedding,
    convnext_v2_block,
    dit_block,
    embedding,
    embedding_init,
    feedforward,
    feedforward_init,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    make_generator,
    precompute_freqs_cis,
    rope_cos_sin,
    timestep_embedding,
)
from korean_f5_tts_tpu_torch.ops.attention import check_attn_int8, check_attn_path
from korean_f5_tts_tpu_torch.ops.ff_block import (
    ff_block_fused,
    ff_block_fused_int8,
    ff_block_int8_reference,
    ff_block_reference,
)
from korean_f5_tts_tpu_torch.parallel.mesh import model_parallel
from korean_f5_tts_tpu_torch.parallel.tp_kernels import (
    attn_half_block_tp,
    ff_block_int8_tp,
    ff_block_tp,
)
from korean_f5_tts_tpu_torch.utils.misc import fold_in, require_device

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
    ada = linear_init(gen, cfg.dim, cfg.dim * 6, device)
    return {
        # AdaLN-zero init: every block starts gated off (modules.py:626-628)
        "attn_norm": {"linear": {k: torch.zeros_like(v) for k, v in ada.items()}},
        "attn": attention_init(gen, cfg.dim, cfg.heads, cfg.dim_head, device,
                               qk_norm=cfg.qk_norm),
        "ff": feedforward_init(gen, cfg.dim, cfg.ff_mult, device),
    }


def init_dit(cfg: DiTConfig, seed: int = 0, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
    """Random DiT parameters with the JAX package's tree, shapes and init
    distributions (torch layouts), drawn from a torch.Generator on `device`
    (the card unless the caller names the CPU). Floating leaves are cast to
    `dtype`. qk_norm "rms_norm" adds the per-head q/k RMSNorm gains."""
    device = require_device(device)
    gen = make_generator(device, seed)
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
    if cfg.long_skip_connection:
        p["long_skip"] = linear_init(gen, cfg.dim * 2, cfg.dim, device, bias=False)
    return cast_params(p, dtype)


def redraw_zero_init(p: dict, seed: int = 0) -> dict:
    """Re-draw the AdaLN-zero layers uniform in +-1/sqrt(d_in), in place:
    a DiT's every block's attn_norm.linear, norm_out.linear and proj_out; an
    MMDiT's every block's attn_norm_x.linear and attn_norm_c.linear,
    norm_out.linear and proj_out (mmdit.py:66-74); a UNetT's proj_out (its
    norms are RMSNorm gains, never zero).

    Freshly initialised, those layers gate every block off and make the mel
    exactly zero, so a wrong kernel would still agree with a right one; any
    comparison of randomly initialised models needs them re-drawn first.
    """
    ref = p["proj_out"]["w"]
    gen = torch.Generator(device=ref.device).manual_seed(seed)
    layers = [blk[name]["linear"] for blk in p.get("blocks", [])
              for name in ("attn_norm", "attn_norm_x", "attn_norm_c") if name in blk]
    if "linear" in p["norm_out"]:
        layers.append(p["norm_out"]["linear"])
    layers.append(p["proj_out"])
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
    # made outside inference mode: the sampler may fill this cache and a training
    # step read it, and autograd cannot save an inference tensor for its backward
    with torch.inference_mode(False):
        return torch.from_numpy(precompute_freqs_cis(dim, PRECOMPUTE_MAX_POS)).to(device)


def _average_upsample(text: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
    """Zipvoice-style late average upsampling (dit.py:99-129): each of a row's
    text_len valid tokens repeats to fill the n slots, the last
    n % text_len tokens once more; rows without a valid token are zero."""
    b, n, _ = text.shape
    text_lens = text_mask.sum(dim=1)                       # [b]
    tl = text_lens.clamp(min=1)[:, None]
    base = n // tl
    pivot = tl - n % tl  # tokens < pivot repeat `base` times, the rest base + 1
    o = torch.arange(n, device=text.device)[None, :]
    tok = torch.where(o < pivot * base, o // base.clamp(min=1),
                      pivot + (o - pivot * base) // (base + 1))
    tok = torch.minimum(tok.clamp(min=0), tl - 1)
    # index of the tok-th valid position of each row
    valid_pos = torch.cumsum(text_mask.long(), dim=1) - 1
    order = torch.where(text_mask, valid_pos, n + torch.arange(n, device=text.device))
    src = torch.gather(torch.argsort(order, dim=1), 1, tok)
    out = torch.gather(text, 1, src[..., None].expand(-1, -1, text.shape[-1]))
    return torch.where((text_lens > 0)[:, None, None], out, torch.zeros_like(out))


def text_embedding(p: dict, cfg: DiTConfig, text: torch.Tensor, seq_len: int,
                   drop_text=False, pad_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[b, nt] token ids (pad = -1) -> [b, seq_len, text_dim] (dit.py:132-173).

    Ids shift by +1 (0 = filler) and are cut or padded to the mel length;
    pad_mask ([1, seq_len]) hides bucket-tail rows from the ConvNeXt stack's
    sequence statistics. drop_text is a bool or a 0/1 tensor (the training
    CFG drop); the padding mask comes from the ids before the drop.
    """
    text = text + 1
    if text.shape[1] >= seq_len:
        text = text[:, :seq_len]
    else:
        text = F.pad(text, (0, seq_len - text.shape[1]))
    text_mask = (text != 0)[..., None]
    if isinstance(drop_text, torch.Tensor):
        text = torch.where(drop_text.bool(), torch.zeros_like(text), text)
    elif drop_text:
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
    if getattr(cfg, "text_embedding_average_upsampling", False):
        h = _average_upsample(h, text_mask[..., 0])
    return h


# ---------------------------------------------------------------------------
# input embedding + backbone
# ---------------------------------------------------------------------------


def precompute_input_static(p: dict, cfg: DiTConfig, cond: torch.Tensor,
                            text_emb_cond: torch.Tensor,
                            text_emb_uncond: torch.Tensor) -> torch.Tensor:
    """Loop-invariant part of the CFG input projection, computed once
    (dit.py:201-220): cond @ Wc + text @ Wt + b for the cond half, text-only
    for the uncond half. Returns [2b, n, dim]. The weights are cast to
    cond's dtype; the text embedding (its table's dtype) meets Wt at the
    wider of the two, as JAX's bf16 @ fp32 promotes."""
    w = p["input_proj"]["w"]  # [dim, 2 * mel + text]
    m = cfg.mel_dim
    dt = cond.dtype
    wc, wt = w[:, m:2 * m].t().to(dt), w[:, 2 * m:].t().to(dt)
    b = p["input_proj"]["b"].to(dt)
    tdt = torch.promote_types(text_emb_cond.dtype, dt)
    top = cond @ wc + text_emb_cond.to(tdt) @ wt.to(tdt) + b
    bottom = text_emb_uncond.to(tdt) @ wt.to(tdt) + b
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


def input_embedding(p: dict, x: torch.Tensor, cond: torch.Tensor, text_embed: torch.Tensor,
                    drop_audio_cond=False, audio_mask: torch.Tensor | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """concat(noise, cond, text) -> proj -> + conv position embedding
    (dit.py:181-193). drop_audio_cond is a bool or a 0/1 tensor."""
    if isinstance(drop_audio_cond, torch.Tensor):
        cond = cond * (1.0 - drop_audio_cond).to(cond.dtype)
    elif drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = linear(p["input_proj"], torch.cat([x, cond, text_embed], dim=-1))
    return conv_position_embedding(p["conv_pos_embed"], h, mask=audio_mask,
                                   kernels=kernels) + h


@functools.lru_cache(maxsize=32)
def _rope_table(seq_len: int, dim_head: int, device: torch.device,
                dtype: torch.dtype = torch.float32):
    cos, sin = rope_cos_sin(seq_len, dim_head)
    with torch.inference_mode(False):  # as _freqs_cis_table: training reads the cache too
        return (torch.from_numpy(cos).to(device=device, dtype=dtype),
                torch.from_numpy(sin).to(device=device, dtype=dtype))


def _rope_for(attn_path: str, h: torch.Tensor, dim_head: int):
    """The rope tables for h's length: fp32 for rope in torch; kernels 18 and
    19 read them in the activations' dtype, cast once here."""
    in_kernel = check_attn_path(attn_path) in ("rope_in_kernel", "qkv_kernel")
    return _rope_table(h.shape[1], dim_head, h.device, h.dtype if in_kernel else torch.float32)


# what the "dots" policy keeps for the backward: the products without batch
# dims (jax.checkpoint_policies.dots_with_no_batch_dims_saveable) and the kernel
# launches of ops/ (cuda_build.launch_op): the attention output of kernels 10,
# 18 and 19 (JAX's "attn_out" name, saved by default) and the products of 7 and 8
_DOTS_SAVED = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVED or op.namespace == "f5_port":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def dit_backbone(p: dict, cfg: DiTConfig, h: torch.Tensor, t_emb: torch.Tensor,
                 mask: torch.Tensor | None = None, dropout_seed: int | None = None,
                 pad_mask: torch.Tensor | None = None, kernels: bool = True,
                 attn_path: str = "default", attn_int8: str | None = None,
                 mesh=None) -> torch.Tensor:
    """Embedded input [b, n, dim] + time embedding [b, dim] -> flow [b, n, mel]
    (dit.py:233-283).

    dropout_seed None turns dropout off. Otherwise block i draws its FF
    dropout mask from a generator seeded with fold_in(dropout_seed, i) and
    made inside the block's function: torch.utils.checkpoint restores only
    the default generators, not an explicit one, so a generator made outside
    would give the recompute another mask than the forward.
    checkpoint_activations recomputes each block in the backward pass:
    remat_policy "full" all of it, "dots" (dit.py:252-268) only the
    elementwise ops. "dots" is torch.utils.checkpoint's selective policy
    (_dots_policy): every product without batch dims and every kernel
    launch that ops/ registers as an operator (the attention output of
    kernels 10, 18, 19 and the products of 7 and 8) is kept, as JAX keeps
    the dots and "attn_out"; a ctypes launch inside an autograd Function
    would be invisible to the policy, hence the operators.
    """
    if cfg.checkpoint_activations and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got {cfg.remat_policy!r}")
    rope = _rope_for(attn_path, h, cfg.dim_head)
    residual = h if cfg.long_skip_connection else None
    rate = cfg.dropout if dropout_seed is not None else 0.0

    def block(blk: dict, x: torch.Tensor, seed: int | None) -> torch.Tensor:
        gen = (torch.Generator(device=x.device).manual_seed(seed)
               if seed is not None and rate > 0.0 else None)
        return dit_block(blk, x, t_emb, cfg.heads, mask=mask, rope=rope,
                         pe_attn_head=cfg.pe_attn_head, attn_mask_enabled=cfg.attn_mask_enabled,
                         pad_mask=pad_mask, dropout_rate=rate, gen=gen, kernels=kernels,
                         attn_path=attn_path, attn_int8=attn_int8, mesh=mesh)

    remat = {}
    if cfg.checkpoint_activations and cfg.remat_policy == "dots":
        remat = {"context_fn": _dots_context}
    for i, blk in enumerate(p["blocks"]):
        seed = fold_in(dropout_seed, i) if dropout_seed is not None else None
        if cfg.checkpoint_activations:
            h = torch.utils.checkpoint.checkpoint(block, blk, h, seed, use_reentrant=False,
                                                  **remat)
        else:
            h = block(blk, h, seed)
    if residual is not None:
        h = linear(p["long_skip"], torch.cat([h, residual], dim=-1))
    h = ada_layernorm_final(p["norm_out"], h, t_emb)
    return linear(p["proj_out"], h)


def dit_forward(p: dict, cfg: DiTConfig, x: torch.Tensor, cond: torch.Tensor,
                text: torch.Tensor, time: torch.Tensor, mask: torch.Tensor | None = None,
                drop_audio_cond=False, drop_text=False, dropout_seed: int | None = None,
                pad_mask: torch.Tensor | None = None, kernels: bool = True,
                attn_path: str = "default", attn_int8: str | None = None,
                mesh=None) -> torch.Tensor:
    """Training-path forward (dit.py:286-301), also one step of the sampler
    without CFG: x, cond [b, n, mel], text ids [b, nt], time [b] (or a
    scalar); the drops are bools or 0/1 tensors. Under a mesh x is this
    data rank's rows and p this model rank's share."""
    if time.dim() == 0:
        time = time.repeat(x.shape[0])
    t_emb = timestep_embedding(p["time_embed"], time)
    text_emb = text_embedding(p["text_embed"], cfg, text, x.shape[1], drop_text=drop_text,
                              pad_mask=pad_mask)
    h = input_embedding(p, x, cond, text_emb, drop_audio_cond=drop_audio_cond,
                        audio_mask=mask if mask is not None else pad_mask, kernels=kernels)
    return dit_backbone(p, cfg, h, t_emb, mask=mask, dropout_seed=dropout_seed,
                        pad_mask=pad_mask, kernels=kernels, attn_path=attn_path,
                        attn_int8=attn_int8, mesh=mesh)


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
                        kernels: bool = True, attn_path: str = "default",
                        attn_int8: str | None = None, mesh=None) -> torch.Tensor:
    """One sampling step of the backbone with precomputed modulations
    (dit.py:323-528). mods: [depth, 6*dim] shared across the batch,
    mod_final: [2*dim]. kernels=False runs every kernel's plain version
    through the same dispatch.

    Per block, as the JAX dispatch (dit.py:394-520) decides it:
      - attention: no duration mask, no qk-norm and int8 projections ->
        kernels 5, A, 6, whatever attn_path says; no duration mask, no
        qk-norm, attn_path "linear_fused" and bf16 projections with biases ->
        kernels 7, A, 8 (the fused half-blocks have no place for the q/k
        norms, dit.py:374); otherwise norm +
        attention(), which runs kernel 18 under "rope_in_kernel", kernel 19
        under "qkv_kernel" and kernel A else (kernel 9 per int8 projection);
      - FF half-block: int8 ff/in -> kernel 4; otherwise kernel B.
    attn_int8 ("qk" or "qkpv") replaces kernel A by kernel 14 in every case
    above that runs kernel A; it raises with "rope_in_kernel" and "qkv_kernel".

    long_skip_connection concatenates the block stack's input to its output
    and projects it back before the final norm (dit.py:340, :522-523).
    Tensor-parallel (`mesh` with a model axis > 1, p this rank's share), as
    dit.py:405-421 and 477-499: the fused attention half runs
    attn_half_block_tp (5, A, 6 or 7, A, 8 on the rank's heads, then the
    all-reduce), the FF half ff_block_tp (kernel B) or ff_block_int8_tp
    (kernel 4); where one returns None (the JAX shape predicate) the rank
    takes the unfused half, attention() and feedforward() on its heads and
    columns. The data axis does not split the sampler's batch: every data
    rank samples it whole.
    """
    check_attn_int8(attn_int8, attn_path)
    rope = _rope_for(attn_path, h, cfg.dim_head)
    residual = h if cfg.long_skip_connection else None
    prefix_lens = pad_mask.sum(dim=-1, dtype=torch.int32) if pad_mask is not None else None
    ff = ff_block_fused if kernels else ff_block_reference
    ff_int8 = ff_block_fused_int8 if kernels else ff_block_int8_reference
    tp = model_parallel(mesh)
    names = ("to_q", "to_k", "to_v", "to_out")
    for i, blk in enumerate(p["blocks"]):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mods[i].to(h.dtype).chunk(6))
        ap = blk["attn"]
        fusable = mask is None and cfg.qk_norm is None and (
            all("w_int8" in ap[n] for n in names)
            or (attn_path == "linear_fused" and all("w" in ap[n] and "b" in ap[n] for n in names)))
        out = None
        if fusable and tp:
            out = attn_half_block_tp(h, scale_msa, shift_msa, gate_msa, ap, cfg.heads, rope,
                                     cfg.pe_attn_head, prefix_lens, mesh, kernels=kernels,
                                     attn_int8=attn_int8)
        elif fusable:
            out = attention_half_fused(ap, h, scale_msa, shift_msa, gate_msa, cfg.heads, rope,
                                       cfg.pe_attn_head, prefix_lens, kernels=kernels,
                                       attn_int8=attn_int8)
        if out is not None:
            h = out
        else:
            norm = layernorm({}, h, eps=1e-6) * (1 + scale_msa) + shift_msa
            attn_out = attention(ap, norm, cfg.heads, mask=mask, rope=rope,
                                 pe_attn_head=cfg.pe_attn_head,
                                 attn_mask_enabled=cfg.attn_mask_enabled,
                                 pad_mask=pad_mask, kernels=kernels, attn_path=attn_path,
                                 attn_int8=attn_int8, mesh=mesh)
            h = h + gate_msa * attn_out
        fp = blk["ff"]
        int8 = "w_int8" in fp["in"]
        out = None
        if tp and int8:
            out = ff_block_int8_tp(h, scale_mlp, shift_mlp, gate_mlp, fp["in"], fp["out"], mesh,
                                   kernels=kernels)
        elif tp:
            out = ff_block_tp(h, scale_mlp, shift_mlp, gate_mlp, fp["in"]["w"], fp["in"]["b"],
                              fp["out"]["w"], fp["out"]["b"], mesh, kernels=kernels)
        if out is not None:
            h = out
        elif tp:
            norm = layernorm({}, h, eps=1e-6) * (1 + scale_mlp) + shift_mlp
            h = h + gate_mlp * feedforward(fp, norm, kernels=kernels, mesh=mesh)
        elif int8:
            h = ff_int8(h, scale_mlp, shift_mlp, gate_mlp, fp["in"], fp["out"])
        else:
            h = ff(h, scale_mlp, shift_mlp, gate_mlp, fp["in"]["w"].to(h.dtype),
                   fp["in"]["b"].to(h.dtype), fp["out"]["w"].to(h.dtype),
                   fp["out"]["b"].to(h.dtype))
    if residual is not None:
        h = linear(p["long_skip"], torch.cat([h, residual], dim=-1))
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
                           kernels: bool = True, attn_path: str = "default",
                           attn_int8: str | None = None, mesh=None) -> torch.Tensor:
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
                              pad_mask=pad_mask, kernels=kernels, attn_path=attn_path,
                              attn_int8=attn_int8, mesh=mesh)
    pred, null_pred = out.chunk(2, dim=0)
    return pred + (pred - null_pred) * cfg_strength


def count_params(p) -> int:
    if isinstance(p, dict):
        return sum(count_params(v) for v in p.values())
    if isinstance(p, list):
        return sum(count_params(v) for v in p)
    return int(np.prod(p.shape))

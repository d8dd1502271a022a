"""Conditional flow matching: the training loss and the serving sampler
(counterpart of korean_f5_tts_tpu/models/cfm.py).

Every backbone (DiT, UNetT, MMDiT) runs through _backbone_fns, which picks
its forward, CFG step and text embedding by the arch config's type
(cfm.py:59-75).

Training: cfm_loss (cfm.py:83-129), split into draw_cfm (the random draws,
from one torch.Generator) and cfm_loss_from_draws (the loss given them), so
that a test can hand the port the JAX package's draws.

Sampling: _sample_core (text embedding once, then the Euler loop over the
EPSS/sway schedule, with CFG packed as batch 2 or, at cfg_strength 0,
without CFG through the backbone's forward; a DiT's CFG step takes the
precomputed modulations, the others their generic CFG step), _sample_core_vocos (the sampler, the cond
splice and the Vocos decode as one call), _serve_core_vocos (masks, cond
padding, seeded noise, _sample_core_vocos, RMS restore, int16) with its host
wrapper serve_sample for the server, and cfm_sample for offline inference
(duration floor and clamp, duration and text buckets, regrouping a mixed
batch by bucket, edit_mask, no_ref_audio, duplicate_test, seeded noise at
the canonical length; MMDiT's text is never bucketed, its attention sees
the text stream at its own length). The JAX scan becomes a Python loop over the steps.
The buckets are arguments here, not environment variables; `attn_path`
(ops/attention.py:ATTN_PATHS) picks the attention half's kernels and
`attn_int8` (ATTN_INT8) the int8 attention kernel, for sampling only.
"""

from __future__ import annotations

import math
import secrets

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.config import CFMConfig, DiTConfig, MMDiTConfig, UNetTConfig
from korean_f5_tts_tpu_torch.models import dit as dit_mod
from korean_f5_tts_tpu_torch.models import mmdit as mmdit_mod
from korean_f5_tts_tpu_torch.models import unett as unett_mod
from korean_f5_tts_tpu_torch.models.vocos import vocos_decode
from korean_f5_tts_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from korean_f5_tts_tpu_torch.utils.misc import (
    fold_in,
    lens_to_mask,
    mask_from_start_end_indices,
    span_start_end,
)
from korean_f5_tts_tpu_torch.utils.timesteps import make_schedule

DEFAULT_DURATION_BUCKET = 128  # frames; the kernels take any n, so no TPU 512
TEXT_BUCKET = 64  # text tokens are padded to a multiple of this


def _mmdit_text(p, arch, text, seq_len, drop_text=False, pad_mask=None):
    # MMDiT embeds the text at its own length, not the mel's
    return mmdit_mod.mmdit_text_embedding(p, arch, text, drop_text=drop_text)


def _backbone_fns(arch):
    """(forward, forward_cfg, text_embedding) of the arch config's backbone
    (cfm.py:59-75); a DiT's CFG step is dit_forward_cfg_premod, which
    _sample_core calls itself."""
    if type(arch) is UNetTConfig:
        return unett_mod.unett_forward, unett_mod.unett_forward_cfg, dit_mod.text_embedding
    if type(arch) is MMDiTConfig:
        return mmdit_mod.mmdit_forward, mmdit_mod.mmdit_forward_cfg, _mmdit_text
    if type(arch) is DiTConfig:
        return dit_mod.dit_forward, None, dit_mod.text_embedding
    raise TypeError(f"unsupported backbone config: {type(arch)}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


def draw_cfm(shape: tuple[int, int, int], lens: torch.Tensor, gen: torch.Generator,
             cfm: CFMConfig = CFMConfig(), dtype: torch.dtype = torch.float32) -> dict:
    """The loss's random draws for a [b, n, d] batch (cfm.py:96-117): span
    fraction and its start, noise x0, time, and the CFG drop bits as 0/1
    tensors (drop_audio already set where drop_text is)."""
    b, n, d = shape
    dev = lens.device
    lo, hi = cfm.frac_lengths_mask
    frac = torch.rand((b,), generator=gen, device=dev) * (hi - lo) + lo
    start, end = span_start_end(lens, frac, torch.rand((b,), generator=gen, device=dev))
    x0 = torch.randn(shape, generator=gen, device=dev).to(dtype)
    time = torch.rand((b,), generator=gen, device=dev).to(dtype)
    drop_audio = torch.rand((), generator=gen, device=dev) < cfm.audio_drop_prob
    drop_both = torch.rand((), generator=gen, device=dev) < cfm.cond_drop_prob
    return {"frac_lengths": frac, "span_start": start, "span_end": end, "x0": x0,
            "time": time, "drop_audio": (drop_audio | drop_both).to(dtype),
            "drop_text": drop_both.to(dtype)}


def cfm_loss_from_draws(params: dict, arch: DiTConfig, mel: torch.Tensor, text: torch.Tensor,
                        lens: torch.Tensor, draws: dict, dropout_seed: int | None = None,
                        kernels: bool = True, attn_int8: str | None = None,
                        attn_path: str = "default", mesh=None):
    """Masked flow-matching MSE over the random span (cfm.py:98-129) given
    draw_cfm's draws; returns (loss, cond, pred). attn_int8 raises: the int8
    attention kernel has no gradient, training keeps the differentiable
    attention kernels; attn_path picks them (ops/attention.py:ATTN_PATHS).

    Under a mesh (any backbone) mel, text, lens and the draws are this data
    rank's rows and the loss is its share of JAX's global masked mean: the
    squared error of its rows over the span count of the whole batch,
    all-reduced over the data group, so that the shares sum to the
    single-device loss. Zero-length rows (distributed.pad_rows) add nothing
    to either."""
    if attn_int8 is not None:
        raise ValueError(f"attn_int8={attn_int8!r} is inference only: the loss keeps the "
                         "differentiable attention kernels")
    b, n, _ = mel.shape
    mask = lens_to_mask(lens, n)
    span = mask_from_start_end_indices(draws["span_start"], draws["span_end"], n) & mask
    x1, x0, time = mel, draws["x0"], draws["time"]
    t = time[:, None, None]
    phi = (1.0 - t) * x0 + t * x1
    flow = x1 - x0
    cond = torch.where(span[..., None], torch.zeros_like(x1), x1)
    pred = _backbone_fns(arch)[0](params, arch, phi, cond, text, time, mask=mask,
                                  drop_audio_cond=draws["drop_audio"],
                                  drop_text=draws["drop_text"], dropout_seed=dropout_seed,
                                  kernels=kernels, attn_path=attn_path, mesh=mesh)
    se = (pred - flow) ** 2
    count = span.sum()
    if axis_size(mesh, "data") > 1:
        count = count.to(torch.float32)  # exact: a span count is far below 2**24
        dist.all_reduce(count, group=axis_group(mesh, "data"))
    denom = count.clamp(min=1) * mel.shape[-1]
    loss = torch.where(span[..., None], se, torch.zeros_like(se)).sum() / denom
    return loss, cond, pred


def cfm_loss(params: dict, arch: DiTConfig, mel: torch.Tensor, text: torch.Tensor,
             lens: torch.Tensor, seed: int, cfm: CFMConfig = CFMConfig(),
             kernels: bool = True, attn_int8: str | None = None,
             attn_path: str = "default", mesh=None):
    """Flow-matching loss (cfm.py:83-129); returns (loss, cond, pred). The
    draws come from a generator seeded with `seed` on mel's device, the
    dropout masks from fold_in(seed, 1). attn_int8 raises (inference only).
    Under a mesh with data ranks the draws are made at the global batch's
    shape and each rank takes its rows, so the sharded step draws what one
    device draws."""
    gen = torch.Generator(device=mel.device).manual_seed(seed)
    dp = axis_size(mesh, "data")
    if dp == 1:
        draws = draw_cfm(tuple(mel.shape), lens, gen, cfm, dtype=mel.dtype)
    else:
        b, r = mel.shape[0], axis_rank(mesh, "data")
        rows = slice(r * b, (r + 1) * b)
        glens = torch.zeros((b * dp,), dtype=lens.dtype, device=lens.device)
        glens[rows] = lens
        draws = draw_cfm((b * dp, *mel.shape[1:]), glens, gen, cfm, dtype=mel.dtype)
        draws = {k: v[rows] if v.dim() else v for k, v in draws.items()}
    return cfm_loss_from_draws(params, arch, mel, text, lens, draws,
                               dropout_seed=fold_in(seed, 1), kernels=kernels,
                               attn_int8=attn_int8, attn_path=attn_path, mesh=mesh)


# ---------------------------------------------------------------------------
# serving sampler
# ---------------------------------------------------------------------------


@torch.inference_mode()
def _sample_core(params: dict, arch: DiTConfig,
                 step_cond: torch.Tensor,      # [b, N, d] cond, masked to its region
                 text: torch.Tensor,           # [b, nt] ids, pad -1
                 mask: torch.Tensor | None,    # [b, N] duration mask (None for b == 1)
                 pad_mask: torch.Tensor | None,  # [1, N] bucket-tail mask
                 y0: torch.Tensor,             # [b, N, d] noise, zero past duration
                 cfg_strength: float, sway_coef: float,
                 steps: int, use_cfg: bool, use_sway: bool, use_epss: bool,
                 t_start: float = 0.0, kernels: bool = True,
                 attn_path: str = "default", attn_int8: str | None = None,
                 mesh=None) -> torch.Tensor:
    """Text embedding (once) + Euler integration over the schedule
    (cfm.py:366-439). Returns the final mel [b, N, d]. With CFG every step is
    one packed forward of 2b items: a DiT's with precomputed modulations, a
    UNetT's or an MMDiT's through its CFG step (cfm.py:424-438); without it
    (cfg_strength <= 1e-5) every step is the backbone's forward on the b
    items."""
    N = step_cond.shape[1]
    dt_ = step_cond.dtype
    base = make_schedule(steps, use_epss=use_epss, sway_sampling_coef=None, t_start=t_start)
    ts = torch.as_tensor(base, dtype=dt_, device=step_cond.device)
    if use_sway:
        c = torch.as_tensor(sway_coef, dtype=dt_, device=ts.device)
        ts = ts + c * (torch.cos(math.pi / 2.0 * ts) - 1.0 + ts)
    dts = ts[1:] - ts[:-1]
    x = y0
    forward, forward_cfg, text_embedding = _backbone_fns(arch)
    paths = dict(kernels=kernels, attn_path=attn_path, attn_int8=attn_int8, mesh=mesh)
    if not use_cfg:
        for s in range(steps):
            pred = forward(params, arch, x, step_cond, text, ts[s].expand(x.shape[0]),
                           mask=mask, pad_mask=pad_mask, **paths)
            x = (x + dts[s] * pred).to(y0.dtype)
        return x
    te_cond = text_embedding(params["text_embed"], arch, text, N, drop_text=False,
                             pad_mask=pad_mask)
    te_uncond = text_embedding(params["text_embed"], arch, text, N, drop_text=True,
                               pad_mask=pad_mask)
    if forward_cfg is not None:
        for s in range(steps):
            pred = forward_cfg(params, arch, x, step_cond, te_cond, te_uncond,
                               ts[s].expand(x.shape[0]), cfg_strength, mask=mask,
                               pad_mask=pad_mask, **paths)
            x = (x + dts[s] * pred).to(y0.dtype)
        return x
    # every time-dependent modulation and the cond/text half of the input
    # projection are loop-invariant: computed once, outside the loop
    mods, mod_final, _ = dit_mod.precompute_step_modulations(params, arch, ts[:-1])
    static_inp = dit_mod.precompute_input_static(params, arch, step_cond, te_cond, te_uncond)
    for s in range(steps):
        pred = dit_mod.dit_forward_cfg_premod(
            params, arch, x, step_cond, te_cond, te_uncond, mods[s], mod_final[s],
            cfg_strength, mask=mask, pad_mask=pad_mask, static_inp=static_inp, **paths)
        x = (x + dts[s] * pred).to(y0.dtype)
    return x


@torch.inference_mode()
def _sample_core_vocos(params: dict, voc_params: dict, arch: DiTConfig, step_cond, text, mask,
                       pad_mask, y0, cond_mask: torch.Tensor, cfg_strength: float,
                       sway_coef: float, *, vcfg, steps: int, use_cfg: bool, use_sway: bool,
                       use_epss: bool, t_start: float = 0.0, kernels: bool = True,
                       attn_path: str = "default", attn_int8: str | None = None,
                       mesh=None):
    """The sampler, the cond splice and the Vocos decode as one call
    (cfm.py:153-193); returns (mel [b, N, d], wav [b, N * hop] fp32)."""
    mel = _sample_core(params, arch, step_cond, text, mask, pad_mask, y0, cfg_strength,
                       sway_coef, steps=steps, use_cfg=use_cfg, use_sway=use_sway,
                       use_epss=use_epss, t_start=t_start, kernels=kernels, attn_path=attn_path,
                       attn_int8=attn_int8, mesh=mesh)
    out = torch.where(cond_mask[..., None], step_cond, mel)
    # replicate one frame so duration * hop samples exist even at full-bucket
    # durations (an ISTFT over N frames yields only (N - 1) * hop)
    out_v = torch.cat([out, out[:, -1:]], dim=1)
    return out, vocos_decode(voc_params, out_v.transpose(1, 2), vcfg)


def _compute_dtype(params: dict, default: torch.dtype) -> torch.dtype:
    """The sampler runs at the model's compute dtype: bf16 weights -> bf16
    everything (a kernel's operands are all of one dtype); fp32 weights keep
    `default`."""
    return (torch.bfloat16 if any(t.dtype == torch.bfloat16 for t in _leaves(params))
            else default)


def bucket_text(text: np.ndarray, text_bucket: int, arch=None) -> np.ndarray:
    """Pad [b, nt] ids with -1 to a multiple of text_bucket tokens (0: as is).
    Exact for DiT and UNetT: text_embedding shifts ids by +1 and pads with the
    same filler 0 itself. An MMDiT's text stays as it is (cfm.py:328,
    :574-578): its attention sees every text position, padding included."""
    nt = text.shape[1]
    if text_bucket <= 0 or type(arch) is MMDiTConfig:
        return text
    ntb = max(text_bucket, int(np.ceil(nt / text_bucket)) * text_bucket)
    return text if ntb == nt else np.pad(text, ((0, 0), (0, ntb - nt)), constant_values=-1)


def draw_noise(seeds, canon: int, d: int, device, dtype) -> torch.Tensor:
    """Per-item N(0, 1) noise [b, canon, d] from one torch.Generator per item:
    identical seeds give the batch one shared noise tensor (cfm.py:268-271)."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(int(s))
        rows.append(torch.randn((canon, d), generator=gen, device=device))
    return torch.stack(rows).to(dtype)


@torch.inference_mode()
def _serve_core_vocos(params: dict, voc_params: dict, arch: DiTConfig,
                      cond_b: torch.Tensor,   # [b, Bc, d] bucketed ref mels (rows >= lens: garbage)
                      lens: np.ndarray,       # [b] true ref frame counts
                      duration: np.ndarray,   # [b] total frames (floored/clamped)
                      text: np.ndarray,       # [b, nt] ids, pad -1
                      seeds: np.ndarray,      # [b] noise seeds
                      cfg_strength: float, sway_coef: float,
                      wav_scale: np.ndarray,  # [b] output gain (RMS restore)
                      *, vcfg, N: int, steps: int, use_cfg: bool, use_sway: bool,
                      use_epss: bool, canon: int, single: bool,
                      y0: torch.Tensor | None = None, kernels: bool = True,
                      attn_path: str = "default", attn_int8: str | None = None,
                      mesh=None) -> torch.Tensor:
    """All request-side device work of a batch (cfm.py:203-285); returns the
    int16 waveform [b, N * hop] on the device. y0 ([b, N, d]), when
    given, replaces the seeded noise."""
    dev = cond_b.device
    b, Bc, d = cond_b.shape
    # run at the model's compute dtype: bf16 weights -> bf16 everything
    cdt = _compute_dtype(params, cond_b.dtype)
    cond_b = cond_b.to(cdt)
    ar = torch.arange(N, device=dev)
    lens_t = torch.as_tensor(np.asarray(lens), device=dev)
    dur_t = torch.as_tensor(np.asarray(duration), device=dev)
    cond_mask = ar[None, :] < lens_t[:, None]
    cond_p = cond_b[:, :N] if Bc >= N else F.pad(cond_b, (0, 0, 0, N - Bc))
    step_cond = cond_p.masked_fill(~cond_mask[..., None], 0.0)
    dur_mask = ar[None, :] < dur_t[:, None]
    # reference-semantics duration mask only for b > 1 (cfm.py:156-158);
    # the bucket-tail pad mask always
    mask = None if single else dur_mask
    pad_mask = (ar < int(np.max(duration)))[None, :]
    if y0 is None:
        y0 = draw_noise(seeds, canon, d, dev, cdt)[:, :N]
    y0 = y0.to(device=dev, dtype=cdt).masked_fill(~dur_mask[..., None], 0.0)
    _, wav = _sample_core_vocos(
        params, voc_params, arch, step_cond, torch.as_tensor(text, device=dev), mask, pad_mask,
        y0, cond_mask, cfg_strength, sway_coef, vcfg=vcfg, steps=steps, use_cfg=use_cfg,
        use_sway=use_sway, use_epss=use_epss, kernels=kernels, attn_path=attn_path,
        attn_int8=attn_int8, mesh=mesh)
    wav = wav.float() * torch.as_tensor(np.asarray(wav_scale, np.float32), device=dev)[:, None]
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def serve_sample(params: dict, arch: DiTConfig, cond_b: torch.Tensor, text, duration, lens,
                 *, vocoder_fused: tuple, steps: int = 16, cfg_strength: float = 2.0,
                 sway_sampling_coef: float | None = -1.0, seed: int | None = None,
                 wav_scale=None, max_duration: int = 4096, duration_bucket: int | None = None,
                 use_epss: bool = True, y0: torch.Tensor | None = None,
                 text_bucket: int = TEXT_BUCKET, kernels: bool = True,
                 attn_path: str = "default", attn_int8: str | None = None,
                 mesh=None):
    """Host wrapper of the serving path (cfm.py:288-357). Returns (int16
    waveform [b, N * hop] on the device, duration [b] host ints).

    Host side: duration floor and clamp, duration bucket N, text padded to a
    multiple of text_bucket tokens, noise seeds (a seed of None draws one per
    item).
    """
    text_host = np.asarray(text)
    lens = np.asarray(lens)
    duration = np.asarray(duration)
    text_lens = (text_host != -1).sum(axis=-1)
    duration = np.maximum(np.maximum(text_lens, lens) + 1, duration)
    duration = np.clip(duration, None, max_duration)
    max_dur = int(duration.max())
    bucket = duration_bucket or DEFAULT_DURATION_BUCKET
    N = max(min(int(np.ceil(max_dur / bucket)) * bucket, max_duration), max_dur)
    b = text_host.shape[0]
    text_host = bucket_text(text_host, text_bucket, arch)
    if seed is None:
        seeds = np.asarray([secrets.randbits(31) for _ in range(b)], np.int64)
    else:
        seeds = np.full((b,), int(seed) & 0xFFFFFFFF, np.int64)
    if wav_scale is None:
        wav_scale = np.ones((b,), np.float32)
    voc_params, vcfg = vocoder_fused
    wav = _serve_core_vocos(
        params, voc_params, arch, cond_b, lens, duration, text_host.astype(np.int64),
        seeds, float(cfg_strength), float(sway_sampling_coef or 0.0), wav_scale,
        vcfg=vcfg, N=int(N), steps=int(steps), use_cfg=float(cfg_strength) > 1e-5,
        use_sway=sway_sampling_coef is not None, use_epss=bool(use_epss),
        canon=max(int(max_duration), int(N)), single=b == 1, y0=y0, kernels=kernels,
        attn_path=attn_path, attn_int8=attn_int8, mesh=mesh)
    return wav, duration


def _param_device(params: dict) -> torch.device:
    return next(_leaves(params)).device


def cfm_sample(params: dict, arch: DiTConfig,
               cond,                       # [b, n_cond, d] reference mel (numpy or tensor)
               text,                       # [b, nt] ids, pad -1
               duration,                   # int or [b] total frames
               *, lens=None, steps: int = 32, cfg_strength: float = 1.0,
               sway_sampling_coef: float | None = None, seed: int | None = None,
               y0: torch.Tensor | None = None, max_duration: int = 4096,
               duration_bucket: int | None = None, text_bucket: int = TEXT_BUCKET,
               use_epss: bool = True, no_ref_audio: bool = False,
               duplicate_test: bool = False, t_inter: float = 0.1, edit_mask=None,
               vocoder=None, vocoder_fused: tuple | None = None,
               split_by_bucket: bool = True, kernels: bool = True,
               attn_path: str = "default", attn_int8: str | None = None,
               mesh=None):
    """Zero-shot sampling (cfm.py:442-652): the host wrapper of offline
    inference. Returns (out, wav): out [b, N, d] is the mel with the
    conditioning region spliced back, at the padded bucket length N (or the
    vocoder's waveform when `vocoder` is given); wav is the fused vocoder's
    fp32 waveform [b, N * hop] when vocoder_fused = (voc_params, VocosConfig)
    is given, else None. Tensors on the parameters' device.

    The work runs on the parameters' device and at their compute dtype (bf16
    weights -> bf16 activations, which the kernels need; the JAX function
    keeps cond's dtype). split_by_bucket regroups a mixed-duration batch so
    that each item runs at its own duration bucket: masked rows are invisible
    to attention either way, but the dense products pay for every padded row.
    The regrouped result is fp32, zero-padded to the longest group.
    duration_bucket None means DEFAULT_DURATION_BUCKET; text_bucket 0 keeps
    the text length as it is. Noise: y0 when given; else one N(0, 1) tensor
    drawn at the canonical length max(max_duration, N) from a generator
    seeded with `seed` and shared by the batch, so a batched item equals the
    same item run alone, or one fresh draw per item when seed is None.
    """
    dev = _param_device(params)
    text_host = np.asarray(text.cpu() if isinstance(text, torch.Tensor) else text)
    cond = torch.as_tensor(cond, device=dev)
    cond = cond.to(_compute_dtype(params, cond.dtype))
    b, cond_seq_len, d = cond.shape
    lens = np.full((b,), cond_seq_len, np.int64) if lens is None else np.asarray(lens)
    if isinstance(duration, int):
        duration = np.full((b,), duration, np.int64)
    duration = np.asarray(duration)
    text_lens = (text_host != -1).sum(axis=-1)
    # at least prompt length + 1 so something is generated (cfm.py:135-139)
    duration = np.maximum(np.maximum(text_lens, lens) + 1, duration)
    duration = np.clip(duration, None, max_duration)
    max_dur = int(duration.max())
    bucket = duration_bucket or DEFAULT_DURATION_BUCKET
    N = max(min(int(np.ceil(max_dur / bucket)) * bucket, max_duration), max_dur)

    if split_by_bucket and b > 1 and edit_mask is None and not duplicate_test:
        Ns = np.minimum(np.maximum(np.ceil(duration / bucket).astype(np.int64), 1) * bucket,
                        max_duration)
        Ns = np.maximum(Ns, duration)
        if len(np.unique(Ns)) > 1:
            subs = []
            for N_g in np.unique(Ns):
                idx = np.where(Ns == N_g)[0]
                sub_out, sub_wav = cfm_sample(
                    params, arch, cond[idx], text_host[idx], duration[idx], lens=lens[idx],
                    steps=steps, cfg_strength=cfg_strength,
                    sway_sampling_coef=sway_sampling_coef, seed=seed,
                    y0=None if y0 is None else y0[idx, :int(N_g)], max_duration=max_duration,
                    duration_bucket=bucket, text_bucket=text_bucket, use_epss=use_epss,
                    no_ref_audio=no_ref_audio, vocoder=vocoder, vocoder_fused=vocoder_fused,
                    split_by_bucket=False, kernels=kernels, attn_path=attn_path,
                    attn_int8=attn_int8, mesh=mesh)
                subs.append((idx, sub_out, sub_wav))
            n1 = max(so.shape[1] for _, so, _ in subs)
            out = torch.zeros((b, n1, *subs[0][1].shape[2:]), dtype=torch.float32, device=dev)
            wav = None
            if subs[0][2] is not None:
                wav = torch.zeros((b, max(sw.shape[1] for _, _, sw in subs)),
                                  dtype=torch.float32, device=dev)
            for idx, so, sw in subs:
                out[idx, :so.shape[1]] = so.float()
                if wav is not None:
                    wav[idx, :sw.shape[1]] = sw.float()
            return out, wav

    ar = np.arange(N)
    cond_mask_h = ar[None, :] < lens[:, None]
    if edit_mask is not None:
        em = np.asarray(edit_mask)
        cond_mask_h = cond_mask_h & np.pad(em, ((0, 0), (0, N - em.shape[1])),
                                           constant_values=False)
    cond_mask = torch.as_tensor(cond_mask_h, device=dev)
    cond_p = F.pad(cond, (0, 0, 0, N - cond_seq_len))
    if no_ref_audio:
        cond_p = torch.zeros_like(cond_p)
    step_cond = cond_p.masked_fill(~cond_mask[..., None], 0.0)
    dur_mask = torch.as_tensor(ar[None, :] < duration[:, None], device=dev)
    # the reference-semantics duration mask only for b > 1; the bucket-tail
    # pad mask whenever the bucket adds rows (cfm.py:556-570)
    mask = dur_mask if b > 1 else None
    pad_mask = torch.as_tensor(ar[None, :] < max_dur, device=dev) if N > max_dur else None
    text_t = torch.as_tensor(bucket_text(text_host, text_bucket, arch), device=dev)

    if y0 is None:
        canon = max(int(max_duration), N)
        seeds = ([secrets.randbits(31) for _ in range(b)] if seed is None
                 else [int(seed) & 0xFFFFFFFF])
        y0 = draw_noise(seeds, canon, d, dev, step_cond.dtype)[:, :N].expand(b, N, d)
    y0 = torch.as_tensor(y0, device=dev).to(step_cond.dtype)
    y0 = y0.masked_fill(~dur_mask[..., None], 0.0)

    t_start = 0.0
    if duplicate_test:
        # inner-timestep observation mode (cfm.py:611-620): start the ODE at
        # t_inter from a cond-shifted state instead of pure noise
        test_cond = torch.zeros((b, N, d), dtype=y0.dtype, device=dev)
        span = min(cond_seq_len, max(N - cond_seq_len, 0))
        test_cond[:, cond_seq_len:cond_seq_len + span] = cond[:, :span]
        t_start = t_inter
        y0 = (1.0 - t_start) * y0 + t_start * test_cond
        steps = int(steps * (1.0 - t_start))

    sampler = dict(steps=int(steps), use_cfg=float(cfg_strength) > 1e-5,
                   use_sway=sway_sampling_coef is not None, use_epss=bool(use_epss),
                   t_start=float(t_start), kernels=kernels, attn_path=attn_path,
                   attn_int8=attn_int8, mesh=mesh)
    sway = float(sway_sampling_coef or 0.0)
    if vocoder_fused is not None:
        voc_params, vcfg = vocoder_fused
        return _sample_core_vocos(params, voc_params, arch, step_cond, text_t, mask, pad_mask, y0,
                                  cond_mask, float(cfg_strength), sway, vcfg=vcfg, **sampler)
    sampled = _sample_core(params, arch, step_cond, text_t, mask, pad_mask, y0,
                           float(cfg_strength), sway, **sampler)
    out = torch.where(cond_mask[..., None], cond_p, sampled)
    if vocoder is not None:
        out = vocoder(out.transpose(1, 2))
    return out, None

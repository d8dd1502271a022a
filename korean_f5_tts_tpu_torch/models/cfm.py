"""Flow-matching sampler for serving (counterpart of korean_f5_tts_tpu/models/cfm.py).

Ported: _sample_core (text embedding once, then the Euler loop over the
EPSS/sway schedule with CFG packed as batch 2), _serve_core_vocos (masks,
cond padding, seeded noise, sampling, cond splice, Vocos decode, RMS
restore, int16) and its host wrapper serve_sample. The JAX scan becomes a
Python loop over the steps. The no-CFG branch and cfm_sample wait for a
later slice.
"""

from __future__ import annotations

import math
import secrets

import numpy as np
import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as dit_mod
from korean_f5_tts_tpu_torch.models.vocos import vocos_decode
from korean_f5_tts_tpu_torch.utils.timesteps import make_schedule

DEFAULT_DURATION_BUCKET = 128  # frames; the kernels take any n, so no TPU 512
TEXT_BUCKET = 64  # text tokens are padded to a multiple of this


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@torch.inference_mode()
def _sample_core(params: dict, arch: DiTConfig,
                 step_cond: torch.Tensor,      # [b, N, d] cond, masked to its region
                 text: torch.Tensor,           # [b, nt] ids, pad -1
                 mask: torch.Tensor | None,    # [b, N] duration mask (None for b == 1)
                 pad_mask: torch.Tensor | None,  # [1, N] bucket-tail mask
                 y0: torch.Tensor,             # [b, N, d] noise, zero past duration
                 cfg_strength: float, sway_coef: float,
                 steps: int, use_cfg: bool, use_sway: bool, use_epss: bool,
                 t_start: float = 0.0, kernels: bool = True) -> torch.Tensor:
    """Text embedding (once) + Euler integration over the schedule
    (cfm.py:366-422). Returns the final mel [b, N, d]."""
    if not use_cfg:
        raise NotImplementedError("sampling without CFG is not ported yet")
    N = step_cond.shape[1]
    dt_ = step_cond.dtype
    base = make_schedule(steps, use_epss=use_epss, sway_sampling_coef=None, t_start=t_start)
    ts = torch.as_tensor(base, dtype=dt_, device=step_cond.device)
    if use_sway:
        c = torch.as_tensor(sway_coef, dtype=dt_, device=ts.device)
        ts = ts + c * (torch.cos(math.pi / 2.0 * ts) - 1.0 + ts)
    te_cond = dit_mod.text_embedding(params["text_embed"], arch, text, N,
                                     drop_text=False, pad_mask=pad_mask)
    te_uncond = dit_mod.text_embedding(params["text_embed"], arch, text, N,
                                       drop_text=True, pad_mask=pad_mask)
    dts = ts[1:] - ts[:-1]
    # every time-dependent modulation and the cond/text half of the input
    # projection are loop-invariant: computed once, outside the loop
    mods, mod_final, _ = dit_mod.precompute_step_modulations(params, arch, ts[:-1])
    static_inp = dit_mod.precompute_input_static(params, arch, step_cond, te_cond, te_uncond)
    x = y0
    for s in range(steps):
        pred = dit_mod.dit_forward_cfg_premod(
            params, arch, x, step_cond, te_cond, te_uncond, mods[s], mod_final[s],
            cfg_strength, mask=mask, pad_mask=pad_mask, static_inp=static_inp,
            kernels=kernels)
        x = (x + dts[s] * pred).to(y0.dtype)
    return x


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
                      y0: torch.Tensor | None = None) -> torch.Tensor:
    """All request-side device work of a batch (cfm.py:203-285); returns the
    int16 waveform [b, N * hop] on the device. y0 ([b, N, d]), when
    given, replaces the seeded noise."""
    dev = cond_b.device
    b, Bc, d = cond_b.shape
    # run at the model's compute dtype: bf16 weights -> bf16 everything
    cdt = (torch.bfloat16 if any(t.dtype == torch.bfloat16 for t in _leaves(params))
           else cond_b.dtype)
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
    mel = _sample_core(params, arch, step_cond, torch.as_tensor(text, device=dev), mask,
                       pad_mask, y0, cfg_strength, sway_coef, steps=steps, use_cfg=use_cfg,
                       use_sway=use_sway, use_epss=use_epss)
    out = torch.where(cond_mask[..., None], step_cond, mel)
    # replicate one frame so duration * hop samples exist even at full-bucket
    # durations (an ISTFT over N frames yields only (N - 1) * hop)
    out_v = torch.cat([out, out[:, -1:]], dim=1)
    wav = vocos_decode(voc_params, out_v.transpose(1, 2), vcfg)
    wav = wav.float() * torch.as_tensor(np.asarray(wav_scale, np.float32), device=dev)[:, None]
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def serve_sample(params: dict, arch: DiTConfig, cond_b: torch.Tensor, text, duration, lens,
                 *, vocoder_fused: tuple, steps: int = 16, cfg_strength: float = 2.0,
                 sway_sampling_coef: float | None = -1.0, seed: int | None = None,
                 wav_scale=None, max_duration: int = 4096, duration_bucket: int | None = None,
                 use_epss: bool = True, y0: torch.Tensor | None = None):
    """Host wrapper of the serving path (cfm.py:288-357). Returns (int16
    waveform [b, N * hop] on the device, duration [b] host ints).

    Host side: duration floor and clamp, duration bucket N, text padded to a
    multiple of 64 tokens, noise seeds (a seed of None draws one per item).
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
    nt = text_host.shape[1]
    ntb = max(TEXT_BUCKET, int(np.ceil(nt / TEXT_BUCKET)) * TEXT_BUCKET)
    if ntb != nt:
        text_host = np.pad(text_host, ((0, 0), (0, ntb - nt)), constant_values=-1)
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
        canon=max(int(max_duration), int(N)), single=b == 1, y0=y0)
    return wav, duration

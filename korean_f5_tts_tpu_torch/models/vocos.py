"""Vocos vocoder: mel -> waveform (counterpart of korean_f5_tts_tpu/models/vocos.py).

embed Conv1d(n_mels -> dim, k=7) -> LayerNorm -> num_layers x ConvNeXt-v1
block (depthwise conv k7, LN, pw -> intermediate, GELU, pw -> dim, layer
scale, residual) -> LayerNorm -> Linear(dim -> n_fft + 2) -> exp-clipped
magnitude and phase -> ISTFT (ops/mel.py).
"""

from __future__ import annotations

import dataclasses

import torch

from korean_f5_tts_tpu_torch.models.modules import (
    cast_params,
    conv1d,
    conv1d_init,
    gelu_exact,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
)
from korean_f5_tts_tpu_torch.ops.mel import istft


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    padding: str = "center"  # "center" | "same"


@dataclasses.dataclass
class Vocos:
    """A vocoder the server fuses into its sampling call: params + config."""
    params: dict
    vcfg: VocosConfig


def init_vocos(cfg: VocosConfig = VocosConfig(), seed: int = 1, device="cpu",
               dtype: torch.dtype = torch.float32) -> dict:
    """Random Vocos parameters with the JAX package's tree and init
    distributions (torch layouts), cast to `dtype`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "dwconv": conv1d_init(gen, cfg.dim, cfg.dim, 7, device, groups=cfg.dim),
            "norm": layernorm_init(cfg.dim, device),
            "pw1": linear_init(gen, cfg.dim, cfg.intermediate_dim, device),
            "pw2": linear_init(gen, cfg.intermediate_dim, cfg.dim, device),
            "gamma": torch.full((cfg.dim,), 1.0 / cfg.num_layers, device=device),
        })
    p = {
        "embed": conv1d_init(gen, cfg.input_channels, cfg.dim, 7, device),
        "norm": layernorm_init(cfg.dim, device),
        "blocks": blocks,
        "final_norm": layernorm_init(cfg.dim, device),
        "head": linear_init(gen, cfg.dim, cfg.n_fft + 2, device),
    }
    return cast_params(p, dtype)


def convnext_v1_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    residual = x
    h = conv1d(p["dwconv"], x, groups=x.shape[-1], padding=3)
    h = layernorm(p["norm"], h, eps=1e-6)
    h = gelu_exact(linear(p["pw1"], h))
    h = linear(p["pw2"], h)
    return residual + p["gamma"].to(h.dtype) * h


def vocos_decode(p: dict, mel: torch.Tensor, cfg: VocosConfig = VocosConfig()) -> torch.Tensor:
    """[b, n_mels, T] log-mel -> [b, nw] fp32 waveform."""
    x = mel.transpose(1, 2)  # channels-last
    x = conv1d(p["embed"], x, padding=3)
    x = layernorm(p["norm"], x, eps=1e-6)
    for blk in p["blocks"]:
        x = convnext_v1_block(blk, x)
    x = layernorm(p["final_norm"], x, eps=1e-6)
    h = linear(p["head"], x)  # [b, T, n_fft + 2]
    n_half = cfg.n_fft // 2 + 1
    mag = torch.exp(torch.clamp(h[..., :n_half], max=1e2))
    phase = h[..., n_half:]
    real = (mag * torch.cos(phase)).transpose(1, 2)
    imag = (mag * torch.sin(phase)).transpose(1, 2)
    if cfg.padding == "center":
        return istft(real, imag, cfg.n_fft, cfg.hop_length, cfg.n_fft, center=True)
    wav = istft(real, imag, cfg.n_fft, cfg.hop_length, cfg.n_fft, center=False)
    pad = (cfg.n_fft - cfg.hop_length) // 2
    return wav[..., pad:-pad]

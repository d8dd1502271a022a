"""BigVGAN vocoder generator, mel -> waveform, in plain PyTorch
(counterpart of korean_f5_tts_tpu/models/bigvgan.py).

NVIDIA BigVGAN v2 (bigvgan_v2_24khz_100band_256x): conv_pre k = 7, then per
stage a ConvTranspose upsampling and AMP resblocks (kernels 3 / 7 / 11,
dilations 1 / 3 / 5) whose snake-beta activations are wrapped in
anti-aliased 2x up- and downsampling (a Kaiser-windowed sinc low-pass), then
snake-beta, conv_post k = 7 and tanh. No TPU kernel runs here; this is the
JAX package's XLA function on the card.

Layouts are the JAX package's: activations channels-last [b, n, c]; conv1d
{"w": [k, c_in, c_out], "b"} (models/modules.conv1d); the upsampling
kernels {"w": [k, c_out, c_in], "b"}, which the JAX function flips and runs
as an lhs-dilated conv (bigvgan.py:170-184): that is F.conv_transpose1d with
the weight w.permute(2, 1, 0) = [c_in, c_out, k] and padding (k - stride) / 2.

It is reached directly (init_bigvgan, bigvgan_decode), not through
api.load_vocoder, which refuses "bigvgan" as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.models.modules import _uniform, cast_params, conv1d, conv1d_init
from korean_f5_tts_tpu_torch.utils.misc import require_device


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    snake_logscale: bool = True
    use_anti_aliasing: bool = True


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               logscale: bool = True) -> torch.Tensor:
    """x + 1/beta sin^2(alpha x), per-channel alpha and beta, stored as logs
    under logscale (BigVGAN's snakebeta)."""
    if logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return x + (1.0 / (beta + 1e-9)) * torch.sin(alpha * x) ** 2


def _kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Low-pass Kaiser-windowed sinc (bigvgan.py:49-68, BigVGAN's
    alias-free activation filter)."""
    even = kernel_size % 2 == 0
    delta_f = 4 * half_width
    a = 2.285 * (kernel_size / 2 - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        t = np.arange(-kernel_size // 2, kernel_size // 2) + 0.5
    else:
        t = np.arange(kernel_size) - (kernel_size - 1) / 2
    f = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    return (f / np.sum(f)).astype(np.float32)


_FILTER = _kaiser_sinc_filter(0.5 / 2, 0.6 / 2, 12)  # the up and the down filter


@functools.lru_cache(maxsize=16)
def _filter(c: int, gain: float, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The filter times `gain` as a depthwise weight [c, 1, k]."""
    with torch.inference_mode(False):
        f = torch.from_numpy(_FILTER * gain).to(device=device, dtype=dtype)
        return f[None, None, :].expand(c, 1, -1).contiguous()


def _resample(x: torch.Tensor, up: bool) -> torch.Tensor:
    """2x anti-aliased up- (zero-stuffing, then the low-pass times 2) or
    downsampling (the low-pass at stride 2) of [b, n, c], 'same' padding
    (pad, pad - 1) of the 12-tap filter (bigvgan.py:71-97)."""
    b, n, c = x.shape
    k = len(_FILTER)
    h = x.transpose(1, 2)
    if up:
        h = torch.zeros((b, c, 2 * n), dtype=x.dtype, device=x.device).index_copy_(
            2, torch.arange(0, 2 * n, 2, device=x.device), h)
    h = F.pad(h, (k // 2, k // 2 - 1 + k % 2))
    w = _filter(c, 2.0 if up else 1.0, x.device, x.dtype)
    return F.conv1d(h, w, stride=1 if up else 2, groups=c).transpose(1, 2)


def aa_snake(x: torch.Tensor, alpha, beta, cfg: BigVGANConfig) -> torch.Tensor:
    """Anti-aliased activation: up 2x, snake-beta, down 2x (Activation1d)."""
    if not cfg.use_anti_aliasing:
        return snake_beta(x, alpha, beta, cfg.snake_logscale)
    h = snake_beta(_resample(x, up=True), alpha, beta, cfg.snake_logscale)
    return _resample(h, up=False)


def _amp_block(p: dict, x: torch.Tensor, kernel: int, dilations: tuple,
               cfg: BigVGANConfig) -> torch.Tensor:
    for i, d in enumerate(dilations):
        h = aa_snake(x, p["alpha1"][i], p["beta1"][i], cfg)
        h = conv1d(p["convs1"][i], h, padding=(kernel * d - d) // 2, dilation=d)
        h = aa_snake(h, p["alpha2"][i], p["beta2"][i], cfg)
        h = conv1d(p["convs2"][i], h, padding=kernel // 2)
        x = x + h
    return x


def _conv_transpose1d(p: dict, x: torch.Tensor, stride: int, kernel: int) -> torch.Tensor:
    """[b, n, c_in] -> [b, n * stride, c_out]: torch ConvTranspose1d with
    padding (k - stride) / 2, the JAX kernel [k, c_out, c_in] permuted to
    torch's [c_in, c_out, k]."""
    y = F.conv_transpose1d(x.transpose(1, 2), p["w"].to(x.dtype).permute(2, 1, 0),
                           p["b"].to(x.dtype), stride=stride, padding=(kernel - stride) // 2)
    return y.transpose(1, 2)


def init_bigvgan(cfg: BigVGANConfig = BigVGANConfig(), seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32) -> dict:
    """Random BigVGAN parameters with the JAX package's tree and layouts
    (torch's default init bounds; snake parameters zero, bigvgan.py:100-168)
    on `device`, floating leaves cast to `dtype`."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ch = cfg.upsample_initial_channel
    p: dict = {"conv_pre": conv1d_init(gen, cfg.num_mels, ch, 7, device)}
    ups, blocks = [], []
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        bound = 1.0 / math.sqrt(c_in * k)
        ups.append({"w": _uniform(gen, (k, c_out, c_in), bound, device),
                    "b": _uniform(gen, (c_out,), bound, device)})
        stage = []
        for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            zeros = lambda: [torch.zeros(c_out, device=device) for _ in dd]  # noqa: E731
            stage.append({
                "convs1": [conv1d_init(gen, c_out, c_out, kk, device) for _ in dd],
                "convs2": [conv1d_init(gen, c_out, c_out, kk, device) for _ in dd],
                "alpha1": zeros(), "beta1": zeros(), "alpha2": zeros(), "beta2": zeros(),
            })
        blocks.append(stage)
    final = ch // 2 ** len(cfg.upsample_rates)
    p.update(ups=ups, blocks=blocks, alpha_post=torch.zeros(final, device=device),
             beta_post=torch.zeros(final, device=device),
             conv_post=conv1d_init(gen, final, 1, 7, device))
    return cast_params(p, dtype)


def bigvgan_decode(p: dict, mel: torch.Tensor, cfg: BigVGANConfig = BigVGANConfig()
                   ) -> torch.Tensor:
    """[b, n_mels, T] log-mel -> [b, T * prod(upsample_rates)] waveform
    (bigvgan.py:187-203), in mel's dtype on mel's device."""
    x = conv1d(p["conv_pre"], mel.transpose(1, 2), padding=3)
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = _conv_transpose1d(p["ups"][i], x, rate, k)
        acc = None
        for j, (kk, dd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            h = _amp_block(p["blocks"][i][j], x, kk, dd, cfg)
            acc = h if acc is None else acc + h
        x = acc / len(cfg.resblock_kernel_sizes)
    x = snake_beta(x, p["alpha_post"], p["beta_post"], cfg.snake_logscale)
    return torch.tanh(conv1d(p["conv_post"], x, padding=3))[..., 0]

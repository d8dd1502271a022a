"""ECAPA-TDNN speaker encoder for speaker-similarity evaluation (counterpart
of korean_f5_tts_tpu/eval/ecapa_tdnn.py).

Capability parity with reference `src/f5_tts/eval/ecapa_tdnn.py` (torch
ECAPA-TDNN with a WavLM feature front-end used by `run_sim`,
utils_eval.py:380-426). This implementation runs over log-mel features from
`ops/mel.py` (the WavLM front-end requires downloadable weights); with a
trained checkpoint it plugs into `run_sim` as `embed_fn` via
`make_embed_fn`.

Architecture: conv stem -> 3 SE-Res2-TDNN blocks (dilations 2/3/4) ->
MFA concat conv -> attentive statistics pooling -> linear embedding.

Plain functions on tensors over models/modules.py's linear and conv1d, as
the DiT's are; the parameter tree has the JAX package's keys and goes through
train/checkpoint.py's converter (linear weights transposed, conv weights kept
[k, c_in, c_out]). There is no Pallas kernel behind it in the JAX package, so
plain PyTorch is the port. It computes in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from korean_f5_tts_tpu_torch.models.modules import conv1d, conv1d_init, linear, linear_init
from korean_f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
from korean_f5_tts_tpu_torch.utils.audio import resample
from korean_f5_tts_tpu_torch.utils.misc import require_device


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    feat_dim: int = 80
    channels: int = 512
    emb_dim: int = 192
    res2_scale: int = 8
    se_bottleneck: int = 128
    attn_bottleneck: int = 128


@contextlib.contextmanager
def cudnn_tf32(allowed: bool):
    """cuDNN's TF32 switch set to `allowed` for the block and restored after
    it. PyTorch's default lets an fp32 F.conv1d on the card run on TF32
    (10-bit mantissa) products; the fp32 F.linear does not (cuBLAS TF32 is
    off by default)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _se_block_init(gen, ch: int, bottleneck: int, device) -> dict:
    return {"down": linear_init(gen, ch, bottleneck, device),
            "up": linear_init(gen, bottleneck, ch, device)}


def _se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=1)  # [b, ch]
    s = torch.relu(linear(p["down"], s))
    s = torch.sigmoid(linear(p["up"], s))
    return x * s[:, None, :]


def _res2_init(gen, ch: int, scale: int, kernel: int, device) -> dict:
    w = ch // scale
    return {"convs": [conv1d_init(gen, w, w, kernel, device) for _ in range(scale - 1)]}


def _res2_block(p: dict, x: torch.Tensor, scale: int, kernel: int,
                dilation: int) -> torch.Tensor:
    parts = torch.chunk(x, scale, dim=-1)
    out = [parts[0]]
    prev = None
    pad = (kernel - 1) * dilation // 2
    for i in range(1, scale):
        h = parts[i] if prev is None else parts[i] + prev
        h = torch.relu(conv1d(p["convs"][i - 1], h, padding=pad, dilation=dilation))
        out.append(h)
        prev = h
    return torch.cat(out, dim=-1)


def _block_init(gen, ch: int, cfg: EcapaConfig, kernel: int, device) -> dict:
    return {
        "conv1": conv1d_init(gen, ch, ch, 1, device),
        "res2": _res2_init(gen, ch, cfg.res2_scale, kernel, device),
        "conv2": conv1d_init(gen, ch, ch, 1, device),
        "se": _se_block_init(gen, ch, cfg.se_bottleneck, device),
    }


def _block(p: dict, x: torch.Tensor, cfg: EcapaConfig, kernel: int,
           dilation: int) -> torch.Tensor:
    h = torch.relu(conv1d(p["conv1"], x, padding=0))
    h = _res2_block(p["res2"], h, cfg.res2_scale, kernel, dilation)
    h = torch.relu(conv1d(p["conv2"], h, padding=0))
    h = _se_block(p["se"], h)
    return x + h


def init_ecapa(gen: torch.Generator, cfg: EcapaConfig = EcapaConfig(),
               device="cuda") -> dict:
    """Random parameters with the JAX package's tree and shapes (torch
    layouts), the torch default initialisers' bounds, drawn from `gen`, which
    lives on `device` (the card unless the caller names the CPU)."""
    device = require_device(device)
    ch = cfg.channels
    return {
        "stem": conv1d_init(gen, cfg.feat_dim, ch, 5, device),
        "blocks": [_block_init(gen, ch, cfg, 3, device) for _ in range(3)],
        "mfa": conv1d_init(gen, 3 * ch, 3 * ch, 1, device),
        "attn_down": conv1d_init(gen, 3 * ch, cfg.attn_bottleneck, 1, device),
        "attn_up": conv1d_init(gen, cfg.attn_bottleneck, 3 * ch, 1, device),
        "emb": linear_init(gen, 6 * ch, cfg.emb_dim, device),
    }


def ecapa_embed(p: dict, feats: torch.Tensor, cfg: EcapaConfig = EcapaConfig(),
                tf32: bool = False) -> torch.Tensor:
    """[b, T, feat_dim] fp32 features -> [b, emb_dim] l2-normalised embedding.

    tf32: whether the convolutions may run on TF32 products. False (the
    default) turns cuDNN's TF32 off for this call only (cudnn_tf32), so the
    embedding is fp32 whatever the process-wide default is; True is the
    control that shows what TF32 would cost."""
    with cudnn_tf32(tf32):
        x = torch.relu(conv1d(p["stem"], feats, padding=2))
        outs = []
        for i, blk in enumerate(p["blocks"]):
            x = _block(blk, x, cfg, kernel=3, dilation=i + 2)
            outs.append(x)
        h = torch.relu(conv1d(p["mfa"], torch.cat(outs, dim=-1), padding=0))
        # attentive statistics pooling
        a = torch.tanh(conv1d(p["attn_down"], h, padding=0))
        a = torch.softmax(conv1d(p["attn_up"], a, padding=0), dim=1)
    mean = (a * h).sum(dim=1)
    var = (a * h * h).sum(dim=1) - mean ** 2
    std = torch.sqrt(torch.clamp(var, min=1e-7))
    emb = linear(p["emb"], torch.cat([mean, std], dim=-1))
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


def ecapa_mel_config(cfg: EcapaConfig = EcapaConfig(), sample_rate: int = 16_000) -> MelConfig:
    """The encoder's log-mel front end: 25 ms windows, 10 ms hop at 16 kHz."""
    return MelConfig(n_mel_channels=cfg.feat_dim, target_sample_rate=sample_rate,
                     n_fft=512, win_length=400, hop_length=160)


def make_embed_fn(params: dict, cfg: EcapaConfig = EcapaConfig(),
                  sample_rate: int = 16_000, tf32: bool = False):
    """Build `embed_fn(wav, sr) -> numpy [emb_dim]` for eval.utils_eval.run_sim:
    the wav resampled to `sample_rate` on the host, its log-mel and the
    embedding on the parameters' device (ecapa_embed's tf32)."""
    mel_cfg = ecapa_mel_config(cfg, sample_rate)
    dev = params["emb"]["w"].device

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
        with torch.inference_mode():
            mel = log_mel_spectrogram(torch.as_tensor(wav, device=dev)[None], mel_cfg)
            emb = ecapa_embed(params, mel.transpose(1, 2), cfg, tf32=tf32)
        return emb[0].cpu().numpy()

    return embed


def ecapa_config_of(params: dict) -> EcapaConfig:
    """The EcapaConfig whose init gives `params`' shapes."""
    stem = params["stem"]["w"]  # [5, feat_dim, channels]
    return EcapaConfig(feat_dim=stem.shape[1], channels=stem.shape[2],
                       emb_dim=params["emb"]["w"].shape[0],
                       res2_scale=len(params["blocks"][0]["res2"]["convs"]) + 1,
                       se_bottleneck=params["blocks"][0]["se"]["down"]["w"].shape[0],
                       attn_bottleneck=params["attn_down"]["w"].shape[2])


def load_ecapa_embed_fn(path: str, device="cuda", sample_rate: int = 16_000):
    """make_embed_fn of a trained encoder stored as a flat .npz in the JAX
    package's layout, its parameters on `device` (the card unless the caller
    names the CPU)."""
    from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

    params = params_from_jax(dict(np.load(path, allow_pickle=False)), device=device)
    return make_embed_fn(params, ecapa_config_of(params), sample_rate)

"""Mel front-end and ISTFT (counterpart of korean_f5_tts_tpu/ops/mel.py).

Ported as the JAX package writes them, not through torch.stft: the STFT is
windowed framing plus a DFT matmul, the ISTFT an adjoint-basis matmul plus a
hop-chunk overlap-add with window-envelope normalisation, so the numerics
follow the JAX package. Filterbanks and DFT bases are host numpy tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelConfig:
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 100
    target_sample_rate: int = 24_000
    mel_spec_type: str = "vocos"  # "vocos" | "bigvgan"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def _triangular_fb(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    """[n_freqs, n_mels] triangular filters with vertices at f_pts (Hz)."""
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """[n_freqs, n_mels] float32 filterbank for the configured variant."""
    sr = cfg.target_sample_rate
    n_freqs = cfg.n_freqs
    if cfg.mel_spec_type == "vocos":
        # torchaudio melscale_fbanks: htk scale, norm=None
        all_freqs = np.linspace(0, sr // 2, n_freqs)
        m_min, m_max = _hz_to_mel_htk(0.0), _hz_to_mel_htk(sr / 2.0)
        f_pts = _mel_to_hz_htk(np.linspace(m_min, m_max, cfg.n_mel_channels + 2))
        fb = _triangular_fb(all_freqs, f_pts)
    elif cfg.mel_spec_type == "bigvgan":
        # librosa.filters.mel: slaney scale + slaney area norm
        all_freqs = np.linspace(0, sr / 2.0, n_freqs)
        m_min, m_max = _hz_to_mel_slaney(0.0), _hz_to_mel_slaney(sr / 2.0)
        f_pts = _mel_to_hz_slaney(np.linspace(m_min, m_max, cfg.n_mel_channels + 2))
        fb = _triangular_fb(all_freqs, f_pts)
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    else:
        raise ValueError(f"unknown mel_spec_type: {cfg.mel_spec_type}")
    return fb.astype(np.float32)


def _hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """torch.hann_window(periodic=True), zero-padded symmetrically to n_fft."""
    n = np.arange(win_length, dtype=np.float64)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-FFT basis: cos / -sin matrices of shape [n_fft, n_freqs]."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., nw] -> [..., n_frames, n_fft], n_frames = (nw - n_fft)//hop + 1."""
    return x.unfold(-1, n_fft, hop)


def stft_spectrogram(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                     magnitude_eps: float = 0.0) -> torch.Tensor:
    """Magnitude STFT |X| of an already padded signal: [..., n_freqs, n_frames]
    (the center=False form the serving front-end uses)."""
    dev = x.device
    window = torch.from_numpy(_hann_window(win_length, n_fft)).to(dev)
    frames = frame_signal(x.float(), n_fft, hop_length) * window
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices(n_fft))
    re = frames @ cos_m
    im = frames @ sin_m
    power = re * re + im * im
    if magnitude_eps:
        mag = torch.sqrt(power + magnitude_eps)
    else:
        mag = torch.sqrt(torch.clamp(power, min=0.0))
    return mag.transpose(-1, -2)


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[b, nw] (or [b, 1, nw]) waveform -> [b, n_mels, n_frames] log-mel
    (JAX log_mel_spectrogram, ops/mel.py:181-202): vocos reflect-pads
    n_fft / 2 (torch.stft's center=True), bigvgan (n_fft - hop) / 2 and adds
    1e-9 under the magnitude's root."""
    if wav.dim() == 3:
        wav = wav[:, 0, :]
    if wav.dim() != 2:
        raise ValueError(f"expected [b, nw], got {tuple(wav.shape)}")
    if cfg.mel_spec_type == "vocos":
        pad, eps = cfg.n_fft // 2, 0.0
    elif cfg.mel_spec_type == "bigvgan":
        pad, eps = (cfg.n_fft - cfg.hop_length) // 2, 1e-9
    else:
        raise ValueError(f"unknown mel_spec_type: {cfg.mel_spec_type}")
    x = torch.nn.functional.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = stft_spectrogram(x, cfg.n_fft, cfg.hop_length, cfg.win_length, magnitude_eps=eps)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(wav.device)
    mel = torch.einsum("bft,fm->bmt", spec, fb)
    return torch.log(torch.clamp(mel, min=1e-5))


def log_mel_prepadded(wav_padded: torch.Tensor, cfg: MelConfig, out_frames: int) -> torch.Tensor:
    """[b, L] pre-padded waveform -> [b, out_frames, n_mels] log-mel.

    The caller performs the variant's reflect padding on the host and
    zero-pads to a bucketed length; frames past the true count read the zero
    pad and are garbage that consumers mask. Rows out to `out_frames` are
    zero-padded (JAX log_mel_prepadded, ops/mel.py:206-231).
    """
    fb = torch.from_numpy(mel_filterbank(cfg)).to(wav_padded.device)
    eps = 1e-9 if cfg.mel_spec_type == "bigvgan" else 0.0
    spec = stft_spectrogram(wav_padded, cfg.n_fft, cfg.hop_length, cfg.win_length,
                            magnitude_eps=eps)
    mel = torch.einsum("bft,fm->btm", spec, fb)
    mel = torch.log(torch.clamp(mel, min=1e-5))
    frames = mel.shape[1]
    if out_frames > frames:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, out_frames - frames))
    return mel[:, :out_frames]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., n_frames, n_fft] -> [..., (n_frames-1)*hop + n_fft] overlap-add.

    With hop | n_fft, sample block j receives chunk k of frame j - k for each
    of the n_fft // hop chunks: shifted adds, no scatter.
    """
    n_frames, n_fft = frames.shape[-2], frames.shape[-1]
    assert n_fft % hop == 0
    factor = n_fft // hop
    total = (n_frames - 1) * hop + n_fft
    chunks = frames.reshape(*frames.shape[:-1], factor, hop)
    out = frames.new_zeros((*frames.shape[:-2], total // hop, hop))
    for k in range(factor):
        out[..., k:k + n_frames, :] += chunks[..., k, :]
    return out.reshape(*frames.shape[:-2], total)


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int, center: bool = True, eps: float = 1e-11) -> torch.Tensor:
    """Inverse STFT with hann window and window-envelope normalisation.

    Inputs [..., n_freqs, n_frames] (any float dtype; computed in fp32, as the
    JAX version's promotion against its fp32 tables does); returns [..., nw].
    """
    dev = spec_real.device
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices(n_fft))
    n_freqs = n_fft // 2 + 1
    w = np.full((n_freqs,), 2.0, dtype=np.float32)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    w = torch.from_numpy(w).to(dev)
    re = spec_real.float().transpose(-1, -2)  # [..., n_frames, n_freqs]
    im = spec_imag.float().transpose(-1, -2)
    frames = ((re * w) @ cos_m.T - (im * w) @ (-sin_m).T) / n_fft
    window = torch.from_numpy(_hann_window(win_length, n_fft)).to(dev)
    sig = overlap_add(frames * window, hop_length)
    n_frames = frames.shape[-2]
    env = overlap_add((window * window).expand(n_frames, n_fft), hop_length)
    sig = sig / torch.clamp(env, min=eps)
    if center:
        sig = sig[..., n_fft // 2: -(n_fft // 2)]
    return sig

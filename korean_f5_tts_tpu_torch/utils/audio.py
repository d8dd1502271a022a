"""Host-side audio helpers of the server and the dataset (load_wav, to_mono,
rms, resample).

Copies of korean_f5_tts_tpu/utils/audio.py functions: importing that file
runs korean_f5_tts_tpu/utils/__init__.py, which imports jax.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 [channels, n] in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return (data[None, :] if data.ndim == 1 else data.T), int(sr)


def to_mono(wav: np.ndarray) -> np.ndarray:
    """[ch, n] -> [n] by channel mean (utils_infer.py:522-524 semantics)."""
    if wav.ndim == 2:
        return wav.mean(axis=0)
    return wav


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def rms(wav: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wav))))

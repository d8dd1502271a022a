"""Host-side audio helpers the server uses (to_mono, rms, resample).

Copies of korean_f5_tts_tpu/utils/audio.py functions: importing that file
runs korean_f5_tts_tpu/utils/__init__.py, which imports jax.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly


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

"""Host-side audio helpers of the server, the dataset and offline inference
(load_wav, save_wav, to_mono, rms, resample, silence detection).

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


def save_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float waveform [-1, 1] (1-D or [ch, n]) as 16-bit PCM wav."""
    wav = np.asarray(wav)
    if wav.ndim == 2:
        wav = wav.T  # [ch, n] -> [n, ch]
    pcm = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))


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


def detect_leading_silence(wav: np.ndarray, sr: int, silence_threshold_db: float = -42.0,
                           chunk_ms: int = 10) -> int:
    """Sample index of the first non-silent chunk (pydub-equivalent)."""
    chunk = max(int(sr * chunk_ms / 1000), 1)
    thresh = 10.0 ** (silence_threshold_db / 20.0)
    n = len(wav)
    for start in range(0, n, chunk):
        if np.sqrt(np.mean(np.square(wav[start:start + chunk]))) > thresh:
            return start
    return n


def split_on_silence_spans(wav: np.ndarray, sr: int, min_silence_ms: int,
                           silence_threshold_db: float = -50.0,
                           keep_silence_ms: int = 1000,
                           seek_ms: int = 10) -> list[tuple[int, int]]:
    """Non-silent (start, end) spans with keep_silence margin, pydub-style."""
    seek = max(int(sr * seek_ms / 1000), 1)
    thresh = 10.0 ** (silence_threshold_db / 20.0)
    n = len(wav)
    loud = []
    for start in range(0, n, seek):
        loud.append(np.sqrt(np.mean(np.square(wav[start:start + seek]))) > thresh)
    loud = np.asarray(loud)
    min_chunks = max(min_silence_ms // seek_ms, 1)
    spans = []
    i = 0
    while i < len(loud):
        if loud[i]:
            j = i
            silent_run = 0
            while j < len(loud):
                if loud[j]:
                    silent_run = 0
                else:
                    silent_run += 1
                    if silent_run >= min_chunks:
                        break
                j += 1
            end_chunk = j - silent_run if silent_run >= min_chunks else len(loud)
            keep = keep_silence_ms // seek_ms
            s = max(0, (i - keep) * seek)
            e = min(n, (end_chunk + keep) * seek)
            spans.append((s, e))
            i = j + 1
        else:
            i += 1
    return spans


def remove_silence_edges(wav: np.ndarray, sr: int,
                         silence_threshold_db: float = -42.0) -> np.ndarray:
    """Trim leading and trailing silence (utils_infer.py:356-364 equivalent)."""
    start = detect_leading_silence(wav, sr, silence_threshold_db)
    rev = wav[::-1]
    end_trim = detect_leading_silence(rev, sr, silence_threshold_db)
    return wav[start: len(wav) - end_trim if end_trim else len(wav)]

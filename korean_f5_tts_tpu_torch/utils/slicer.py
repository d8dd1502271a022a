"""Audio slicer: split long recordings at silences into training clips (a
copy of korean_f5_tts_tpu/utils/slicer.py: numpy only).

Role parity with the Slicer the reference vendors into its finetuning studio
(`train/finetune_gradio.py:181-296`, a GPT-SoVITS port): RMS-windowed silence
detection with hysteresis (threshold dB, min clip length, min silence
interval, max kept silence), returning clip boundaries in samples.
Implemented from the algorithm's definition over numpy frames.
"""

from __future__ import annotations

import numpy as np


def _rms_frames(wav: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max((len(wav) - frame) // hop + 1, 0)
    if n == 0:
        return np.zeros(0, np.float32)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return np.sqrt(np.mean(np.square(wav[idx]), axis=1))


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,      # dB below which a frame is silent
        min_length: int = 5000,        # ms: minimum clip length
        min_interval: int = 300,       # ms: minimum silence to split at
        hop_size: int = 20,            # ms
        max_sil_kept: int = 500,       # ms of silence kept at clip edges
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if max_sil_kept < hop_size:
            raise ValueError("max_sil_kept must be >= hop_size")
        self.sr = sr
        self.threshold = 10.0 ** (threshold / 20.0)
        self.hop = round(sr * hop_size / 1000)
        self.win = min(round(sr * min_interval / 1000), 4 * self.hop)
        self.min_length_f = round(sr * min_length / 1000 / self.hop)
        self.min_interval_f = round(min_interval / hop_size)
        self.max_sil_f = round(sr * max_sil_kept / 1000 / self.hop)

    def slice_spans(self, wav: np.ndarray) -> list[tuple[int, int]]:
        """-> list of (start_sample, end_sample) clips."""
        if len(wav) <= self.min_length_f * self.hop:
            return [(0, len(wav))]
        rms = _rms_frames(wav, self.win, self.hop)
        silent = rms < self.threshold

        # find silence runs of at least min_interval_f frames
        sil_runs = []
        i = 0
        while i < len(silent):
            if silent[i]:
                j = i
                while j < len(silent) and silent[j]:
                    j += 1
                if j - i >= self.min_interval_f:
                    sil_runs.append((i, j))
                i = j
            else:
                i += 1

        spans = []
        clip_start = 0
        for s, e in sil_runs:
            if s - clip_start < self.min_length_f and spans:
                continue  # clip too short: merge into previous by skipping split
            if s - clip_start < self.min_length_f and not spans and s == 0:
                clip_start = max(e - self.max_sil_f, 0)
                continue
            cut_start = min(s + self.max_sil_f, (s + e) // 2)
            spans.append((clip_start * self.hop, cut_start * self.hop))
            clip_start = max(e - self.max_sil_f, cut_start)
        if (len(silent) - clip_start) * self.hop > 0:
            spans.append((clip_start * self.hop, len(wav)))
        return [(s, e) for s, e in spans if e - s > self.hop]

    def slice(self, wav: np.ndarray) -> list[np.ndarray]:
        return [wav[s:e] for s, e in self.slice_spans(wav)]

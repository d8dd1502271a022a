"""Training data: CustomDataset, HFDataset, frame-budget batching, collate
and the load_dataset dispatch (counterpart of
korean_f5_tts_tpu/data/dataset.py).

numpy copies: the JAX module imports its mel ops, and so jax, at import
(dataset.py:27). Mels of wav rows come from the port's
ops/mel.log_mel_spectrogram on the host. pyarrow (the arrow files) and
datasets (HFDataset's save_to_disk directories) are imported inside the
calls that read them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from korean_f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
from korean_f5_tts_tpu_torch.utils import audio as audio_utils


class CustomDataset:
    """Rows of {audio_path | mel_spec, text, duration} + frame-length oracle."""

    def __init__(self, rows: Sequence[dict[str, Any]], durations: Sequence[float] | None = None,
                 mel: MelConfig = MelConfig(), preprocessed_mel: bool = False):
        self.rows = rows
        self.durations = durations
        self.mel = mel
        self.preprocessed_mel = preprocessed_mel

    def get_frame_len(self, index: int) -> float:
        dur = self.durations[index] if self.durations is not None else self.rows[index]["duration"]
        return dur * self.mel.target_sample_rate / self.mel.hop_length

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> dict[str, Any]:
        # skip out-of-range durations (0.3-30 s), like dataset.py:68-74
        while True:
            row = self.rows[index]
            if 0.3 <= row["duration"] <= 30:
                break
            index = (index + 1) % len(self.rows)
        if self.preprocessed_mel:
            mel_spec = np.asarray(row["mel_spec"], dtype=np.float32)
        else:
            wav, sr = audio_utils.load_wav(row["audio_path"])
            wav = audio_utils.to_mono(wav)
            if sr != self.mel.target_sample_rate:
                wav = audio_utils.resample(wav, sr, self.mel.target_sample_rate)
            mel_spec = _host_mel(wav.astype(np.float32), self.mel)
        return {"mel_spec": mel_spec, "text": row["text"]}


def _host_mel(wav: np.ndarray, mel: MelConfig) -> np.ndarray:
    """[n] waveform -> [n_mels, frames] fp32 log-mel, on the CPU."""
    return log_mel_spectrogram(torch.from_numpy(wav)[None], mel)[0].numpy()


class DynamicBatchSampler:
    """Frame-budgeted batch packing with a seeded per-epoch shuffle
    (dataset.py:87-136): indices sorted by frame length, packed greedily
    under `frames_threshold` (and `max_samples`), over-long items dropped."""

    def __init__(self, dataset, frames_threshold: int, max_samples: int = 0,
                 random_seed: int | None = None, drop_residual: bool = False):
        self.frames_threshold = frames_threshold
        self.max_samples = max_samples
        self.random_seed = random_seed
        self.epoch = 0
        indices = sorted(((i, dataset.get_frame_len(i)) for i in range(len(dataset))),
                         key=lambda e: e[1])
        batches, batch, batch_frames = [], [], 0.0
        for idx, frame_len in indices:
            fits = batch_frames + frame_len <= frames_threshold
            has_room = max_samples == 0 or len(batch) < max_samples
            if fits and has_room:
                batch.append(idx)
                batch_frames += frame_len
            else:
                if batch:
                    batches.append(batch)
                if frame_len <= frames_threshold:
                    batch, batch_frames = [idx], frame_len
                else:
                    batch, batch_frames = [], 0.0
        if not drop_residual and batch:
            batches.append(batch)
        self.batches = batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        if self.random_seed is not None:
            order = np.random.default_rng(self.random_seed + self.epoch).permutation(
                len(self.batches))
            return iter([self.batches[i] for i in order])
        return iter(list(self.batches))

    def __len__(self) -> int:
        return len(self.batches)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def list_str_to_idx(text, vocab_char_map: dict[str, int], padding_value: int = -1,
                    pad_to: int | None = None) -> np.ndarray:
    """Token lists -> [b, nt] int32 ids; unknown -> 0, pad -> -1
    (korean_f5_tts_tpu/text/vocab.py:72-86)."""
    rows = [[vocab_char_map.get(c, 0) for c in t] for t in text]
    max_len = max((len(r) for r in rows), default=0)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    out = np.full((len(rows), max_len), padding_value, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def collate_batch(items: list[dict[str, Any]], vocab_char_map: dict[str, int] | None,
                  tokenize_fn=None, frame_bucket: int = 128,
                  text_bucket: int = 32) -> dict[str, np.ndarray]:
    """Pad {mel_spec [d, t], text} items into {mel [b, n, d], mel_lengths [b],
    text [b, nt], text_lengths [b]} (dataset.py:143-190), n and nt rounded
    up to their buckets. The port's kernels take any n; the 128-frame bucket
    is kept so that both packages see the same batches."""
    mel_lengths = np.array([it["mel_spec"].shape[-1] for it in items], np.int32)
    max_mel = _round_up(int(mel_lengths.max()), frame_bucket)
    d = items[0]["mel_spec"].shape[0]
    mel = np.zeros((len(items), max_mel, d), np.float32)
    for i, it in enumerate(items):
        m = it["mel_spec"]
        mel[i, : m.shape[-1], :] = m.T
    texts = [it["text"] for it in items]
    token_lists = tokenize_fn(texts) if tokenize_fn is not None else [list(t) for t in texts]
    text_lengths = np.array([len(t) for t in token_lists], np.int32)
    max_text = _round_up(max(int(text_lengths.max()), 1), text_bucket)
    if vocab_char_map is not None:
        text_ids = list_str_to_idx(token_lists, vocab_char_map, pad_to=max_text)
    else:
        text_ids = np.full((len(items), max_text), -1, np.int32)
        for i, toks in enumerate(token_lists):
            # utf-8-byte fallback for str tokens; pre-tokenized int ids pass
            text_ids[i, : len(toks)] = [t if isinstance(t, (int, np.integer)) else ord(t) % 256
                                        for t in toks]
    return {"mel": mel, "mel_lengths": mel_lengths, "text": text_ids,
            "text_lengths": text_lengths}


class HFDataset:
    """Rows of a `datasets` dataset, {audio: {array, sampling_rate}, text}
    (dataset.py:193-237): frame length from the raw audio length, the 0.3-30 s
    duration filter with skip-forward, host resample, lazy wav -> log-mel."""

    def __init__(self, hf_dataset, mel: MelConfig = MelConfig()):
        self.data = hf_dataset
        self.mel = mel

    def get_frame_len(self, index: int) -> float:
        row = self.data[index]
        audio = np.asarray(row["audio"]["array"])
        sr = row["audio"]["sampling_rate"]
        return (audio.shape[-1] / sr) * self.mel.target_sample_rate / self.mel.hop_length

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict[str, Any]:
        while True:
            row = self.data[index]
            audio = np.asarray(row["audio"]["array"], dtype=np.float32)
            sr = row["audio"]["sampling_rate"]
            if 0.3 <= audio.shape[-1] / sr <= 30:
                break
            index = (index + 1) % len(self.data)
        wav = audio_utils.to_mono(audio)
        if sr != self.mel.target_sample_rate:
            wav = audio_utils.resample(wav, sr, self.mel.target_sample_rate)
        return {"mel_spec": _host_mel(np.asarray(wav, np.float32), self.mel),
                "text": row["text"]}


def load_dataset(dataset_name: str, tokenizer: str = "pinyin",
                 dataset_type: str = "CustomDataset", audio_type: str = "raw",
                 mel_spec_kwargs: dict | None = None,
                 data_dir: str | None = None) -> CustomDataset | HFDataset:
    """Dataset dispatch (dataset.py:239-292):
      - CustomDataset:     {data_dir}/{name}_{tokenizer}/raw.arrow (or mel.arrow
                           with audio_type "mel") + duration.json;
      - CustomDatasetPath: `dataset_name` is that directory itself;
      - HFDataset:         a `datasets` save_to_disk directory, or
                           "<repo>_<split>" through datasets.load_dataset (from
                           its local cache: nothing is downloaded here).
    data_dir defaults to $F5_TTS_DATA_DIR, else "data"."""
    mel = MelConfig(**(mel_spec_kwargs or {}))
    if dataset_type == "HFDataset":
        import datasets as hfds

        if os.path.isdir(dataset_name):
            ds = hfds.load_from_disk(dataset_name)
            if isinstance(ds, hfds.DatasetDict):
                ds = ds["train"]
        else:
            pre, _, post = dataset_name.partition("_")
            ds = hfds.load_dataset(f"{pre}/{pre}", split=f"train.{post}" if post else "train",
                                   cache_dir=os.environ.get("F5_TTS_DATA_DIR", "data"))
        return HFDataset(ds, mel=mel)

    data_dir = data_dir or os.environ.get("F5_TTS_DATA_DIR", "data")
    base = (dataset_name if dataset_type == "CustomDatasetPath"
            else os.path.join(data_dir, f"{dataset_name}_{tokenizer}"))
    rows = _read_arrow_rows(os.path.join(base, "raw.arrow" if audio_type == "raw"
                                         else "mel.arrow"))
    durations = None
    dur_path = os.path.join(base, "duration.json")
    if os.path.exists(dur_path):
        with open(dur_path, "r", encoding="utf-8") as f:
            durations = json.load(f)["duration"]
    return CustomDataset(rows, durations=durations, mel=mel,
                         preprocessed_mel=audio_type != "raw")


def _read_arrow_rows(path: str) -> list[dict]:
    """The rows of an arrow file, in the IPC stream format (what prepare.py
    writes) or the IPC file format."""
    import pyarrow as pa

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with pa.memory_map(path) as source:
        head = source.read(6)
    opener = pa.ipc.open_file if head == b"ARROW1" else pa.ipc.open_stream
    with pa.memory_map(path) as source:
        return opener(source).read_all().to_pylist()

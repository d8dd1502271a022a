"""Evaluation utilities: testset parsing, bucketed prompt batching, sharding,
ASR-WER and speaker-SIM scoring with injectable backends.

Capability parity with reference `src/f5_tts/eval/utils_eval.py`:
  - seed-tts metalst parser (`:18-32`) and librispeech-pc parser (`:36-54`)
  - `get_inference_prompt`: duration-bucketed batch prompt grouping with
    seeded shuffle (`:72-205`)
  - job sharding across accelerators (`:212-278`)
  - `run_asr_wer` / `run_sim` (`:306-426`) — ASR and speaker-embedding
    models require downloadable weights; callers inject `transcribe_fn` /
    `embed_fn` (e.g. a local Whisper/WavLM, or eval/ecapa_tdnn.py's
    make_embed_fn), the scoring logic lives here.

A copy of korean_f5_tts_tpu/eval/utils_eval.py over the port's utils/audio.py
(host numpy only: nothing here touches a device).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from korean_f5_tts_tpu_torch.eval.metrics import char_error_rate, word_error_rate
from korean_f5_tts_tpu_torch.utils.audio import load_wav, resample, to_mono


def get_seedtts_testset_metainfo(metalst: str) -> list[tuple]:
    """Rows: (utt, prompt_text, prompt_wav, gt_text, gt_wav)."""
    out = []
    base = Path(metalst).parent
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) == 5:
                utt, prompt_text, prompt_wav, gt_text, gt_wav = parts
            elif len(parts) == 4:
                utt, prompt_text, prompt_wav, gt_text = parts
                gt_wav = os.path.join(str(base), "wavs", utt + ".wav")
            else:
                continue
            if not os.path.isabs(prompt_wav):
                prompt_wav = os.path.join(str(base), prompt_wav)
            out.append((utt, prompt_text, prompt_wav, gt_text, gt_wav))
    return out


def get_librispeech_test_clean_metainfo(metalst: str, librispeech_test_clean_path: str):
    """Rows from cross-sentence lst: (ref utt, ref dur, ref txt, gen utt, gen dur, gen txt)."""
    out = []
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            ref_utt, ref_dur, ref_txt, gen_utt, gen_dur, gen_txt = line.strip().split("\t")

            def wav_path(utt):
                spk, chap = utt.split("-")[:2]
                return os.path.join(librispeech_test_clean_path, spk, chap, utt + ".flac")

            out.append((
                ref_utt, float(ref_dur), ref_txt, wav_path(ref_utt),
                gen_utt, float(gen_dur), gen_txt, wav_path(gen_utt),
            ))
    return out


def get_inference_prompt(
    metainfo: list[tuple],
    speed: float = 1.0,
    tokenizer: str = "pinyin",
    target_sample_rate: int = 24_000,
    hop_length: int = 256,
    num_buckets: int = 200,
    min_secs: float = 3.0,
    max_secs: float = 40.0,
    seed: int = 666,
    tokenize_fn=None,
):
    """Group prompts into duration buckets for static-shape batch inference.

    Parity with utils_eval.py:72-205: estimated total duration maps each
    utterance to one of `num_buckets` buckets between min/max secs; buckets
    are shuffled with a fixed seed so batches are reproducible.
    """
    buckets: list[list] = [[] for _ in range(num_buckets)]
    bounds = np.linspace(min_secs, max_secs, num_buckets + 1)
    for row in metainfo:
        utt, prompt_text, prompt_wav, gt_text = row[0], row[1], row[2], row[3]
        wav, sr = load_wav(prompt_wav)
        mono = to_mono(wav)
        if sr != target_sample_rate:
            mono = resample(mono, sr, target_sample_rate)
        ref_secs = len(mono) / target_sample_rate
        ref_bytes = len(prompt_text.encode("utf-8"))
        gen_bytes = len(gt_text.encode("utf-8"))
        total_secs = ref_secs + ref_secs / max(ref_bytes, 1) * gen_bytes / speed
        total_secs = float(np.clip(total_secs, min_secs, max_secs - 1e-6))
        b = int(np.searchsorted(bounds, total_secs, side="right") - 1)
        ref_frames = int(len(mono) / hop_length)
        total_frames = ref_frames + int(
            ref_frames / max(ref_bytes, 1) * gen_bytes / speed
        )
        buckets[b].append({
            "utt": utt,
            "ref_wav": mono,
            "ref_text": prompt_text,
            "gen_text": gt_text,
            "ref_frames": ref_frames,
            "total_frames": total_frames,
        })
    rng = np.random.default_rng(seed)
    prompts = []
    for b in buckets:
        if b:
            rng.shuffle(b)
            prompts.append(b)
    return prompts


def split_jobs(items: list, num_shards: int, shard_id: int) -> list:
    """Deterministic contiguous shard split (utils_eval.py:212-278 role)."""
    per = int(np.ceil(len(items) / num_shards))
    return items[shard_id * per: (shard_id + 1) * per]


def run_asr_wer(
    lang: str,
    gen_wav_dir: str,
    metainfo: list[tuple],
    transcribe_fn,
    normalize_fn=None,
) -> list[dict]:
    """Transcribe generated wavs and score WER+CER against ground truth.

    transcribe_fn(path) -> text. Returns per-utterance result dicts
    (jsonl-compatible with the reference's `_wer_results.jsonl`).
    """
    results = []
    for row in metainfo:
        utt, gt_text = row[0], row[3]
        wav_path = os.path.join(gen_wav_dir, utt + ".wav")
        if not os.path.exists(wav_path):
            continue
        hyp = transcribe_fn(wav_path)
        ref = gt_text
        if normalize_fn is not None:
            hyp, ref = normalize_fn(hyp), normalize_fn(ref)
        results.append({
            "wav": wav_path,
            "truth": ref,
            "hypo": hyp,
            "wer": word_error_rate(ref, hyp),
            "cer": char_error_rate(ref, hyp),
        })
    return results


def run_sim(gen_wav_dir: str, metainfo: list[tuple], embed_fn) -> list[dict]:
    """Cosine speaker similarity generated-vs-prompt (utils_eval.py:380-426).

    embed_fn(wav float32 [n], sr) -> 1-D embedding.
    """
    results = []
    for row in metainfo:
        utt, prompt_wav = row[0], row[2]
        gen_path = os.path.join(gen_wav_dir, utt + ".wav")
        if not os.path.exists(gen_path):
            continue
        g_wav, g_sr = load_wav(gen_path)
        p_wav, p_sr = load_wav(prompt_wav)
        e1 = np.asarray(embed_fn(to_mono(g_wav), g_sr), np.float64)
        e2 = np.asarray(embed_fn(to_mono(p_wav), p_sr), np.float64)
        sim = float(e1 @ e2 / (np.linalg.norm(e1) * np.linalg.norm(e2) + 1e-9))
        results.append({"wav": gen_path, "sim": sim})
    return results

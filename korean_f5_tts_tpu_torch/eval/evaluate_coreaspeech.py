"""CoreaSpeech validation-set evaluation, same-speaker reference matching
(counterpart of korean_f5_tts_tpu/eval/evaluate_coreaspeech.py).

Parity with reference root-level `evaluate_coreaspeech.py` (and the KUB
variant): unlike the KSS grid, each validation utterance is prompted with a
*same-speaker* reference clip from the training split (`:55-80`), then scored
CER/WER/SIM like the grid harness. `main` reads the metadata rows whole
(read_jsonl_rows), so the speaker key reaches the mapping; it loads the model
on `--device` (the card unless the caller names the CPU).

    python -m korean_f5_tts_tpu_torch.eval.evaluate_coreaspeech \\
        --valid_metadata valid.jsonl --train_metadata train.jsonl --ckpt_file m.npz
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from korean_f5_tts_tpu_torch.config import model_config_of
from korean_f5_tts_tpu_torch.eval.evaluate_korean import evaluate_one_model


def build_same_speaker_mapping(
    test_rows: list[dict], train_rows: list[dict],
    speaker_key: str = "speaker", min_dur: float = 3.0, max_dur: float = 10.0,
    seed: int = 666,
) -> dict[str, dict]:
    """Pair each test utterance with a same-speaker in-duration reference."""
    rng = np.random.default_rng(seed)
    by_speaker: dict[str, list[dict]] = defaultdict(list)
    for r in train_rows:
        if min_dur <= r.get("duration", 0.0) <= max_dur:
            by_speaker[str(r.get(speaker_key, ""))].append(r)
    mapping = {}
    counters: dict[str, int] = defaultdict(int)
    for row in test_rows:
        spk = str(row.get(speaker_key, ""))
        pool = by_speaker.get(spk)
        if not pool:
            mapping[row["utt"]] = None
            continue
        order = rng.permutation(len(pool)) if counters[spk] == 0 else None
        if order is not None:
            by_speaker[spk] = [pool[i] for i in order]
            pool = by_speaker[spk]
        mapping[row["utt"]] = pool[counters[spk] % len(pool)]
        counters[spk] += 1
    return mapping


def read_jsonl_rows(path: str) -> list[dict]:
    """Every key of every non-empty jsonl line (speaker included)."""
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_evaluate-coreaspeech")
    p.add_argument("--valid_metadata", required=True, help="jsonl with utt/text/speaker")
    p.add_argument("--train_metadata", required=True,
                   help="jsonl with audio_path/text/speaker/duration")
    p.add_argument("--ckpt_file", required=True)
    p.add_argument("--model", default="F5TTS_Base", help="preset name or model config yaml")
    p.add_argument("--tokenizer", default="kor_phoneme")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--out_dir", default="eval_results/coreaspeech")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    test_rows = [{"utt": f"v{i:05d}", **r}
                 for i, r in enumerate(read_jsonl_rows(args.valid_metadata))]
    train_rows = read_jsonl_rows(args.train_metadata)
    mapping = build_same_speaker_mapping(test_rows, train_rows)

    model_obj = load_model(model_config_of(args.model), ckpt_path=args.ckpt_file,
                           vocab_file=args.vocab_file, tokenizer=args.tokenizer, device=device)
    vocoder = load_vocoder("vocos", device=device)
    summary = evaluate_one_model(model_obj, vocoder, test_rows, mapping,
                                 args.out_dir, nfe_step=args.nfe_step)
    print(summary)
    return summary


if __name__ == "__main__":
    main()

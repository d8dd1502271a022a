"""Validation-split model grid, distinct from the test-set evaluation
(counterpart of korean_f5_tts_tpu/eval/validate_models.py).

Capability parity with reference root-level `validate_models_1h.py` — the
checkpoint-selection harness run over the KSS *validation* list while
training is still in flight: strict REVERSED-list reference pairing
(`validate_models_1h.py:138-151`: item i takes item total-1-i as its prompt,
so prompts never leak the target utterance), candidate-validity rules
(`:125-128`: no comma, no mid-sentence period) and a char-count duration
floor (`:110-113`: MIN_DURATION / CHAR_DURATION_RATIO), a coarse step grid
(50k..350k by 50k, `:70-72`), legacy mode-name mapping (`:74-84`), and a
separate output root so validation artifacts never mix with test results
(`:93`). Synthesis/scoring reuse evaluate_korean.evaluate_one_model
(resumable details.csv, injected ASR/SIM backends); `main` loads each cell's
model on `--device` (the card unless the caller names the CPU).

    python -m korean_f5_tts_tpu_torch.eval.validate_models --val_metadata val.jsonl
"""

from __future__ import annotations

import argparse
import csv
import os
import re

from korean_f5_tts_tpu_torch.eval.evaluate_korean import (
    evaluate_one_model,
    grid_model_loader,
    run_grid,
)

MIN_DURATION = 2.7
CHAR_DURATION_RATIO = 0.33

# validate_models_1h.py:74-84 — legacy mode names -> tokenizer modes
MODE_MAP = {
    "V+N+L-H": "kor_efficient_allophone",
    "VCP": "kor_allophone",
    "N": "kor_n_only",
    "salt_n": "kor_n_only",
    "salt_vcp": "kor_allophone",
    "V": "kor_i_only",
    "C": "kor_c_only",
    "V+C": "kor_i_and_c",
    "V+N": "kor_i_and_n",
    "N+L": "kor_nf",
    "V+N+L": "kor_inf",
    "grapheme": "kor_grapheme",
    "phoneme": "kor_phoneme",
}

DEFAULT_VAL_MODES = ["grapheme", "phoneme", "salt_n", "salt_vcp"]
DEFAULT_VAL_STEPS = list(range(50_000, 350_001, 50_000))


def resolve_mode(name: str) -> str:
    return MODE_MAP.get(name, name)


def get_pure_char_count(text: str) -> int:
    return len(re.findall(r"[가-힣A-Za-z0-9]", text))


def is_valid_candidate(text: str) -> bool:
    """validate_models_1h.py:125-128: commas and mid-sentence periods make an
    utterance a poor zero-shot prompt (pause ambiguity)."""
    text = text.strip()
    if "," in text:
        return False
    if "." in text[:-1]:
        return False
    return True


def min_duration_for(text: str) -> float:
    return max(MIN_DURATION, get_pure_char_count(text) * CHAR_DURATION_RATIO)


def build_reversed_mapping(rows: list[dict]) -> dict[str, dict]:
    """Strict reversed-list pairing (validate_models_1h.py:138-151): row i
    prompts with row total-1-i, so a model can never copy its own target."""
    total = len(rows)
    return {rows[i]["utt"]: rows[total - 1 - i] for i in range(total)}


def filter_validation_rows(rows: list[dict]) -> list[dict]:
    out = []
    for r in rows:
        dur = float(r.get("duration", 0.0) or 0.0)
        if not is_valid_candidate(r.get("text", "")):
            continue
        if dur and dur < min_duration_for(r["text"]):
            continue
        out.append(r)
    return out


def write_summary(results: list[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = ["mode", "step", "n", "cer", "wer", "sim", "out_dir"]
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        for r in results:
            w.writerow(r)


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_validate-models")
    p.add_argument("--val_metadata", required=True,
                   help="validation jsonl/csv: utt/audio_path/text/duration")
    p.add_argument("--ckpt_root", default="ckpts")
    p.add_argument("--modes", nargs="*", default=DEFAULT_VAL_MODES)
    p.add_argument("--steps", nargs="*", type=int, default=DEFAULT_VAL_STEPS)
    p.add_argument("--results_dir", default="eval_results/KSS_1h_val")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--model", default="F5TTS_Base",
                   help="preset name or model config yaml of every cell")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from korean_f5_tts_tpu_torch.train.datasets.prepare import read_jsonl_corpus
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    rows = [
        {"utt": f"v{i:04d}", **r}
        for i, r in enumerate(read_jsonl_corpus(args.val_metadata))
    ]
    rows = filter_validation_rows(rows)
    mapping = build_reversed_mapping(rows)
    modes = [resolve_mode(m) for m in args.modes]

    def ckpt_dir_fn(mode, step):
        path = os.path.join(args.ckpt_root, mode, f"model_{step}.npz")
        return path if os.path.exists(path) else None

    results = run_grid(modes, args.steps, ckpt_dir_fn,
                       grid_model_loader(args.model, args.ckpt_root, device), rows,
                       mapping, results_dir=args.results_dir, nfe_step=args.nfe_step)
    write_summary(results, os.path.join(args.results_dir, "validation_summary.csv"))
    return results


__all__ = [
    "MODE_MAP", "build_reversed_mapping", "evaluate_one_model",
    "filter_validation_rows", "is_valid_candidate", "main",
    "min_duration_for", "resolve_mode",
]

if __name__ == "__main__":
    main()

"""Korean tokenizer-grid evaluation harness (counterpart of
korean_f5_tts_tpu/eval/evaluate_korean.py).

Capability parity with reference root-level `evaluate_models.py` (and the
_1h / coreaspeech variants): loop tokenizer modes x checkpoint steps
(`:57-80`), build a deterministic reverse reference-prompt mapping
(`:128-148`, `get_reference_mapping.py`), synthesize the test set, score
Whisper-CER/WER on N2gk+-normalised punctuation-stripped text (`:154-158,
263-267`), plus speaker-SIM; everything resumable through a details.csv.

ASR / speaker / MOS backends are injected (no downloadable weights offline);
the grid, mapping, synthesis, normalisation and bookkeeping all run.
Synthesis is the port's infer_process on the model's device; `main` loads
each cell's model on `--device` (the card unless the caller names the CPU).

    python -m korean_f5_tts_tpu_torch.eval.evaluate_korean \\
        --test_metadata test.jsonl --train_metadata train.jsonl --ckpt_root ckpts
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from korean_f5_tts_tpu_torch.eval.metrics import char_error_rate, strip_punctuation, word_error_rate
from korean_f5_tts_tpu_torch.eval.utils_eval import run_sim
from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process, preprocess_ref_audio_text
from korean_f5_tts_tpu_torch.text.normalization import normalize_n2gk_plus
from korean_f5_tts_tpu_torch.utils.audio import save_wav

DEFAULT_MODES = [
    "kor_grapheme", "kor_phoneme", "kor_allophone", "kor_i_only", "kor_c_only",
    "kor_i_and_c", "kor_n_only", "kor_i_and_n", "kor_inf", "kor_nf",
    "kor_efficient_allophone",
]


def build_reference_mapping(
    test_rows: list[dict],
    train_rows: list[dict],
    min_dur: float = 3.0,
    max_dur: float = 10.0,
    seed: int = 666,
) -> dict[str, dict]:
    """Deterministic test->train prompt assignment with duration/punctuation
    constraints (get_reference_mapping.py:1-172 role): each test utterance is
    paired with a distinct same-corpus reference whose duration lies in
    [min_dur, max_dur] and whose text ends with sentence punctuation."""
    rng = np.random.default_rng(seed)
    eligible = [
        r for r in train_rows
        if min_dur <= r.get("duration", 0.0) <= max_dur
        and r["text"].strip()[-1:] in ".?!。"
    ]
    order = rng.permutation(len(eligible))
    mapping = {}
    for i, row in enumerate(test_rows):
        ref = eligible[order[i % len(eligible)]] if eligible else None
        mapping[row["utt"]] = ref
    return mapping


def normalize_for_scoring(text: str) -> str:
    """N2gk+ then punctuation strip (evaluate_models.py:154-158,263-267)."""
    return strip_punctuation(normalize_n2gk_plus(text)).strip()


def evaluate_one_model(
    model_obj, vocoder, test_rows: list[dict], mapping: dict[str, dict],
    out_dir: str, nfe_step: int = 32, transcribe_fn=None, embed_fn=None,
    details_csv: str | None = None, seed: int | None = None,
) -> dict:
    """Synthesize + score the test set for one (mode, checkpoint) cell.

    Rows already in details.csv are skipped, so a second call adds none."""
    os.makedirs(out_dir, exist_ok=True)
    details_csv = details_csv or os.path.join(out_dir, "details.csv")
    done = set()
    if os.path.exists(details_csv):  # resumable (evaluate_models.py:404-420)
        with open(details_csv, "r", encoding="utf-8", newline="") as f:
            done = {row["utt"] for row in csv.DictReader(f)}

    fieldnames = ["utt", "gt_text", "hyp_text", "cer", "wer"]
    write_header = not os.path.exists(details_csv)
    with open(details_csv, "a", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        if write_header:
            writer.writeheader()
        for row in test_rows:
            if row["utt"] in done:
                continue
            ref = mapping.get(row["utt"])
            if ref is None:
                continue
            ref_audio, ref_text = preprocess_ref_audio_text(
                ref["audio_path"], ref["text"], show_info=lambda *a: None
            )
            wav, sr, _ = infer_process(
                ref_audio, ref_text, row["text"], model_obj, vocoder,
                nfe_step=nfe_step, show_info=lambda *a: None, seed=seed,
            )
            wav_path = os.path.join(out_dir, row["utt"] + ".wav")
            save_wav(wav_path, wav, sr)
            rec = {"utt": row["utt"], "gt_text": row["text"], "hyp_text": "",
                   "cer": "", "wer": ""}
            if transcribe_fn is not None:
                hyp = transcribe_fn(wav_path)
                gt_n, hyp_n = normalize_for_scoring(row["text"]), normalize_for_scoring(hyp)
                rec.update(hyp_text=hyp, cer=char_error_rate(gt_n, hyp_n),
                           wer=word_error_rate(gt_n, hyp_n))
            writer.writerow(rec)
            f.flush()

    summary: dict = {"out_dir": out_dir, "n": len(test_rows)}
    if transcribe_fn is not None:
        with open(details_csv, "r", encoding="utf-8", newline="") as f:
            rows = [r for r in csv.DictReader(f) if r["cer"] != ""]
        if rows:
            summary["cer"] = float(np.mean([float(r["cer"]) for r in rows]))
            summary["wer"] = float(np.mean([float(r["wer"]) for r in rows]))
    if embed_fn is not None:
        meta = [(r["utt"], "", mapping[r["utt"]]["audio_path"], r["text"])
                for r in test_rows if mapping.get(r["utt"])]
        sims = run_sim(out_dir, meta, embed_fn)
        if sims:
            summary["sim"] = float(np.mean([s["sim"] for s in sims]))
    return summary


def run_grid(
    modes: list[str], steps: list[int], ckpt_dir_fn, model_loader_fn,
    test_rows: list[dict], mapping: dict, results_dir: str = "eval_results",
    **eval_kwargs,
) -> list[dict]:
    """Grid loop over tokenizer modes x ckpt steps (evaluate_models.py:57-80)."""
    results = []
    for mode in modes:
        for step in steps:
            ckpt = ckpt_dir_fn(mode, step)
            if ckpt is None or not os.path.exists(ckpt):
                continue
            model_obj, vocoder = model_loader_fn(mode, ckpt)
            out_dir = os.path.join(results_dir, f"{mode}_{step}")
            summary = evaluate_one_model(model_obj, vocoder, test_rows, mapping,
                                         out_dir, **eval_kwargs)
            summary.update(mode=mode, step=step)
            results.append(summary)
            print(summary)
    return results


def grid_model_loader(model: str, ckpt_root: str, device):
    """`model_loader_fn` of the grid mains: the `model` preset (or a model
    config yaml) from a cell's checkpoint with tokenizer = the mode, and that
    mode's vocabulary when `<ckpt_root>/<mode>/vocab.txt` exists (each
    tokenizer mode has its own symbol set); fp32 weights, as the JAX package
    loads them, and a Vocos on the same device."""
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.config import model_config_of
    from korean_f5_tts_tpu_torch.infer.model import load_model

    model_cfg = model_config_of(model)

    def loader(mode, ckpt):
        vocab = os.path.join(ckpt_root, mode, "vocab.txt")
        model_obj = load_model(model_cfg, ckpt_path=ckpt, tokenizer=mode, device=device,
                               vocab_file=vocab if os.path.exists(vocab) else None)
        return model_obj, load_vocoder("vocos", device=device)

    return loader


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_evaluate-korean")
    p.add_argument("--test_metadata", required=True,
                   help="jsonl/csv with utt, text, (duration)")
    p.add_argument("--train_metadata", required=True,
                   help="reference-prompt pool with audio_path, text, duration")
    p.add_argument("--ckpt_root", default="ckpts",
                   help="<ckpt_root>/<mode>/model_<step>.npz (and the mode's vocab.txt)")
    p.add_argument("--modes", nargs="*", default=DEFAULT_MODES)
    p.add_argument("--steps", nargs="*", type=int,
                   default=[60_000, 80_000, 100_000, 120_000, 150_000])
    p.add_argument("--results_dir", default="eval_results")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--model", default="F5TTS_Base",
                   help="preset name or model config yaml of every cell")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from korean_f5_tts_tpu_torch.train.datasets.prepare import read_jsonl_corpus
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    test_rows = [
        {"utt": f"t{i:04d}", **r}
        for i, r in enumerate(read_jsonl_corpus(args.test_metadata))
    ]
    train_rows = read_jsonl_corpus(args.train_metadata)
    mapping = build_reference_mapping(test_rows, train_rows)

    def ckpt_dir_fn(mode, step):
        path = os.path.join(args.ckpt_root, mode, f"model_{step}.npz")
        return path if os.path.exists(path) else None

    return run_grid(args.modes, args.steps, ckpt_dir_fn,
                    grid_model_loader(args.model, args.ckpt_root, device), test_rows,
                    mapping, results_dir=args.results_dir, nfe_step=args.nfe_step)


if __name__ == "__main__":
    main()

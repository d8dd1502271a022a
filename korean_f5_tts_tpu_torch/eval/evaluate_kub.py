"""KUB-style test-list evaluation, CER/WER + UTMOS + SIM per subset
(counterpart of korean_f5_tts_tpu/eval/evaluate_kub.py).

Role parity with reference root-level `evaluate_coreaspeech_kub.py`: a direct
1:1 evaluation over a pipe-separated 6-column test list
(`parse_KUB_line`, kub.py:124-143):

    subset | ref_wav | ref_text | ref_duration | gt_wav | target_text

Each line is synthesized from its own reference clip and scored against its
ground-truth clip; results are grouped per `subset` (clean / noisy / numeric
…) and summarized per (mode, step, subset) like the reference's
`df.groupby(['mode','step','subset'])` table (kub.py:648-655).

ASR / MOS / speaker-embedding backends are injectable (Whisper, UTMOSv2 and
WavLM weights are not downloaded; same convention as the other eval harnesses
in this package). Synthesis is the port's infer_process on the model's
device; `main` loads the model on `--device` (the card unless the caller
names the CPU).

    python -m korean_f5_tts_tpu_torch.eval.evaluate_kub --test_list kub.txt \
        --data_root data/ --ckpt_file m.npz
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np

from korean_f5_tts_tpu_torch.config import model_config_of
from korean_f5_tts_tpu_torch.eval.evaluate_korean import normalize_for_scoring
from korean_f5_tts_tpu_torch.eval.metrics import char_error_rate, word_error_rate
from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process, preprocess_ref_audio_text
from korean_f5_tts_tpu_torch.utils.audio import save_wav


def parse_kub_line(line: str) -> dict | None:
    """One `subset|ref_wav|ref_text|ref_duration|gt_wav|target_text` row
    (evaluate_coreaspeech_kub.py:124-143)."""
    parts = line.rstrip("\n").split("|")
    if len(parts) != 6:
        return None
    try:
        ref_duration = float(parts[3].strip())
    except ValueError:
        return None
    return {
        "subset": parts[0].strip(),
        "ref_wav": parts[1].strip(),
        "ref_text": parts[2].strip(),
        "ref_duration": ref_duration,
        "gt_wav": parts[4].strip(),
        "target_text": parts[5].strip(),
    }


def load_test_items(test_path: str) -> list[dict]:
    items = []
    with open(test_path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            item = parse_kub_line(line)
            if item is not None:
                items.append(item)
    return items


def resolve_audio_path(data_root: str, rel_path: str) -> str:
    return rel_path if os.path.isabs(rel_path) else os.path.join(data_root, rel_path)


def evaluate_kub(
    model_obj, vocoder, items: list[dict], data_root: str, out_dir: str,
    nfe_step: int = 32, transcribe_fn=None, mos_fn=None, embed_fn=None,
    seed: int | None = None, details_csv: str | None = None,
) -> list[dict]:
    """Synthesize + score each test item; returns per-item records.

    Resumable through details.csv like the grid harness."""
    os.makedirs(out_dir, exist_ok=True)
    details_csv = details_csv or os.path.join(out_dir, "details.csv")
    done = set()
    if os.path.exists(details_csv):
        with open(details_csv, "r", encoding="utf-8", newline="") as f:
            done = {row["utt"] for row in csv.DictReader(f)}

    fieldnames = ["utt", "subset", "gt_text", "hyp_text", "cer", "wer",
                  "utmos", "sim"]
    write_header = not os.path.exists(details_csv)
    with open(details_csv, "a", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        if write_header:
            writer.writeheader()
        for i, item in enumerate(items):
            utt = f"kub{i:05d}"
            if utt in done:
                continue
            ref_path = resolve_audio_path(data_root, item["ref_wav"])
            ref_audio, ref_text = preprocess_ref_audio_text(
                ref_path, item["ref_text"], show_info=lambda *a: None)
            wav, sr, _ = infer_process(
                ref_audio, ref_text, item["target_text"], model_obj, vocoder,
                nfe_step=nfe_step, show_info=lambda *a: None, seed=seed)
            wav_path = os.path.join(out_dir, utt + ".wav")
            save_wav(wav_path, wav, sr)
            rec = {"utt": utt, "subset": item["subset"],
                   "gt_text": item["target_text"], "hyp_text": "",
                   "cer": "", "wer": "", "utmos": "", "sim": ""}
            if transcribe_fn is not None:
                hyp = transcribe_fn(wav_path)
                gt_n = normalize_for_scoring(item["target_text"])
                hyp_n = normalize_for_scoring(hyp)
                rec.update(hyp_text=hyp, cer=char_error_rate(gt_n, hyp_n),
                           wer=word_error_rate(gt_n, hyp_n))
            if mos_fn is not None:
                rec["utmos"] = float(mos_fn(wav_path))
            if embed_fn is not None:
                gt_path = resolve_audio_path(data_root, item["gt_wav"])
                a, b = np.asarray(embed_fn(wav_path)), np.asarray(embed_fn(gt_path))
                rec["sim"] = float(
                    np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
            writer.writerow(rec)
            f.flush()

    with open(details_csv, "r", encoding="utf-8", newline="") as f:
        return list(csv.DictReader(f))


def summarize_by_subset(records: list[dict], mode: str = "", step: int = 0) -> list[dict]:
    """Per-(mode, step, subset) metric means (kub.py:648-655)."""
    groups: dict[str, list[dict]] = defaultdict(list)
    for r in records:
        groups[r["subset"]].append(r)
    out = []
    for subset, rows in sorted(groups.items()):
        row = {"mode": mode, "step": step, "subset": subset, "n": len(rows)}
        for metric in ("cer", "wer", "utmos", "sim"):
            vals = [float(r[metric]) for r in rows if r.get(metric, "") != ""]
            if vals:
                row[metric] = float(np.mean(vals))
        out.append(row)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_evaluate-kub")
    p.add_argument("--test_list", required=True,
                   help="pipe-separated 6-column KUB test list")
    p.add_argument("--data_root", required=True)
    p.add_argument("--ckpt_file", required=True)
    p.add_argument("--model", default="F5TTS_Base", help="preset name or model config yaml")
    p.add_argument("--tokenizer", default="kor_phoneme")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--out_dir", default="eval_results/kub")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    items = load_test_items(args.test_list)
    model_obj = load_model(model_config_of(args.model),
                           ckpt_path=args.ckpt_file, vocab_file=args.vocab_file,
                           tokenizer=args.tokenizer, device=device)
    vocoder = load_vocoder("vocos", device=device)
    records = evaluate_kub(model_obj, vocoder, items, args.data_root,
                           args.out_dir, nfe_step=args.nfe_step, seed=args.seed)
    summary = summarize_by_subset(records)
    out_csv = os.path.join(args.out_dir, "summary.csv")
    if summary:
        with open(out_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(summary[0]))
            w.writeheader()
            w.writerows(summary)
    for row in summary:
        print(row)
    return summary


if __name__ == "__main__":
    main()

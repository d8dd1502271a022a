"""Batch generation of eval wavs from a metadata list (KSS-style;
counterpart of korean_f5_tts_tpu/infer/batch_infer.py): python -m
korean_f5_tts_tpu_torch.infer.batch_infer, on the card unless --device cpu.

Parity with reference `src/f5_tts/infer/batch_infer.py` (hard-coded KSS
batch loop) — generalised to any jsonl/csv metadata with a fixed reference
prompt or per-row references.
"""

from __future__ import annotations

import argparse
import json
import os

from korean_f5_tts_tpu_torch.infer.utils_infer import infer_process, preprocess_ref_audio_text
from korean_f5_tts_tpu_torch.utils.audio import save_wav


def batch_generate(model_obj, vocoder, rows: list[dict], out_dir: str,
                   ref_audio: str | None = None, ref_text: str | None = None,
                   nfe_step: int = 32, seed: int | None = None,
                   attn_path: str = "default", attn_int8: str | None = None) -> list[str]:
    """rows: [{utt, text, (ref_audio, ref_text)}] -> wav paths written."""
    os.makedirs(out_dir, exist_ok=True)
    shared = None
    if ref_audio is not None:
        shared = preprocess_ref_audio_text(ref_audio, ref_text or "")
    written = []
    for row in rows:
        out_path = os.path.join(out_dir, row["utt"] + ".wav")
        if os.path.exists(out_path):
            continue
        if shared is not None:
            (wav_ref, sr), rtext = shared
        else:
            (wav_ref, sr), rtext = preprocess_ref_audio_text(
                row["ref_audio"], row.get("ref_text", "")
            )
        wav, out_sr, _ = infer_process(
            (wav_ref, sr), rtext, row["text"], model_obj, vocoder,
            nfe_step=nfe_step, show_info=lambda *a: None, seed=seed,
            attn_path=attn_path, attn_int8=attn_int8,
        )
        save_wav(out_path, wav, out_sr)
        written.append(out_path)
    return written


def main(argv=None):
    from korean_f5_tts_tpu_torch.serving.server import add_model_arguments, load_from_arguments

    p = argparse.ArgumentParser(prog="f5-tts_batch-infer")
    add_model_arguments(p)
    p.add_argument("--metadata", required=True, help="jsonl with utt/text")
    p.add_argument("--ref_audio", default=None)
    p.add_argument("--ref_text", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    rows = []
    with open(args.metadata, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    model_obj, vocoder = load_from_arguments(args)
    written = batch_generate(model_obj, vocoder, rows, args.out_dir,
                             ref_audio=args.ref_audio, ref_text=args.ref_text,
                             nfe_step=args.nfe_step, seed=args.seed,
                             attn_path=args.attn_path, attn_int8=args.attn_int8)
    print(f"wrote {len(written)} wavs to {args.out_dir}")


if __name__ == "__main__":
    main()

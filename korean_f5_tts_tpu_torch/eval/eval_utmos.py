"""UTMOS naturalness-MOS prediction over a wav directory (counterpart of
korean_f5_tts_tpu/eval/eval_utmos.py).

Parity with reference `src/f5_tts/eval/eval_utmos.py` (torch.hub SpeechMOS
`utmos22_strong`). The predictor weights require network access; the runner
accepts any callable `mos_fn(wav float32 [n], sr) -> float` — plug in a local
UTMOS/UTMOSv2 checkpoint where available. Without one, evaluate_dir (and
so `main`) raises, as the JAX package's does. Host work only: no device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from korean_f5_tts_tpu_torch.utils.audio import load_wav, to_mono


def evaluate_dir(audio_dir: str, ext: str = "wav", mos_fn=None) -> dict:
    if mos_fn is None:
        raise RuntimeError(
            "UTMOS weights are not downloaded (no network at run time); pass "
            "mos_fn (e.g. a locally-stored utmos22_strong checkpoint wrapper)"
        )
    results = []
    for path in sorted(Path(audio_dir).rglob(f"*.{ext}")):
        wav, sr = load_wav(str(path))
        score = float(mos_fn(to_mono(wav), sr))
        results.append({"wav": str(path), "utmos": score})
    out_path = Path(audio_dir) / "_utmos_results.jsonl"
    with open(out_path, "w", encoding="utf-8") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    mean = float(np.mean([r["utmos"] for r in results])) if results else float("nan")
    print(f"UTMOS: {mean:.4f} over {len(results)} utts")
    return {"mean": mean, "n": len(results), "out": str(out_path)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--ext", default="wav")
    args = p.parse_args(argv)
    evaluate_dir(args.audio_dir, args.ext)


if __name__ == "__main__":
    main()

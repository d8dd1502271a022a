"""LibriSpeech-PC test-clean cross-sentence WER/SIM scoring (counterpart of
korean_f5_tts_tpu/eval/eval_librispeech_test_clean.py).

Parity with reference `src/f5_tts/eval/eval_librispeech_test_clean.py`
(mp.Pool-per-GPU WER/SIM writing result jsonl). Backends injected as in
eval_seedtts_testset, with its `--ecapa_params` / `--device` SIM backend.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from korean_f5_tts_tpu_torch.eval.utils_eval import (
    get_librispeech_test_clean_metainfo,
    run_asr_wer,
    run_sim,
    split_jobs,
)


def evaluate(
    metalst: str, librispeech_test_clean_path: str, gen_wav_dir: str,
    eval_task: str = "wer", transcribe_fn=None, embed_fn=None,
    num_shards: int = 1, shard_id: int = 0,
) -> dict:
    rows = get_librispeech_test_clean_metainfo(metalst, librispeech_test_clean_path)
    # normalise to (utt, prompt_text, prompt_wav, gt_text)
    meta = [(m[4], m[2], m[3], m[6]) for m in rows]
    meta = split_jobs(meta, num_shards, shard_id)
    out_path = os.path.join(gen_wav_dir, f"_{eval_task}_results.jsonl")
    if eval_task == "wer":
        if transcribe_fn is None:
            raise RuntimeError("WER needs an ASR backend (transcribe_fn)")
        results = run_asr_wer("en", gen_wav_dir, meta, transcribe_fn)
        key = "wer"
    else:
        if embed_fn is None:
            raise RuntimeError("SIM needs a speaker-embedding backend (embed_fn)")
        results = run_sim(gen_wav_dir, meta, embed_fn)
        key = "sim"
    with open(out_path, "w", encoding="utf-8") as f:
        for r in results:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    mean = float(np.mean([r[key] for r in results])) if results else float("nan")
    print(f"{eval_task}: {mean:.4f} over {len(results)} utts -> {out_path}")
    return {"task": eval_task, "mean": mean, "n": len(results), "out": out_path}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--eval_task", default="wer", choices=["wer", "sim"])
    p.add_argument("--metalst", required=True)
    p.add_argument("--librispeech_test_clean_path", required=True)
    p.add_argument("--gen_wav_dir", required=True)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--ecapa_params", default=None,
                   help="trained ECAPA-TDNN .npz (JAX layout): the SIM backend")
    p.add_argument("--device", default="cuda",
                   help="device of the ECAPA encoder: cuda (default; raises without a card) "
                        "or cpu")
    args = p.parse_args(argv)
    embed_fn = None
    if args.ecapa_params:
        from korean_f5_tts_tpu_torch.eval.ecapa_tdnn import load_ecapa_embed_fn

        embed_fn = load_ecapa_embed_fn(args.ecapa_params, device=args.device)
    return evaluate(args.metalst, args.librispeech_test_clean_path, args.gen_wav_dir,
                    args.eval_task, embed_fn=embed_fn, num_shards=args.num_shards,
                    shard_id=args.shard_id)


if __name__ == "__main__":
    main()

"""Batch synthesis over an eval testset, seed-tts / librispeech-pc
(counterpart of korean_f5_tts_tpu/eval/eval_infer_batch.py).

Parity with reference `src/f5_tts/eval/eval_infer_batch.py`: bucketed
prompts -> batched `cfm_sample` with per-item lens and durations
(`:189-200`), sharded across workers via split_jobs (the accelerate
`split_between_processes` role at `:181`). cfm_sample regroups a batch whose
durations fall into several duration buckets (split_by_bucket), so each
group runs at its own bucket; with one shared seed an item's mel is the same
item's mel run alone. `main` loads the model on `--device` (the card unless
the caller names the CPU).

    python -m korean_f5_tts_tpu_torch.eval.eval_infer_batch -t seedtts_test_zh \\
        --metalst meta.lst --ckpt_file m.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from korean_f5_tts_tpu_torch.eval.utils_eval import (
    get_inference_prompt,
    get_librispeech_test_clean_metainfo,
    get_seedtts_testset_metainfo,
    split_jobs,
)
from korean_f5_tts_tpu_torch.infer.utils_infer import (
    _vocode_bucketed,
    hop_length,
    target_sample_rate,
)
from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, tokenize_text
from korean_f5_tts_tpu_torch.utils.audio import save_wav


def synthesize_bucket(bucket: list[dict], model_obj, vocoder, out_dir: str,
                      nfe_step: int = 32, cfg_strength: float = 2.0,
                      sway: float = -1.0, seed: int | None = None,
                      max_batch: int = 8) -> dict[str, np.ndarray]:
    """Run one duration bucket as padded batches through the sampler, write
    each item's wav, and return each item's generated mel [frames, n_mels]
    by utterance id."""
    os.makedirs(out_dir, exist_ok=True)
    mels_out = {}
    for i in range(0, len(bucket), max_batch):
        chunk = bucket[i: i + max_batch]
        mels = [model_obj.mel_of_wav(it["ref_wav"]) for it in chunk]
        max_ref = max(m.shape[0] for m in mels)
        d = mels[0].shape[1]
        cond = np.zeros((len(chunk), max_ref, d), np.float32)
        for j, m in enumerate(mels):
            cond[j, : m.shape[0]] = m
        lens = np.array([m.shape[0] for m in mels])
        durations = np.array([it["total_frames"] for it in chunk])
        token_lists = tokenize_text(
            [it["ref_text"] + " " + it["gen_text"] for it in chunk],
            tokenizer_type=model_obj.tokenizer_type,
            vocab=model_obj.vocab_char_map,
            use_n2gk_plus=model_obj.use_n2gk_plus,
            use_skip_tc=model_obj.use_skip_tc,
            legacy=model_obj.tokenizer_legacy,
        )
        text_ids = list_str_to_idx(token_lists, model_obj.vocab_char_map or {" ": 0})
        out, _ = cfm_sample(
            model_obj.params, model_obj.arch, cond, text_ids, durations,
            lens=lens, steps=nfe_step, cfg_strength=cfg_strength,
            sway_sampling_coef=sway, seed=seed,
        )
        out = out.float().cpu().numpy()
        for j, it in enumerate(chunk):
            gen = out[j: j + 1, lens[j]: durations[j], :]
            mel_out = np.swapaxes(gen, 1, 2)
            if vocoder is not None:
                wav = _vocode_bucketed(vocoder, mel_out, device=model_obj.device).reshape(-1)
            else:
                wav = np.zeros(mel_out.shape[-1] * hop_length, np.float32)
            save_wav(os.path.join(out_dir, it["utt"] + ".wav"), wav,
                     target_sample_rate)
            mels_out[it["utt"]] = gen[0]
    return mels_out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--expname", "-n", default="F5TTS_v1_Base",
                   help="preset name or model config yaml")
    p.add_argument("--ckptstep", "-c", type=int, default=1_250_000)
    p.add_argument("--ckpt_file", default=None)
    p.add_argument("--nfestep", "-nfe", type=int, default=32)
    p.add_argument("--odemethod", "-o", default="euler", choices=["euler"])
    p.add_argument("--swaysampling", "-ss", type=float, default=-1)
    p.add_argument("--testset", "-t", required=True,
                   choices=["ls_pc_test_clean", "seedtts_test_zh", "seedtts_test_en"])
    p.add_argument("--metalst", required=True)
    p.add_argument("--librispeech_path", default=None)
    p.add_argument("--output_dir", default="results")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.config import model_config_of
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    if args.testset == "ls_pc_test_clean":
        meta = get_librispeech_test_clean_metainfo(args.metalst, args.librispeech_path)
        # normalise row layout to (utt, prompt_text, prompt_wav, gt_text)
        meta = [(m[4], m[2], m[3], m[6]) for m in meta]
    else:
        meta = get_seedtts_testset_metainfo(args.metalst)
        meta = [(m[0], m[1], m[2], m[3]) for m in meta]

    model_obj = load_model(model_config_of(args.expname),
                           ckpt_path=args.ckpt_file, vocab_file=args.vocab_file,
                           tokenizer=args.tokenizer, device=device)
    vocoder = load_vocoder("vocos", device=device)
    prompts = get_inference_prompt(meta)
    buckets = split_jobs(prompts, args.num_shards, args.shard_id)
    name = os.path.splitext(os.path.basename(args.expname))[0]
    out_dir = os.path.join(args.output_dir, f"{name}_{args.ckptstep}_{args.testset}")
    for bucket in buckets:
        synthesize_bucket(bucket, model_obj, vocoder, out_dir,
                          nfe_step=args.nfestep, sway=args.swaysampling,
                          seed=args.seed)
    print(out_dir)
    return out_dir


if __name__ == "__main__":
    main()

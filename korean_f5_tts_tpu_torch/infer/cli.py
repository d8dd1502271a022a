"""Zero-shot synthesis command line of the port (counterpart of
korean_f5_tts_tpu/infer/cli.py): python -m korean_f5_tts_tpu_torch.infer.cli.

Runs on the card unless --device cpu is given (no card raises);
--compute_dtype casts the weights (default: fp32 as loaded). The sampler
keeps the reference mel's fp32 whatever the weights' dtype, as the JAX
sampler does, so every attention path and --attn_int8 run the fp32 forms of
their kernels; bfloat16 rounds the weights and halves their memory at rest
only: the sampler widens them to fp32 once per call and holds that copy
beside them while it samples (the all-bf16 function is the servers' fast
path). --quantize rewrites the block linears to int8 weights
(kernels 4, 5, 6, 9, here on fp32 rows), --attn_path picks the attention
half's kernels, --attn_int8 the int8 attention kernel.

Parity with reference `src/f5_tts/infer/infer_cli.py`: argparse + TOML config
overlay (`:211-252`), multi-voice `[voice]` tag splitting (`:363-382`),
per-voice speed, chunk saving, Korean tokenizer flags
(`--skip_tc/--tokenizer_version/--use_n2gk_plus/--tokenizer`, `:177-205`).
Nothing is downloaded: pass --ckpt_file (a JAX .npz, or a reference torch
.pt / .safetensors, EMA or LoRA-bearing, converted on load), or none for
seeded random weights.
"""

from __future__ import annotations

import argparse
import os
import re
from datetime import datetime

import numpy as np
import torch

from korean_f5_tts_tpu_torch.api import load_vocoder
from korean_f5_tts_tpu_torch.config import PRESETS, load_model_config, preset_model_config
from korean_f5_tts_tpu_torch.infer.model import load_model
from korean_f5_tts_tpu_torch.infer.utils_infer import (
    infer_process,
    preprocess_ref_audio_text,
    remove_silence_for_generated_wav,
)
from korean_f5_tts_tpu_torch.ops.attention import ATTN_PATHS, check_attn_int8
from korean_f5_tts_tpu_torch.utils.audio import save_wav


def _load_toml(path: str) -> dict:
    try:
        import tomllib
    except ImportError:  # py<3.11
        import tomli as tomllib
    with open(path, "rb") as f:
        return tomllib.load(f)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m korean_f5_tts_tpu_torch.infer.cli",
        description="F5-TTS zero-shot inference on a CUDA card (PyTorch port).",
    )
    p.add_argument("-c", "--config", default=None, help="TOML config file with defaults")
    p.add_argument("-m", "--model", default=None, help=f"model name: {sorted(PRESETS)}")
    p.add_argument("--model_cfg", default=None, help="path to model config yaml")
    p.add_argument("-p", "--ckpt_file", default=None,
                   help="model checkpoint: .npz of the JAX package | reference torch "
                        ".pt/.safetensors")
    p.add_argument("-v", "--vocab_file", default=None, help="vocab.txt path")
    p.add_argument("-r", "--ref_audio", default=None, help="reference audio wav")
    p.add_argument("-s", "--ref_text", default=None, help="reference transcript")
    p.add_argument("-t", "--gen_text", default=None, help="text to synthesize")
    p.add_argument("-f", "--gen_file", default=None, help="file with text to synthesize")
    p.add_argument("-o", "--output_dir", default=None, help="output directory")
    p.add_argument("-w", "--output_file", default=None, help="output wav filename")
    p.add_argument("--save_chunk", action="store_true", help="save per-chunk wavs")
    p.add_argument("--remove_silence", action="store_true")
    p.add_argument("--load_vocoder_from_local", action="store_true")
    p.add_argument("--vocoder_name", default=None, choices=["vocos", "bigvgan"])
    p.add_argument("--vocoder_ckpt", default=None, help="local vocoder .npz")
    p.add_argument("--target_rms", type=float, default=None)
    p.add_argument("--cross_fade_duration", type=float, default=None)
    p.add_argument("--nfe_step", type=int, default=None)
    p.add_argument("--cfg_strength", type=float, default=None)
    p.add_argument("--sway_sampling_coef", type=float, default=None)
    p.add_argument("--speed", type=float, default=None)
    p.add_argument("--fix_duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                   help="cast the weights to this dtype (default: float32 as loaded); the "
                        "sampler keeps the reference mel's fp32 either way, as the JAX "
                        "sampler, so the kernels' fp32 forms run; bfloat16 saves memory "
                        "only at rest, each call holding an fp32 copy beside it")
    p.add_argument("--quantize", action="store_true",
                   help="int8 block linears (load_model(..., quantize=True), after the dtype "
                        "cast): kernels 4, 5, 6, 9 on fp32 or bf16 rows")
    p.add_argument("--attn_path", default="default", choices=list(ATTN_PATHS),
                   help="kernels of the attention half (ops/attention.py)")
    p.add_argument("--attn_int8", default=None, choices=["qk", "qkpv"],
                   help="int8 attention (kernel 14) in kernel A's place: int8 q.k^T only, or "
                        "p.v as well; with --attn_path default or linear_fused")
    # Korean tokenizer flags (infer_cli.py:177-205)
    p.add_argument("--skip_tc", action="store_true",
                   help="use SkipTC syllable-boundary tokens")
    p.add_argument("--tokenizer_version", default="new", choices=["new", "legacy"],
                   help="SkipTC token '*' (new) vs '' (legacy)")
    p.add_argument("--use_n2gk_plus", dest="use_n2gk_plus", action="store_true",
                   default=None)
    p.add_argument("--no_n2gk_plus", dest="use_n2gk_plus", action="store_false")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer mode override (kor_allophone, kor_grapheme, ...)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_attn_int8(args.attn_int8, args.attn_path)
    dtype = getattr(torch, args.compute_dtype) if args.compute_dtype else None
    cfg = _load_toml(args.config) if args.config else {}

    def pick(name, default):
        v = getattr(args, name, None)
        if v is not None and v is not False:
            return v
        if name in cfg:
            return cfg[name]
        return default

    model_name = pick("model", "F5TTS_v1_Base")
    ref_audio = pick("ref_audio", None)
    ref_text = pick("ref_text", "")
    gen_text = pick("gen_text", None)
    gen_file = pick("gen_file", None)
    if gen_file:
        with open(gen_file, "r", encoding="utf-8") as f:
            gen_text = f.read()
    if not ref_audio or gen_text is None:
        raise SystemExit("need --ref_audio and --gen_text/--gen_file (or TOML config)")

    output_dir = pick("output_dir", "tests")
    output_file = pick(
        "output_file", f"infer_cli_{datetime.now().strftime('%Y%m%d_%H%M%S')}.wav"
    )
    nfe_step = int(pick("nfe_step", 32))
    cfg_strength = float(pick("cfg_strength", 2.0))
    sway = float(pick("sway_sampling_coef", -1.0))
    speed = float(pick("speed", 1.0))
    target_rms = float(pick("target_rms", 0.1))
    cross_fade = float(pick("cross_fade_duration", 0.15))
    fix_duration = pick("fix_duration", None)
    vocoder_name = pick("vocoder_name", "vocos")

    if args.model_cfg:
        model_cfg = load_model_config(args.model_cfg)
    else:
        model_cfg = preset_model_config(model_name)

    use_n2gk = args.use_n2gk_plus if args.use_n2gk_plus is not None else True
    model_obj = load_model(
        model_cfg,
        ckpt_path=pick("ckpt_file", None),
        vocab_file=pick("vocab_file", None),
        tokenizer=args.tokenizer,
        use_skip_tc=bool(pick("skip_tc", False)),
        use_n2gk_plus=use_n2gk,
        tokenizer_version=args.tokenizer_version,
        dtype=dtype,
        device=args.device,
        quantize=args.quantize,
    )
    vocoder = load_vocoder(
        vocoder_name, args.load_vocoder_from_local, args.vocoder_ckpt or "",
        device=args.device, dtype=dtype,
    )

    # multi-voice: TOML [voices.<name>] sections (infer_cli.py:355-382)
    voices = {"main": {"ref_audio": ref_audio, "ref_text": ref_text, "speed": speed}}
    for vname, vcfg in cfg.get("voices", {}).items():
        voices[vname] = {
            "ref_audio": vcfg["ref_audio"],
            "ref_text": vcfg.get("ref_text", ""),
            "speed": vcfg.get("speed", speed),
        }
    for vname, v in voices.items():
        v["ref_audio"], v["ref_text"] = preprocess_ref_audio_text(
            v["ref_audio"], v["ref_text"]
        )

    os.makedirs(output_dir, exist_ok=True)
    chunk_dir = os.path.join(output_dir, os.path.splitext(output_file)[0] + "_chunks")
    if args.save_chunk:
        os.makedirs(chunk_dir, exist_ok=True)

    segments = []
    sr = 24_000
    for text in re.split(r"(?=\[\w+\])", gen_text):
        if not text.strip():
            continue
        match = re.match(r"\[(\w+)\]", text)
        voice = match[1] if match and match[1] in voices else "main"
        if match and match[1] not in voices:
            print(f"Voice {match[1]} not found, using main.")
        text = re.sub(r"\[(\w+)\]", "", text).strip()
        v = voices[voice]
        print(f"Voice: {voice}")
        wav_seg, sr, _spec = infer_process(
            v["ref_audio"], v["ref_text"], text, model_obj, vocoder,
            mel_spec_type=vocoder_name, target_rms=target_rms,
            cross_fade_duration=cross_fade, nfe_step=nfe_step,
            cfg_strength=cfg_strength, sway_sampling_coef=sway,
            speed=v.get("speed", speed),
            fix_duration=float(fix_duration) if fix_duration else None,
            seed=args.seed, attn_path=args.attn_path, attn_int8=args.attn_int8,
        )
        segments.append(wav_seg)
        if args.save_chunk:
            tag = text[:200]
            save_wav(os.path.join(chunk_dir, f"{len(segments) - 1}_{tag}.wav"),
                     wav_seg, sr)

    if segments:
        final = np.concatenate(segments)
        out_path = os.path.join(output_dir, output_file)
        save_wav(out_path, final, sr)
        if args.remove_silence:
            remove_silence_for_generated_wav(out_path)
        print(out_path)


if __name__ == "__main__":
    main()

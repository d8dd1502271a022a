"""Decompose one served request's latency into its pipeline stages
(counterpart of scripts/profile_serving_request.py).

Mirrors the fused serving path (serving/server.py's single-request call,
infer/utils_infer.infer_batch_process's steps) stage by stage on
F5TTS_v1_Base + Vocos in bf16 with seeded random weights (AdaLN-zero layers
re-drawn), and times each stage on the host clock with a fence at its end:
torch.cuda.synchronize() after the device work, a host copy for a readback.
Stages: ref_mel_ms (the reference's log-mel, read back), tokenize_ms,
sample_ms (cfm_sample with the fused vocoder: every step and the decode),
wav_readback_ms, mel_readback_ms, host_slice_ms, and their total_ms, to
attribute the gap between the sampler's device time and a request's served
latency (scripts/bench_serving_throughput.py).

    python -m korean_f5_tts_tpu_torch.scripts.profile_serving_request [--reps 3]

Runs on the card unless `--device cpu` is given (no card raises); `--tiny`
cuts the model to dim 64, depth 2 and the Vocos to dim 32, 2 layers for a
CPU smoke run. Prints a JSON line per run and the stages' medians last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def smoke_model_config(name: str, tiny: bool):
    """The preset's ModelConfig, or its tiny cut (dim 64, depth 2, 2 heads,
    text_dim 32, one conv layer) for CPU smoke runs."""
    import dataclasses

    from korean_f5_tts_tpu_torch.config import preset_model_config

    cfg = preset_model_config(name)
    if tiny:
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, dim=64, depth=2, heads=2, text_dim=32, conv_layers=1))
    return cfg


def load_random_model(name: str, device, tiny: bool = False, quantize: bool = False):
    """(model, vocoder): the preset and a Vocos (or their tiny cuts: the DiT
    of smoke_model_config, a Vocos of dim 32, 2 layers) with seeded random
    weights, the AdaLN-zero layers re-drawn (left at zero they gate every
    block off), bf16 on the card and fp32 on the CPU; int8 block linears
    with quantize."""
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = load_model(smoke_model_config(name, tiny), dtype=dtype, device=device,
                       quantize=quantize)
    redraw_zero_init(model.params, seed=1)  # the AdaLN layers are never quantized
    if tiny:
        vcfg = VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
        return model, Vocos(init_vocos(vcfg, seed=0, device=device, dtype=dtype), vcfg)
    return model, load_vocoder("vocos", device=device, dtype=dtype)


def run(device="cuda", nfe_step: int = 16, reps: int = 3, tiny: bool = False) -> dict:
    from korean_f5_tts_tpu_torch.infer.utils_infer import hop_length, target_sample_rate
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, list_str_to_tensor, tokenize_text

    model, vocoder = load_random_model("F5TTS_v1_Base", device, tiny)
    dev = model.device
    fused = (vocoder.params, vocoder.vcfg)
    sr = 24_000
    rng = np.random.default_rng(0)
    ref = (0.05 * np.sin(2 * np.pi * 220 * np.arange(int(4.6 * sr)) / sr)
           + 0.01 * rng.standard_normal(int(4.6 * sr))).astype(np.float32)
    ref_text = "the quick brown fox jumps over the lazy dog. "
    target_text = ref_text * 2

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    stages: dict[str, list[float]] = {}

    def run_once(record: bool):
        t = {}
        t0 = time.perf_counter()
        mel = model.mel_of_wav(ref)  # the front end on the device, read back
        t["ref_mel_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        toks = tokenize_text([ref_text + target_text], tokenizer_type=model.tokenizer_type,
                             vocab=model.vocab_char_map, use_n2gk_plus=model.use_n2gk_plus,
                             use_skip_tc=model.use_skip_tc, legacy=model.tokenizer_legacy)
        text_ids = (list_str_to_idx(toks, model.vocab_char_map) if model.vocab_char_map
                    else list_str_to_tensor(["".join(x) for x in toks]))
        t["tokenize_ms"] = (time.perf_counter() - t0) * 1e3

        ref_len = mel.shape[0]
        dur = ref_len + int(ref_len * len(target_text.encode()) / len(ref_text.encode()))
        t0 = time.perf_counter()
        out, wav_full = cfm_sample(model.params, model.arch, mel[None], text_ids, dur,
                                   steps=nfe_step, cfg_strength=2.0, sway_sampling_coef=-1.0,
                                   seed=0, vocoder_fused=fused)
        fence()
        t["sample_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        wav_np = wav_full.float().cpu().numpy()
        t["wav_readback_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        out.float().cpu().numpy()
        t["mel_readback_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        wav_np[0, ref_len * hop_length: dur * hop_length].copy()
        t["host_slice_ms"] = (time.perf_counter() - t0) * 1e3
        t["total_ms"] = sum(t.values())
        if record:
            for k, v in t.items():
                stages.setdefault(k, []).append(v)
        return t, dur, ref_len

    tw, dur, ref_len = run_once(False)
    print("warmup:", json.dumps(tw), flush=True)
    for _ in range(reps):
        tr, dur, ref_len = run_once(True)
        print(json.dumps(tr), flush=True)
    return {"stage_ms_median": {k: float(np.median(v)) for k, v in stages.items()},
            "reps": reps, "nfe_step": nfe_step,
            "gen_audio_s": (dur - ref_len) * hop_length / target_sample_rate,
            "duration_frames": dur,
            "model": "tiny (smoke)" if tiny else "F5TTS_v1_Base bf16",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "protocol": "serving stage profile"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--nfe_step", type=int, default=16)
    p.add_argument("--tiny", action="store_true", help="dim-64 model for CPU smoke runs")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    result = run(args.device, args.nfe_step, args.reps, args.tiny)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

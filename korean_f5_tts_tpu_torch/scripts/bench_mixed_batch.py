"""Mixed-duration batch synthesis: wall seconds per generated audio second,
joint against split_by_bucket (counterpart of scripts/bench_mixed_batch.py).

A batch whose durations run from 50% to 100% of the longest item pays, in one
joint call, for every padded row of the dense products (qkv, FF, LN):
cfm_sample(split_by_bucket=True) regroups it so that each item runs at its
own duration bucket. This measures both paths through the port's cfm_sample
host wrapper (reference protocol: eval batch synthesis,
`src/f5_tts/eval/utils_eval.py:95-98`, duration-bucketed prompts), on
F5TTS_v1_Base's widths (dim 1024, depth 22, 16 heads x 64, text_num_embeds
2545) with seeded random weights (AdaLN-zero layers re-drawn), bf16 or int8
block linears, 16 NFE, CFG 2, sway -1, seed 0. Each timed run ends in
torch.cuda.synchronize(). `l20_baseline` is the reference's figure for its
L20 card (0.0394 wall s per generated s, `BASELINE.md`), for scale only: it
was taken on another card and another protocol.

    python -m korean_f5_tts_tpu_torch.scripts.bench_mixed_batch           # bf16
    python -m korean_f5_tts_tpu_torch.scripts.bench_mixed_batch --int8

Runs on the card unless `--device cpu` is given (no card raises); `--tiny`
cuts the model to dim 64, depth 2 for a CPU smoke run. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

L20_BASELINE = 0.0394  # the reference's L20 figure (BASELINE.md)


def build_params(device, int8: bool = False, tiny: bool = False):
    """(params, arch): F5TTS_v1_Base's DiT (or the tiny cut) in bf16 on the
    card, fp32 on the CPU, AdaLN-zero layers re-drawn, int8 block linears
    when asked."""
    from korean_f5_tts_tpu_torch.config import DiTConfig
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.modules import cast_params
    from korean_f5_tts_tpu_torch.models.quant import quantize_params

    arch = DiTConfig(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                     conv_layers=4, text_num_embeds=2545)
    if tiny:
        arch = DiTConfig(dim=64, depth=2, heads=2, ff_mult=2, text_dim=32,
                         conv_layers=1, text_num_embeds=2545)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = redraw_zero_init(init_dit(arch, seed=0, device=device), seed=1)
    params = cast_params(params, dtype)
    return (quantize_params(params) if int8 else params), arch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device="cuda", int8: bool = False, batch: int = 4, iters: int = 5, steps: int = 16,
        tiny: bool = False) -> dict:
    """Both paths on one seeded mixed batch: one untimed run each, then
    `iters` timed runs; wall seconds per generated second, their median,
    min, max and every run."""
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(device)
    params, arch = build_params(device, int8, tiny)
    hop, sr = 256, 24_000
    b, cond_len, total_len = batch, 432, 1536
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((b, cond_len, 100)).astype(np.float32)
    text = rng.integers(1, 2545, (b, 160)).astype(np.int32)
    # durations 50%..100% of the largest bucket
    durations = np.linspace(total_len // 2, total_len, b).astype(np.int64)
    lens = np.full((b,), cond_len, dtype=np.int64)
    gen_seconds = float((durations - cond_len).sum() * hop / sr)

    results = {}
    for split in (False, True):
        def once():
            out, _ = cfm_sample(params, arch, cond, text, durations, lens=lens,
                                steps=steps, cfg_strength=2.0, sway_sampling_coef=-1.0,
                                seed=0, split_by_bucket=split)
            _sync(device)
            return out

        once()  # untimed: the first call builds and loads the kernels
        per_iter = []
        for _ in range(iters):
            t0 = time.perf_counter()
            once()
            per_iter.append((time.perf_counter() - t0) / gen_seconds)
        results["split" if split else "joint"] = per_iter

    def stats(xs):
        return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs), "runs": xs}

    return {
        "metric": "mixed_batch_wall_per_generated_s",
        "batch": b, "durations": durations.tolist(), "steps": steps,
        "mode": "int8" if int8 else ("bf16" if device.type == "cuda" else "fp32"),
        "model": "tiny (smoke)" if tiny else "F5TTS_v1_Base",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "joint": stats(results["joint"]),
        "split": stats(results["split"]),
        "l20_baseline": L20_BASELINE,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--int8", action="store_true", help="int8 block linears")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tiny", action="store_true", help="dim-64 model for CPU smoke runs")
    args = p.parse_args(argv)
    result = run(args.device, args.int8, args.batch, args.iters, args.steps, args.tiny)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

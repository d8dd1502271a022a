"""What cfm_sample's dtype rule costs: one offline chunk of F5TTS_v1_Base
(seeded weights, the AdaLN-zero layers re-drawn) with bf16 weights and
with int8 weights over them, sampled from the same cond twice in one
process, in turns (bf16 cond, fp32 cond, fp32 cond, bf16 cond, ...):

  fp32 cond  cfm_sample's rule, as the JAX sampler: fp32 activations on
             the weights widened once per call, every kernel's fp32 form;
  bf16 cond  the all-bf16 function (what serve_sample computes): bf16
             activations, the bf16 kernels.

The chunk is the bench protocol's shape at the offline defaults: cond 432
frames, duration 1376 (bucket 128: 1408 frames), 160 text ids, 32 NFE, CFG
2, sway -1. Prints one JSON line: per weights and cond dtype the wall ms
of each of RUNS timed runs (host clock around a synchronised call), their
median, the device busy ms of one profiled call (torch.profiler, taken
after the timed runs), the bytes of the weights at rest, the bytes
allocated before one call and at its peak (torch.cuda.max_memory_allocated;
peak minus before is what the call adds: the widened copy under fp32 cond
and the activations), the kernel launches of one call and the card's name
and power limit.

    python -m korean_f5_tts_tpu_torch.scripts.offline_chunk_cost [--out x.json]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.utils.misc import require_device

COND, DURATION, N_TEXT, NFE, RUNS = 432, 1376, 160, 32, 4


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name()


def _busy_ms(call) -> float:
    """Device busy time of one call: the CUDA kernels' self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def build(dev: torch.device):
    """(arch, {"bf16": tree, "int8": tree}) of F5TTS_v1_Base, seeded."""
    import dataclasses

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.modules import cast_params
    from korean_f5_tts_tpu_torch.models.quant import quantize_params

    arch = dataclasses.replace(preset_model_config("F5TTS_v1_Base").arch, text_num_embeds=2545)
    bf16 = cast_params(redraw_zero_init(init_dit(arch, seed=0, device=dev), seed=1),
                       torch.bfloat16)
    return arch, {"bf16": bf16, "int8": quantize_params(bf16)}


def run() -> dict:
    from korean_f5_tts_tpu_torch.models.cfm import cfm_sample

    dev = require_device("cuda")
    arch, trees = build(dev)
    rng = np.random.default_rng(0)
    cond32 = torch.as_tensor(rng.standard_normal((1, COND, arch.mel_dim)).astype(np.float32),
                             device=dev)
    conds = {"fp32": cond32, "bf16": cond32.to(torch.bfloat16)}
    text = rng.integers(1, arch.text_num_embeds, (1, N_TEXT)).astype(np.int32)
    result = {"card": _card(), "arch": {"dim": arch.dim, "depth": arch.depth,
                                        "heads": arch.heads},
              "cond": COND, "duration": DURATION, "nfe": NFE}

    def call(params, cond_dtype: str):
        out, _ = cfm_sample(params, arch, conds[cond_dtype], text, DURATION, steps=NFE,
                            cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0)
        torch.cuda.synchronize(dev)
        return out

    entries = {}
    with torch.inference_mode():
        for weights, params in trees.items():
            entry = entries[weights] = {}
            for cd in ("bf16", "fp32"):  # untimed: builds and loads the kernels
                reset_launch_counts()
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                out = call(params, cd)
                entry[cd] = {"out_dtype": str(out.dtype).removeprefix("torch."),
                             "launches": {k: v for k, v in launch_counts().items() if v},
                             "weights_bytes": sum(t.numel() * t.element_size()
                                                  for t in flatten_tree(params).values()),
                             "allocated_before_bytes": before,
                             "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
                             "wall_ms": []}
                del out
            for i in range(RUNS):
                for cd in (("bf16", "fp32") if i % 2 == 0 else ("fp32", "bf16")):
                    t0 = time.perf_counter()
                    call(params, cd)
                    entry[cd]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            for cd in ("bf16", "fp32"):
                entry[cd]["wall_ms_median"] = float(np.median(entry[cd]["wall_ms"]))
        # after every timed run: once the profiler has run, later launches cost more
        for weights, params in trees.items():
            for cd in ("bf16", "fp32"):
                entries[weights][cd]["device_busy_ms"] = _busy_ms(lambda: call(params, cd))
            result[f"{weights}_weights"] = {f"{cd}_cond": v for cd, v in entries[weights].items()}
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    result = run()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()

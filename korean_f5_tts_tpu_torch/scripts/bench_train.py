"""Training throughput of the port: mel frames per second of train_step.

Counterpart of korean_f5_tts_tpu/scripts/bench_train.py:17-122, same
protocol: F5TTS_v1_Base widths (text_num_embeds 2545), the JAX package's
init (AdaLN-zero layers at zero), make_optimizer's defaults, EMA on, one
batch of random mels at full length, one warm-up step, then `--iters`
timed steps, each with its own seed. Prints one JSON line with
train_frames_per_s and step_ms.

    python -m korean_f5_tts_tpu_torch.scripts.bench_train             # kernels
    python -m korean_f5_tts_tpu_torch.scripts.bench_train --no-kernels # plain
    python -m korean_f5_tts_tpu_torch.scripts.bench_train --remat dots --io_overlap

The kernels switch is an argument (train_step's `kernels`), never an
environment variable. `--remat` takes the remat policy ("full", the
default, or "dots"); `--no-remat` keeps every activation. `--io_overlap`
also times the step with a host wav -> mel of the whole batch before each
step, synchronous and behind the Trainer's prefetch thread
(scripts/bench_train.py:87-120). A time is taken on a CUDA device unless
`--device` names another; the JSON says which device it was.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(frames: int = 9_600, seq_len: int = 1_200, bf16: bool = True, iters: int = 8,
        remat: bool | str = True, ema: bool = True, kernels: bool = True, device: str = "cuda",
        dim: int = 1024, depth: int = 22, io_overlap: bool = False) -> dict:
    """The protocol at F5TTS_v1_Base's widths; dim and depth cut the model
    for a run on the CPU (heads = dim / 64). remat: True or "full", "dots",
    or False."""
    from korean_f5_tts_tpu_torch.config import CFMConfig, DiTConfig
    from korean_f5_tts_tpu_torch.models.dit import init_dit
    from korean_f5_tts_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_train: no CUDA device (pass --device cpu for a CPU run)")
    batch = max(frames // seq_len, 1)
    policy = "full" if remat is True else remat or "full"
    arch = DiTConfig(dim=dim, depth=depth, heads=dim // 64, ff_mult=2, text_dim=512,
                     conv_layers=4, text_num_embeds=2545, checkpoint_activations=bool(remat),
                     remat_policy=policy)
    opt = make_optimizer()
    state = init_train_state(init_dit(arch, seed=0, device=dev), opt, use_ema=ema)
    rng = np.random.default_rng(0)
    data = {
        "mel": torch.from_numpy(rng.standard_normal((batch, seq_len, 100)).astype(np.float32)),
        "text": torch.from_numpy(rng.integers(1, 2545, (batch, 256)).astype(np.int32)),
        "lens": torch.full((batch,), seq_len, dtype=torch.int32),
    }
    data = {k: v.to(dev) for k, v in data.items()}
    dtype = torch.bfloat16 if bf16 else None

    def step(seed: int):
        return train_step(state, data, seed, arch, opt, CFMConfig(), compute_dtype=dtype,
                          kernels=kernels)[1]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    float(step(1))
    sync()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(iters)]
    sync()
    dt = (time.perf_counter() - t0) / iters
    if not all(np.isfinite(float(x)) for x in losses):
        raise RuntimeError("bench_train: non-finite loss")
    result = {
        "metric": "train_frames_per_s",
        "value": round(batch * seq_len / dt, 1),
        "unit": f"mel frames/s per device (batch {batch} x {seq_len}, "
                f"{'bf16' if bf16 else 'fp32'}, {'kernels' if kernels else 'plain'}, "
                f"remat {policy if remat else 'off'})",
        "step_ms": round(dt * 1e3, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
    }
    if io_overlap:
        result.update(_io_overlap(step, sync, batch, seq_len, rng))
    return result


def _io_overlap(step, sync, batch: int, seq_len: int, rng, steps: int = 4) -> dict:
    """The input-pipeline overlap check (bench_train.py:87-120): a host-side
    wav -> mel of the whole batch before every step, once in line and once
    behind the Trainer's _Prefetcher thread, which hides it behind the
    device step."""
    from korean_f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
    from korean_f5_tts_tpu_torch.train.trainer import _Prefetcher

    mel_cfg = MelConfig()
    wavs = torch.from_numpy(
        rng.standard_normal((batch, seq_len * mel_cfg.hop_length)).astype(np.float32))

    def timed_epoch(prefetch: bool) -> float:
        gen = (log_mel_spectrogram(wavs, mel_cfg).numpy() for _ in range(steps))
        stream = _Prefetcher(gen, depth=2) if prefetch else gen
        t0 = time.perf_counter()
        pend = [step(2) for _ in stream]
        sync()
        if not all(np.isfinite(float(x)) for x in pend):
            raise RuntimeError("bench_train: non-finite loss")
        return (time.perf_counter() - t0) / steps

    sync_ms = timed_epoch(False) * 1e3
    overlap_ms = timed_epoch(True) * 1e3
    return {"io_sync_step_ms": round(sync_ms, 1), "io_prefetch_step_ms": round(overlap_ms, 1),
            "io_overlap_gain": round(sync_ms / max(overlap_ms, 1e-9), 3)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=9_600,
                   help="frames per step (24GB-GPU finetune budget = 9600)")
    p.add_argument("--seq_len", type=int, default=1_200)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--remat", nargs="?", const="full", default="full", choices=("full", "dots"),
                   help="activation checkpointing per DiT block, and its policy")
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--no-ema", dest="ema", action="store_false", default=True)
    p.add_argument("--kernels", action="store_true", default=True,
                   help="the Hopper kernels (default); --no-kernels runs their plain versions")
    p.add_argument("--no-kernels", dest="kernels", action="store_false")
    p.add_argument("--device", default="cuda")
    p.add_argument("--io_overlap", action="store_true",
                   help="also time the step with a host wav -> mel per batch, in line and "
                        "behind the Trainer's prefetch thread")
    args = p.parse_args(argv)
    result = run(frames=args.frames, seq_len=args.seq_len, bf16=args.bf16, iters=args.iters,
                 remat=args.remat, ema=args.ema, kernels=args.kernels, device=args.device,
                 io_overlap=args.io_overlap)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

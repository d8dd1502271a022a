"""Offline serving benchmark: RTF and its stage decomposition, and the
single-request latency of the fused path (counterpart of
korean_f5_tts_tpu/serving/benchmark.py).

    python -m korean_f5_tts_tpu_torch.serving.benchmark [--latency] [--n_items 26]

Runs on the card unless --device cpu is given (no card raises). Every timed
region ends in a host readback, or torch.cuda.synchronize() where nothing is
read back, so the times are of finished work. The result is one JSON line
with the JAX benchmark's keys.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from korean_f5_tts_tpu_torch.infer.utils_infer import vocoder_input
from korean_f5_tts_tpu_torch.models.cfm import DEFAULT_DURATION_BUCKET, cfm_sample, serve_sample

HOP, SR = 256, 24_000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _inputs(model_obj, ref_seconds: float, gen_seconds: float):
    """Seeded reference mel and text ids of the benchmark's one prompt."""
    ref_frames = int(ref_seconds * SR / HOP)
    total_frames = ref_frames + int(gen_seconds * SR / HOP)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((1, ref_frames, model_obj.mel.n_mel_channels)).astype(np.float32)
    text = rng.integers(1, max(model_obj.arch.text_num_embeds - 1, 2), (1, 160)).astype(np.int32)
    return cond, text, ref_frames, total_frames


def run_offline_benchmark(model_obj, vocoder, n_items: int = 26, nfe_step: int = 16,
                          gen_seconds: float = 10.0, ref_seconds: float = 4.6,
                          warmup: int = 2, profile_dir: str | None = None,
                          attn_path: str = "default", attn_int8: str | None = None) -> dict:
    """n_items utterances one after the other: the sampler (cfm_sample) and
    the vocoder as two timed stages. profile_dir: a torch.profiler trace of
    the timed loop, written there as trace.json."""
    dev = model_obj.device
    cond, text, _, total_frames = _inputs(model_obj, ref_seconds, gen_seconds)

    def dit_stage():
        out, _ = cfm_sample(model_obj.params, model_obj.arch, cond, text,
                            duration=total_frames, steps=nfe_step, cfg_strength=2.0,
                            sway_sampling_coef=-1.0, seed=0, attn_path=attn_path,
                            attn_int8=attn_int8)
        _sync(dev)
        return out

    def voc_stage(mel):
        wav = vocoder(vocoder_input(vocoder, mel.transpose(1, 2), dev))
        _sync(dev)
        return wav

    for _ in range(warmup):
        mel = dit_stage()
        if vocoder is not None:
            voc_stage(mel)

    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()

    dit_times, voc_times = [], []
    for _ in range(n_items):
        t0 = time.perf_counter()
        mel = dit_stage()
        t1 = time.perf_counter()
        if vocoder is not None:
            voc_stage(mel)
        t2 = time.perf_counter()
        dit_times.append(t1 - t0)
        voc_times.append(t2 - t1)

    if prof is not None:
        import os

        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    total = float(np.sum(dit_times) + np.sum(voc_times))
    audio_s = n_items * gen_seconds
    return {
        "n_items": n_items,
        "nfe_step": nfe_step,
        "rtf": total / audio_s,
        "dit_time_avg_ms": float(np.mean(dit_times) * 1e3),
        "vocoder_time_avg_ms": float(np.mean(voc_times) * 1e3),
        "total_s": total,
        "audio_s": audio_s,
    }


def run_latency_benchmark(model_obj, vocoder, n_items: int = 26, nfe_step: int = 16,
                          gen_seconds: float = 10.0, ref_seconds: float = 4.6,
                          warmup: int = 2, attn_path: str = "default",
                          attn_int8: str | None = None) -> dict:
    """Single-request latency through the fused sampler + vocoder call: the
    server's fast path (serve_sample on a reference mel already on the
    device, one int16 readback). The host-device round trip (a scalar through
    a null kernel) and the readback of a waveform-sized int16 array are timed
    on their own and reported beside it under the JAX benchmark's keys, less
    reference_l20_avg_ms: that constant is another card's published number
    (BASELINE.md), not a measurement of this run."""
    if not (hasattr(vocoder, "params") and hasattr(vocoder, "vcfg")):
        raise ValueError("latency mode needs a vocoder with .params and .vcfg "
                         "(api.load_vocoder)")
    fused = (vocoder.params, vocoder.vcfg)
    dev = model_obj.device
    cond, text, ref_frames, total_frames = _inputs(model_obj, ref_seconds, gen_seconds)
    # the reference mel is on the device before the timed region: the serving
    # fast path caches it there, so steady-state requests do not upload it
    cond = torch.as_tensor(cond, device=dev)
    _sync(dev)

    def request():
        wav, _ = serve_sample(model_obj.params, model_obj.arch, cond, text,
                              np.array([total_frames]), np.array([ref_frames]),
                              vocoder_fused=fused, steps=nfe_step, cfg_strength=2.0,
                              sway_sampling_coef=-1.0, seed=0, attn_path=attn_path,
                              attn_int8=attn_int8)
        return wav.cpu().numpy()  # the host transfer a server must make

    for _ in range(warmup):
        request()

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times) * 1e3)

    roundtrip_ms = median_ms(lambda: float(torch.zeros((), device=dev) + 1))
    bucket_frames = int(math.ceil(total_frames / DEFAULT_DURATION_BUCKET)
                        * DEFAULT_DURATION_BUCKET)
    wz = torch.zeros((bucket_frames * HOP,), dtype=torch.int16, device=dev)
    wav_readback_ms = median_ms(lambda: (wz + 1).cpu().numpy())

    lat = []
    for _ in range(n_items):
        t0 = time.perf_counter()
        request()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    return {
        "protocol": "fused single-request latency (1 program, 1 readback)",
        "n_items": n_items,
        "nfe_step": nfe_step,
        "gen_seconds": gen_seconds,
        "latency_avg_ms": float(lat_ms.mean()),
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p95_ms": float(np.percentile(lat_ms, 95)),
        "relay_roundtrip_ms": roundtrip_ms,
        "wav_readback_ms": wav_readback_ms,
        "latency_minus_roundtrip_ms": float(lat_ms.mean() - roundtrip_ms),
        "latency_minus_relay_ms": float(lat_ms.mean() - wav_readback_ms),
    }


def build_parser() -> argparse.ArgumentParser:
    from korean_f5_tts_tpu_torch.serving.server import add_model_arguments

    p = argparse.ArgumentParser(prog="f5-tts_serving-benchmark")
    add_model_arguments(p)
    p.add_argument("--nfe_step", type=int, default=16)
    p.add_argument("--n_items", type=int, default=26)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--latency", action="store_true",
                   help="single-request latency through the fused sampler + vocoder call")
    return p


def main(argv=None):
    from korean_f5_tts_tpu_torch.serving.server import load_from_arguments

    args = build_parser().parse_args(argv)
    model_obj, vocoder = load_from_arguments(args)
    kw = dict(n_items=args.n_items, nfe_step=args.nfe_step, attn_path=args.attn_path,
              attn_int8=args.attn_int8)
    if args.latency:
        result = run_latency_benchmark(model_obj, vocoder, **kw)
    else:
        result = run_offline_benchmark(model_obj, vocoder, profile_dir=args.profile_dir, **kw)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

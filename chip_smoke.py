#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (korean_f5_tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit; build the Hopper kernels from
     korean_f5_tts_tpu_torch/csrc and print the build time;
  2. hold each kernel against its plain PyTorch version at the main-path
     shapes in bf16, plus ragged and edge cases, and time both with CUDA
     events (20 runs after a warm-up);
  3. build F5TTS_v1_Base + Vocos in bf16 with seeded random weights (AdaLN-
     zero layers re-drawn), serve three HTTP /tts requests through the port's
     serve() (one alone, then two concurrently as one batch of 2), check the
     audio and that every kernel's launch count rose by the expected amount;
  4. run the bench protocol (cond 432, total 1376, bucket 1536, 16 NFE,
     CFG 2, sway -1, batch 1) through the sampler with kernels and with the
     plain versions, and compare the mels;
  5. time the port's RTF at that protocol (1 warm-up, 10 timed runs).
The line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.

It needs a CUDA card and the repository checkout it sits in; it imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT_PKG = ROOT / "korean_f5_tts_tpu_torch"
REPLACES = {
    "flash_prefix": "korean_f5_tts_tpu/ops/flash_prefix.py:558",
    "ff_block": "korean_f5_tts_tpu/ops/ff_block.py:40",
    "grouped_conv": "korean_f5_tts_tpu/ops/grouped_conv.py:69",
}
SOURCES = {
    "flash_prefix": "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu",
    "ff_block": "korean_f5_tts_tpu_torch/csrc/ff_block.cu",
    "grouped_conv": "korean_f5_tts_tpu_torch/csrc/grouped_conv.cu",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, runs: int = 20) -> float:
    """Mean device time of fn() over `runs` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def compare(name: str, got, want, rel_bound: float) -> tuple[float, float]:
    """max-abs and relative-L2 error of got vs want (fp32), checked against
    max_abs <= 2**-6 * max(1, max|want|) (4 bf16 ulps at the output's scale)
    and rel <= rel_bound."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    max_abs = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    abs_bound = 2.0 ** -6 * max(1.0, w.abs().max().item())
    ok = max_abs <= abs_bound and rel <= rel_bound
    print(f"  {name}: max_abs_err {max_abs:.3e} (bound {abs_bound:.3e}) "
          f"rel_err {rel:.3e} (bound {rel_bound:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs, rel


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_attention(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

    def case(label, H, n, d, lens):
        q, k, v = (torch.randn((H, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        got = fp.flash_prefix_folded(q, k, v, kv)
        want = fp.prefix_attention_reference(q, k, v, kv)
        torch.cuda.synchronize()
        return compare(f"flash_prefix {label}", got, want, 1e-2), (q, k, v, kv)

    print("kernel A, prefix attention (bf16, rel bound 1e-2: p rounds to bf16 "
          "before P.V in the kernel, after normalisation in the plain version)")
    (max_abs, _), (q, k, v, kv) = case("main H=32 n=1536 d=64 kv=1376", 32, 1536, 64,
                                      [1376] * 32)
    case("n=1000 kv=1", 4, 1000, 64, [1] * 4)
    case("n=1000 kv=700", 4, 1000, 64, [700] * 4)
    case("n=1000 kv=n", 4, 1000, 64, [1000] * 4)
    mixed = torch.randint(1, 1001, (8,), generator=gen, device=dev).tolist()
    case(f"n=1000 mixed kv={mixed}", 8, 1000, 64, mixed)
    case("n=300 d=128 mixed", 4, 300, 128, [300, 1, 77, 129])
    ms = cuda_time_ms(lambda: fp.flash_prefix_folded(q, k, v, kv))
    plain_ms = cuda_time_ms(lambda: fp.prefix_attention_reference(q, k, v, kv))
    print(f"  time at main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def check_ff(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb

    def uni(shape, bound):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)

    def inputs(B, n, d=1024, dff=2048):
        h = torch.randn((B, n, d), generator=gen, device=dev).to(torch.bfloat16)
        sc, sh = uni((d,), 0.3), uni((d,), 0.3)
        gate = uni((d,), 1.0)
        w1, b1 = uni((dff, d), d ** -0.5), uni((dff,), d ** -0.5)
        w2, b2 = uni((d, dff), dff ** -0.5), uni((d,), dff ** -0.5)
        return h, sc, sh, gate, w1, b1, w2, b2

    print("kernel B, FF half-block (bf16, rel bound 5e-3: same rounding points, "
          "fp32 sums in another order)")
    args = inputs(2, 1536)
    max_abs, _ = compare("ff_block main m=3072 d=1024 dff=2048",
                         fb.ff_block_fused(*args), fb.ff_block_reference(*args), 5e-3)
    ragged = inputs(1, 1000)
    compare("ff_block ragged m=1000", fb.ff_block_fused(*ragged),
            fb.ff_block_reference(*ragged), 5e-3)
    ms = cuda_time_ms(lambda: fb.ff_block_fused(*args))
    plain_ms = cuda_time_ms(lambda: fb.ff_block_reference(*args))
    print(f"  time at main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def check_conv(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import grouped_conv as gc

    def inputs(B, N, C=1024, k=31, groups=16):
        bound = (C // groups * k) ** -0.5
        x = torch.randn((B, N, C), generator=gen, device=dev).to(torch.bfloat16)
        w = ((torch.rand((k, C // groups, C), generator=gen, device=dev) * 2 - 1)
             * bound).to(torch.bfloat16)
        b = ((torch.rand((C,), generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)
        return x, w, b

    print("kernel C, grouped conv1d + Mish (bf16, rel bound 5e-3: fp32 sums in "
          "another order)")
    x, w, b = inputs(2, 1536)
    max_abs, _ = compare("grouped_conv main B=2 N=1536 C=1024 k=31",
                         gc.grouped_conv1d_mish(x, w, b, 16),
                         gc.grouped_conv1d_mish_reference(x, w, b, 16), 5e-3)
    xr, wr, br = inputs(1, 1000)
    compare("grouped_conv ragged N=1000", gc.grouped_conv1d_mish(xr, wr, br, 16),
            gc.grouped_conv1d_mish_reference(xr, wr, br, 16), 5e-3)
    compare("grouped_conv no bias, no mish", gc.grouped_conv1d_mish(xr, wr, None, 16, False),
            gc.grouped_conv1d_mish_reference(xr, wr, None, 16, False), 5e-3)
    ms = cuda_time_ms(lambda: gc.grouped_conv1d_mish(x, w, b, 16))
    plain_ms = cuda_time_ms(lambda: gc.grouped_conv1d_mish_reference(x, w, b, 16))
    print(f"  time at main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phase 3: full-width model behind the HTTP server
# ---------------------------------------------------------------------------

HOP, SR = 256, 24_000
DEPTH, STEPS = 22, 16
REF_TEXT = "This is the reference speech."


def build_model(dev):
    """F5TTS_v1_Base + Vocos in bf16, seeded random weights, AdaLN re-drawn."""
    import torch

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import count_params, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos

    model = load_model(preset_model_config("F5TTS_v1_Base"),
                       vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"),
                       dtype=torch.bfloat16, seed=0, device=dev)
    redraw_zero_init(model.params, seed=1)
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    arch = model.arch
    print(f"  DiT dim {arch.dim} depth {arch.depth} heads {arch.heads}x{arch.dim_head} "
          f"ff_mult {arch.ff_mult} text_dim {arch.text_dim} text embeds {arch.text_num_embeds}: "
          f"{count_params(model.params) / 1e6:.1f} M params; Vocos "
          f"{count_params(vocoder.params) / 1e6:.1f} M params; bf16")
    if arch.depth != DEPTH:
        fail(f"expected depth {DEPTH}, got {arch.depth}")
    return model, vocoder


def chirp_wav_b64(seconds: float) -> tuple[str, int]:
    """A 0.3-amplitude chirp as a base64 16-bit wav; returns (b64, samples)."""
    import base64
    import io

    import numpy as np
    from scipy.io import wavfile

    t = np.arange(int(seconds * SR)) / SR
    wav = 0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * t) * t)
    buf = io.BytesIO()
    wavfile.write(buf, SR, (wav * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode(), wav.size


def expected_samples(ref_samples: int, target: str) -> int:
    """(duration - ref_frames) * hop for the server's byte-ratio duration rule."""
    ref_frames = ref_samples // HOP + 1          # center-padded mel frames
    ref_bytes = len(REF_TEXT.encode()) + 1       # the server appends a space
    dur = ref_frames + int(ref_frames * len(target.encode()) / ref_bytes)
    return (dur - ref_frames) * HOP


def phase3_serve(model, vocoder) -> dict[str, int]:
    import io
    import threading
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving.server import serve

    print("phase 3: serve() on localhost, 3 POST /tts requests (1 alone, then 2 at once)")
    httpd, service = serve(model, vocoder, host="127.0.0.1", port=0, max_batch=8,
                           max_wait_us=300_000)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    ref_b64, ref_samples = chirp_wav_b64(3.0)
    targets = ["Hello from the first request of the port.",
               "A second request in a batch.", "A third one, batched as well!"]
    results: dict[int, tuple] = {}

    def post(i: int, seed: int) -> None:
        body = json.dumps({"reference_audio": ref_b64, "reference_text": REF_TEXT,
                           "target_text": targets[i], "seed": seed}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            results[i] = (resp.status, resp.read(), time.perf_counter() - t0)

    try:
        reset_launch_counts()
        post(0, 11)
        pair = [threading.Thread(target=post, args=(i, 7)) for i in (1, 2)]
        for t in pair:
            t.start()
        for t in pair:
            t.join(timeout=600)
        counts = launch_counts()
        for i, target in enumerate(targets):
            if i not in results:
                fail(f"request {i} got no response")
            status, body, secs = results[i]
            sr, wav = wavfile.read(io.BytesIO(body))
            want = expected_samples(ref_samples, target)
            w = wav.astype(np.float64) / 32768.0
            rms = float(np.sqrt(np.mean(w * w))) if w.size else 0.0
            print(f"  request {i}: HTTP {status}, {secs:.2f} s, {wav.dtype} {sr} Hz, "
                  f"{wav.size} samples (expected {want}), rms {rms:.4f}")
            if status != 200 or sr != SR or wav.dtype != np.int16 or wav.ndim != 1:
                fail(f"request {i}: not a 24 kHz mono int16 wav")
            if wav.size != want or not np.isfinite(w).all() or rms <= 0:
                fail(f"request {i}: wrong length or silent audio")
        sizes = service.stats["batch_sizes"]
        print(f"  batches {service.stats['batches']} with sizes {sizes}")
        if sorted(sizes) != [1, 2]:
            fail(f"expected one batch of 1 and one of 2, got {sizes}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()
        server_thread.join(timeout=10)
    batches = len(sizes)
    want = {"flash_prefix": DEPTH * STEPS * batches, "ff_block": DEPTH * STEPS * batches,
            "grouped_conv": 2 * STEPS * batches}
    print(f"  kernel launches during serving: {counts} (expected {want})")
    if counts != want:
        fail("a kernel of the main path did not run as often as the path requires")
    return counts


# ---------------------------------------------------------------------------
# phases 4 and 5: bench protocol, kernels vs plain, and RTF
# ---------------------------------------------------------------------------


def bench_inputs(dev, cond_len=432, total_len=1376, n_bucket=1536):
    """bench.py's single-utterance protocol with seeded inputs."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    cond = torch.randn((1, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    cond_mask = torch.zeros((1, n_bucket, 1), dtype=torch.bool, device=dev)
    cond_mask[:, :cond_len] = True
    step_cond = cond.masked_fill(~cond_mask, 0.0)
    text = torch.randint(1, 2545, (1, 160), generator=gen, device=dev, dtype=torch.int32)
    y0 = torch.randn((1, n_bucket, 100), generator=gen, device=dev).to(torch.bfloat16)
    pad_mask = (torch.arange(n_bucket, device=dev) < total_len)[None]
    return step_cond, cond_mask, text, y0, pad_mask, total_len - cond_len


def synthesize(model, vocoder, inputs, kernels: bool = True, params=None):
    """One bench-protocol utterance: sampler, cond splice, Vocos -> (mel, wav)."""
    from korean_f5_tts_tpu_torch.models.cfm import _sample_core
    from korean_f5_tts_tpu_torch.models.vocos import vocos_decode

    step_cond, cond_mask, text, y0, pad_mask, _ = inputs
    mel = _sample_core(params or model.params, model.arch, step_cond, text, None, pad_mask,
                       y0, 2.0, -1.0, steps=STEPS, use_cfg=True, use_sway=True,
                       use_epss=True, kernels=kernels)
    out = mel.where(~cond_mask, step_cond)
    wav = vocos_decode(vocoder.params, out.transpose(1, 2).to(step_cond.dtype), vocoder.vcfg)
    return mel, wav


def phase4_parity(model, vocoder, dev) -> None:
    import torch

    from korean_f5_tts_tpu_torch.models.modules import cast_params

    print("phase 4: bench protocol (cond 432, total 1376, bucket 1536, 16 NFE, CFG 2, "
          "sway -1, batch 1), kernels vs plain on the card")
    inputs = bench_inputs(dev)
    total = 1376
    mel_k, wav_k = synthesize(model, vocoder, inputs, kernels=True)
    mel_p, _ = synthesize(model, vocoder, inputs, kernels=False)
    f32 = [t.float() if t.is_floating_point() else t for t in inputs[:5]] + [inputs[5]]
    mel_32, _ = synthesize(model, vocoder, f32, kernels=False,
                           params=cast_params(model.params, torch.float32))
    torch.cuda.synchronize()

    def rel(a, b):
        a, b = a[:, :total].float(), b[:, :total].float()
        return ((a - b).norm() / b.norm()).item()

    if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()):
        fail("non-finite mel or waveform")
    if mel_k[:, :total].abs().max().item() == 0:
        fail("the mel is exactly zero: the model is gated off")
    err = rel(mel_k, mel_p)
    floor = rel(mel_p, mel_32)
    bound = 5e-2
    print(f"  mel rel err, kernels vs plain (bf16): {err:.3e} (bound {bound:.0e})")
    print(f"  for scale: plain bf16 vs plain fp32 {floor:.3e}, kernels bf16 vs plain fp32 "
          f"{rel(mel_k, mel_32):.3e}; mel shape {tuple(mel_k.shape)}, "
          f"mean |mel| {mel_k[:, :total].float().abs().mean().item():.3f}")
    if err > bound:
        fail("the sampler with kernels disagrees with the plain versions")


def phase5_rtf(model, vocoder, dev, card: str) -> float:
    import torch

    inputs = bench_inputs(dev)
    gen_seconds = inputs[5] * HOP / SR
    print(f"phase 5: RTF at the bench protocol ({gen_seconds:.4f} s generated), "
          f"1 warm-up + 10 timed runs each")
    out = {}
    for kernels in (True, False):
        synthesize(model, vocoder, inputs, kernels=kernels)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            synthesize(model, vocoder, inputs, kernels=kernels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        mean = sum(times) / len(times)
        out[kernels] = mean / gen_seconds
        label = "kernels" if kernels else "plain  "
        print(f"  {label}: {mean * 1e3:.2f} ms per utterance (min {min(times) * 1e3:.2f}, "
              f"max {max(times) * 1e3:.2f}), RTF {out[kernels]:.5f} [{card}]")
    return out[True]


def profile_once(model, vocoder, dev, path: Path) -> None:
    """One bench-protocol utterance under torch.profiler: device busy time
    (device-side kernel events only), its share of the un-profiled wall time
    (mean of 3 runs), and the kernels by device time; the table goes to path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inputs = bench_inputs(dev)
    synthesize(model, vocoder, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        synthesize(model, vocoder, inputs)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synthesize(model, vocoder, inputs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: wall {wall_ms:.2f} ms (un-profiled, mean of 3), device busy "
          f"{busy_ms:.2f} ms in {sum(e.count for e in kernels)} kernel launches, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; kernels by device time:")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    print(f"  full table: {path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5",
                        help="comma-separated phases to run (default: all)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="also profile one bench-protocol utterance; table to this file")
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not (PORT_PKG / "csrc").is_dir():
        print(f"chip_smoke: the port package is missing next to this script "
              f"({PORT_PKG})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the plain versions are fp32 references: full fp32 products and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    card = card_line()
    print(card)  # as nvidia-smi --query-gpu=name,power.limit prints it
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from korean_f5_tts_tpu_torch.ops import KERNEL_MODULES, cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_seconds if cuda_build.build_seconds is not None else 'cached'} s)")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    results = {name: {} for name in KERNEL_MODULES}
    if 2 in phases:
        gen = torch.Generator(device=dev).manual_seed(0)
        print("phase 2: kernels against their plain versions")
        results["flash_prefix"] = check_attention(gen, dev)
        results["ff_block"] = check_ff(gen, dev)
        results["grouped_conv"] = check_conv(gen, dev)

    counts = {name: 0 for name in KERNEL_MODULES}
    if phases & {3, 4, 5} or args.profile is not None:
        model, vocoder = build_model(dev)
        if 3 in phases:
            counts = phase3_serve(model, vocoder)
        if 4 in phases:
            phase4_parity(model, vocoder, dev)
        if 5 in phases:
            phase5_rtf(model, vocoder, dev, card)
        if args.profile is not None:
            profile_once(model, vocoder, dev, args.profile)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": results[name].get("max_abs_err"),
                "ms": results[name].get("ms"), "plain_ms": results[name].get("plain_ms")}
               for name in KERNEL_MODULES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

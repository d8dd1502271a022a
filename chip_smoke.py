#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (korean_f5_tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit; build the Hopper kernels from
     korean_f5_tts_tpu_torch/csrc and print the build time;
  2. hold each of the seven kernels (bf16: A, B, C; int8: 9, 5, 6, 4)
     against its plain PyTorch version at the main-path shapes, plus ragged,
     zero-row and outlier cases, and time both with CUDA events (20 runs
     after a warm-up);
  3. build F5TTS_v1_Base + Vocos with seeded random weights (AdaLN-zero
     layers re-drawn), in bf16 and again with int8 weights
     (load_model(..., quantize=True)); for each mode serve three HTTP /tts
     requests through the port's serve() (one alone, then two concurrently
     as one batch of 2), check the audio and that every kernel's launch
     count, reset just before, is exactly what the mode's path requires;
  4. for each mode run the bench protocol (cond 432, total 1376, bucket
     1536, 16 NFE, CFG 2, sway -1, batch 1) through the sampler with kernels
     and with the plain versions, and compare the mels;
  5. for each mode time the port's RTF at that protocol (1 warm-up, 10
     timed runs).
Both modes run the full depth of 22 blocks. The line before the last is a
JSON object with the kernels' numbers (launches: both modes' serving runs);
the last line is {"ok": true, "device": {...}}.

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
    "ff_block_int8": "korean_f5_tts_tpu/ops/ff_block.py:101",
    "ln_mod_matmul_int8": "korean_f5_tts_tpu/ops/fused_linears.py:109",
    "proj_gated_residual_int8": "korean_f5_tts_tpu/ops/fused_linears.py:156",
    "qmatmul": "korean_f5_tts_tpu/ops/qmatmul.py:24",
}
SOURCES = {
    "flash_prefix": "korean_f5_tts_tpu_torch/csrc/flash_prefix.cu",
    "ff_block": "korean_f5_tts_tpu_torch/csrc/ff_block.cu",
    "grouped_conv": "korean_f5_tts_tpu_torch/csrc/grouped_conv.cu",
    "ff_block_int8": "korean_f5_tts_tpu_torch/csrc/ff_block_int8.cu",
    "ln_mod_matmul_int8": "korean_f5_tts_tpu_torch/csrc/fused_linears_int8.cu",
    "proj_gated_residual_int8": "korean_f5_tts_tpu_torch/csrc/fused_linears_int8.cu",
    "qmatmul": "korean_f5_tts_tpu_torch/csrc/qmatmul.cu",
}
# int8 kernels against their plain versions: both quantize the same values
# and sum the integer products exactly, but where the quantized value is
# computed first (LN statistics, GELU) fp32 sums in another order can flip a
# value at a rounding tie, which moves one product term by one quantization
# step (~1e-3 of a row's output): a few such flips per call stay far below
# INT8_REL. Kernels 9 and 6 quantize their bf16 input as it is, so without a
# GELU they must equal their plain versions exactly.
INT8_REL = 2e-3


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


def compare(name: str, got, want, rel_bound: float,
            exact: bool = False) -> tuple[float, float]:
    """max-abs and relative-L2 error of got vs want (fp32), checked against
    max_abs <= 2**-6 * max(1, max|want|) (4 bf16 ulps at the output's scale)
    and rel <= rel_bound, or against max_abs == 0 when exact; also prints how
    many elements differ by more than 4 bf16 ulps of their own value."""
    import torch

    g, w = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    max_abs = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    abs_bound = 2.0 ** -6 * max(1.0, w.abs().max().item())
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)  # bf16 ulp of w
    past = int(((g - w).abs() > 4 * ulp).sum().item())
    if exact:
        abs_bound = 0.0
    ok = max_abs <= abs_bound and rel <= rel_bound
    print(f"  {name}: max_abs_err {max_abs:.3e} (bound {abs_bound:.3e}) "
          f"rel_err {rel:.3e} (bound {rel_bound:.1e}), {past} of {w.numel()} elements "
          f"past 4 bf16 ulps {'ok' if ok else 'FAIL'}")
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


def _uni(gen, dev, shape, bound):
    import torch

    return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).to(torch.bfloat16)


def _int8_linear(gen, dev, n: int, k: int) -> dict:
    """An int8 linear of models/quant.py from uniform +-1/sqrt(k) bf16 weights."""
    from korean_f5_tts_tpu_torch.models.quant import quantize_linear

    qp = quantize_linear({"w": _uni(gen, dev, (n, k), k ** -0.5)})
    qp["b"] = _uni(gen, dev, (n,), k ** -0.5)
    return qp


def _edge_rows(gen, dev, m: int, k: int):
    """bf16 rows with an all-zero row (the 1e-6 scale floor) and a row with
    one large outlier."""
    import torch

    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    x[3] = 0
    x[7, 5] = 300.0
    return x


def _timed(fn, plain, ops: float) -> dict:
    ms = cuda_time_ms(fn)
    plain_ms = cuda_time_ms(plain)
    print(f"  time at main shape: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), "
          f"plain {plain_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms}


def check_qmatmul(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import qmatmul as qm

    print("kernel 9, dynamic-int8 matmul (bf16 x int8; exact without GELU: the same "
          f"int8 values and an exact product; rel bound {INT8_REL:.0e} with GELU)")
    x = torch.randn((3072, 1024), generator=gen, device=dev).to(torch.bfloat16)
    qp = _int8_linear(gen, dev, 1024, 1024)
    w, ws, b = qp["w_int8"], qp["w_scale"], qp["b"]
    max_abs, _ = compare("qmatmul main M=3072 K=N=1024 + bias", qm.qmatmul(x, w, ws, b),
                         qm.qmatmul_reference(x, w, ws, b), INT8_REL, exact=True)
    xr = _edge_rows(gen, dev, 1000, 1024)
    for label, bias, act in (("+ bias", b, None), ("no bias", None, None),
                             ("+ bias + gelu_tanh", b, "gelu_tanh")):
        compare(f"qmatmul ragged M=1000 zero+outlier rows {label}",
                qm.qmatmul(xr, w, ws, bias, act), qm.qmatmul_reference(xr, w, ws, bias, act),
                INT8_REL, exact=act is None)
    times = _timed(lambda: qm.qmatmul(x, w, ws, b),
                   lambda: qm.qmatmul_reference(x, w, ws, b), 2.0 * 3072 * 1024 * 1024)
    return {"max_abs_err": max_abs, **times}


def check_ln_mod_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print(f"kernel 5, int8 LN + modulate + qkv product (rel bound {INT8_REL:.0e}: one "
          "quantization step per tie flip of the fp32 LN output)")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh = _uni(gen, dev, (1024,), 0.3), _uni(gen, dev, (1024,), 0.3)
    qps = [_int8_linear(gen, dev, 1024, 1024) for _ in range(3)]
    max_abs, _ = compare("ln_mod_matmul_int8 main m=3072 d=1024 n=3x1024",
                         fl.ln_mod_matmul_int8(h, sc, sh, qps),
                         fl.ln_mod_matmul_int8_reference(h, sc, sh, qps), INT8_REL)
    hr = _edge_rows(gen, dev, 1000, 1024)[None]
    zero = torch.zeros_like(sh)
    for label, shift in (("", sh), (", sh = 0 (zero y row)", zero)):
        compare(f"ln_mod_matmul_int8 ragged m=1000 zero+outlier rows{label}",
                fl.ln_mod_matmul_int8(hr, sc, shift, qps),
                fl.ln_mod_matmul_int8_reference(hr, sc, shift, qps), INT8_REL)
    times = _timed(lambda: fl.ln_mod_matmul_int8(h, sc, sh, qps),
                   lambda: fl.ln_mod_matmul_int8_reference(h, sc, sh, qps),
                   2.0 * 3072 * 1024 * 3072)
    return {"max_abs_err": max_abs, **times}


def check_proj_gated_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import fused_linears as fl

    print("kernel 6, int8 out-projection + gated residual (exact: the same int8 values, "
          "an exact product and the same fp32 epilogue)")
    a, h = (torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    gate = _uni(gen, dev, (1024,), 1.0)
    qp = _int8_linear(gen, dev, 1024, 1024)
    max_abs, _ = compare("proj_gated_residual_int8 main m=3072 d=1024",
                         fl.proj_gated_residual_int8(a, h, gate, qp),
                         fl.proj_gated_residual_int8_reference(a, h, gate, qp), INT8_REL,
                         exact=True)
    ar = _edge_rows(gen, dev, 1000, 1024)[None]
    compare("proj_gated_residual_int8 ragged m=1000 zero+outlier rows",
            fl.proj_gated_residual_int8(ar, h[:1, :1000], gate, qp),
            fl.proj_gated_residual_int8_reference(ar, h[:1, :1000], gate, qp), INT8_REL,
            exact=True)
    times = _timed(lambda: fl.proj_gated_residual_int8(a, h, gate, qp),
                   lambda: fl.proj_gated_residual_int8_reference(a, h, gate, qp),
                   2.0 * 3072 * 1024 * 1024)
    return {"max_abs_err": max_abs, **times}


def check_ff_int8(gen, dev) -> dict:
    import torch

    from korean_f5_tts_tpu_torch.ops import ff_block as fb

    print(f"kernel 4, int8 FF half-block (rel bound {INT8_REL:.0e}: tie flips of the fp32 "
          "LN and GELU outputs; z quantized from fp32 on both sides)")
    h = torch.randn((2, 1536, 1024), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh, gate = (_uni(gen, dev, (1024,), bound) for bound in (0.3, 0.3, 1.0))
    qp_in, qp_out = _int8_linear(gen, dev, 2048, 1024), _int8_linear(gen, dev, 1024, 2048)
    args = (sc, sh, gate, qp_in, qp_out)
    max_abs, _ = compare("ff_block_int8 main m=3072 d=1024 dff=2048",
                         fb.ff_block_fused_int8(h, *args), fb.ff_block_int8_reference(h, *args),
                         INT8_REL)
    hr = _edge_rows(gen, dev, 1000, 1024)[None]
    zero = torch.zeros_like(sh)
    for label, shift in (("", sh), (", sh = 0 (zero y row)", zero)):
        rargs = (sc, shift, gate, qp_in, qp_out)
        compare(f"ff_block_int8 ragged m=1000 zero+outlier rows{label}",
                fb.ff_block_fused_int8(hr, *rargs), fb.ff_block_int8_reference(hr, *rargs),
                INT8_REL)
    times = _timed(lambda: fb.ff_block_fused_int8(h, *args),
                   lambda: fb.ff_block_int8_reference(h, *args), 4.0 * 3072 * 1024 * 2048)
    return {"max_abs_err": max_abs, **times}


# ---------------------------------------------------------------------------
# phase 3: full-width model behind the HTTP server
# ---------------------------------------------------------------------------

HOP, SR = 256, 24_000
DEPTH, STEPS = 22, 16
REF_TEXT = "This is the reference speech."


def build_model(dev, quantize: bool = False):
    """F5TTS_v1_Base + Vocos in bf16, seeded random weights, AdaLN re-drawn;
    quantize=True gives the same weights with int8 block linears."""
    import torch

    from korean_f5_tts_tpu_torch.config import preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.models.dit import count_params, redraw_zero_init
    from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos

    model = load_model(preset_model_config("F5TTS_v1_Base"),
                       vocab_file=str(ROOT / "data/Emilia_ZH_EN_pinyin/vocab.txt"),
                       dtype=torch.bfloat16, seed=0, device=dev, quantize=quantize)
    redraw_zero_init(model.params, seed=1)  # the AdaLN layers are never quantized
    vcfg = VocosConfig()
    vocoder = Vocos(init_vocos(vcfg, seed=1, device=dev, dtype=torch.bfloat16), vcfg)
    arch = model.arch
    print(f"  DiT dim {arch.dim} depth {arch.depth} heads {arch.heads}x{arch.dim_head} "
          f"ff_mult {arch.ff_mult} text_dim {arch.text_dim} text embeds {arch.text_num_embeds}: "
          f"{count_params(model.params) / 1e6:.1f} M params; Vocos "
          f"{count_params(vocoder.params) / 1e6:.1f} M params; "
          f"{'int8 block linears, bf16 compute' if quantize else 'bf16'}")
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


def expected_launches(mode: str, batches: int) -> dict[str, int]:
    """Launches of each kernel while serving one batch of 1 and one of 2 (22
    blocks x 16 steps each). bf16: A and B per block, C twice per step.
    int8: A and 4 per block; 5 and 6 per block at batch 1 (no duration
    mask); kernel 9 for each of q, k, v and out per block at batch 2."""
    from korean_f5_tts_tpu_torch.ops import KERNELS

    per = DEPTH * STEPS
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_prefix=per * batches, grouped_conv=2 * STEPS * batches)
    if mode == "bf16":
        want["ff_block"] = per * batches
    else:
        want.update(ff_block_int8=per * batches, ln_mod_matmul_int8=per,
                    proj_gated_residual_int8=per, qmatmul=4 * per)
    return want


def phase3_serve(model, vocoder, mode: str) -> dict[str, int]:
    import io
    import threading
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
    from korean_f5_tts_tpu_torch.serving.server import serve

    print(f"phase 3 ({mode}): serve() on localhost, 3 POST /tts requests (1 alone, then 2 "
          "at once)")
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
    want = expected_launches(mode, len(sizes))
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


def phase4_parity(model, vocoder, dev, mode: str, bf16_plain=None):
    """Kernels vs plain versions through the sampler; returns the plain mel.
    bf16 prints the plain bf16-vs-fp32 gap for scale, int8 the plain
    int8-vs-bf16 gap (bf16_plain: the bf16 model's plain mel)."""
    import torch

    from korean_f5_tts_tpu_torch.models.modules import cast_params

    print(f"phase 4 ({mode}): bench protocol (cond 432, total 1376, bucket 1536, 16 NFE, "
          "CFG 2, sway -1, batch 1), kernels vs plain on the card")
    inputs = bench_inputs(dev)
    total = 1376
    mel_k, wav_k = synthesize(model, vocoder, inputs, kernels=True)
    mel_p, _ = synthesize(model, vocoder, inputs, kernels=False)
    torch.cuda.synchronize()

    def rel(a, b):
        a, b = a[:, :total].float(), b[:, :total].float()
        return ((a - b).norm() / b.norm()).item()

    if not (torch.isfinite(mel_k).all() and torch.isfinite(wav_k).all()):
        fail("non-finite mel or waveform")
    if mel_k[:, :total].abs().max().item() == 0:
        fail("the mel is exactly zero: the model is gated off")
    err = rel(mel_k, mel_p)
    bound = 5e-2
    print(f"  mel rel err, kernels vs plain ({mode}): {err:.3e} (bound {bound:.0e})")
    if mode == "bf16":
        f32 = [t.float() if t.is_floating_point() else t for t in inputs[:5]] + [inputs[5]]
        mel_32, _ = synthesize(model, vocoder, f32, kernels=False,
                               params=cast_params(model.params, torch.float32))
        print(f"  for scale: plain bf16 vs plain fp32 {rel(mel_p, mel_32):.3e}, kernels bf16 "
              f"vs plain fp32 {rel(mel_k, mel_32):.3e}; mel shape {tuple(mel_k.shape)}, "
              f"mean |mel| {mel_k[:, :total].float().abs().mean().item():.3f}")
    else:
        print(f"  for scale (not gated): plain int8 vs plain bf16 {rel(mel_p, bf16_plain):.3e}, "
              f"kernels int8 vs plain bf16 {rel(mel_k, bf16_plain):.3e}; mean |mel| "
              f"{mel_k[:, :total].float().abs().mean().item():.3f}")
    if err > bound:
        fail("the sampler with kernels disagrees with the plain versions")
    return mel_p


def phase5_rtf(model, vocoder, dev, card: str, mode: str) -> float:
    import torch

    inputs = bench_inputs(dev)
    gen_seconds = inputs[5] * HOP / SR
    print(f"phase 5 ({mode}): RTF at the bench protocol ({gen_seconds:.4f} s generated), "
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
        print(f"  {mode} {label}: {mean * 1e3:.2f} ms per utterance (min "
              f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), RTF {out[kernels]:.5f} "
              f"[{card}]")
    return out[True]


def profile_once(model, vocoder, dev, path: Path, mode: str) -> None:
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
    print(f"profile ({mode}): wall {wall_ms:.2f} ms (un-profiled, mean of 3), device busy "
          f"{busy_ms:.2f} ms in {sum(e.count for e in kernels)} kernel launches, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; kernels by device time:")
    for e in kernels[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    print(f"  full table: {path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5",
                        help="comma-separated phases to run (default: all)")
    parser.add_argument("--profile", type=Path, default=None,
                        help="also profile one bench-protocol utterance per mode; tables to "
                             "this file (int8) and to its .bf16 sibling")
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

    from korean_f5_tts_tpu_torch.ops import KERNELS, cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_seconds if cuda_build.build_seconds is not None else 'cached'} s)")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    results = {name: {} for name in KERNELS}
    if 2 in phases:
        gen = torch.Generator(device=dev).manual_seed(0)
        print("phase 2: kernels against their plain versions")
        results["flash_prefix"] = check_attention(gen, dev)
        results["ff_block"] = check_ff(gen, dev)
        results["grouped_conv"] = check_conv(gen, dev)
        results["qmatmul"] = check_qmatmul(gen, dev)
        results["ln_mod_matmul_int8"] = check_ln_mod_int8(gen, dev)
        results["proj_gated_residual_int8"] = check_proj_gated_int8(gen, dev)
        results["ff_block_int8"] = check_ff_int8(gen, dev)

    counts = dict.fromkeys(KERNELS, 0)
    if phases & {3, 4, 5} or args.profile is not None:
        bf16_plain = None
        for mode in ("bf16", "int8"):
            model, vocoder = build_model(dev, quantize=mode == "int8")
            if 3 in phases:
                for name, n in phase3_serve(model, vocoder, mode).items():
                    counts[name] += n
            if 4 in phases:
                bf16_plain = phase4_parity(model, vocoder, dev, mode, bf16_plain)
            if 5 in phases:
                phase5_rtf(model, vocoder, dev, card, mode)
            if args.profile is not None:
                path = args.profile if mode == "int8" else args.profile.with_suffix(".bf16.txt")
                profile_once(model, vocoder, dev, path, mode)
            del model, vocoder
            torch.cuda.empty_cache()
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": results[name].get("max_abs_err"),
                "ms": results[name].get("ms"), "plain_ms": results[name].get("plain_ms")}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

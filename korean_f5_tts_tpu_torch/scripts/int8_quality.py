"""Quantify the int8 inference modes' quality cost on the card: mel MAE between
bf16 sampling and each int8 mode at the headline shapes (same noise, same
schedule). Counterpart of the repository's scripts/int8_quality.py; prints
the same JSON lines, one per mode.

    python -m korean_f5_tts_tpu_torch.scripts.int8_quality [--modes int8_all bf16+attn_i8 ...]

This is the protocol to run before enabling int8 attention (attn_int8) on a
model: the six modes are int8 FF only, int8 block linears, and int8 attention
("qk": q.k^T only; "qkpv": p.v as well) over bf16 and over int8 weights.
Needs a CUDA card unless --device cpu is given with a small --depth and --n.
The weights are seeded and random, with the AdaLN-zero layers re-drawn (at
their zero init every block is gated off and every mode would read 0.0).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.cfm import _sample_core
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.quant import quantize_params
from korean_f5_tts_tpu_torch.utils.misc import require_device

# name -> (quantization patterns: "bf16" none, None the default set; attn_int8)
MODES = {
    "int8_ff": ((r"ff/in$", r"ff/out$"), None),
    "int8_all": (None, None),
    "bf16+attn_i8qk": ("bf16", "qk"),  # the attention quantization error alone
    "bf16+attn_i8": ("bf16", "qkpv"),
    "int8_all+attn_i8qk": (None, "qk"),
    "int8_all+attn_i8": (None, "qkpv"),
}


def run(modes=tuple(MODES), device="cuda", dim: int = 1024, depth: int = 22, heads: int = 16,
        n: int = 1536, cond_len: int = 432, total_len: int = 1376, steps: int = 16,
        dtype: torch.dtype = torch.bfloat16, kernels: bool = True, emit=print) -> list[dict]:
    """The mel MAE of each mode against the unquantized sampler; one dict per
    mode, also passed to `emit` as a JSON line."""
    dev = require_device(device)
    arch = DiTConfig(dim=dim, depth=depth, heads=heads, ff_mult=2, text_dim=dim // 2,
                     conv_layers=4, text_num_embeds=2545)
    params = redraw_zero_init(cast_params(init_dit(arch, seed=0, device=dev), dtype), seed=7)
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.standard_normal((1, n, 100)).astype(np.float32), device=dev)
    cond_mask = (torch.arange(n, device=dev) < cond_len)[None, :, None]
    step_cond = cond.to(dtype).masked_fill(~cond_mask, 0.0)
    text = torch.as_tensor(rng.integers(1, 2545, (1, 160)).astype(np.int32), device=dev)
    y0 = torch.as_tensor(rng.standard_normal((1, n, 100)).astype(np.float32), device=dev).to(dtype)
    pad_mask = (torch.arange(n, device=dev) < total_len)[None]

    def sample(p, attn_int8=None):
        mel = _sample_core(p, arch, step_cond, text, None, pad_mask, y0, 2.0, -1.0, steps=steps,
                           use_cfg=True, use_sway=True, use_epss=True, kernels=kernels,
                           attn_int8=attn_int8)
        return mel.float()[:, :total_len].cpu().numpy()

    ref = sample(params)
    scale = float(np.abs(ref).mean())
    results = []
    for name in modes:
        pats, attn = MODES[name]
        if pats == "bf16":
            qp = params
        else:
            qp = quantize_params(params) if pats is None else quantize_params(params, patterns=pats)
        mae = float(np.abs(sample(qp, attn) - ref).mean())
        results.append({"mode": name, "mel_mae_vs_bf16": round(mae, 5),
                        "relative": round(mae / scale, 5)})
        emit(json.dumps(results[-1]))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", nargs="*", default=list(MODES), choices=list(MODES))
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--depth", type=int, default=22)
    p.add_argument("--n", type=int, default=1536, help="frames of the duration bucket")
    p.add_argument("--no-kernels", dest="kernels", action="store_false",
                   help="run the kernels' plain versions")
    args = p.parse_args(argv)
    total = args.n * 1376 // 1536
    run(tuple(args.modes), device=args.device, depth=args.depth, n=args.n,
        cond_len=total * 432 // 1376, total_len=total, kernels=args.kernels,
        dtype=torch.bfloat16 if args.device != "cpu" else torch.float32)


if __name__ == "__main__":
    main()

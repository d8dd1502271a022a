"""Int8 quantized linears (counterpart of korean_f5_tts_tpu/models/quant.py).

Per-channel int8 weights with dynamic per-row int8 activations:
    y = (q(x) @ w_int8^T) * (x_scale (x) w_scale) + b
    w_int8[c] = rint(w[c] / w_scale[c]),  w_scale[c] = max(max|w[c]|, 1e-8) / 127
    q(x)[r]   = rint(x[r] / x_scale[r]),  x_scale[r] = max(max|x[r]|, 1e-6) / 127
(symmetric, no zero points, ties to even). quantize_params rewrites the
matching linear dicts to {"w_int8" [d_out, d_in] int8, "w_scale" [d_out] fp32,
"b"?}: the JAX layout transposed, as the converter (train/checkpoint.py)
transposes it. models.modules.linear dispatches on that layout.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from korean_f5_tts_tpu_torch.ops.qmatmul import div127, qmatmul, qmatmul_reference

DEFAULT_QUANT_PATTERNS = (
    r"attn/to_q$", r"attn/to_k$", r"attn/to_v$", r"attn/to_out$",
    r"ff/in$", r"ff/out$",
)


def quantize_linear(p: dict) -> dict:
    """{"w" [d_out, d_in], "b"?} -> {"w_int8", "w_scale" fp32, "b"?}, bit for
    bit the JAX quantize_linear (quant.py:30-37) on the same weights, on any
    device: fp32 scale, IEEE divisions, round half to even, clip to +-127."""
    w = p["w"].float()
    w_scale = div127(w.abs().amax(dim=1).clamp_min(1e-8))
    w_int8 = torch.clamp(torch.round(w / w_scale[:, None]), -127, 127).to(torch.int8)
    out = {"w_int8": w_int8.contiguous(), "w_scale": w_scale.contiguous()}
    if "b" in p:
        out["b"] = p["b"]
    return out


def qlinear(p: dict, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """Dynamic-activation int8 linear on x [..., d_in]; returns x's dtype.

    kernels=True takes kernel 9 (ops/qmatmul.py: CUDA tensors launch it for
    any number of rows, CPU tensors take its plain version); kernels=False
    the plain version on any device.
    """
    n, k = p["w_int8"].shape
    fn = qmatmul if kernels else qmatmul_reference
    y = fn(x.reshape(-1, k), p["w_int8"], p["w_scale"], p.get("b"))
    return y.reshape(*x.shape[:-1], n)


def quantize_params(params: Any, patterns=DEFAULT_QUANT_PATTERNS) -> Any:
    """Rewrite matching linear dicts to the int8 layout; path regexes match
    with block indices stripped (quant.py:73-89)."""
    compiled = [re.compile(p) for p in patterns]

    def walk(node, path):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) == 2:
                canon = re.sub(r"/\d+", "", path)
                if any(c.search(canon) for c in compiled):
                    return quantize_linear(node)
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(params, "")

"""LoRA adapters over the port's parameter trees (counterpart of
korean_f5_tts_tpu/models/lora.py).

The adapter tree is {path: {"a": [d_in, r], "b": [r, d_out], "scale": []}}
for the matched linears, in the JAX layout: a and b are not transposed, so
adapters cross between the packages as they are (lora_from_jax,
lora_to_jax). The port's linear weights are [d_out, d_in], so apply_lora
adds the transposed delta: w := w + (scale * (a @ b))^T, which is the JAX
package's w + scale * (a @ b) in its [d_in, d_out] layout. `scale` is a leaf
like a and b: train/train_lora.py trains it.

Functional, as in the JAX package: apply_lora builds a new tree inside the
loss (the rank-r products are cheap), the base tensors stay as they are and
only the adapters (and the text embedding, when asked) take gradients.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from korean_f5_tts_tpu_torch.utils.misc import require_device

# r 16 / alpha 32 on the attention projections, r 64 / alpha 128 on the input
# projection (the reference's train_lora.py:123-135)
DEFAULT_TARGETS = {
    r"attn/to_q$|attn/to_k$|attn/to_v$|attn/to_out$": (16, 32.0),
    r"^input_proj$": (64, 128.0),
}


def _iter_linears(params: Any, path: str = ""):
    """(path, linear) of every dict holding a 2-D "w", depth first (the JAX
    package's order)."""
    if isinstance(params, dict):
        if "w" in params and getattr(params["w"], "ndim", 0) == 2:
            yield path, params
        for k, v in params.items():
            if k == "w":
                continue
            yield from _iter_linears(v, f"{path}/{k}" if path else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _iter_linears(v, f"{path}/{i}")


def _match(path: str, patterns: dict[str, tuple[int, float]]):
    canon = re.sub(r"/\d+", "", path)  # blocks/3/attn/to_q -> blocks/attn/to_q
    for pat, cfg in patterns.items():
        if re.search(pat, canon):
            return cfg
    return None


def init_lora(params: Any, targets: dict[str, tuple[int, float]] | None = None,
              seed: int = 0) -> dict:
    """The adapter tree for the matched linears of the port's `params`, on
    their device: a ~ N(0, 1) / sqrt(d_in) from a generator seeded with
    `seed`, b = 0 (so every adapter starts as the identity), scale alpha / r.
    The draws are the port's own; lora_from_jax takes the JAX package's."""
    targets = targets or DEFAULT_TARGETS
    adapters = {}
    gen = None
    for path, lin in _iter_linears(params):
        cfg = _match(path, targets)
        if cfg is None:
            continue
        rank, alpha = cfg
        d_out, d_in = lin["w"].shape
        dev = lin["w"].device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
        adapters[path] = {
            "a": torch.randn((d_in, rank), generator=gen, device=dev) / (d_in ** 0.5),
            "b": torch.zeros((rank, d_out), device=dev),
            "scale": torch.tensor(alpha / rank, dtype=torch.float32, device=dev),
        }
    return adapters


def apply_lora(base: Any, adapters: dict) -> Any:
    """A new tree with w := w + (scale * (a @ b))^T at the adapted paths; the
    other leaves are the base's own tensors."""

    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
            if path in adapters and "w" in out:
                ad = adapters[path]
                delta = (ad["a"] @ ad["b"]) * ad["scale"]
                out["w"] = out["w"] + delta.T.to(out["w"].dtype)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return node

    return walk(base, "")


@torch.no_grad()
def merge_lora(base: Any, adapters: dict) -> Any:
    """A new tree with the adapters folded in (the other leaves are the
    base's tensors), for inference and for the checkpoint train_lora writes."""
    return apply_lora(base, adapters)


def lora_from_jax(adapters: dict, device="cuda") -> dict:
    """The JAX package's adapter tree (numpy or jax arrays) -> tensors on
    `device` (the card unless the caller names the CPU), layouts unchanged."""
    device = require_device(device)
    return {path: {k: torch.tensor(np.asarray(v), device=device) for k, v in ad.items()}
            for path, ad in adapters.items()}


def lora_to_jax(adapters: dict) -> dict:
    """Inverse of lora_from_jax: numpy copies in the JAX layout."""
    return {path: {k: v.detach().cpu().numpy().copy() for k, v in ad.items()}
            for path, ad in adapters.items()}

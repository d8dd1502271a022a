"""Vocab extension and checkpoint surgery for fine-tuning on new token sets
(counterpart of korean_f5_tts_tpu/train/vocab_extend.py).

Extend a pretrained checkpoint's vocab with new tokens (text-embedding rows
appended, drawn from numpy's generator as the JAX package draws them), and
prune a training checkpoint down to inference weights (EMA only, no
optimizer state). Files are the JAX package's .npz (train/checkpoint.py),
so either package reads what the other writes; the surgery is host work and
runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from korean_f5_tts_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint


def extend_vocab_file(base_vocab: list[str], new_tokens: list[str]) -> list[str]:
    seen = set(base_vocab)
    out = list(base_vocab)
    for t in new_tokens:
        if t not in seen and t != "":
            out.append(t)
            seen.add(t)
    return out


def expand_text_embedding(params: dict, new_vocab_size: int, init_std: float = 0.02,
                          seed: int = 0) -> dict:
    """Grow text_embed rows to new_vocab_size + 1 (filler row 0 convention).
    The embedding table is [num, dim] in both packages' layouts."""
    emb = params["text_embed"]["embed"]["w"]
    target_rows = new_vocab_size + 1
    if emb.shape[0] >= target_rows:
        return params
    rng = np.random.default_rng(seed)
    extra = rng.normal(0.0, init_std, (target_rows - emb.shape[0], emb.shape[1]))
    out = dict(params)
    out["text_embed"] = dict(params["text_embed"])
    out["text_embed"]["embed"] = {
        "w": torch.cat([emb, torch.from_numpy(extra).to(emb.dtype).to(emb.device)], dim=0)}
    return out


def extend_checkpoint(ckpt_path: str, out_path: str, base_vocab_path: str,
                      new_tokens: list[str], new_vocab_path: str) -> int:
    """Write an extended vocab + matching checkpoint; returns the new vocab size."""
    with open(base_vocab_path, "r", encoding="utf-8") as f:
        base_vocab = [line.rstrip("\n") for line in f]
    vocab = extend_vocab_file(base_vocab, new_tokens)
    with open(new_vocab_path, "w", encoding="utf-8") as f:
        f.writelines(v + "\n" for v in vocab)
    data = load_checkpoint(ckpt_path, device="cpu")
    params = expand_text_embedding(data["params"], len(vocab))
    ema = data.get("ema_params")
    if ema is not None:
        ema = expand_text_embedding(ema, len(vocab))
    save_checkpoint(out_path, params, ema_params=ema, update=data["update"])
    return len(vocab)


def prune_checkpoint(ckpt_path: str, out_path: str, use_ema: bool = True) -> None:
    """Strip optimizer state; keep the (EMA) params only."""
    data = load_checkpoint(ckpt_path, device="cpu")
    params = data.get("ema_params") if use_ema and data.get("ema_params") else data["params"]
    save_checkpoint(out_path, params, update=data["update"])

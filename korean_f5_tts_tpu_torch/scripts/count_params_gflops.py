"""Parameter and FLOP counter for the model zoo (counterpart of
korean_f5_tts_tpu/scripts/count_params_gflops.py).

    python -m korean_f5_tts_tpu_torch.scripts.count_params_gflops [--duration 20] [--text_length 150]

Parameters are counted from shapes: each backbone's init builds its tree on
PyTorch's meta device, which allocates and draws nothing. FLOPs are counted
analytically from the config (the matmul terms and attention, a
multiply-accumulate as 2), for the DiT as in the JAX script; the numbers
printed are the JAX script's.
"""

from __future__ import annotations

import argparse

from korean_f5_tts_tpu_torch.config import DiTConfig, MMDiTConfig, UNetTConfig
from korean_f5_tts_tpu_torch.models.dit import count_params as _count_leaves
from korean_f5_tts_tpu_torch.models.dit import init_dit
from korean_f5_tts_tpu_torch.models.mmdit import init_mmdit
from korean_f5_tts_tpu_torch.models.unett import init_unett

ZOO = [
    ("DiT F5TTS_Base", init_dit,
     DiTConfig(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512, conv_layers=4)),
    ("DiT F5TTS_Small", init_dit,
     DiTConfig(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512, conv_layers=4)),
    ("UNetT E2TTS_Base", init_unett, UNetTConfig(dim=1024, depth=24, heads=16, ff_mult=4)),
    ("MMDiT", init_mmdit, MMDiTConfig(dim=512, depth=16, heads=16, ff_mult=2)),
]


def count_params(init_fn, cfg) -> int:
    """Parameters of a backbone's tree, from its shapes on the meta device."""
    return _count_leaves(init_fn(cfg, device="meta"))


def dit_flops(cfg: DiTConfig, n_frames: int, n_text: int) -> float:
    """Matmul + attention FLOPs of one DiT forward (multiply-accumulate = 2)."""
    d, h, dh, L = cfg.dim, cfg.heads, cfg.dim_head, cfg.depth
    inner = h * dh
    per_block = 2 * n_frames * (
        3 * d * inner + inner * d          # qkv + out
        + 2 * d * (d * cfg.ff_mult)        # ff in + out
        + d * 6 * d                        # adaLN modulation
    ) + 4 * n_frames * n_frames * inner    # attention QK^T + PV
    text_dim = cfg.text_dim_
    text = 2 * n_frames * cfg.conv_layers * (
        7 * text_dim + 2 * text_dim * text_dim * cfg.conv_mult
    )
    io = 2 * n_frames * ((2 * cfg.mel_dim + text_dim) * d + d * cfg.mel_dim)
    return float(L * per_block + text + io)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--text_length", type=int, default=150)
    args = p.parse_args(argv)
    n_frames = int(args.duration * 24_000 / 256)
    for name, init_fn, cfg in ZOO:
        line = f"{name}: Params: {count_params(init_fn, cfg) / 1e6:.1f} M"
        if isinstance(cfg, DiTConfig):
            line += f", FLOPs: {dit_flops(cfg, n_frames, args.text_length) / 1e9:.1f} G"
        print(line)


if __name__ == "__main__":
    main()

"""The quantization error of int8 attention's plain version (kernel 14's
function) against the plain bf16 attention, across random draws and key
chunks, on the CPU.

    python -m korean_f5_tts_tpu_torch.scripts.int8_attn_tail [--draws 80]

For each case of chip_smoke.py's kernel 14 check that holds the error
bounds, and for each key chunk (64, the tile of the mma.sync kernel; 128,
the attention core's tile, I8_KEY_TILE; 512, the JAX wrapper's default bkv
and the kernel's chunk, I8_KEY_CHUNK),
it draws q, k, v as chip_smoke.py does (standard normal, rounded to bf16)
under seeds 0 .. draws-1 and prints, over the valid rows, the count of
elements past 3e-2 (mean, largest, and the share of draws past the count
QUANT_TAIL allows), the largest error and the largest mean error. The
statistics are the function's own: no kernel runs.
"""

from __future__ import annotations

import argparse

import torch

from korean_f5_tts_tpu_torch.ops import flash_prefix as fp

QUANT_TAIL = 1e-5  # chip_smoke.py's share of the valid elements that may pass 3e-2
CASES = {  # name: (kv_lens of one-head items, n)
    "ragged n=1000": ([1, 1000, 700, 64, 65, 999, 333, 128], 1000),
    "n=300": ([300, 1, 77, 129], 300),
}
CHUNKS = (64, 128, 512)


def draw(lens, n, seed, chunks):
    """[(past 3e-2, max, mean) per chunk] for one draw, "qkpv"."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((len(lens), n, 64), generator=g).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.tensor(lens, dtype=torch.int32)
    base = fp.prefix_attention_reference(q, k, v, kv).float()
    rows = torch.arange(n)[None, :, None] < kv[:, None, None]
    valid = int(rows.sum()) * 64
    out = []
    for ck in chunks:
        err = (fp.flash_prefix_i8_reference(q, k, v, kv, True, ck=ck).float() - base).abs() * rows
        out.append((int((err > 3e-2).sum()), err.max().item(), err.sum().item() / valid))
    return out, int(QUANT_TAIL * valid)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=80)
    args = ap.parse_args()
    for name, (lens, n) in CASES.items():
        runs = [draw(lens, n, seed, CHUNKS) for seed in range(args.draws)]
        allowed = runs[0][1]
        for i, ck in enumerate(CHUNKS):
            past = [r[0][i][0] for r in runs]
            print(f"{name} chunk {ck}: past 3e-2 mean {sum(past) / len(past):.3f}, largest "
                  f"{max(past)}, {sum(p > allowed for p in past)} of {len(past)} draws past "
                  f"the {allowed} allowed; max error {max(r[0][i][1] for r in runs):.3e}, "
                  f"largest mean {max(r[0][i][2] for r in runs):.3e}")


if __name__ == "__main__":
    main()

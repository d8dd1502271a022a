"""Mask helpers of the training loss (counterpart of
korean_f5_tts_tpu/utils/misc.py:38-64) and the seed derivation that stands in
for jax.random.fold_in.

Randomness comes from an explicit torch.Generator; the same seed gives the
same draws, but not the JAX package's (a test that needs those hands the JAX
draws over as tensors).
"""

from __future__ import annotations

import hashlib

import torch


def require_device(device="cuda") -> torch.device:
    """The torch.device an entry point was asked for. The port's entry points
    default to the card; nothing picks the CPU on finding no GPU: a CUDA
    device without a usable card raises, and the CPU runs only when the
    caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return device


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), as jax.random.fold_in derives a
    key: distinct data give unrelated streams, the same pair the same one."""
    digest = hashlib.blake2b(f"{seed}/{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def lens_to_mask(lens: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """[b] lengths -> [b, length] bool mask."""
    if length is None:
        length = int(lens.max())
    return torch.arange(length, device=lens.device)[None, :] < lens[:, None]


def mask_from_start_end_indices(start: torch.Tensor, end: torch.Tensor,
                                length: int) -> torch.Tensor:
    """[b] start/end -> [b, length] bool mask with start <= i < end."""
    seq = torch.arange(length, device=start.device)[None, :]
    return (seq >= start[:, None]) & (seq < end[:, None])


def span_start_end(seq_len: torch.Tensor, frac_lengths: torch.Tensor,
                   rand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Start and end of a contiguous span covering `frac` of each row, its
    start placed by `rand` in [0, 1) (misc.py:59-63; casts truncate toward
    zero, as astype(int32) does)."""
    lengths = (frac_lengths * seq_len.to(frac_lengths.dtype)).to(torch.int32)
    max_start = seq_len.to(torch.int32) - lengths
    start = (max_start.to(frac_lengths.dtype) * rand).to(torch.int32).clamp(min=0)
    return start, start + lengths


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor,
                           gen: torch.Generator, length: int) -> torch.Tensor:
    """Random contiguous span covering `frac` of each row (the training infill
    mask), its start drawn from `gen`."""
    rand = torch.rand(frac_lengths.shape, generator=gen, device=frac_lengths.device,
                      dtype=frac_lengths.dtype)
    return mask_from_start_end_indices(*span_start_end(seq_len, frac_lengths, rand), length)

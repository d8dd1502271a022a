"""Epoch math for frame-budget training runs (a copy of
korean_f5_tts_tpu/scripts/count_max_epoch.py, framework-free).

Parity with reference `scripts/count_max_epoch.py` / `count_max_epoch_precise.py`:
given total updates, dataset hours and the per-chip frame budget, compute how
many epochs a run covers (and inversely, updates per epoch).
"""

from __future__ import annotations

import argparse

HOP_S = 256 / 24_000  # seconds per mel frame


def updates_per_epoch(dataset_hours: float, frames_per_update: int) -> float:
    total_frames = dataset_hours * 3600 / HOP_S
    return total_frames / frames_per_update


def max_epochs(total_updates: int, dataset_hours: float, frames_per_update: int) -> float:
    return total_updates / updates_per_epoch(dataset_hours, frames_per_update)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--total_updates", type=int, default=1_200_000)
    p.add_argument("--dataset_hours", type=float, default=95_000.0,
                   help="Emilia ZH+EN ~ 95k h")
    p.add_argument("--frames_per_update", type=int, default=307_200,
                   help="8 chips x 38400 frames")
    args = p.parse_args(argv)
    upe = updates_per_epoch(args.dataset_hours, args.frames_per_update)
    print(f"updates/epoch: {upe:,.0f}")
    print(f"epochs at {args.total_updates:,} updates: "
          f"{max_epochs(args.total_updates, args.dataset_hours, args.frames_per_update):.2f}")


if __name__ == "__main__":
    main()

"""ODE timestep schedules: EPSS tables + sway warp.

Copy of korean_f5_tts_tpu/utils/timesteps.py (importing that file runs
korean_f5_tts_tpu/utils/__init__.py, which imports jax). Tables are host-side
numpy; the sampler turns them into a tensor of its compute dtype.
"""

from __future__ import annotations

import numpy as np

# Empirically Pruned Step Sampling: indices into a 32-step uniform grid.
_EPSS_TABLES: dict[int, list[int]] = {
    5: [0, 2, 4, 8, 16, 32],
    6: [0, 2, 4, 6, 8, 16, 32],
    7: [0, 2, 4, 6, 8, 16, 24, 32],
    10: [0, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32],
    12: [0, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32],
    16: [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32],
}


def get_epss_timesteps(n: int, dtype=np.float32) -> np.ndarray:
    """EPSS schedule of n steps (n+1 knots); uniform linspace if no table."""
    table = _EPSS_TABLES.get(n)
    if table is None:
        return np.linspace(0.0, 1.0, n + 1, dtype=dtype)
    return (np.asarray(table, dtype=dtype) / 32.0).astype(dtype)


def sway_warp(t: np.ndarray, coef: float) -> np.ndarray:
    """Sway sampling: t + coef * (cos(pi/2 * t) - 1 + t)."""
    t = np.asarray(t)
    return t + coef * (np.cos(np.pi / 2.0 * t) - 1.0 + t)


def make_schedule(
    steps: int,
    use_epss: bool = True,
    sway_sampling_coef: float | None = None,
    t_start: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Full inference schedule: EPSS (only from t=0) or linspace, then sway."""
    if t_start == 0.0 and use_epss:
        t = get_epss_timesteps(steps, dtype=dtype)
    else:
        t = np.linspace(t_start, 1.0, steps + 1, dtype=dtype)
    if sway_sampling_coef is not None:
        t = sway_warp(t, sway_sampling_coef).astype(dtype)
    return t

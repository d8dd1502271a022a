"""Kernels of the port and the plain tensor code around them.

Each kernel module keeps a plain integer `launches` that its wrapper raises
by one per kernel launch (plain calls do not count), so a run can show that
the main path went through the kernels.
"""

from __future__ import annotations

from korean_f5_tts_tpu_torch.ops import ff_block, flash_prefix, grouped_conv

KERNEL_MODULES = {
    "flash_prefix": flash_prefix,
    "ff_block": ff_block,
    "grouped_conv": grouped_conv,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0

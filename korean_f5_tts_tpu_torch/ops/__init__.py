"""Kernels of the port and the plain tensor code around them.

Each kernel keeps a plain integer counter in its wrapper's module that the
wrapper raises by one per kernel launch (plain calls do not count), so a run
can show that the main path went through the kernels. A module that holds
several kernels keeps one counter for each.
"""

from __future__ import annotations

from korean_f5_tts_tpu_torch.ops import (
    ff_block,
    flash_prefix,
    fused_linears,
    grouped_conv,
    qmatmul,
)

# kernel name -> (wrapper module, name of its launch counter)
KERNELS = {
    "flash_prefix": (flash_prefix, "launches"),
    "ff_block": (ff_block, "launches"),
    "grouped_conv": (grouped_conv, "launches"),
    "ff_block_int8": (ff_block, "launches_int8"),
    "ln_mod_matmul_int8": (fused_linears, "launches_ln_mod_int8"),
    "proj_gated_residual_int8": (fused_linears, "launches_proj_gated_int8"),
    "qmatmul": (qmatmul, "launches"),
    "flash_prefix_lse": (flash_prefix, "launches_lse"),
    "flash_prefix_dq_lsein": (flash_prefix, "launches_dq_lsein"),
    "flash_prefix_dq": (flash_prefix, "launches_dq"),
    "flash_prefix_dkv": (flash_prefix, "launches_dkv"),
    "ln_mod_matmul": (fused_linears, "launches_ln_mod"),
    "proj_gated_residual": (fused_linears, "launches_proj_gated"),
    "flash_prefix_rope": (flash_prefix, "launches_rope"),
    "flash_prefix_qkv": (flash_prefix, "launches_qkv"),
    "flash_prefix_i8": (flash_prefix, "launches_i8"),
    "flash_prefix_i8_quant": (flash_prefix, "launches_i8_quant"),  # kernel 14's quantization pass
    # the fp32 forms of kernels A, B, C (what the offline entry points run by default)
    "flash_prefix_f32": (flash_prefix, "launches_f32"),
    "ff_block_f32": (ff_block, "launches_f32"),
    "grouped_conv_f32": (grouped_conv, "launches_f32"),
    # the fp32 forms of kernels 10-13 (what fp32 training runs: Trainer's default)
    "flash_prefix_lse_f32": (flash_prefix, "launches_lse_f32"),
    "flash_prefix_dq_lsein_f32": (flash_prefix, "launches_dq_lsein_f32"),
    "flash_prefix_dq_f32": (flash_prefix, "launches_dq_f32"),
    "flash_prefix_dkv_f32": (flash_prefix, "launches_dkv_f32"),
    # the fp32 forms of kernels 7, 8, 18, 19, 14 and its pass (the offline entry
    # points' fp32 weights under attn_path and attn_int8)
    "ln_mod_matmul_f32": (fused_linears, "launches_ln_mod_f32"),
    "proj_gated_residual_f32": (fused_linears, "launches_proj_gated_f32"),
    "flash_prefix_rope_f32": (flash_prefix, "launches_rope_f32"),
    "flash_prefix_qkv_f32": (flash_prefix, "launches_qkv_f32"),
    "flash_prefix_i8_f32": (flash_prefix, "launches_i8_f32"),  # "qkpv" on the core
    "flash_prefix_i8_qk_f32": (flash_prefix, "launches_i8_qk_f32"),  # "qk": int8 S, 3xTF32 P.V
    "flash_prefix_i8_quant_f32": (flash_prefix, "launches_i8_quant_f32"),
    # the forms at head dim 128 (A, 10, 18 bf16 on the attention core, 13 bf16 on the
    # backward core, 11, 12 mma.sync in bf16, A, 10-13, 18 fp32 split 3xTF32; 14 on
    # int8 mma.sync)
    **{f"{base}_d128": (flash_prefix, f"{attr}_d128") for base, attr in (
        ("flash_prefix", "launches"), ("flash_prefix_f32", "launches_f32"),
        ("flash_prefix_lse", "launches_lse"), ("flash_prefix_lse_f32", "launches_lse_f32"),
        ("flash_prefix_dq_lsein", "launches_dq_lsein"),
        ("flash_prefix_dq_lsein_f32", "launches_dq_lsein_f32"),
        ("flash_prefix_dq", "launches_dq"), ("flash_prefix_dq_f32", "launches_dq_f32"),
        ("flash_prefix_dkv", "launches_dkv"), ("flash_prefix_dkv_f32", "launches_dkv_f32"),
        ("flash_prefix_rope", "launches_rope"), ("flash_prefix_rope_f32", "launches_rope_f32"),
        ("flash_prefix_i8", "launches_i8"),  # "qkpv", bf16 out
        ("flash_prefix_i8_qk", "launches_i8_qk"),  # "qk" on bf16 v
        ("flash_prefix_i8_f32", "launches_i8_f32"),  # "qkpv", fp32 out
        ("flash_prefix_i8_qk_f32", "launches_i8_qk_f32"),  # "qk" on fp32 v
        ("flash_prefix_i8_quant", "launches_i8_quant"),
        ("flash_prefix_i8_quant_f32", "launches_i8_quant_f32"))},
    # kernel C at 8 channels a group: pairs of groups packed block-diagonally
    # into the 16-channel instantiation
    "grouped_conv_g8": (grouped_conv, "launches_g8"),
    "grouped_conv_f32_g8": (grouped_conv, "launches_f32_g8"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)

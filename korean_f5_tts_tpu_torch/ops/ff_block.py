"""Fused DiT FF half-block: Hopper kernels B (bf16) and 4 (int8) and their
plain versions.

Counterpart of korean_f5_tts_tpu/ops/ff_block.py:
    out = h + gate * FF(LN(h) * (1 + sc) + sh)
with FF = Linear(d -> dff) -> GELU(tanh) -> Linear(dff -> d). Weights are in
the port's torch layout: w1 [dff, d], w2 [d, dff]; the int8 form takes the
int8 linears of models/quant.py ({w_int8, w_scale, b}, same layout). Kernel
B (csrc/ff_block.cu) replaces the TPU's _kernel, kernel 4
(csrc/ff_block_int8.cu) its _kernel_int8; their source notes record the
designs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build
from korean_f5_tts_tpu_torch.ops.fused_linears import (
    GEMM_MAX_LN_DIM,
    ln_mod_rows,
    ln_stats_scratch,
)
from korean_f5_tts_tpu_torch.ops.qmatmul import (
    I8_CORE_MAX_K,
    check_int8_linear,
    check_int8_rows,
    check_tensor,
    int8_product,
    quant_rows_reference,
)

launches = 0       # kernel B launches by ff_block_fused on bf16 operands (not plain calls)
launches_f32 = 0   # kernel B's fp32 form, launches by ff_block_fused on fp32 operands
launches_int8 = 0  # kernel 4 launches by ff_block_fused_int8


def ff_block_reference(h, sc, sh, gate, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain version of kernel B with the TPU kernel's rounding points.

    LN and modulation in fp32, y rounded to h's dtype, both products as fp32
    sums of the rounded operands, +b1 and GELU in fp32, z rounded, +b2 and the
    gated residual in fp32, one cast at the end. sc/sh/gate: [d].
    """
    dt = h.dtype
    xf = h.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps) * (1.0 + sc.float()) + sh.float()).to(dt)
    z = torch.matmul(y.float(), w1.float().t()) + b1.float()
    z = F.gelu(z, approximate="tanh").to(dt)
    o = torch.matmul(z.float(), w2.float().t()) + b2.float()
    return (xf + gate.float() * o).to(dt)


def ff_block_fused(h, sc, sh, gate, w1, b1, w2, b2, eps: float = 1e-6):
    """Kernel B wrapper: h [B, n, d], sc/sh/gate [d], w1 [dff, d], b1 [dff],
    w2 [d, dff], b2 [d], all bf16 or all fp32 (a mix raises TypeError); the
    result has their dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel (the
    wgmma core on bf16, split 3xTF32 on wgmma on fp32) or raise; nothing
    falls back.
    """
    global launches, launches_f32
    operands = (h, sc, sh, gate, w1, b1, w2, b2)
    if h.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != h.dtype for t in operands):
        raise TypeError("ff_block: operands must be all bfloat16 or all float32, got "
                        f"{[str(t.dtype) for t in operands]}")
    if h.device.type == "cpu":
        return ff_block_reference(h, sc, sh, gate, w1, b1, w2, b2, eps)
    d = h.shape[-1]
    dff = w1.shape[0]
    shapes = {"sc": (sc, (d,)), "sh": (sh, (d,)), "gate": (gate, (d,)),
              "w1": (w1, (dff, d)), "b1": (b1, (dff,)), "w2": (w2, (d, dff)),
              "b2": (b2, (d,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ff_block: {name} has shape {tuple(t.shape)}, want {want}")
    if d % 128 or dff % 128 or d > GEMM_MAX_LN_DIM:
        raise ValueError(f"ff_block: d={d} and dff={dff} must be multiples of 128 and d at "
                         f"most {GEMM_MAX_LN_DIM}")
    cuda_build.require_cuda("ff_block", *operands, dtype=h.dtype)
    m = h.numel() // d
    z = torch.empty((m, dff), dtype=h.dtype, device=h.device)
    stats = ln_stats_scratch(h)
    out = torch.empty_like(h)
    lib = cuda_build.library()
    ptrs = [t.data_ptr() for t in (*operands, z, stats, out)]
    if h.dtype == torch.float32:
        err = lib.f5_ff_block_f32_fwd(*ptrs, m, d, dff, eps, h.device.index,
                                      cuda_build.stream_of(h))
        cuda_build.check(err, "ff_block_f32_fwd")
        launches_f32 += 1
        return out
    err = lib.f5_ff_block_fwd(*ptrs, m, d, dff, eps, h.device.index, cuda_build.stream_of(h))
    cuda_build.check(err, "ff_block_fwd")
    launches += 1
    return out


def ff_block_int8_reference(h, sc, sh, gate, qp_in: dict, qp_out: dict,
                            eps: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel 4 with the TPU kernel's rounding points
    (ff_block.py:101-126): y = LN(h)(1+sc)+sh in fp32, quantized per row;
    z = gelu_tanh(acc * ys * w1s + b1) in fp32, quantized per row from fp32
    (never rounded to bf16); out = h + gate * (acc * zs * w2s + b2) in fp32,
    one cast. Integer products exact (int8_product)."""
    yq, ys = quant_rows_reference(ln_mod_rows(h, sc, sh, eps))
    z = int8_product(yq, qp_in["w_int8"]) * ys * qp_in["w_scale"].float()
    z = F.gelu(z + qp_in["b"].float(), approximate="tanh")
    zq, zs = quant_rows_reference(z)
    o = int8_product(zq, qp_out["w_int8"]) * zs * qp_out["w_scale"].float()
    o = o + qp_out["b"].float()
    return (h.float() + gate.float() * o).to(h.dtype)


def ff_block_fused_int8(h, sc, sh, gate, qp_in: dict, qp_out: dict,
                        eps: float = 1e-6) -> torch.Tensor:
    """Kernel 4 wrapper: h [B, n, d] bf16 or fp32, sc/sh/gate [d] and the
    biases of h's dtype (a mix raises TypeError), qp_in {w_int8 [dff, d],
    w_scale [dff] fp32, b [dff]}, qp_out {w_int8 [d, dff], w_scale [d], b [d]}
    -> [B, n, d] of h's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any number of rows; d, dff multiples of 128
    and at most 4096 (the row passes hold a row in registers). Raises on an
    input that requires a gradient (forward-only, as the JAX kernel).
    """
    global launches_int8
    cuda_build.require_no_grad("ff_block_fused_int8", h, sc, sh, gate)
    if h.device.type == "cpu":
        return ff_block_int8_reference(h, sc, sh, gate, qp_in, qp_out, eps)
    d = h.shape[-1]
    dff = qp_in["w_int8"].shape[0]
    if "b" not in qp_in or "b" not in qp_out:
        raise ValueError("ff_block_int8: the linears need a bias")
    f32 = check_int8_rows("ff_block_int8", h, sc=sc, sh=sh, gate=gate, b_in=qp_in["b"],
                          b_out=qp_out["b"])
    for name, v in (("sc", sc), ("sh", sh), ("gate", gate)):
        check_tensor("ff_block_int8", name, v, (d,))
    for qp, n, k in ((qp_in, dff, d), (qp_out, d, dff)):
        check_int8_linear("ff_block_int8", h, qp["w_int8"], qp["w_scale"], qp["b"], n, k,
                          k_multiple=128, k_max=I8_CORE_MAX_K)
    cuda_build.require_cuda("ff_block_int8", h, sc, sh, gate)
    m = h.numel() // d
    dev = h.device
    yq = torch.empty((m, d), dtype=torch.int8, device=dev)
    ys = torch.empty((m,), dtype=torch.float32, device=dev)
    z = torch.empty((m, dff), dtype=torch.float32, device=dev)
    zq = torch.empty((m, dff), dtype=torch.int8, device=dev)
    zs = torch.empty((m,), dtype=torch.float32, device=dev)
    out = torch.empty_like(h)
    lib = cuda_build.library()
    err = lib.f5_ff_block_int8_fwd(
        h.data_ptr(), sc.data_ptr(), sh.data_ptr(), gate.data_ptr(),
        qp_in["w_int8"].data_ptr(), qp_in["w_scale"].data_ptr(), qp_in["b"].data_ptr(),
        qp_out["w_int8"].data_ptr(), qp_out["w_scale"].data_ptr(), qp_out["b"].data_ptr(),
        yq.data_ptr(), ys.data_ptr(), z.data_ptr(), zq.data_ptr(), zs.data_ptr(),
        out.data_ptr(), m, d, dff, eps, f32, dev.index, cuda_build.stream_of(h))
    cuda_build.check(err, "ff_block_int8_fwd")
    launches_int8 += 1
    return out

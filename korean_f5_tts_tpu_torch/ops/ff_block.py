"""Fused DiT FF half-block: Hopper kernel B and its plain version.

Counterpart of korean_f5_tts_tpu/ops/ff_block.py (bf16 only):
    out = h + gate * FF(LN(h) * (1 + sc) + sh)
with FF = Linear(d -> dff) -> GELU(tanh) -> Linear(dff -> d). Weights are in
the port's torch layout: w1 [dff, d], w2 [d, dff]. The kernel
(csrc/ff_block.cu) replaces the TPU's _kernel; its source note records the
two-kernel design (z written once between the two products).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build

launches = 0  # kernel launches by ff_block_fused (not plain calls)


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
    """Kernel B wrapper: h [B, n, d] bf16, sc/sh/gate [d], w1 [dff, d],
    b1 [dff], w2 [d, dff], b2 [d].

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back.
    """
    global launches
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
    if d % 128 or dff % 128:
        raise ValueError(f"ff_block: d={d} and dff={dff} must be multiples of 128")
    cuda_build.require_cuda("ff_block", h, sc, sh, gate, w1, b1, w2, b2,
                            dtype=torch.bfloat16)
    m = h.numel() // d
    z = torch.empty((m, dff), dtype=h.dtype, device=h.device)
    out = torch.empty_like(h)
    lib = cuda_build.library()
    err = lib.f5_ff_block_fwd(
        h.data_ptr(), sc.data_ptr(), sh.data_ptr(), gate.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), z.data_ptr(), out.data_ptr(),
        m, d, dff, eps, h.device.index, cuda_build.stream_of(h))
    cuda_build.check(err, "ff_block_fwd")
    launches += 1
    return out

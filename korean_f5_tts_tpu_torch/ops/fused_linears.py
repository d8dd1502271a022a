"""Fused attention-side linears: Hopper kernels 7 and 8 (bf16, and their fp32
forms), 5 and 6 (int8) and their plain versions.

Counterparts of korean_f5_tts_tpu/ops/fused_linears.py:
  ln_mod_matmul             out = bf16(LN(h) * (1 + sc) + sh) @ W^T + b
                            (kernel 7: AdaLN-modulated norm + fused qkv product)
  proj_gated_residual       out = h + gate * (a @ W^T + b)
                            (kernel 8: out-projection folded into the gated residual)
Their weights are linears of the port's layout ({"w": [d_out, d_in], "b"});
the kernels (csrc/fused_linears.cu) replace the TPU's _ln_mod_matmul_kernel
and _proj_gated_kernel. Their operands are all bf16 (the TMA + wgmma core)
or all fp32 (the split 3xTF32 products of csrc/gemm_f32.cuh on the tensor
cores, fp32-accurate, as the TPU kernels compute at the input's dtype); a
mix raises TypeError, and each form keeps its own launch counter. Under
autograd (an input requires a gradient) each launches inside a
torch.autograd.Function whose backward differentiates the XLA formulation
(ln_mod_matmul_xla, proj_gated_xla), as the JAX custom_vjps do
(fused_linears.py:82-100, :237-254); the launch itself is an operator
(cuda_build.launch_op), so the "dots" remat policy can keep its output.

The int8 functions:
  ln_mod_matmul_int8        out = (q(LN(h) * (1 + sc) + sh) @ W^T) * ys * ws + b
                            (kernel 5: AdaLN-modulated norm + fused qkv product)
  proj_gated_residual_int8  out = h + gate * ((q(a) @ W^T) * as * ws + b)
                            (kernel 6: out-projection folded into the gated residual)
Weights are int8 linears of models/quant.py in the port's layout: w_int8
[d_out, d_in], w_scale [d_out] fp32, b [d_out]. The kernels
(csrc/fused_linears_int8.cu) replace the TPU's _ln_mod_matmul_int8_kernel
and _proj_gated_int8_kernel; each keeps one launch counter.

ln_mod_matmul and ln_mod_matmul_int8 take a list of linears sharing one
input (to_q, to_k, to_v) and return their outputs side by side: this is the
JAX package's product with the concatenated weight (dit.py:429-447),
without building that weight. The int8 kernels serve only (they raise on
an input that requires a gradient), as the JAX kernels have no vjp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build
from korean_f5_tts_tpu_torch.ops.qmatmul import (
    I8_CORE_MAX_K,
    check_int8_linear,
    check_int8_rows,
    check_tensor,
    int8_product,
    quant_rows_reference,
)

launches_ln_mod = 0            # kernel 7 launches by ln_mod_matmul (bf16)
launches_proj_gated = 0        # kernel 8 launches by proj_gated_residual (bf16)
launches_ln_mod_f32 = 0        # their fp32 forms
launches_proj_gated_f32 = 0
launches_ln_mod_int8 = 0       # kernel 5 launches by ln_mod_matmul_int8
launches_proj_gated_int8 = 0   # kernel 6 launches by proj_gated_residual_int8

MAX_SEGMENTS = 3  # linears one kernel-5 launch takes (q, k, v)

GEMM_MAX_LN_DIM = 4096  # kernels B and 7 hold (1 + sc) and sh in shared memory as fp32


def ln_stats_scratch(h: torch.Tensor) -> torch.Tensor:
    """[2, rows] fp32 scratch for the row statistics of kernels B and 7."""
    return torch.empty((2, h.numel() // h.shape[-1]), dtype=torch.float32, device=h.device)


def ln_mod_rows(h: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """fp32 LN(h) * (1 + sc) + sh, never rounded: the TPU int8 kernels
    quantize this value straight from fp32 (fused_linears.py:111-117,
    ff_block.py:108-115)."""
    xf = h.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * (1.0 + sc.float()) + sh.float()


def ln_mod_matmul_reference(h, sc, sh, ps, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel 7 with the TPU kernel's rounding points
    (fused_linears.py:34-43): LN and modulation in fp32, y rounded to h's
    dtype before the product, the product as an fp32 sum, + b in fp32, one
    cast. ps: a list of linears whose outputs are concatenated."""
    dt = h.dtype
    w = torch.cat([p["w"] for p in ps], dim=0).to(dt)
    b = torch.cat([p["b"] for p in ps]).to(dt)
    y = ln_mod_rows(h, sc, sh, eps).to(dt)
    return (torch.matmul(y.float(), w.float().t()) + b.float()).to(dt)


def proj_gated_residual_reference(a, h, gate, p) -> torch.Tensor:
    """Plain version of kernel 8 (fused_linears.py:198-203): the product as
    an fp32 sum, + b and h + gate * (.) in fp32, one cast."""
    dt = h.dtype
    o = torch.matmul(a.float(), p["w"].to(dt).float().t()) + p["b"].to(dt).float()
    return (h.float() + gate.float() * o).to(dt)


def _operand_dtype(what: str, x: torch.Tensor, *others: torch.Tensor) -> torch.dtype:
    """The dtype rule of kernels 7 and 8: every operand bf16 or every one
    fp32, else TypeError."""
    if x.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != x.dtype for t in others):
        raise TypeError(f"{what}: the operands must be all bfloat16 or all float32, got "
                        f"{sorted({str(t.dtype) for t in (x, *others)})}")
    return x.dtype


def ln_mod_matmul_xla(h, sc, sh, ps, eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's XLA formulation of kernel 7 (_ln_mod_matmul_xla,
    fused_linears.py:71-79), which its backward differentiates: LN
    statistics in fp32 (float64 stays float64), the normed rows rounded to
    h's dtype, the modulation and the product in h's dtype."""
    x = h.to(torch.promote_types(h.dtype, torch.float32))
    xc = x - x.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).to(h.dtype) * (1 + sc) + sh
    return F.linear(y, torch.cat([p["w"] for p in ps], dim=0),
                    torch.cat([p["b"] for p in ps]))


def proj_gated_xla(a, h, gate, p) -> torch.Tensor:
    """The JAX package's XLA formulation of kernel 8 (_proj_gated_xla,
    fused_linears.py:233-234): h + gate * (a @ W^T + b)."""
    return h + gate * F.linear(a, p["w"], p["b"])


def _vjp(fn, inputs, needs, g):
    """Gradients of fn(*inputs) for the output gradient g, for the inputs
    whose `needs` is true (None for the others)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        out = fn(*xs)
        grads = iter(torch.autograd.grad(out, [x for x, n in zip(xs, needs) if n], g))
    return [next(grads) if n else None for n in needs]


def _requires_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _linears(ws, bs) -> list[dict]:
    return [{"w": w, "b": b} for w, b in zip(ws, bs)]


def _ln_mod_matmul_launch(h, sc, sh, ws, bs, eps):
    return _ln_mod_matmul_fwd(h, sc, sh, _linears(ws, bs), eps)


def _proj_gated_launch(a, h, gate, w, b):
    return _proj_gated_fwd(a, h, gate, {"w": w, "b": b})


_ln_mod_matmul_op = cuda_build.launch_op(
    "ln_mod_matmul", "(Tensor h, Tensor sc, Tensor sh, Tensor[] ws, Tensor[] bs, float eps) "
    "-> Tensor", _ln_mod_matmul_launch)
_proj_gated_op = cuda_build.launch_op(
    "proj_gated_residual", "(Tensor a, Tensor h, Tensor gate, Tensor w, Tensor b) -> Tensor",
    _proj_gated_launch)


class LnModMatmul(torch.autograd.Function):
    """Kernel 7 under autograd: the forward launches it, the backward
    differentiates ln_mod_matmul_xla (the JAX _lmm_bwd)."""

    @staticmethod
    def forward(ctx, h, sc, sh, eps, *wb):
        ctx.eps = eps
        ctx.save_for_backward(h, sc, sh, *wb)
        k = len(wb) // 2
        return _ln_mod_matmul_op(h, sc, sh, list(wb[:k]), list(wb[k:]), eps)

    @staticmethod
    def backward(ctx, g):
        h, sc, sh, *wb = ctx.saved_tensors
        k = len(wb) // 2

        def fn(h, sc, sh, *wb):
            return ln_mod_matmul_xla(h, sc, sh, _linears(wb[:k], wb[k:]), ctx.eps)

        needs = (*ctx.needs_input_grad[:3], *ctx.needs_input_grad[4:])
        grads = _vjp(fn, (h, sc, sh, *wb), needs, g)
        return (*grads[:3], None, *grads[3:])


class ProjGatedResidual(torch.autograd.Function):
    """Kernel 8 under autograd: the forward launches it, the backward
    differentiates proj_gated_xla (the JAX _pgr_bwd)."""

    @staticmethod
    def forward(ctx, a, h, gate, w, b):
        ctx.save_for_backward(a, h, gate, w, b)
        return _proj_gated_op(a, h, gate, w, b)

    @staticmethod
    def backward(ctx, g):
        def fn(a, h, gate, w, b):
            return proj_gated_xla(a, h, gate, {"w": w, "b": b})

        return tuple(_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad, g))


def ln_mod_matmul(h, sc, sh, ps, eps: float = 1e-6) -> torch.Tensor:
    """Kernel 7 wrapper: h [..., d], sc/sh [d], ps a list of one to three
    linears of one shape ({w [n, d], b [n]}) -> [..., n * len(ps)], all bf16
    or all fp32 (the fp32 form).

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any number of rows; d % 32 == 0, d <= 4096,
    n % 128 == 0. When an input requires a gradient, the launch runs inside
    LnModMatmul, whose backward differentiates ln_mod_matmul_xla.
    """
    if any("b" not in p for p in ps):
        raise ValueError("ln_mod_matmul: the linears need a bias")
    ws, bs = [p["w"] for p in ps], [p["b"] for p in ps]
    if _requires_grad(h, sc, sh, *ws, *bs):
        return LnModMatmul.apply(h, sc, sh, eps, *ws, *bs)
    return _ln_mod_matmul_fwd(h, sc, sh, ps, eps)


def _ln_mod_matmul_fwd(h, sc, sh, ps, eps: float) -> torch.Tensor:
    """Kernel 7's launch (its plain version on CPU tensors)."""
    global launches_ln_mod, launches_ln_mod_f32
    if h.device.type == "cpu":
        return ln_mod_matmul_reference(h, sc, sh, ps, eps)
    if not 1 <= len(ps) <= MAX_SEGMENTS:
        raise ValueError(f"ln_mod_matmul: 1 to {MAX_SEGMENTS} linears, got {len(ps)}")
    d = h.shape[-1]
    n = ps[0]["w"].shape[0]
    if d % 32 or n % 128 or d > GEMM_MAX_LN_DIM:
        raise ValueError(f"ln_mod_matmul: d={d} must be a multiple of 32, at most "
                         f"{GEMM_MAX_LN_DIM}, and n={n} a multiple of 128")
    dt = _operand_dtype("ln_mod_matmul", h, sc, sh, *(t for p in ps for t in (p["w"], p["b"])))
    for name, v in (("sc", sc), ("sh", sh)):
        check_tensor("ln_mod_matmul", name, v, (d,))
    for p in ps:
        check_tensor("ln_mod_matmul", "w", p["w"], (n, d))
        check_tensor("ln_mod_matmul", "b", p["b"], (n,))
    cuda_build.require_cuda("ln_mod_matmul", h, sc, sh, *(t for p in ps for t in (p["w"], p["b"])),
                            dtype=dt)
    m = h.numel() // d
    out = torch.empty((*h.shape[:-1], n * len(ps)), dtype=h.dtype, device=h.device)
    seg = [ps[min(i, len(ps) - 1)] for i in range(MAX_SEGMENTS)]
    stats = ln_stats_scratch(h)
    lib = cuda_build.library()
    f32 = dt == torch.float32
    fwd = lib.f5_ln_mod_matmul_f32_fwd if f32 else lib.f5_ln_mod_matmul_fwd
    err = fwd(h.data_ptr(), sc.data_ptr(), sh.data_ptr(), *(p["w"].data_ptr() for p in seg),
              *(p["b"].data_ptr() for p in seg), stats.data_ptr(), out.data_ptr(), m, d, n,
              len(ps), eps, h.device.index, cuda_build.stream_of(h))
    cuda_build.check(err, "ln_mod_matmul_fwd")
    if f32:
        launches_ln_mod_f32 += 1
    else:
        launches_ln_mod += 1
    return out


def proj_gated_residual(a, h, gate, p) -> torch.Tensor:
    """Kernel 8 wrapper: a [..., din], h [..., d], gate [d], p {w [d, din],
    b [d]} -> [..., d], all bf16 or all fp32 (the fp32 form).

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any number of rows; din % 32 == 0, d % 128 == 0.
    When an input requires a gradient, the launch runs inside
    ProjGatedResidual, whose backward differentiates proj_gated_xla.
    """
    if "b" not in p:
        raise ValueError("proj_gated_residual: the linear needs a bias")
    if _requires_grad(a, h, gate, p["w"], p["b"]):
        return ProjGatedResidual.apply(a, h, gate, p["w"], p["b"])
    return _proj_gated_fwd(a, h, gate, p)


def _proj_gated_fwd(a, h, gate, p) -> torch.Tensor:
    """Kernel 8's launch (its plain version on CPU tensors)."""
    global launches_proj_gated, launches_proj_gated_f32
    if a.device.type == "cpu":
        return proj_gated_residual_reference(a, h, gate, p)
    din, d = a.shape[-1], h.shape[-1]
    if a.shape[:-1] != h.shape[:-1]:
        raise ValueError(f"proj_gated_residual: a {tuple(a.shape)} and h {tuple(h.shape)} "
                         "must have the same rows")
    if din % 32 or d % 128:
        raise ValueError(f"proj_gated_residual: din={din} must be a multiple of 32 and "
                         f"d={d} of 128")
    dt = _operand_dtype("proj_gated_residual", a, h, gate, p["w"], p["b"])
    check_tensor("proj_gated_residual", "gate", gate, (d,))
    check_tensor("proj_gated_residual", "w", p["w"], (d, din))
    check_tensor("proj_gated_residual", "b", p["b"], (d,))
    cuda_build.require_cuda("proj_gated_residual", a, h, gate, p["w"], p["b"], dtype=dt)
    out = torch.empty_like(h)
    lib = cuda_build.library()
    f32 = dt == torch.float32
    fwd = lib.f5_proj_gated_f32_fwd if f32 else lib.f5_proj_gated_fwd
    err = fwd(a.data_ptr(), h.data_ptr(), gate.data_ptr(), p["w"].data_ptr(), p["b"].data_ptr(),
              out.data_ptr(), a.numel() // din, din, d, a.device.index, cuda_build.stream_of(a))
    cuda_build.check(err, "proj_gated_fwd")
    if f32:
        launches_proj_gated_f32 += 1
    else:
        launches_proj_gated += 1
    return out


def ln_mod_matmul_int8_reference(h, sc, sh, qps, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel 5 (fused_linears.py:109-121): y in fp32, one
    per-row quantization, exact integer product, fp32 acc * ys * ws + b, one
    cast to h's dtype. qps: a list of int8 linears whose outputs are
    concatenated."""
    w = torch.cat([p["w_int8"] for p in qps], dim=0)
    ws = torch.cat([p["w_scale"] for p in qps]).float()
    b = torch.cat([p["b"] for p in qps]).float()
    q, s = quant_rows_reference(ln_mod_rows(h, sc, sh, eps))
    return (int8_product(q, w) * s * ws + b).to(h.dtype)


def proj_gated_residual_int8_reference(a, h, gate, qp) -> torch.Tensor:
    """Plain version of kernel 6 (fused_linears.py:156-164): q(a) from fp32,
    exact integer product, fp32 h + gate * (acc * as * ws + b), one cast."""
    q, s = quant_rows_reference(a)
    o = int8_product(q, qp["w_int8"]) * s * qp["w_scale"].float() + qp["b"].float()
    return (h.float() + gate.float() * o).to(h.dtype)


def ln_mod_matmul_int8(h, sc, sh, qps, eps: float = 1e-6) -> torch.Tensor:
    """Kernel 5 wrapper: h [..., d] bf16 or fp32, sc/sh [d] and the biases of
    h's dtype (a mix raises TypeError), qps a list of one to three int8
    linears of one shape ({w_int8 [n, d], w_scale [n] fp32, b [n]}) ->
    [..., n * len(qps)] of h's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any number of rows; d % 16 == 0, d <= 4096
    (the row pass holds a row in registers), n % 128 == 0.
    """
    global launches_ln_mod_int8
    cuda_build.require_no_grad("ln_mod_matmul_int8", h, sc, sh)
    if h.device.type == "cpu":
        return ln_mod_matmul_int8_reference(h, sc, sh, qps, eps)
    if not 1 <= len(qps) <= MAX_SEGMENTS:
        raise ValueError(f"ln_mod_matmul_int8: 1 to {MAX_SEGMENTS} linears, got {len(qps)}")
    d = h.shape[-1]
    n = qps[0]["w_int8"].shape[0]
    if any("b" not in p for p in qps):
        raise ValueError("ln_mod_matmul_int8: the linears need a bias")
    f32 = check_int8_rows("ln_mod_matmul_int8", h, sc=sc, sh=sh,
                          **{f"b{i}": p["b"] for i, p in enumerate(qps)})
    for name, v in (("sc", sc), ("sh", sh)):
        check_tensor("ln_mod_matmul_int8", name, v, (d,))
    for p in qps:
        check_int8_linear("ln_mod_matmul_int8", h, p["w_int8"], p["w_scale"], p["b"], n, d,
                          k_multiple=16, k_max=I8_CORE_MAX_K)
    cuda_build.require_cuda("ln_mod_matmul_int8", h, sc, sh)
    m = h.numel() // d
    yq = torch.empty((m, d), dtype=torch.int8, device=h.device)
    ys = torch.empty((m,), dtype=torch.float32, device=h.device)
    out = torch.empty((*h.shape[:-1], n * len(qps)), dtype=h.dtype, device=h.device)
    seg = [qps[min(i, len(qps) - 1)] for i in range(MAX_SEGMENTS)]
    lib = cuda_build.library()
    err = lib.f5_ln_mod_matmul_int8_fwd(
        h.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        *(p["w_int8"].data_ptr() for p in seg), *(p["w_scale"].data_ptr() for p in seg),
        *(p["b"].data_ptr() for p in seg), yq.data_ptr(), ys.data_ptr(), out.data_ptr(),
        m, d, n, len(qps), eps, f32, h.device.index, cuda_build.stream_of(h))
    cuda_build.check(err, "ln_mod_matmul_int8_fwd")
    launches_ln_mod_int8 += 1
    return out


def proj_gated_residual_int8(a, h, gate, qp) -> torch.Tensor:
    """Kernel 6 wrapper: a [..., din] and h [..., d] bf16 or fp32, gate [d]
    and the bias of their dtype (a mix raises TypeError), qp {w_int8 [d, din],
    w_scale [d] fp32, b [d]} -> [..., d] of their dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any number of rows; din % 16 == 0, din <= 4096
    (the int8 core's row pass holds a row in registers), d % 128 == 0.
    """
    global launches_proj_gated_int8
    cuda_build.require_no_grad("proj_gated_residual_int8", a, h, gate)
    if a.device.type == "cpu":
        return proj_gated_residual_int8_reference(a, h, gate, qp)
    din, d = a.shape[-1], h.shape[-1]
    if a.shape[:-1] != h.shape[:-1]:
        raise ValueError(f"proj_gated_residual_int8: a {tuple(a.shape)} and h "
                         f"{tuple(h.shape)} must have the same rows")
    if "b" not in qp:
        raise ValueError("proj_gated_residual_int8: the linear needs a bias")
    f32 = check_int8_rows("proj_gated_residual_int8", a, h=h, gate=gate, b=qp["b"])
    check_tensor("proj_gated_residual_int8", "gate", gate, (d,))
    check_int8_linear("proj_gated_residual_int8", a, qp["w_int8"], qp["w_scale"], qp["b"],
                      d, din, k_multiple=16, k_max=I8_CORE_MAX_K)
    cuda_build.require_cuda("proj_gated_residual_int8", a, h, gate, dtype=a.dtype)
    m = a.numel() // din
    aq = torch.empty((m, din), dtype=torch.int8, device=a.device)
    as_ = torch.empty((m,), dtype=torch.float32, device=a.device)
    out = torch.empty_like(h)
    lib = cuda_build.library()
    err = lib.f5_proj_gated_int8_fwd(
        a.data_ptr(), h.data_ptr(), gate.data_ptr(), qp["w_int8"].data_ptr(),
        qp["w_scale"].data_ptr(), qp["b"].data_ptr(), aq.data_ptr(), as_.data_ptr(),
        out.data_ptr(), m, din, d, f32, a.device.index, cuda_build.stream_of(a))
    cuda_build.check(err, "proj_gated_int8_fwd")
    launches_proj_gated_int8 += 1
    return out

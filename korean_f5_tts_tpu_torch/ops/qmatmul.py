"""Dynamic-int8 matmul: Hopper kernel 9 and its plain version.

Counterpart of korean_f5_tts_tpu/ops/qmatmul.py:
    y = (q(x) @ W_int8^T) * x_scale * w_scale + b   [then tanh-GELU]
with per-row dynamic quantization of the activations and per-channel int8
weights in the port's layout w_int8 [N, K] (models/quant.py). The kernel
(csrc/qmatmul.cu) replaces the TPU's _qmm_kernel; its source note records
the design (rows quantized once by a row pass, then the int8 TMA + wgmma
product of csrc/gemm_int8.cuh that kernels 4, 5 and 6 run on).

quant_rows_reference and int8_product are the shared plain pieces of every
int8 kernel of the port (qmatmul, fused_linears, ff_block).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build

launches = 0  # kernel launches by qmatmul (not plain calls)

ACT_SCALE_FLOOR = 1e-6  # activation scale floor (weights use 1e-8, quant.py)


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division on every device. PyTorch's CUDA division
    by a Python number multiplies by its reciprocal instead, which rounds
    differently (on an H100 it moved the scale of 160 of 3072 rows by an ulp
    against the JAX package and the kernels); a tensor divisor divides."""
    return t / torch.full_like(t, 127.0)


def quant_rows_reference(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of fp32 values, as the TPU kernels'
    _quant_rows: s = max(max|y|, 1e-6) / 127 in fp32, q = clip(rint(y / s),
    -127, 127) with IEEE divisions and ties to even (torch.round).
    Returns (q as fp32 integer values, s [..., 1])."""
    y = y.float()
    s = div127(y.abs().amax(dim=-1, keepdim=True).clamp_min(ACT_SCALE_FLOOR))
    return torch.clamp(torch.round(y / s), -127.0, 127.0), s


def int8_product(q: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """Exact integer product q @ w_int8^T, returned as its fp32 rounding.

    Computed as a float64 matmul of the integer values: every product and
    partial sum is an integer below 2**53, so the sum is exact in any order,
    and the one rounding to fp32 is the int32 -> fp32 conversion of the TPU
    kernel and of the card's kernels. (torch.matmul on int8 CPU tensors
    wraps in int8, PyTorch has no int32 matmul on CUDA, and an fp32 product
    is exact only while 127**2 * K < 2**24, i.e. K <= 1040.)
    """
    return torch.matmul(q.double(), w_int8.double().t()).float()


def qmatmul_reference(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      activation: str | None = None) -> torch.Tensor:
    """Plain version of kernel 9: x [M, K] -> [M, N] in x's dtype.

    Rounding points of _qmm_kernel (qmatmul.py:24-37) and of the XLA qlinear
    (quant.py:59-70): quantize x from fp32, exact integer product, then in
    fp32 acc * x_scale * w_scale + b, optional tanh-GELU, one cast.
    """
    q, s = quant_rows_reference(x)
    y = int8_product(q, w_int8) * s * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    if activation == "gelu_tanh":
        y = F.gelu(y, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"qmatmul: unknown activation {activation!r}")
    return y.to(x.dtype)


def check_tensor(what: str, name: str, t: torch.Tensor, shape: tuple, dtype=None) -> None:
    """ValueError on a wrong shape, TypeError on a wrong dtype (None: the
    dtype is checked elsewhere)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")


I8_CORE_MAX_K = 4096  # kernels 4, 5, 6, 9 hold a row of K values in registers (gemm_int8.cuh)
# the rows kernels 4, 5, 6, 9 take (the TPU kernels read theirs as fp32 and
# write the input's dtype); their vectors (modulation, gate, biases) take the
# rows' dtype
INT8_ROW_DTYPES = (torch.bfloat16, torch.float32)


def check_int8_rows(what: str, x: torch.Tensor, **vectors: torch.Tensor) -> int:
    """TypeError unless the rows x are bf16 or fp32 and every named vector
    has their dtype (a mix is refused, as kernel B refuses one); returns the
    kernels' f32 flag."""
    if x.dtype not in INT8_ROW_DTYPES or any(v.dtype != x.dtype for v in vectors.values()):
        raise TypeError(f"{what}: the rows and their vectors must be all bfloat16 or all "
                        f"float32, got rows {x.dtype} and "
                        + ", ".join(f"{k} {v.dtype}" for k, v in vectors.items()))
    return int(x.dtype == torch.float32)


def check_int8_linear(what: str, x, w_int8, w_scale, bias, n: int, k: int, *,
                      k_multiple: int, k_max: int | None) -> None:
    """Checks before a kernel launch: one int8 linear {w_int8 [n, k] int8,
    w_scale [n] fp32, b [n] or None} on the CUDA device of the activations x,
    everything contiguous and 16-byte aligned; K a multiple of k_multiple (16
    for the int8 TMA core's rows; 128 for kernel 4's d and dff) and at most
    k_max (None: no bound), N a multiple of 128. The dtypes of x and the bias
    are check_int8_rows' to check."""
    check_tensor(what, "w_int8", w_int8, (n, k), torch.int8)
    check_tensor(what, "w_scale", w_scale, (n,), torch.float32)
    if bias is not None:
        check_tensor(what, "bias", bias, (n,))
    if k % k_multiple or n % 128 or (k_max is not None and k > k_max):
        raise ValueError(f"{what}: K={k} must be a multiple of {k_multiple}"
                         f"{'' if k_max is None else f' and at most {k_max}'}, and N={n} a "
                         "multiple of 128")
    cuda_build.require_cuda(what, x, w_int8, w_scale, *([] if bias is None else [bias]))


def check_qmatmul(x, w_int8, w_scale, bias, activation) -> None:
    """Kernel 9's checks before a launch: the int8 core's shape rule (any M;
    K % 16 == 0, K <= I8_CORE_MAX_K; N % 128 == 0) and the device checks."""
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"qmatmul: unknown activation {activation!r}")
    if x.dim() != 2:
        raise ValueError(f"qmatmul: x must be [M, K], got {tuple(x.shape)}")
    check_int8_rows("qmatmul", x, **({} if bias is None else {"bias": bias}))
    check_int8_linear("qmatmul", x, w_int8, w_scale, bias, w_int8.shape[0], x.shape[1],
                      k_multiple=16, k_max=I8_CORE_MAX_K)


def qmatmul(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor | None = None, activation: str | None = None) -> torch.Tensor:
    """Kernel 9 wrapper: x [M, K] bf16 or fp32, w_int8 [N, K] int8, w_scale
    [N] fp32, bias [N] of x's dtype or None, activation None or "gelu_tanh"
    -> [M, N] of x's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. Any M; K % 16 == 0 and K <= 4096 (the int8
    core's rule, the TPU kernel's domain: it keeps the whole K in VMEM),
    N % 128 == 0. Raises on an input that requires a gradient (forward-only,
    as the JAX kernel).
    """
    global launches
    cuda_build.require_no_grad("qmatmul", x, *(() if bias is None else (bias,)))
    if x.device.type == "cpu":
        return qmatmul_reference(x, w_int8, w_scale, bias, activation)
    check_qmatmul(x, w_int8, w_scale, bias, activation)
    m, k = x.shape
    n = w_int8.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = cuda_build.library()
    err = lib.f5_qmatmul_fwd(
        x.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        out.data_ptr(), m, k, n, int(activation == "gelu_tanh"), int(x.dtype == torch.float32),
        x.device.index, cuda_build.stream_of(x))
    cuda_build.check(err, "qmatmul_fwd")
    launches += 1
    return out

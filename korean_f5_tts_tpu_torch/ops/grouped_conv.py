"""ConvPositionEmbedding's grouped conv1d + Mish: Hopper kernel C and its plain
version.

Counterpart of korean_f5_tts_tpu/ops/grouped_conv.py. Weights keep the JAX
layout w [k, C/groups, C] with group-major output channels (the converter
leaves conv weights as they are); the plain version permutes a view to
torch's [C, C/groups, k]. The kernel (csrc/grouped_conv.cu) replaces the
TPU's _gc_kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build

launches = 0  # kernel launches by grouped_conv1d_mish (not plain calls)
KERNEL_GROUP_WIDTH = 64  # the only C / groups the kernel takes
KERNEL_MAX_TAPS = 33


def grouped_conv1d_mish_reference(x, w, b, groups: int, fuse_mish: bool = True):
    """Plain version of kernel C: x [B, N, C], w [k, C/groups, C], b [C] or
    None. SAME conv as fp32 sums of x's dtype values, bias and Mish in fp32,
    one cast."""
    k = w.shape[0]
    y = F.conv1d(x.float().transpose(1, 2), w.float().permute(2, 1, 0),
                 None if b is None else b.float(), padding=k // 2, groups=groups)
    y = y.transpose(1, 2)
    if fuse_mish:
        y = y * torch.tanh(F.softplus(y))
    return y.to(x.dtype)


def grouped_conv1d_mish(x, w, b, groups: int = 16, fuse_mish: bool = True):
    """Kernel C wrapper. CPU tensors take the plain version. CUDA tensors
    launch the kernel or raise; nothing falls back."""
    global launches
    if x.device.type == "cpu":
        return grouped_conv1d_mish_reference(x, w, b, groups, fuse_mish)
    B, N, C = x.shape
    k = w.shape[0]
    if C % groups or C // groups != KERNEL_GROUP_WIDTH:
        raise ValueError(f"grouped_conv: C / groups must be {KERNEL_GROUP_WIDTH}, got "
                         f"C={C}, groups={groups}")
    if k % 2 == 0 or k > KERNEL_MAX_TAPS:
        raise ValueError(f"grouped_conv: kernel size {k} must be odd and <= {KERNEL_MAX_TAPS}")
    if tuple(w.shape) != (k, C // groups, C):
        raise ValueError(f"grouped_conv: w has shape {tuple(w.shape)}, want {(k, C // groups, C)}")
    tensors = (x, w) if b is None else (x, w, b)
    if b is not None and tuple(b.shape) != (C,):
        raise ValueError(f"grouped_conv: b has shape {tuple(b.shape)}, want {(C,)}")
    cuda_build.require_cuda("grouped_conv", *tensors, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    lib = cuda_build.library()
    err = lib.f5_grouped_conv_fwd(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        B, N, C, groups, k, int(fuse_mish), x.device.index, cuda_build.stream_of(x))
    cuda_build.check(err, "grouped_conv_fwd")
    launches += 1
    return out

"""ConvPositionEmbedding's grouped conv1d + Mish: Hopper kernel C and its plain
version.

Counterpart of korean_f5_tts_tpu/ops/grouped_conv.py. Weights keep the JAX
layout w [k, C/groups, C] with group-major output channels (the converter
leaves conv weights as they are); the plain version permutes a view to
torch's [C, C/groups, k]. The kernel (csrc/grouped_conv.cu) replaces the
TPU's _gc_kernel, at 8 channels a group through the TPU kernel's
block-diagonal packing (pack_group_pairs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from korean_f5_tts_tpu_torch.ops import cuda_build

launches = 0      # kernel C launches by grouped_conv1d_mish on bf16 operands (not plain calls)
launches_f32 = 0  # kernel C's fp32 form, launches by grouped_conv1d_mish on fp32 operands
launches_g8 = 0       # kernel C at 8 channels a group (pairs packed, pack_group_pairs), bf16
launches_f32_g8 = 0   # the same on fp32 operands
# the group widths C / groups kernel C takes (csrc/grouped_conv.cu, one
# instantiation each from 16 up; 8 through pack_group_pairs on the 16-wide
# one): the widths the TPU kernel takes from 8 up; below 8 (which conv-pos's
# 16 groups never reach: the TPU predicate admits 1, 2 and 4 only at 32-128
# groups) a card launch raises
KERNEL_GROUP_WIDTHS = (8, 16, 32, 64, 128)
KERNEL_MAX_TAPS = 33
_LANES = 128


def pallas_conv_supported(c: int, groups: int, kernel: int) -> bool:
    """The shapes the TPU kernel takes (korean_f5_tts_tpu/ops/grouped_conv.py:42-50):
    C / groups divides 128, the groups fill whole 128-lane blocks, odd SAME
    kernel. Where it holds conv-pos runs kernel C; elsewhere the JAX package
    and the port run the plain grouped conv (models/modules.py)."""
    if c % groups != 0:
        return False
    cg = c // groups
    if cg > _LANES or _LANES % cg != 0:
        return False
    return groups % (_LANES // cg) == 0 and kernel % 2 == 1


def pack_group_pairs(w: torch.Tensor, groups: int) -> torch.Tensor:
    """[k, 8, C] weights of `groups` groups of 8 channels -> [k, 16, C] of
    groups / 2 groups of 16: each pair of groups as one block-diagonal group,
    w'[t, j*8 + ci, p*16 + l*8 + co] = w[t, ci, (2p + l)*8 + co] where j == l
    and 0 elsewhere. The TPU kernel's _pack_block_diag
    (korean_f5_tts_tpu/ops/grouped_conv.py:53-64) two groups deep instead of
    16 lanes' worth: kernel C's narrowest instantiation is 16 channels a group
    (a wgmma step is 16 deep, a TMA row 16 bytes). The input and output
    channel orders are unchanged, so x, b and the result are as they were."""
    k, cg, c = w.shape
    wg = w.reshape(k, cg, groups // 2, 2, cg)  # t, ci, p, l, co
    eye = torch.eye(2, dtype=w.dtype, device=w.device)
    w6 = wg[:, None] * eye[None, :, None, None, :, None]  # t, j, ci, p, l, co
    return w6.reshape(k, 2 * cg, c)


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


def grouped_conv1d_mish_train(x, w, b, groups: int, fuse_mish: bool = True):
    """The training path's conv: the plain convolution in x's dtype, the bias
    added and Mish taken in that dtype, for autograd to differentiate. This is
    the JAX package's _xla_ref (korean_f5_tts_tpu/ops/grouped_conv.py:126-137),
    which its custom_vjp runs in the forward rule and differentiates in the
    backward rule. On bf16 it rounds after the conv, after the bias and inside
    Mish, where kernel C's plain version rounds once."""
    k = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0), None, padding=k // 2,
                 groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(x.dtype)
    if fuse_mish:
        y = y * torch.tanh(F.softplus(y))
    return y


def grouped_conv1d_mish(x, w, b, groups: int = 16, fuse_mish: bool = True):
    """Kernel C wrapper: x, w and b (if any) all bf16 or all fp32 (a mix
    raises TypeError). CPU tensors take the plain version. CUDA tensors
    launch the kernel (wgmma on bf16; on fp32 split 3xTF32 products on the
    tensor cores, each tap summed apart, fp32-accurate) or raise; nothing
    falls back. At 8 channels a group the weights are packed into pairs
    first (pack_group_pairs, plain tensor ops) and the 16-channel
    instantiation runs at groups / 2, counted apart (launches_g8,
    launches_f32_g8).

    When a gradient is being taken (grad mode on and an input that requires
    one) the convolution runs as plain tensor code in x's dtype on any device
    (grouped_conv1d_mish_train) and autograd differentiates it, as the JAX
    package's custom_vjp does, since under remat the kernel's forward would
    only be run again for the backward.
    """
    global launches, launches_f32, launches_g8, launches_f32_g8
    tensors = (x, w) if b is None else (x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return grouped_conv1d_mish_train(x, w, b, groups, fuse_mish)
    if x.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("grouped_conv: operands must be all bfloat16 or all float32, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.device.type == "cpu":
        return grouped_conv1d_mish_reference(x, w, b, groups, fuse_mish)
    B, N, C = x.shape
    k = w.shape[0]
    if C % groups or C // groups not in KERNEL_GROUP_WIDTHS:
        raise ValueError(f"grouped_conv: C / groups must be one of {KERNEL_GROUP_WIDTHS}, got "
                         f"C={C}, groups={groups}")
    if k % 2 == 0 or k > KERNEL_MAX_TAPS:
        raise ValueError(f"grouped_conv: kernel size {k} must be odd and <= {KERNEL_MAX_TAPS}")
    if tuple(w.shape) != (k, C // groups, C):
        raise ValueError(f"grouped_conv: w has shape {tuple(w.shape)}, want {(k, C // groups, C)}")
    if b is not None and tuple(b.shape) != (C,):
        raise ValueError(f"grouped_conv: b has shape {tuple(b.shape)}, want {(C,)}")
    cuda_build.require_cuda("grouped_conv", *tensors, dtype=x.dtype)
    g8 = C // groups == 8
    if g8:  # a pair of groups a block-diagonal 16-channel group (one launch still)
        w, groups = pack_group_pairs(w, groups), groups // 2
    out = torch.empty_like(x)
    lib = cuda_build.library()
    f32 = x.dtype == torch.float32
    fwd = lib.f5_grouped_conv_f32_fwd if f32 else lib.f5_grouped_conv_fwd
    err = fwd(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
              B, N, C, groups, k, int(fuse_mish), x.device.index, cuda_build.stream_of(x))
    cuda_build.check(err, "grouped_conv_fwd")
    if g8 and f32:
        launches_f32_g8 += 1
    elif g8:
        launches_g8 += 1
    elif f32:
        launches_f32 += 1
    else:
        launches += 1
    return out

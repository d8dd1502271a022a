"""Prefix-masked attention: Hopper kernel A (serving forward), kernels 10-13
(training forward with logsumexp, the two dq sweeps, dk/dv), kernel 14 (the
serving forward with int8 products), kernels 18 and 19 (the forward with the
rotary embedding applied inside the kernel, on split heads and straight from
the fused qkv projection) and their plain versions.

Counterpart of korean_f5_tts_tpu/ops/flash_prefix.py. Every attention mask of
the model is a prefix mask, so one length per folded head describes it: head
i attends keys [0, kv_lens[i]). Kernel A (csrc/flash_prefix.cu) replaces the
TPU's _flash_prefix_folded; kernels 10-13 (csrc/flash_prefix_train.cu)
replace _flash_prefix_folded_lse, _flash_prefix_dq_lsein, _flash_prefix_dq
and _flash_prefix_dkv (10 runs on kernel A's TMA + wgmma attention core,
csrc/attn_wgmma.cuh, 11 and 13 on the attention backward core,
csrc/attn_bwd_wgmma.cuh; both need 16-byte-aligned contiguous operands,
which the wrappers check; their fp32 forms are split 3xTF32 tensor-core
products: kernel A's fp32 kernel for 10 (csrc/flash_prefix.cu) and
csrc/flash_prefix_train_f32.cu for 11-13); kernel 14
(csrc/flash_prefix_int8.cu, the int8 form of the attention core) replaces
_flash_prefix_folded_i8; kernel 18 (csrc/flash_prefix_rope.cu) replaces
_flash_prefix_rope_call, and kernel 19
(csrc/flash_prefix_qkv.cu) replaces _flash_prefix_qkv_call: both are the
rope form of the attention core of csrc/attn_wgmma.cuh (strided 4-D maps
over the split heads or the fused qkv rows, the rotation in shared memory).
The sources' notes say what bounds each kernel on the card and how its
design answers that. Kernels 18, 19 and 14 (with its pass) also take fp32
operands (the offline entry points' default weights): their fp32 forms are
kernel A's split 3xTF32 kernel with strided heads and the rotation in fp32
(csrc/flash_prefix.cu), the pass reading fp32 as it is, and for 14 the
attention core's int8 form with an fp32 output in "qkpv" (csrc/
flash_prefix_int8.cu) and in "qk" csrc/flash_prefix_int8_f32.cu, whose
integer scores are exact on the int8 tensor cores and whose p.v is fp32 p
times fp32 v as a split 3xTF32 product (kernel A's fp32 P.V).
Under autograd
kernels 18 and 19 launch inside torch.autograd.Functions whose backward
differentiates the plain rope + prefix attention (_xla_rope_prefix_reference,
_xla_qkv_reference), as the JAX custom_vjps _fpr_bwd and _fpq_bwd do
(:1496-1542, :1696-1745); no gradient flows to kv_lens, cos or sin.
Kernel 14 serves only (the JAX kernel has no vjp):
flash_prefix_attention_i8 quantizes q, k (and v) per folded head with one
kernel of its own (quantize_heads, csrc/quant_heads.cu; XLA in the JAX
package) and launches kernel 14 on the int8 operands.

Layouts: q/k/v/o and their gradients are folded [H, n, d]; lse (base 2, of
the scores pre-scaled by log2(e)/sqrt(d), the JAX convention) and
D = rowsum(dO * o) are fp32 [H, n] (the JAX arrays are [H, n, 1]). A row
with no valid key has lse 0.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise (every kernel on bf16 or fp32 operands, all of one dtype, a
mix raising TypeError, each form with its own launch counter). Head dims:
A, 10-14, 14's pass and 18 take d = 64 and d = 128 (KERNEL_HEAD_DIMS, the
JAX kernels' `d in (64, 128)`); 19 takes dh = 64 only, as the JAX kernel
(flash_prefix.py:1632, `2 * dh == LANES`). At d = 128 A, 10 and 18 in bf16
run on the attention core's d = 128 form (csrc/attn_wgmma.cuh, through
csrc/flash_prefix_core_d128.cu), 11, 12 and 13 in bf16 on the attention
backward core's (csrc/flash_prefix_bwd_core_d128.cu, on
csrc/attn_bwd_wgmma.cuh), A, 10 and 18 in fp32 on split 3xTF32 products
(csrc/flash_prefix_tf32_d128.cu), 11-13 in fp32 on split 3xTF32 products too
(csrc/flash_prefix_train_tf32_d128.cu), and 14 on the attention core's int8 D = 128
kernel (csrc/flash_prefix_int8_core_d128.cu) but its fp32 "qk" form, split
3xTF32 in csrc/flash_prefix_int8_d128.cu, each
with its own counter (`launches_*_d128`). Which head dims reach a kernel at all is the dispatch's
choice (ops/attention.py:ATTENTION_KERNEL_DIMS); a wrapper given another d
on a CUDA tensor raises.
flash_prefix_attention takes the autograd Function (kernel 10 forward,
kernels 11 and 13 backward, as the JAX custom_vjp _fp_fwd/_fp_bwd does at
:1353-1402) when a gradient is being taken, and kernel A otherwise.
"""

from __future__ import annotations

import math

import torch

from korean_f5_tts_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (64, 128)  # the head dims of kernels A, 10-14, 14's pass and 18
MASK_VALUE = -1e37  # the JAX reference's finite mask logit
I8_KEY_TILE = 128   # keys per tile of kernel 14 (and the unit n is padded to for its v8)
# keys per chunk of int8 attention's online softmax: the JAX wrapper's default
# bkv (flash_prefix_attention_i8, and F5_TTS_PREFIX_BKV's default in the
# model). It is part of the arithmetic: p8 = rint(127 p) sees the running max
# of the chunks visited so far. Kernel 14 takes its max per group of
# I8_KEY_CHUNK / I8_KEY_TILE tiles.
I8_KEY_CHUNK = 512

# kernel launches by the wrappers (not plain calls)
launches = 0           # kernel A, flash_prefix_folded on bf16 operands
launches_f32 = 0       # kernel A's fp32 form, flash_prefix_folded on fp32 operands
launches_lse = 0       # kernel 10, flash_prefix_folded_lse on bf16 operands
launches_dq_lsein = 0  # kernel 11, flash_prefix_dq_lsein on bf16 operands
launches_dq = 0        # kernel 12, flash_prefix_dq on bf16 operands
launches_dkv = 0       # kernel 13, flash_prefix_dkv on bf16 operands
launches_lse_f32 = 0       # the fp32 forms of kernels 10-13 (fp32 operands)
launches_dq_lsein_f32 = 0
launches_dq_f32 = 0
launches_dkv_f32 = 0
launches_i8 = 0        # kernel 14, flash_prefix_folded_i8
launches_i8_quant = 0  # kernel 14's quantization pass, quantize_heads
launches_rope = 0      # kernel 18, flash_prefix_rope_attention
launches_qkv = 0       # kernel 19, flash_prefix_qkv_attention
launches_i8_f32 = 0        # the fp32 forms of 14 ("qkpv"; "qk"), its pass, 18 and 19
launches_i8_qk_f32 = 0
launches_i8_quant_f32 = 0
launches_rope_f32 = 0
launches_qkv_f32 = 0
# the d = 128 forms (csrc/attn_wgmma.cuh, csrc/flash_prefix_bwd_core_d128.cu,
# csrc/flash_prefix_tf32_d128.cu, csrc/flash_prefix_train_tf32_d128.cu,
# csrc/flash_prefix_int8_core_d128.cu, csrc/flash_prefix_int8_d128.cu,
# csrc/quant_heads.cu at d = 128), bf16 and
# fp32, one counter each; 14 at d = 128
# counts "qkpv" and "qk" on bf16 apart
launches_d128 = 0
launches_f32_d128 = 0
launches_lse_d128 = 0
launches_lse_f32_d128 = 0
launches_dq_lsein_d128 = 0
launches_dq_lsein_f32_d128 = 0
launches_dq_d128 = 0
launches_dq_f32_d128 = 0
launches_dkv_d128 = 0
launches_dkv_f32_d128 = 0
launches_rope_d128 = 0
launches_rope_f32_d128 = 0
launches_i8_d128 = 0
launches_i8_qk_d128 = 0
launches_i8_f32_d128 = 0
launches_i8_qk_f32_d128 = 0
launches_i8_quant_d128 = 0
launches_i8_quant_f32_d128 = 0


def _count(base: str, f32: bool, d: int) -> None:
    """One launch of the form `base` (a counter name above without its
    suffixes) on fp32 or bf16 operands at head dim d."""
    name = base + ("_f32" if f32 else "") + ("_d128" if d == 128 else "")
    globals()[name] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _valid_keys(kv_lens: torch.Tensor, n: int, device) -> torch.Tensor:
    """[H, 1, n] bool: key j of head h is valid."""
    return (torch.arange(n, device=device)[None, :] < kv_lens.to(device)[:, None])[:, None, :]


def prefix_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kv_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: [H, n, d] q/k/v, [H] int kv_lens.

    Same formulation as the JAX reference _xla_prefix_attention: fp32 logits,
    fp32 softmax over the valid prefix, probabilities cast to v's dtype.
    Differentiable: autograd through it is the plain attention backward.
    """
    n, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    up = torch.promote_types(q.dtype, torch.float32)  # fp32 logits (float64 stays float64)
    logits = torch.matmul(q.to(up), k.to(up).transpose(-1, -2)) * scale
    logits = logits.masked_fill(~_valid_keys(kv_lens, n, q.device), MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _scores2(q: torch.Tensor, k: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """fp32 [H, n, n] scores in the base-2 domain, -inf at invalid keys."""
    n, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (LOG2E / math.sqrt(d))
    return s.masked_fill(~_valid_keys(kv_lens, n, q.device), -math.inf)


def _lse2(s2: torch.Tensor) -> torch.Tensor:
    """Base-2 logsumexp over the valid keys; 0 for a row with none."""
    lse = torch.logsumexp(s2 / LOG2E, dim=-1) * LOG2E
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def prefix_attention_lse_reference(q, k, v, kv_lens):
    """Plain version of kernel 10: (o [H, n, d], lse [H, n] fp32)."""
    return prefix_attention_reference(q, k, v, kv_lens), _lse2(_scores2(q, k, kv_lens))


def _probs_ds(q, k, v, do, dvec, lse, kv_lens):
    """Normalised P and dS = P * (dO.v^T - D), fp32 [H, n, n] each."""
    p = torch.exp2(_scores2(q, k, kv_lens) - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dvec.float()[..., None])


def flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens):
    """Plain version of kernel 11: dq = dS.k / sqrt(d), in fp32."""
    _, ds = _probs_ds(q, k, v, do, dvec, lse, kv_lens)
    return (torch.matmul(ds, k.float()) / math.sqrt(q.shape[-1])).to(q.dtype)


def flash_prefix_dq_reference(q, k, v, do, dvec, kv_lens):
    """Plain version of kernel 12: (dq, lse), the lse computed here."""
    lse = _lse2(_scores2(q, k, kv_lens))
    return flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens), lse


def flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv_lens):
    """Plain version of kernel 13: dk = dS^T.q / sqrt(d), dv = P^T.dO, in fp32."""
    p, ds = _probs_ds(q, k, v, do, dvec, lse, kv_lens)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) / math.sqrt(q.shape[-1])
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def rope_reference(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   pe_attn_head: int | None = None) -> torch.Tensor:
    """Half-split rotary embedding on [b, h, n, d] with kernel 18's rounding
    points: the tables rounded to x's dtype, the arithmetic in fp32, one
    rounding of the result. Heads at or past pe_attn_head keep x."""
    n, d2 = x.shape[2], x.shape[-1] // 2
    c = cos[:n].to(x.dtype).float()[None, None]
    s = sin[:n].to(x.dtype).float()[None, None]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    rx = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if pe_attn_head is None:
        return rx
    sel = (torch.arange(x.shape[1], device=x.device) < pe_attn_head)[None, :, None, None]
    return torch.where(sel, rx, x)


def flash_prefix_rope_reference(q, k, v, kv_lens, cos, sin, pe_attn_head=None):
    """Plain version of kernel 18 (_xla_rope_prefix_reference,
    flash_prefix.py:1484-1493): rope on the pre-rope q, k, then the plain
    prefix attention. [b, h, n, d] in and out."""
    (qf, kf, vf), lens_h = _fold(rope_reference(q, cos, sin, pe_attn_head),
                                 rope_reference(k, cos, sin, pe_attn_head), v, kv_lens)
    return prefix_attention_reference(qf, kf, vf, lens_h).reshape(q.shape)


def qkv_unpack(qkv: torch.Tensor, heads: int):
    """[B, n, 3 * heads * dh] (q | k | v, heads-major inside each) -> three
    [B, heads, n, dh] views."""
    B, n, three_inner = qkv.shape
    inner = three_inner // 3
    return tuple(qkv[..., i * inner:(i + 1) * inner].reshape(B, n, heads, -1).transpose(1, 2)
                 for i in range(3))


def flash_prefix_qkv_reference(qkv, kv_lens, heads, cos, sin, pe_attn_head=None):
    """Plain version of kernel 19 (_xla_qkv_reference, flash_prefix.py:
    1680-1693): split heads, rope, plain prefix attention, merge heads.
    [B, n, 3 * heads * dh] -> [B, n, heads * dh]."""
    q, k, v = qkv_unpack(qkv, heads)
    out = flash_prefix_rope_reference(q, k, v, kv_lens, cos, sin, pe_attn_head)
    B, h, n, d = out.shape
    return out.transpose(1, 2).reshape(B, n, h * d)


def _quant_head(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch*head) symmetric int8: [H, n, d] -> (int8 [H, n, d], amax [H]
    fp32), the JAX _quant_head (flash_prefix.py:901-907): amax floored at
    1e-8, x * (127 / amax) rounded half to even, clipped to +-127.

    127 / amax divides tensor by tensor: `127.0 / a` is Tensor.__rtruediv__,
    a reciprocal times 127, which is not the correctly rounded quotient and
    moves int8 values with it.
    """
    a = x.abs().amax(dim=(1, 2)).float().clamp_min(1e-8)
    scale = torch.full_like(a, 127.0) / a
    # bf16 * fp32 promotes inside the one multiply: no fp32 copy of x first
    x8 = (x * scale[:, None, None]).round_().clamp_(-127.0, 127.0)
    return x8.to(torch.int8), a


def _quantize_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pv_i8: bool):
    """The quantization pass of int8 attention: q, k, v of one [..., n, d]
    shape (folded [H, n, d], or [b, h, n, d] views of any strides) ->
    (q8, k8, v8 or v, c, sv) on folded heads, with
    c = aq*ak/127^2 * log2(e)/sqrt(d) and sv = av/127^2, multiplied in the
    order of the JAX wrapper (:933, :936). The tensors to quantize are
    gathered into one [2H or 3H, n, d] tensor (the one copy that folds the
    heads), so _quant_head's few launches run once, not per tensor."""
    n, d = q.shape[-2:]
    H = q.numel() // (n * d)
    x8, a = _quant_head(torch.cat((q, k, v) if pv_i8 else (q, k), dim=0).reshape(-1, n, d))
    q8, k8 = x8[:H], x8[H:2 * H]
    c = a[:H] * a[H:2 * H] * torch.full_like(a[:H], (1.0 / 127.0 ** 2) * LOG2E / math.sqrt(d))
    if not pv_i8:
        return q8, k8, v.reshape(H, n, d).contiguous(), c, torch.zeros_like(c)
    return q8, k8, x8[2 * H:], c, a[2 * H:] * torch.full_like(c, 1.0 / (127.0 * 127.0))


def _v8_kernel_layout(v8: torch.Tensor) -> torch.Tensor:
    """[H, n, d] int8 -> kernel 14's v operand [H, d, n_pad]: keys contiguous
    (the B operand of p8.v8), n padded with zeros to a multiple of the key
    tile (I8_KEY_TILE), and
    inside every group of 32 keys, key 16h + 8j + 2t + e at slot
    16h + 4t + 2j + e: the order in which a thread's score accumulator holds
    the keys, so that p8 is packed into the A fragment without a shuffle."""
    H, n, d = v8.shape
    n_pad = -(-n // I8_KEY_TILE) * I8_KEY_TILE
    if n_pad != n:
        v8 = torch.nn.functional.pad(v8, (0, 0, 0, n_pad - n))
    g = v8.reshape(H, n_pad // 32, 2, 2, 4, 2, d)  # [H, group, h, j, t, e, d]
    return g.permute(0, 6, 1, 2, 4, 3, 5).reshape(H, d, n_pad).contiguous()


def _v8_natural_layout(vk: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of _v8_kernel_layout: [H, d, n_pad] -> [H, n, d]."""
    H, d, n_pad = vk.shape
    g = vk.reshape(H, d, n_pad // 32, 2, 4, 2, 2)  # [H, d, group, h, t, j, e]
    return g.permute(0, 2, 3, 5, 4, 6, 1).reshape(H, n_pad, d)[:, :n]


def _i8_online(q8, k8, v, c, sv, kv_lens, pv_i8: bool, ck: int):
    """Kernel 14's online softmax on quantized folded heads, key chunk by key
    chunk of ck from key 0 (the JAX _chunk_plan: the last chunk holds what is
    left): (acc [H, n, d], l [H, n, 1], m [H, n, 1]) in fp32, the output
    unnormalised. v: int8 [H, n, d] (pv_i8) or the unquantized [H, n, d].
    Integer products run in fp32 (fp64 where a chunk's sum could pass 2^24),
    where sums of integers are exact."""
    H, n, d = q8.shape
    dev = q8.device
    lens = kv_lens.to(dev).clamp(max=n)[:, None, None]
    pv_t = torch.float32 if 127 * 127 * ck < 2 ** 24 else torch.float64
    q8f = q8.float()
    m = torch.full((H, n, 1), -math.inf, device=dev)
    l = torch.zeros((H, n, 1), device=dev)
    acc = torch.zeros((H, n, d), device=dev)
    for start in range(0, n, ck):
        stop = min(start + ck, n)
        s = torch.matmul(q8f, k8[:, start:stop].float().transpose(1, 2)) * c[:, None, None]
        col = torch.arange(start, stop, device=dev)[None, None, :]
        s = s.masked_fill(col >= lens, -math.inf)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_next), torch.zeros_like(m_next), m_next)
        p = torch.exp2(s - m_safe)
        alpha = torch.exp2(m - m_safe)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        m = m_next
        if pv_i8:
            p8 = torch.round(p * 127.0)  # p in [0, 1]: no clip
            pv = torch.matmul(p8.to(pv_t), v[:, start:stop].to(pv_t)).float()
            acc = acc * alpha + pv * sv[:, None, None]
        else:
            # bf16 v: p is rounded to bf16 for the product, as the kernel's
            # tensor cores take it; fp32 v: fp32 p times fp32 v, as the JAX
            # kernel (and kernel 14's fp32 "qk" form) multiplies them
            pb = p if v.dtype == torch.float32 else p.to(torch.bfloat16).float()
            acc = acc * alpha + torch.matmul(pb, v[:, start:stop].float())
    return acc, l, m


def _i8_attention_plain(q8, k8, v, c, sv, kv_lens, pv_i8: bool, ck: int) -> torch.Tensor:
    """Kernel 14's arithmetic on quantized folded heads (_i8_online), the
    output divided by l; a head with no valid key gives zeros."""
    acc, l, _ = _i8_online(q8, k8, v, c, sv, kv_lens, pv_i8, ck)
    inv = torch.where(l == 0.0, torch.ones_like(l), torch.ones_like(l) / l)
    return acc * inv


def flash_prefix_i8_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_lens: torch.Tensor, pv_i8: bool = True,
                              ck: int | None = None) -> torch.Tensor:
    """Plain version of kernel 14 on q/k/v of one [..., n, d] shape with H
    heads in all (folded [H, n, d], or [b, h, n, d]) and [H] int kv_lens; the
    result is folded [H, n, d]. The quantization pass, then the kernel's
    online softmax repeated chunk by chunk of ck keys (default I8_KEY_CHUNK,
    the JAX wrapper's default bkv, which kernel 14 computes).

    The chunk is part of the arithmetic: p8 = rint(127 * exp2(s - m)) sees
    the running max m when its chunk is visited. With ck = the JAX call's bkv
    this is the JAX kernel at that bkv (ck = 128: the JAX kernel at bkv =
    128, one max per kernel tile). pv_i8=False:
    only q.k^T is int8; on bf16 v, p is rounded to bf16 for the product with
    the unquantized v (the JAX kernel multiplies fp32 p by v there), on fp32
    v it stays fp32, as in the JAX kernel. The result has v's dtype. A head
    with kv_lens 0 gives zeros.
    """
    q8, k8, vq, c, sv = _quantize_qkv(q, k, v, pv_i8)
    out = _i8_attention_plain(q8, k8, vq, c, sv, kv_lens, pv_i8, ck or I8_KEY_CHUNK)
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, q, kv_lens, others,
           head_dims=KERNEL_HEAD_DIMS) -> tuple[int, int, int]:
    """Shape and device checks of a launch (the callers check q's dtype;
    the others must have it); returns (H, n, d)."""
    if q.dim() != 3 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{what}: q/k/v(/dO) must share one [H, n, d] shape, got "
                         f"{[tuple(t.shape) for t in (q, *others)]}")
    H, n, d = q.shape
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not supported ({head_dims})")
    if kv_lens.shape != (H,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"{what}: kv_lens must be int32 [{H}], got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
    cuda_build.require_cuda(what, q, *others, dtype=q.dtype)
    cuda_build.require_cuda(what, q, kv_lens)
    return H, n, d


def _rows(what: str, H: int, n: int, *rows) -> None:
    for r in rows:
        if r.shape != (H, n) or r.dtype != torch.float32:
            raise ValueError(f"{what}: lse and D must be fp32 [{H}, {n}], got "
                             f"{r.dtype} {tuple(r.shape)}")
    cuda_build.require_cuda(what, *rows)


def flash_prefix_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_lens: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper: [H, n, d] q/k/v (d 64 or 128), all bf16 or all fp32
    (a mix raises TypeError), [H] int32 kv_lens; the result has their dtype.
    bf16 runs on the TMA + wgmma attention core at both head dims. On fp32
    operands nothing is rounded below fp32 (split 3xTF32 products on the
    tensor cores at both head dims)."""
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_prefix: q, k, v must be all bfloat16 or all float32, got "
                        f"{[str(t.dtype) for t in (q, k, v)]}")
    if q.device.type == "cpu":
        return prefix_attention_reference(q, k, v, kv_lens)
    H, n, d = _check("flash_prefix", q, kv_lens, (k, v))
    out = torch.empty_like(q)
    lib = cuda_build.library()
    f32 = q.dtype == torch.float32
    fwd = lib.f5_flash_prefix_f32_fwd if f32 else lib.f5_flash_prefix_fwd
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
              H, n, d, LOG2E / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_fwd")
    _count("launches", f32, d)
    return out


def _train_dtype(what: str, q, *others) -> bool:
    """The dtype rule of kernels 10-13: q, k, v (and dO) all bf16 or all
    fp32, else TypeError; True for the fp32 form."""
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{what}: q, k, v and dO must be all bfloat16 or all float32, got "
                        f"{[str(t.dtype) for t in (q, *others)]}")
    return q.dtype == torch.float32


def flash_prefix_folded_lse(q, k, v, kv_lens):
    """Kernel 10 wrapper: (o [H, n, d] of q's dtype, lse [H, n] fp32); bf16
    operands on the attention core at both head dims, fp32 ones on kernel
    A's split 3xTF32 kernel at both (its lse form)."""
    if q.device.type == "cpu":
        return prefix_attention_lse_reference(q, k, v, kv_lens)
    f32 = _train_dtype("flash_prefix_lse", q, k, v)
    H, n, d = _check("flash_prefix_lse", q, kv_lens, (k, v))
    out = torch.empty_like(q)
    lse = torch.empty((H, n), dtype=torch.float32, device=q.device)
    lib = cuda_build.library()
    fwd = lib.f5_flash_prefix_f32_fwd_lse if f32 else lib.f5_flash_prefix_fwd_lse
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
              lse.data_ptr(), H, n, d, LOG2E / math.sqrt(d), q.device.index,
              cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_fwd_lse")
    _count("launches_lse", f32, d)
    return out, lse


def flash_prefix_dq_lsein(q, k, v, do, dvec, lse, kv_lens):
    """Kernel 11 wrapper: dq [H, n, d] from the forward's lse."""
    if q.device.type == "cpu":
        return flash_prefix_dq_lsein_reference(q, k, v, do, dvec, lse, kv_lens)
    f32 = _train_dtype("flash_prefix_dq_lsein", q, k, v, do)
    H, n, d = _check("flash_prefix_dq_lsein", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dq_lsein", H, n, dvec, lse)
    dq = torch.empty_like(q)
    lib = cuda_build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
            lse.data_ptr(), kv_lens.data_ptr(), dq.data_ptr(), H, n, d, LOG2E / math.sqrt(d),
            1.0 / math.sqrt(d))
    if f32:
        err = lib.f5_flash_prefix_f32_dq_lsein(*args, q.device.index, cuda_build.stream_of(q))
    else:
        err = lib.f5_flash_prefix_dq_lsein(*args, q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dq_lsein")
    _count("launches_dq_lsein", f32, d)
    return dq


def flash_prefix_dq(q, k, v, do, dvec, kv_lens):
    """Kernel 12 wrapper: (dq [H, n, d], lse [H, n]), the lse recomputed."""
    if q.device.type == "cpu":
        return flash_prefix_dq_reference(q, k, v, do, dvec, kv_lens)
    f32 = _train_dtype("flash_prefix_dq", q, k, v, do)
    H, n, d = _check("flash_prefix_dq", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dq", H, n, dvec)
    dq = torch.empty_like(q)
    lse = torch.empty((H, n), dtype=torch.float32, device=q.device)
    lib = cuda_build.library()
    fn = lib.f5_flash_prefix_f32_dq if f32 else lib.f5_flash_prefix_dq
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
             kv_lens.data_ptr(), dq.data_ptr(), lse.data_ptr(), H, n, d, LOG2E / math.sqrt(d),
             1.0 / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dq")
    _count("launches_dq", f32, d)
    return dq, lse


def flash_prefix_dkv(q, k, v, do, dvec, lse, kv_lens):
    """Kernel 13 wrapper: (dk, dv) [H, n, d]; bf16 operands on the attention
    backward core at both head dims, fp32 ones on split 3xTF32."""
    if q.device.type == "cpu":
        return flash_prefix_dkv_reference(q, k, v, do, dvec, lse, kv_lens)
    f32 = _train_dtype("flash_prefix_dkv", q, k, v, do)
    H, n, d = _check("flash_prefix_dkv", q, kv_lens, (k, v, do))
    _rows("flash_prefix_dkv", H, n, dvec, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda_build.library()
    fn = lib.f5_flash_prefix_f32_dkv if f32 else lib.f5_flash_prefix_dkv
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dvec.data_ptr(),
             lse.data_ptr(), kv_lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), H, n, d,
             LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_dkv")
    _count("launches_dkv", f32, d)
    return dk, dv


def _rope_launch_args(what: str, x: torch.Tensor, B: int, n: int, dh: int, kv_lens, cos, sin,
                      heads: int, pe_attn_head, head_dims=KERNEL_HEAD_DIMS):
    """Checks shared by kernels 18 (dh 64 or 128) and 19 (dh 64); returns
    (lens [B] int32, cos, sin as [n, dh / 2] tables of x's dtype: bf16 for
    the bf16 form, fp32 for the fp32 form, the number of leading heads that
    rotate)."""
    if dh not in head_dims:
        raise ValueError(f"{what}: head dim {dh} not supported ({head_dims})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: the kernel takes bf16 or fp32 operands, got {x.dtype}")
    if cos.shape != sin.shape or cos.dim() != 2 or cos.shape[0] < n or cos.shape[1] != dh // 2:
        raise ValueError(f"{what}: cos and sin must be [>= {n}, {dh // 2}] tables, got "
                         f"{tuple(cos.shape)} and {tuple(sin.shape)}")
    if kv_lens.dim() != 1 or kv_lens.shape[0] not in (1, B):
        raise ValueError(f"{what}: kv_lens must be [{B}] or [1], got {tuple(kv_lens.shape)}")
    lens = kv_lens.to(device=x.device, dtype=torch.int32).expand(B).contiguous()
    cos, sin = (t[:n].to(device=x.device, dtype=x.dtype).contiguous() for t in (cos, sin))
    cuda_build.require_cuda(what, x, cos, sin, dtype=x.dtype)
    cuda_build.require_cuda(what, x, lens)
    n_rope = heads if pe_attn_head is None else max(0, min(int(pe_attn_head), heads))
    return lens, cos, sin, n_rope


def flash_prefix_rope_attention(q, k, v, kv_lens, cos, sin,
                                pe_attn_head: int | None = None) -> torch.Tensor:
    """Kernel 18 wrapper: prefix attention with the half-split rotary
    embedding applied inside the kernel. q, k (PRE-rope), v: [b, h, n, d], d
    64 or 128 (bf16: the attention core's rope form at either; fp32: split
    3xTF32, csrc/flash_prefix.cu, csrc/flash_prefix_tf32_d128.cu), all bf16 or all fp32 (a mix raises TypeError; fp32 runs the fp32 form);
    kv_lens: [b] or [1] int; cos, sin: [>= n, d / 2] tables (cast to the
    operands' dtype for the kernel); pe_attn_head: only the first N heads
    rotate. The result has the operands' dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. When q, k or v requires a gradient the launch
    runs inside RopePrefixAttention, whose backward differentiates the plain
    rope + prefix attention.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return RopePrefixAttention.apply(q, k, v, kv_lens, cos, sin, pe_attn_head)
    return _rope_fwd(q, k, v, kv_lens, cos, sin, pe_attn_head)


def _rope_fwd(q, k, v, kv_lens, cos, sin, pe_attn_head: int | None) -> torch.Tensor:
    """Kernel 18's launch (its plain version on CPU tensors)."""
    if q.device.type == "cpu":
        return flash_prefix_rope_reference(q, k, v, kv_lens, cos, sin, pe_attn_head)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_prefix_rope_attention: q/k/v must share one [b, h, n, d] "
                         f"shape, got {[tuple(t.shape) for t in (q, k, v)]}")
    b, h, n, d = q.shape
    lens, cos, sin, n_rope = _rope_launch_args("flash_prefix_rope_attention", q, b, n, d,
                                               kv_lens, cos, sin, h, pe_attn_head)
    cuda_build.require_cuda("flash_prefix_rope_attention", q, k, v, dtype=q.dtype)
    out = torch.empty_like(q)
    lib = cuda_build.library()
    f32 = q.dtype == torch.float32
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), out.data_ptr(), b, h, n, n_rope, LOG2E / math.sqrt(d))
    if d == 128:
        err = lib.f5_flash_prefix_rope_d128_fwd(*args, int(f32), q.device.index,
                                                cuda_build.stream_of(q))
    else:
        fwd = lib.f5_flash_prefix_rope_f32_fwd if f32 else lib.f5_flash_prefix_rope_fwd
        err = fwd(*args, q.device.index, cuda_build.stream_of(q))
    cuda_build.check(err, "flash_prefix_rope_fwd")
    _count("launches_rope", f32, d)
    return out


def flash_prefix_qkv_attention(qkv, kv_lens, heads: int, cos, sin,
                               pe_attn_head: int | None = None) -> torch.Tensor:
    """Kernel 19 wrapper: attention straight from the fused qkv projection
    output. qkv: [B, n, 3 * heads * 64] bf16, or fp32 for the fp32 form
    (q | k | v along the features, heads-major inside each, q and k
    PRE-rope); returns [B, n, heads * 64] of qkv's dtype, already merged for
    the output projection. Other arguments as kernel 18.
    The kernel takes any B, heads (B * heads <= 65535) and n.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise; nothing falls back. When qkv requires a gradient the launch runs
    inside QkvPrefixAttention, whose backward differentiates the plain split,
    rope and prefix attention.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QkvPrefixAttention.apply(qkv, kv_lens, heads, cos, sin, pe_attn_head)
    return _qkv_fwd(qkv, kv_lens, heads, cos, sin, pe_attn_head)


def _qkv_fwd(qkv, kv_lens, heads: int, cos, sin, pe_attn_head: int | None) -> torch.Tensor:
    """Kernel 19's launch (its plain version on CPU tensors)."""
    global launches_qkv, launches_qkv_f32
    if qkv.device.type == "cpu":
        return flash_prefix_qkv_reference(qkv, kv_lens, heads, cos, sin, pe_attn_head)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError("flash_prefix_qkv_attention: qkv must be [B, n, 3 * heads * dh], got "
                         f"{tuple(qkv.shape)} for {heads} heads")
    B, n, three_inner = qkv.shape
    dh = three_inner // (3 * heads)
    lens, cos, sin, n_rope = _rope_launch_args("flash_prefix_qkv_attention", qkv, B, n, dh,
                                               kv_lens, cos, sin, heads, pe_attn_head,
                                               head_dims=(64,))
    out = torch.empty((B, n, heads * dh), dtype=qkv.dtype, device=qkv.device)
    lib = cuda_build.library()
    f32 = qkv.dtype == torch.float32
    fwd = lib.f5_flash_prefix_qkv_f32_fwd if f32 else lib.f5_flash_prefix_qkv_fwd
    err = fwd(qkv.data_ptr(), lens.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B,
              heads, n, n_rope, LOG2E / math.sqrt(dh), qkv.device.index,
              cuda_build.stream_of(qkv))
    cuda_build.check(err, "flash_prefix_qkv_fwd")
    if f32:
        launches_qkv_f32 += 1
    else:
        launches_qkv += 1
    return out


def quantize_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pv_i8: bool = True):
    """Kernel 14's quantization pass: q, k, v [b, h, n, d] (views of any
    strides) -> (q8, k8 [H, n, d] int8, v8 in _v8_kernel_layout [H, d, n_pad]
    int8 with pv_i8 else v folded [H, n, d], c [H], sv [H] fp32), H = b * h,
    with c and sv multiplied in the JAX wrapper's order.

    CPU tensors take the plain version (_quantize_qkv, then
    _v8_kernel_layout). CUDA tensors launch the pass (csrc/quant_heads.cu) or
    raise: q, k, v all bf16 or all fp32 (the fp32 form, which quantizes the
    fp32 values as they are), d 64 or 128; a view whose rows are not
    contiguous or whose strides are not 16-byte multiples is made contiguous
    first (the kernel reads any other view in place). It is equal to the
    plain version to the bit.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("quantize_heads: q/k/v must share one [b, h, n, d] shape, got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    b, h, n, d = q.shape
    if q.device.type == "cpu":
        q8, k8, vq, c, sv = _quantize_qkv(q, k, v, pv_i8)
        return q8, k8, (_v8_kernel_layout(vq) if pv_i8 else vq), c, sv
    if d not in KERNEL_HEAD_DIMS or q.dtype not in (torch.bfloat16, torch.float32) or \
            any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError("quantize_heads: the kernel takes q, k, v all bf16 or all fp32 with head "
                        f"dim 64 or 128, got {[str(t.dtype) for t in (q, k, v)]} with head dim "
                        f"{d}")

    def readable(t):  # rows contiguous, 16-byte strides and base
        ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
        return t if ok else t.contiguous()

    q, k, v = (readable(t) for t in (q, k, v))
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("quantize_heads: q, k, v must be on one CUDA device, got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    H = b * h
    q8 = torch.empty((H, n, d), dtype=torch.int8, device=dev)
    k8 = torch.empty_like(q8)
    n_pad = -(-n // I8_KEY_TILE) * I8_KEY_TILE
    v8 = torch.empty((H, d, n_pad), dtype=torch.int8, device=dev) if pv_i8 else None
    c = torch.empty((H,), dtype=torch.float32, device=dev)
    sv = torch.empty_like(c)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    err = cuda_build.library().f5_quant_heads(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, q8.data_ptr(), k8.data_ptr(),
        None if v8 is None else v8.data_ptr(), c.data_ptr(), sv.data_ptr(), b, h, n, n_pad, d,
        int(pv_i8), int(q.dtype == torch.float32),
        (1.0 / 127.0 ** 2) * LOG2E / math.sqrt(d), 1.0 / (127.0 * 127.0), dev.index,
        cuda_build.stream_of(q))
    cuda_build.check(err, "quant_heads")
    _count("launches_i8_quant", q.dtype == torch.float32, d)
    return q8, k8, (v8 if pv_i8 else v.reshape(H, n, d).contiguous()), c, sv


def flash_prefix_folded_i8(q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor,
                           c: torch.Tensor, sv: torch.Tensor, kv_lens: torch.Tensor,
                           pv_i8: bool = True,
                           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Kernel 14 wrapper on quantized folded heads. q8, k8: [H, n, d] int8,
    d 64 or 128 (k8 as it is: q8.k8^T wants k with d contiguous); v: with
    pv_i8 the int8 [H, d, n_pad] of _v8_kernel_layout (keys contiguous and
    slot-permuted), else the unquantized [H, n, d], bf16 or fp32; c, sv: [H]
    fp32; kv_lens: [H] int32. At d = 128 "qkpv" and "qk" on bf16 v run on
    the attention core's int8 D = 128 kernel (csrc/attn_wgmma.cuh:
    attn_i8_d128_wgmma_kernel: TMA rings, S and "qkpv"'s P.V on wgmma .s8,
    "qk"'s P.V on bf16 wgmma) and fp32 "qk" on split 3xTF32
    (csrc/flash_prefix_int8_d128.cu: S exact on mma.sync .s8), the running
    max per I8_KEY_CHUNK. Returns [H, n, d] of out_dtype (None: the unquantized v's
    dtype, bf16 under pv_i8), the JAX kernel's out_dtype: bf16 or, with
    pv_i8, fp32 on the attention core's int8 form; fp32 without pv_i8 on
    csrc/flash_prefix_int8_f32.cu, exact int8 scores on the tensor cores and
    fp32 p times fp32 v as a split 3xTF32 product (a bf16 v with an fp32
    output, or the reverse, raises TypeError). The JAX counterpart takes k8
    transposed instead, a Mosaic workaround.

    CPU tensors take the plain version at the kernel's key chunk
    (I8_KEY_CHUNK). CUDA tensors launch the kernel or raise. A head with
    kv_lens 0 gives zeros (the JAX kernel without prune gives the mean of v
    there; serving never sends 0).
    """
    H, n, d = q8.shape
    if out_dtype is None:
        out_dtype = torch.bfloat16 if pv_i8 else v.dtype
    if q8.device.type == "cpu":
        vn = _v8_natural_layout(v, n) if pv_i8 else v
        return _i8_attention_plain(q8, k8, vn, c, sv, kv_lens, pv_i8,
                                   I8_KEY_CHUNK).to(out_dtype)
    what = "flash_prefix_i8"
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: the output must be bf16 or fp32, got {out_dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not supported ({KERNEL_HEAD_DIMS})")
    if k8.shape != q8.shape or q8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise ValueError(f"{what}: q8 and k8 must be int8 of one [H, n, d] shape, got "
                         f"{q8.dtype} {tuple(q8.shape)} and {k8.dtype} {tuple(k8.shape)}")
    if pv_i8:
        n_pad = -(-n // I8_KEY_TILE) * I8_KEY_TILE
        if v.shape != (H, d, n_pad) or v.dtype != torch.int8:
            raise ValueError(f"{what}: v must be int8 [{H}, {d}, {n_pad}] (keys contiguous, "
                             f"_v8_kernel_layout), got {v.dtype} {tuple(v.shape)}")
    else:
        n_pad = n
        if v.shape != q8.shape or v.dtype != out_dtype:
            raise TypeError(f"{what}: with pv_i8=False v must be {out_dtype} {tuple(q8.shape)}, "
                            f"got {v.dtype} {tuple(v.shape)}")
    if kv_lens.shape != (H,) or kv_lens.dtype != torch.int32:
        raise ValueError(f"{what}: kv_lens must be int32 [{H}], got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
    if c.shape != (H,) or sv.shape != (H,):
        raise ValueError(f"{what}: c and sv must be [{H}], got {tuple(c.shape)}, "
                         f"{tuple(sv.shape)}")
    cuda_build.require_cuda(what, q8, k8, v, kv_lens)
    cuda_build.require_cuda(what, q8, c, sv, dtype=None)
    if c.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError(f"{what}: c and sv must be fp32, got {c.dtype}, {sv.dtype}")
    out = torch.empty((H, n, d), dtype=out_dtype, device=q8.device)
    lib = cuda_build.library()
    f32 = out_dtype == torch.float32
    if d == 128:
        err = lib.f5_flash_prefix_i8_d128_fwd(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), c.data_ptr(), sv.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), H, n, n_pad, int(pv_i8), int(f32),
            q8.device.index, cuda_build.stream_of(q8))
        cuda_build.check(err, "flash_prefix_i8_d128_fwd")
        _count("launches_i8" if pv_i8 else "launches_i8_qk", f32, d)
        return out
    if f32 and not pv_i8:
        err = lib.f5_flash_prefix_i8_qk_f32_fwd(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), c.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), H, n, q8.device.index, cuda_build.stream_of(q8))
        cuda_build.check(err, "flash_prefix_i8_qk_f32_fwd")
        _count("launches_i8_qk", True, d)
        return out
    err = lib.f5_flash_prefix_i8_fwd(q8.data_ptr(), k8.data_ptr(), v.data_ptr(), c.data_ptr(),
                                     sv.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), H, n,
                                     n_pad, int(pv_i8), int(f32), q8.device.index,
                                     cuda_build.stream_of(q8))
    cuda_build.check(err, "flash_prefix_i8_fwd")
    _count("launches_i8", f32, d)
    return out


def flash_prefix_attention_i8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_lens: torch.Tensor, pv_i8: bool = True,
                              kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] prefix attention with int8 q.k^T (and, with pv_i8, p.v)
    products: kernel 14 (JAX flash_prefix_attention_i8, :910-945).

    Inference only: per-head dynamic symmetric quantization of q, k (and v)
    by the pass quantize_heads, then the kernel. Accuracy is bounded by the
    127-level per-head quantization (about 1e-2 relative on the attention output):
    measure the end-to-end mel deviation before enabling it, by the protocol
    of scripts/int8_quality.py. kv_lens: [b] or [1] int.

    CPU tensors and kernels=False take the plain version at the kernel's key
    chunk (I8_KEY_CHUNK, the JAX default bkv). CUDA tensors launch the pass
    and the kernel (two launches) or raise: q, k, v all bf16 or all fp32
    (the fp32 forms of the pass and of 14; the result has their dtype), d 64
    or 128, any n (the ragged last tile is masked); nothing falls back to kernel
    A. Raises on an input that requires a gradient.
    """
    cuda_build.require_no_grad("flash_prefix_attention_i8", q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_prefix_attention_i8: q/k/v must share one [b, h, n, d] shape, "
                         f"got {[tuple(t.shape) for t in (q, k, v)]}")
    lens_h = _fold_lens(kv_lens, q.shape[0], q.shape[1], q.device)
    if not kernels or q.device.type == "cpu":
        return flash_prefix_i8_reference(q, k, v, lens_h, pv_i8=pv_i8).reshape(q.shape)
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype for t in (k, v)) \
            or q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise TypeError("flash_prefix_attention_i8: the kernels take q, k, v all bf16 or all fp32 "
                        f"with head dim 64 or 128, got {[str(t.dtype) for t in (q, k, v)]} with "
                        f"head dim {q.shape[-1]}")
    q8, k8, vq, c, sv = quantize_heads(q, k, v, pv_i8)
    return flash_prefix_folded_i8(q8, k8, vq, c, sv, lens_h, pv_i8=pv_i8,
                                  out_dtype=q.dtype).reshape(q.shape)


# ---------------------------------------------------------------------------
# backward and autograd
# ---------------------------------------------------------------------------


def _folded_bwd(q, k, v, kv_lens, g, o, lse):
    """(dq, dk, dv) of folded heads: D = rowsum(dO * o) in fp32 (plain, as
    the JAX package leaves it to XLA), then kernel 11 (lse given) or 12, then
    kernel 13."""
    dvec = (g.float() * o.float()).sum(dim=-1)
    if lse is not None:
        dq = flash_prefix_dq_lsein(q, k, v, g, dvec, lse, kv_lens)
    else:
        dq, lse = flash_prefix_dq(q, k, v, g, dvec, kv_lens)
    dk, dv = flash_prefix_dkv(q, k, v, g, dvec, lse, kv_lens)
    return dq, dk, dv


def _fold_lens(kv_lens: torch.Tensor, b: int, h: int, device) -> torch.Tensor:
    """[b] or [1] valid lengths -> int32 [b * h], one per folded head."""
    lens = kv_lens.to(device=device, dtype=torch.int32)
    if lens.shape[0] == 1 and b > 1:
        lens = lens.expand(b)
    return lens.repeat_interleave(h)


def _fold(q, k, v, kv_lens):
    b, h, n, d = q.shape
    fold = (b * h, n, d)
    return ([t.reshape(fold).contiguous() for t in (q, k, v)],
            _fold_lens(kv_lens, b, h, q.device))


def flash_prefix_attention_bwd(q, k, v, kv_lens, g, o=None, lse=None):
    """(dq, dk, dv) of [b, h, n, d] prefix attention for the output gradient g
    (JAX flash_prefix_attention_bwd, :1246-1297). o: the forward output, run
    through kernel A when absent. lse: the forward's [b*h, n] logsumexp;
    given, dq takes kernel 11, absent, kernel 12, which recomputes it."""
    (qf, kf, vf), lens_h = _fold(q, k, v, kv_lens)
    gf = g.reshape(qf.shape).contiguous()
    of = flash_prefix_folded(qf, kf, vf, lens_h) if o is None else o.reshape(qf.shape)
    return tuple(t.reshape(q.shape) for t in _folded_bwd(qf, kf, vf, lens_h, gf, of, lse))


def _lse_launch(q, k, v, kv_lens):
    return flash_prefix_folded_lse(q, k, v, kv_lens)


def _rope_launch(q, k, v, kv_lens, cos, sin, pe_attn_head):
    return _rope_fwd(q, k, v, kv_lens, cos, sin, pe_attn_head)


def _qkv_launch(qkv, kv_lens, heads, cos, sin, pe_attn_head):
    return _qkv_fwd(qkv, kv_lens, heads, cos, sin, pe_attn_head)


# the launches of kernels 10, 18 and 19 as operators (cuda_build.launch_op): the
# "dots" remat policy keeps their outputs, the attention outputs, for the backward
_lse_op = cuda_build.launch_op(
    "flash_prefix_folded_lse", "(Tensor q, Tensor k, Tensor v, Tensor kv_lens) -> (Tensor, Tensor)",
    _lse_launch)
_rope_op = cuda_build.launch_op(
    "flash_prefix_rope_attention", "(Tensor q, Tensor k, Tensor v, Tensor kv_lens, Tensor cos, "
    "Tensor sin, int? pe_attn_head) -> Tensor", _rope_launch)
_qkv_op = cuda_build.launch_op(
    "flash_prefix_qkv_attention", "(Tensor qkv, Tensor kv_lens, int heads, Tensor cos, "
    "Tensor sin, int? pe_attn_head) -> Tensor", _qkv_launch)


def _xla_rope_prefix(q, k, v, kv_lens, cos, sin, pe_attn_head):
    """The JAX _xla_rope_prefix_reference (flash_prefix.py:1484-1493): rope
    in the operands' dtype (modules.apply_rope), then the plain prefix
    attention. [b, h, n, d] in and out."""
    from korean_f5_tts_tpu_torch.models.modules import apply_rope

    n = q.shape[2]
    qr = apply_rope(q, cos[:n], sin[:n], pe_attn_head)
    kr = apply_rope(k, cos[:n], sin[:n], pe_attn_head)
    (qf, kf, vf), lens_h = _fold(qr, kr, v, kv_lens)
    return prefix_attention_reference(qf, kf, vf, lens_h).reshape(q.shape)


def _grad_of(fn, inputs, needs, g):
    """Gradients of fn(*inputs) for g, for the inputs whose `needs` is true."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        grads = iter(torch.autograd.grad(fn(*xs), [x for x, n in zip(xs, needs) if n], g))
    return [next(grads) if n else None for n in needs]


class RopePrefixAttention(torch.autograd.Function):
    """Kernel 18 under autograd: the forward launches it; the backward
    differentiates _xla_rope_prefix (the JAX _fpr_bwd), with no gradient
    for kv_lens, cos and sin. It materialises the [b, h, n, n] scores."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, cos, sin, pe_attn_head):
        ctx.pe_attn_head = pe_attn_head
        ctx.save_for_backward(q, k, v, kv_lens, cos, sin)
        return _rope_op(q, k, v, kv_lens, cos, sin, pe_attn_head)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, cos, sin = ctx.saved_tensors

        def fn(q, k, v):
            return _xla_rope_prefix(q, k, v, kv_lens, cos, sin, ctx.pe_attn_head)

        return (*_grad_of(fn, (q, k, v), ctx.needs_input_grad[:3], g), None, None, None, None)


class QkvPrefixAttention(torch.autograd.Function):
    """Kernel 19 under autograd: the forward launches it; the backward
    differentiates the split, _xla_rope_prefix and the head merge (the JAX
    _fpq_bwd), with no gradient for kv_lens, cos and sin."""

    @staticmethod
    def forward(ctx, qkv, kv_lens, heads, cos, sin, pe_attn_head):
        ctx.heads, ctx.pe_attn_head = heads, pe_attn_head
        ctx.save_for_backward(qkv, kv_lens, cos, sin)
        return _qkv_op(qkv, kv_lens, heads, cos, sin, pe_attn_head)

    @staticmethod
    def backward(ctx, g):
        qkv, kv_lens, cos, sin = ctx.saved_tensors

        def fn(qkv):
            out = _xla_rope_prefix(*qkv_unpack(qkv, ctx.heads), kv_lens, cos, sin,
                                   ctx.pe_attn_head)
            B, h, n, d = out.shape
            return out.transpose(1, 2).reshape(B, n, h * d)

        return (*_grad_of(fn, (qkv,), ctx.needs_input_grad[:1], g), None, None, None, None,
                None)


class FlashPrefixAttention(torch.autograd.Function):
    """Folded prefix attention with a kernel backward: the forward is kernel
    10 and keeps o and lse; the backward is D, kernel 11, kernel 13 (each in
    the operands' form: bf16 or fp32)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens):
        o, lse = _lse_op(q, k, v, kv_lens)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        dq, dk, dv = _folded_bwd(q, k, v, kv_lens, g.contiguous(), o, lse)
        return dq, dk, dv, None


def flash_prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lens: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """[b, h, n, d] attention where item i attends only keys [0, kv_lens[i]).

    kv_lens: [b] or [1] (broadcast) int valid-prefix lengths. Query rows past
    the prefix get well-defined output over the valid keys (callers zero or
    slice them). With a gradient being taken the kernel path is the autograd
    Function (kernels 10, 11, 13), otherwise kernel A. kernels=False runs the
    plain version on any device, and autograd differentiates it.
    """
    (qf, kf, vf), lens_h = _fold(q, k, v, kv_lens)
    if not kernels:
        out = prefix_attention_reference(qf, kf, vf, lens_h)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashPrefixAttention.apply(qf, kf, vf, lens_h)
    else:
        out = flash_prefix_folded(qf, kf, vf, lens_h)
    return out.reshape(q.shape)

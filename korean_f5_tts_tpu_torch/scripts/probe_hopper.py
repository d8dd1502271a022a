"""Probes of the CUDA idioms the qkv-layout attention kernel rests on
(counterpart of scripts/probe_mosaic.py, which probes the Mosaic lowering of
the same idioms for the TPU kernel).

    python -m korean_f5_tts_tpu_torch.scripts.probe_hopper

Tiny hand-written kernels (csrc/probe_hopper.cu), each held against two
lines of torch and printed OK or FAIL by name:
  slice_mma   a 64-column slice of a wider row-major array fed to an mma
              product (a head read in place from the fused qkv rows);
  pair_store  two heads' results stored side by side into one merged row
              (the [B, n, heads * 64] output written without a merge pass);
  half_swap   the half swap of the rotary embedding inside a 64-wide head
              (the loader that ropes rows as it stages them).
and the idioms of the TMA + wgmma product core (csrc/gemm_bf16.cuh):
  tma_swizzle a TMA tile load into 128-byte-swizzled shared memory, signalled
              on an mbarrier, inside the array and hanging over its edge
              (zero fill): the bytes must lie where hopper.cuh says they do;
  wgmma_ss    wgmma m64n128k16 with both operands read through
              shared-memory descriptors of that layout, against a product;
  wgmma_rs    the same with the A operand read by ldmatrix from the
              swizzled tile, changed in registers (2x + 1) and fed to wgmma
              from registers: the form kernels B and 7 compute LN in;
  tile_width  kernel 8's product (out = h + gate * (a @ W^T + b)) at each of
              the core's two output tile widths, forced (the kernels' entry
              points pick one by the card's SM count).
and the same idioms on 8-bit operands, for the int8 core (csrc/gemm_int8.cuh):
  tma_swizzle_i8  an int8 TMA box (128 int8 a 128-byte row), inside the array
              and over its edge, swizzled as the bf16 box is;
  wgmma_s8_n128, wgmma_s8_n256  wgmma m64nNk32 .s32.s8.s8 over one 128-deep
              stage (four k32 steps, the descriptor advancing 32 bytes a
              step), both operands through descriptors, against the product
              in float64 (exact at these sizes).
and the idioms of the attention core (csrc/attn_wgmma.cuh):
  tma_3d, tma_3d_edge  a 64-row box of a 3-D map over folded heads [H, n,
              64], inside a head and hanging over its last row: past n the
              box holds zeros, not the next head's rows;
  wgmma_pv    O = P.V with P laid out as the m64n128 score accumulator,
              rounded to bf16 into A fragments in registers, and V [128][64]
              read as an MN-major operand through a transposed-B descriptor
              (wgmma m64n64k16), against P.float() @ V.float().
and the idioms of the attention core's rope form (kernel 19):
  tma_4d_qkv, tma_4d_qkv_edge  a 64-row box of one head's 64 columns of a
              fused qkv array through a strided 4-D map, inside the rows
              and hanging over an item's last row: the torch slice, then
              zeros, never the next item's rows;
  tma_4d_heads, tma_4d_heads_edge  the same map over split heads [B, heads,
              n, 64] (slot stride n * 64, row stride 64; kernel 18);
  rope_smem, rope_wgmma  q and K tiles landed by TMA (K's rows of the
              tables beside it), rotated in shared memory on the swizzled
              layout (the partners at chunks p and p ^ 4), fenced for the
              async proxy and multiplied by wgmma:
              the rotated K tile equals rope_reference's rows swizzled to
              the bit, and S = q.K^T their product.
and the idioms of the attention backward core (csrc/attn_bwd_wgmma.cuh):
  wgmma_ss_n64  wgmma m64n64k16 with both operands through k-major
              descriptors (the 64-query score tiles S^T = K.Q^T, dP^T =
              V.dO^T), against a product;
  wgmma_bwd_grad  that m64n64 accumulator rounded to bf16 into A fragments
              in registers, times a 64-row MN-major tile (dV += P^T.dO,
              dK += dS^T.Q), against the kernel's own scores rounded to bf16
              times the tile.
and the idioms of the attention core's int8 form (kernel 14):
  wgmma_qk_s8  S = q8.k8^T on wgmma m64n128k32 .s32.s8.s8 from one head's
              [n, 64] int8 rows through 3-D maps whose 128-byte boxes TMA
              fills past the 64-byte row (and past row n) with zeros;
  wgmma_rs_s8  wgmma m64n64k32 .s32.s8.s8 with the 8-bit A operand from
              registers in mma.m16n8k32's fragment layout, B k-major;
  wgmma_pv_s8  p8 = rint(127 p) packed from the score accumulator's
              positions into those fragments, times v8 in kernel 14's slot
              permutation (_v8_kernel_layout): the product in natural key
              order, exact.
and the idioms of the fp32 product core (csrc/gemm_f32.cuh: the fp32 forms
of B, 7 and 8):
  tma_swizzle_f32  an fp32 TMA box (32 fp32 a 128-byte row), inside the
              array and over its edge, swizzled as the bf16 box is;
  wgmma_tf32_ss, wgmma_tf32_rs  wgmma m64n128k8 .tf32 over one 32-deep
              stage of raw fp32 words, both operands through descriptors,
              and A from registers by ldmatrix: against the product of the
              operands read as tf32, truncated or rounded, whichever the card
              does (a line says which);
  wgmma_3xtf32  the core's split product: A split into hi and lo in
              registers, B into a hi tile in place and a lo tile beside it,
              the small terms first, against the product in float64 at fp32
              accuracy (a single TF32 product misses it by ~1e-3).
and, printed beside them (a measurement, not held): the tensor cores' fp32
accumulation (tf32_accumulate), 32 products that each add three quarters of
an ulp to an accumulator of 1 on mma.sync m16n8k8 .tf32 and on wgmma .tf32:
an ulp a step when they round to nearest, none when they truncate.
Unlike the Mosaic script it raises on a failure. It needs a CUDA card.
"""

from __future__ import annotations

import torch

from korean_f5_tts_tpu_torch.ops import cuda_build
from korean_f5_tts_tpu_torch.ops.flash_prefix import (
    _v8_kernel_layout,
    _v8_natural_layout,
    rope_reference,
)
from korean_f5_tts_tpu_torch.ops.fused_linears import proj_gated_residual_reference
from korean_f5_tts_tpu_torch.utils.misc import require_device


def _probes(dev: torch.device) -> dict:
    """name -> (got, want, absolute tolerance)."""
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def rnd_i8(*shape):  # the full range, -128 and 127 included
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    out = {}
    # a head of q (columns 64..127) against a head of k (columns 192..255) of 384-wide rows
    x, y, ld, cx, cy = rnd(64, 384), rnd(64, 384), 384, 64, 192
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    cuda_build.check(lib.f5_probe_slice_mma(x.data_ptr(), y.data_ptr(), s.data_ptr(), ld, cx, cy,
                                            dev.index, stream), "probe_slice_mma")
    out["slice_mma"] = (s, x[:, cx:cx + 64].float() @ y[:, cy:cy + 64].float().t(), 1e-3)

    q, k = rnd(2, 64, 64), rnd(2, 64, 64)
    merged = torch.empty((64, 128), dtype=torch.bfloat16, device=dev)
    cuda_build.check(lib.f5_probe_pair_store(q.data_ptr(), k.data_ptr(), merged.data_ptr(),
                                             dev.index, stream), "probe_pair_store")
    want = torch.cat([q[g].float() @ k[g].float().t() for g in range(2)], dim=1)
    out["pair_store"] = (merged, want.to(torch.bfloat16), 0.25)  # <= 1 bf16 ulp at |s| < 64

    x = rnd(64, 192)
    ang = torch.rand((64, 32), generator=gen, device=dev) * 6.28
    cos, sin = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
    roped = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
    cuda_build.check(lib.f5_probe_half_swap(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                            roped.data_ptr(), 192, dev.index, stream),
                     "probe_half_swap")
    want = rope_reference(x[None, None, :, :64], cos, sin)[0, 0]
    out["half_swap"] = (roped, want, 0.0625)  # <= 1 bf16 ulp at |x| < 8

    # a 64 x 64 box of a [100, 200] array: inside it, and over its lower right edge
    x = rnd(100, 200)
    for label, row, col in (("tma_swizzle", 8, 64), ("tma_swizzle_edge", 72, 176)):
        raw = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
        cuda_build.check(lib.f5_probe_tma(x.data_ptr(), raw.data_ptr(), 100, 200, row, col, 0,
                                          dev.index, stream), "probe_tma")
        out[label] = (raw, swizzled_box(x, row, col), 0.0)
    # a 64 x 128 int8 box of a [100, 320] array, the same two ways
    x8 = rnd_i8(100, 320)
    for label, row, col in (("tma_swizzle_i8", 8, 128), ("tma_swizzle_i8_edge", 72, 256)):
        raw = torch.empty((64, 128), dtype=torch.int8, device=dev)
        cuda_build.check(lib.f5_probe_tma(x8.data_ptr(), raw.data_ptr(), 100, 320, row, col, 1,
                                          dev.index, stream), "probe_tma")
        out[label] = (raw, swizzled_box(x8, row, col), 0.0)

    # 64-row boxes of [3, 100, 64]: inside head 1, and over its last row
    x3 = rnd(3, 100, 64)
    for label, row in (("tma_3d", 8), ("tma_3d_edge", 72)):
        raw = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
        cuda_build.check(lib.f5_probe_tma_3d(x3.data_ptr(), raw.data_ptr(), 3, 100, row, 1,
                                             dev.index, stream), "probe_tma_3d")
        out[label] = (raw, swizzled_box(x3[1], row, 0), 0.0)

    # 64-row boxes of one head's columns of a fused qkv array [2, 100, 3 * 2 * 64]
    # (slots: q of heads 0, 1, then k, then v): k of head 1 of item 1 inside
    # the rows, and v of head 0 of item 0 over its last row, where the box
    # must hold zeros and not item 1's rows
    qkv = rnd(2, 100, 6 * 64)
    for label, slot, row, item in (("tma_4d_qkv", 3, 8, 1), ("tma_4d_qkv_edge", 4, 72, 0)):
        raw = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
        cuda_build.check(lib.f5_probe_tma_4d(qkv.data_ptr(), raw.data_ptr(), 2, 100, 6, row,
                                             slot, item, 0, dev.index, stream), "probe_tma_4d")
        out[label] = (raw, swizzled_box(qkv[item, :, 64 * slot:64 * slot + 64], row, 0), 0.0)
    # the same over split heads [2, 3, 100, 64]: head 2 of item 1 inside its
    # rows, head 0 of item 0 over its last row (zeros, not head 1's rows)
    heads = rnd(2, 3, 100, 64)
    for label, slot, row, item in (("tma_4d_heads", 2, 8, 1), ("tma_4d_heads_edge", 0, 72, 0)):
        raw = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
        cuda_build.check(lib.f5_probe_tma_4d(heads.data_ptr(), raw.data_ptr(), 2, 100, 3, row,
                                             slot, item, 1, dev.index, stream), "probe_tma_4d")
        out[label] = (raw, swizzled_box(heads[item, slot], row, 0), 0.0)

    # the int8 attention core: one head of n = 100 rows, q rows 40..103 (past
    # 100 zeros), K rows 0..127 (past 100 zeros); A read as it is, and p8
    # packed from probabilities (zeros as masked keys give) against v8 in the
    # kernel's slot order
    n, q0 = 100, 40
    q8, k8 = rnd_i8(1, n, 64).clamp_(-127, 127), rnd_i8(1, n, 64).clamp_(-127, 127)
    v_nat = rnd_i8(1, 128, 64).clamp_(-127, 127)
    v8k = _v8_kernel_layout(v_nat).contiguous()
    a8 = rnd_i8(64, 128)
    p_in = torch.rand((64, 128), generator=gen, device=dev)
    p_in[:, 100:] = 0
    p_in[:, 7] = 1.0  # the row max's own p
    s_qk = torch.empty((64, 128), dtype=torch.int32, device=dev)
    q_box = torch.zeros((64, 64), dtype=torch.float64, device=dev)
    q_box[:n - q0] = q8[0, q0:].double()
    k_box = torch.zeros((128, 64), dtype=torch.float64, device=dev)
    k_box[:n] = k8[0].double()
    v_back = _v8_natural_layout(v8k, 128)[0].double()
    # mode 0 multiplies the slots as they lie (A's k index is v8's slot), mode 1
    # must undo the permutation: p8 in natural key order times v
    for label, mode, want in (("wgmma_rs_s8", 0, a8.double() @ v8k[0].double().t()),
                              ("wgmma_pv_s8", 1, torch.round(p_in * 127.0).double() @ v_back)):
        pv = torch.empty((64, 64), dtype=torch.int32, device=dev)
        cuda_build.check(lib.f5_probe_attn_i8(q8.data_ptr(), k8.data_ptr(), v8k.data_ptr(),
                                              a8.data_ptr(), p_in.data_ptr(), mode, n, q0,
                                              s_qk.data_ptr(), pv.data_ptr(), dev.index, stream),
                         "probe_attn_i8")
        out[label] = (pv, want, 0.0)
    out["wgmma_qk_s8"] = (s_qk, q_box @ k_box.t(), 0.0)

    # the rotation in shared memory on TMA-landed swizzled tiles: q rows
    # 40..103 and K rows 0..127 of one head of a [1, 100, 3 * 64] qkv (rows past
    # 100 are TMA's zeros and stay so), then S = q.K^T on wgmma. The rotated K
    # tile is the torch-rotated rows swizzled, to the bit; S is their product
    # (fp32 sums in another order)
    n, q0 = 100, 40
    qkv = rnd(1, n, 3 * 64)
    ang = torch.rand((n, 32), generator=gen, device=dev) * 6.28
    cos, sin = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
    s_qk = torch.empty((64, 128), dtype=torch.float32, device=dev)
    raw_k = torch.empty((128, 64), dtype=torch.bfloat16, device=dev)
    cuda_build.check(lib.f5_probe_rope(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                       s_qk.data_ptr(), raw_k.data_ptr(), n, q0, 0, dev.index,
                                       stream), "probe_rope")
    q_rot = rope_reference(qkv[:, None, :, :64], cos, sin)[0, 0]
    k_rot = rope_reference(qkv[:, None, :, 64:128], cos, sin)[0, 0]
    out["rope_smem"] = (raw_k, swizzled_box(k_rot, 0, 0, rows=128), 0.0)
    q_box = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    q_box[:n - q0] = q_rot[q0:]
    k_box = torch.zeros((128, 64), dtype=torch.bfloat16, device=dev)
    k_box[:n] = k_rot
    out["rope_wgmma"] = (s_qk, q_box.float() @ k_box.float().t(), 1e-3)

    # probabilities in [0, 1) as the softmax leaves them, with zeros as masked keys give
    p_in = torch.rand((64, 128), generator=gen, device=dev)
    p_in[:, 100:] = 0
    p_in = p_in.to(torch.bfloat16)
    v = rnd(128, 64)
    prod = torch.empty((64, 64), dtype=torch.float32, device=dev)
    cuda_build.check(lib.f5_probe_pv(p_in.data_ptr(), v.data_ptr(), prod.data_ptr(), dev.index,
                                     stream), "probe_pv")
    out["wgmma_pv"] = (prod, p_in.float() @ v.float(), 1e-3)

    # the backward core's score tile (S^T = K.Q^T, 64 queries) and gradient
    # product (dV += bf16(P^T).dO, the tile MN-major); the second is held to
    # the kernel's own scores rounded to bf16, so only the product's fp32 sum
    # order differs
    x, y, z = rnd(64, 64), rnd(64, 64), rnd(64, 64)
    s64, g64 = (torch.empty((64, 64), dtype=torch.float32, device=dev) for _ in range(2))
    cuda_build.check(lib.f5_probe_bwd(x.data_ptr(), y.data_ptr(), z.data_ptr(), s64.data_ptr(),
                                      g64.data_ptr(), dev.index, stream), "probe_bwd")
    out["wgmma_ss_n64"] = (s64, x.float() @ y.float().t(), 1e-3)
    out["wgmma_bwd_grad"] = (g64, s64.to(torch.bfloat16).float() @ z.float(), 1e-3)

    a, b = rnd(64, 64), rnd(128, 64)
    for label, register_a in (("wgmma_ss", 0), ("wgmma_rs", 1)):
        prod = torch.empty((64, 128), dtype=torch.float32, device=dev)
        cuda_build.check(lib.f5_probe_wgmma(a.data_ptr(), b.data_ptr(), prod.data_ptr(),
                                            register_a, dev.index, stream), "probe_wgmma")
        lhs = (2.0 * a.float() + 1.0).to(torch.bfloat16) if register_a else a
        out[label] = (prod, lhs.float() @ b.float().t(), 1e-3)

    # the fp32 core: an fp32 box, and the .tf32 products on a 32-deep stage
    xf = torch.randn((100, 200), generator=gen, device=dev)
    for label, row, col in (("tma_swizzle_f32", 8, 32), ("tma_swizzle_f32_edge", 72, 184)):
        raw = torch.empty((64, 32), dtype=torch.float32, device=dev)
        cuda_build.check(lib.f5_probe_tma(xf.data_ptr(), raw.data_ptr(), 100, 200, row, col, 2,
                                          dev.index, stream), "probe_tma")
        out[label] = (raw, swizzled_box(xf, row, col), 0.0)
    x, y = (torch.randn(shape, generator=gen, device=dev) for shape in ((64, 32), (128, 32)))
    exact = x.double() @ y.double().t()
    readings = {"truncated": (tf32_truncate(x).double() @ tf32_truncate(y).double().t()),
                "rounded": (tf32_round(x).double() @ tf32_round(y).double().t())}
    for label, mode in (("wgmma_tf32_ss", 0), ("wgmma_tf32_rs", 1), ("wgmma_3xtf32", 2)):
        prod = torch.empty((64, 128), dtype=torch.float32, device=dev)
        cuda_build.check(lib.f5_probe_wgmma_tf32(x.data_ptr(), y.data_ptr(), prod.data_ptr(),
                                                 mode, dev.index, stream), "probe_wgmma_tf32")
        if mode == 2:  # fp32 accuracy at |x . y| < ~30: a few 1e-6
            out[label] = (prod, exact, 1e-4)
            continue
        torch.cuda.synchronize(dev)
        how = min(readings, key=lambda r: (prod.double() - readings[r]).abs().max().item())
        print(f"probe {label}: .tf32 reads a raw fp32 word as its {how} tf32 value")
        out[label] = (prod, readings[how], 3e-4)

    a8 = rnd_i8(64, 128)
    for n in (128, 256):
        b8 = rnd_i8(n, 128)
        prod = torch.empty((64, n), dtype=torch.int32, device=dev)
        cuda_build.check(lib.f5_probe_wgmma_i8(a8.data_ptr(), b8.data_ptr(), prod.data_ptr(), n,
                                               dev.index, stream), "probe_wgmma_i8")
        out[f"wgmma_s8_n{n}"] = (prod, a8.double() @ b8.double().t(), 0.0)

    a, h, gate = rnd(200, 128), rnd(200, 256), rnd(256) * 0.25
    p = {"w": rnd(256, 128) * 128 ** -0.5, "b": rnd(256)}
    want = proj_gated_residual_reference(a, h, gate, p)
    for bn in (128, 256):
        res = torch.empty_like(h)
        cuda_build.check(lib.f5_probe_tile_width(
            a.data_ptr(), h.data_ptr(), gate.data_ptr(), p["w"].data_ptr(), p["b"].data_ptr(),
            res.data_ptr(), 200, 128, 256, bn, dev.index, stream), "probe_tile_width")
        out[f"tile_width_{bn}"] = (res, want, 0.0625)  # <= 1 bf16 ulp at |out| < 16
    torch.cuda.synchronize(dev)
    return out


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x read as tf32 by dropping its 13 low mantissa bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: to 10 mantissa bits, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def accumulation(dev: torch.device) -> dict[str, float]:
    """Probe (15): ulps added per product by the tensor cores' fp32
    accumulation when each product adds three quarters of an ulp (1:
    rounded to nearest; 0: truncated), for mma.sync and wgmma .tf32."""
    lib = cuda_build.library()
    acc = torch.empty(2, dtype=torch.float32, device=dev)
    cuda_build.check(lib.f5_probe_tf32_accumulate(
        acc.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream),
        "probe_tf32_accumulate")
    steps, ulp = 32, 2.0 ** -23
    return {name: (v - 1.0) / ulp / steps
            for name, v in zip(("mma.sync m16n8k8", "wgmma m64n128k8"), acc.tolist())}


def swizzled_box(x: torch.Tensor, row: int, col: int, rows: int = 64) -> torch.Tensor:
    """What a box of `rows` rows x 128 bytes of x at (row, col) (64 bf16, 128
    int8 or 32 fp32 a row) looks like in 128-byte-swizzled shared memory:
    zeros past x's edges, and the 16-byte chunk c of box row r at chunk c ^
    (r % 8)."""
    width = 128 // x.element_size()
    box = torch.zeros((rows, width), dtype=x.dtype, device=x.device)
    part = x[row:row + rows, col:col + width]
    box[:part.shape[0], :part.shape[1]] = part
    r = torch.arange(rows, device=x.device)[:, None]
    c = torch.arange(8, device=x.device)[None, :]
    src = (c ^ (r % 8))  # the physical chunk c holds logical chunk c ^ (r % 8)
    chunk = width // 8
    return box.reshape(rows, 8, chunk).gather(1, src[:, :, None].expand(rows, 8, chunk)).reshape(
        rows, width)


def run(device="cuda") -> dict[str, float]:
    """Run the probes; returns name -> max abs error, raises on a FAIL."""
    dev = require_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_hopper runs CUDA kernels: it needs a card")
    dev = torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())
    errs, failed = {}, []
    for name, (got, want, tol) in _probes(dev).items():
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.isfinite(got.float()).all().item() and err <= tol
        print(f"probe {name}: {'OK' if ok else 'FAIL'} (max abs err {err:.3e}, bound {tol:.1e})")
        errs[name] = err
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"probe_hopper: {', '.join(failed)} failed")
    for name, ulps in accumulation(dev).items():
        print(f"probe tf32_accumulate ({name} .tf32): {ulps:.3f} ulp added a product of 0.75 "
              "ulp (1: rounded to nearest, 0: truncated)")
    return errs


if __name__ == "__main__":
    run()

"""What kernel 19 on the attention core's rope form (csrc/flash_prefix_qkv.cu
on csrc/attn_wgmma.cuh) is held to, on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py). Here:

- its plain version (flash_prefix_qkv_reference, which the wrapper takes on
  CPU tensors) against the TPU kernel _kernel_qkv in interpret mode, at the
  edges the new tiles bring (192 query rows a block, 128-key tiles): n 100,
  200 and 301, kv_len 1, 127, 128, 129 and n (those <= n), B 2-3, heads 2
  and 4, pe_attn_head None and 1. The JAX kernel takes n in multiples of 128,
  so its rows are zero-padded: the padded keys lie past every kv_len and are
  masked, so its first n rows are the function at n. Tolerances, those
  tests/test_torch_attn_paths.py states for 19: fp32 1e-5 relative L2 (sums
  in another order), bf16 2e-2 (the TPU kernel multiplies the rotation in
  bf16 where the port rounds once from fp32, and P rounds at other points);
- a torch mirror of the index arithmetic with which the kernel rotates a
  swizzled tile in shared memory (attn_wgmma.cuh:attn_rope_tile: which
  thread takes which rows and chunks, the partner at p ^ 4, the stop at n or
  kv_len), applied to the swizzled image of a K tile, against rope_reference
  on the plain tile, to the bit;
- the coordinates of the strided 4-D tensor map over the fused qkv rows
  (hopper.cuh:tensor_map_4d: q of head g at slot g, k at heads + g, v at
  2 * heads + g) against qkv_unpack.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models.modules import rope_cos_sin
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts.probe_hopper import swizzled_box

FP32_REL, BF16_REL = 1e-5, 2e-2
DH = 64

# (B, heads, n, kv_lens, pe_attn_head)
EDGE_CASES = [
    (2, 2, 100, [1, 100], None),
    (3, 4, 100, [1, 100, 99], 1),
    (3, 2, 200, [127, 128, 129], None),
    (2, 4, 200, [1, 200], 1),
    (3, 2, 301, [127, 129, 301], 1),
    (3, 4, 301, [1, 128, 301], None),
]
CASES = [pytest.param(*case, dtype, id=f"B{case[0]}-h{case[1]}-n{case[2]}-kv"
                      f"{'_'.join(map(str, case[3]))}-pe{case[4]}-{dtype}")
         for case in EDGE_CASES for dtype in ("float32", "bfloat16")]


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


@pytest.mark.parametrize("B,heads,n,lens,pe,dtype", CASES)
def test_qkv_reference_matches_the_tpu_kernel_at_the_core_tile_edges(B, heads, n, lens, pe,
                                                                      dtype):
    rng = np.random.default_rng(1000 * n + 10 * heads + B)
    qkv = rng.standard_normal((B, n, 3 * heads * DH)).astype(np.float32)
    n_pad = -(-n // 128) * 128
    jd = getattr(jnp, dtype)
    jqkv = jnp.asarray(np.pad(qkv, ((0, 0), (0, n_pad - n), (0, 0)))).astype(jd)
    cos, sin = rope_cos_sin(n_pad, DH)
    want = jfp.flash_prefix_qkv_attention(jqkv, jnp.asarray(lens, jnp.int32), heads,
                                          jnp.asarray(cos), jnp.asarray(sin), pe, 128, 128)
    want = np.asarray(want.astype(jnp.float32))[:, :n]
    tqkv = t(np.asarray(jqkv.astype(jnp.float32))[:, :n]).to(getattr(torch, dtype))
    got = flash_prefix.flash_prefix_qkv_attention(tqkv, torch.tensor(lens), heads,
                                                  t(cos[:n]), t(sin[:n]), pe)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, n, heads * DH)
    assert rel_err(got.float().numpy(), want) < (FP32_REL if dtype == "float32" else BF16_REL)


def _thread_items(rows: int, nthreads: int):
    """(thread, r, j) of every item attn_rope_tile rotates, thread by thread:
    thread t takes chunk j = t & 3 of rows r0(t), r0(t) + nthreads / 4, ..."""
    out = []
    for tid in range(nthreads):
        j = tid & 3
        r0 = ((tid >> 5) << 3) + ((tid >> 3) & 3) + (((tid >> 2) & 1) << 2)
        out += [(tid, r, j) for r in range(r0, rows, nthreads >> 2)]
    return out


def _rope_swizzled(tile: torch.Tensor, row0: int, lim: int, cos, sin, nthreads: int):
    """attn_rope_tile on a swizzled [rows, 64] bf16 tile, in torch: item (r, j)
    reads the 16-byte chunk at p = j ^ (r & 7) and its partner at p ^ 4,
    rotates the 8 pairs in fp32 from the bf16 tables (products, then one sum
    or difference, each rounded: the kernel's _rn intrinsics), rounds once,
    and writes both back; rows at or past lim stay as they are."""
    rows = tile.shape[0]
    out = tile.clone()
    items = [(r, j) for _, r, j in _thread_items(rows, nthreads) if row0 + r < lim]
    r = torch.tensor([a for a, _ in items])
    j = torch.tensor([b for _, b in items])
    p = j ^ (r & 7)
    chunks = tile.reshape(rows, 8, 8)
    x1, x2 = chunks[r, p].float(), chunks[r, p ^ 4].float()
    cols = 8 * j[:, None] + torch.arange(8)
    c = cos.to(torch.bfloat16).float()[row0 + r[:, None], cols]
    s = sin.to(torch.bfloat16).float()[row0 + r[:, None], cols]
    out_chunks = out.reshape(rows, 8, 8)
    out_chunks[r, p] = (x1 * c - x2 * s).to(torch.bfloat16)
    out_chunks[r, p ^ 4] = (x2 * c + x1 * s).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("rows,nthreads", [(64, 128), (128, 96), (128, 128)])
def test_rope_items_cover_a_tile_once_without_bank_conflicts(rows, nthreads):
    """The q tile (64 rows, a consumer warpgroup's 128 threads) and the K tile
    (128 rows, the three rotating warps' 96 threads)."""
    items = _thread_items(rows, nthreads)
    assert sorted((r, j) for _, r, j in items) == [(a, b) for a in range(rows) for b in range(4)]
    # a thread's rows are a multiple of 8 apart: one chunk position p for all
    for tid in range(nthreads):
        mine = [r for t, r, _ in items if t == tid]
        assert len({r & 7 for r in mine}) == 1 and mine == sorted(mine)
    # in each pass the 8 loads of 16 bytes of a quarter-warp (chunks p, then
    # p ^ 4) fall into the 8 distinct 16-byte bank groups of a 128-byte span
    by_thread = {}
    for tid, r, j in items:
        by_thread.setdefault(tid, []).append(j ^ (r & 7))
    for k in range(len(by_thread[0])):
        for q in range(0, nthreads, 8):
            ps = [by_thread[t][k] for t in range(q, q + 8) if k < len(by_thread[t])]
            if len(ps) == 8:
                assert sorted(ps) == list(range(8))
                assert sorted(x ^ 4 for x in ps) == list(range(8))


@pytest.mark.parametrize("row0,n,lim", [(0, 301, 301), (128, 301, 200), (256, 301, 301),
                                        (0, 100, 100), (0, 100, 1)])
def test_rope_on_the_swizzled_tile_equals_rope_reference(row0, n, lim):
    """A 128-row K tile at sequence row row0 (rows past n: TMA's zeros),
    rotated in its swizzled image up to row lim (n, or a kv_len), is the
    swizzled image of the rows rotated by rope_reference up to lim."""
    rng = np.random.default_rng(row0 + n + lim)
    k = t(rng.standard_normal((n, DH)).astype(np.float32)).to(torch.bfloat16)
    cos, sin = (t(a) for a in rope_cos_sin(n, DH))
    tile = swizzled_box(k, row0, 0, rows=128)
    got = _rope_swizzled(tile, row0, lim, cos, sin, 96)
    rot = torch.cat([flash_prefix.rope_reference(k[None, None, :lim], cos, sin)[0, 0],
                     k[lim:]])
    want = swizzled_box(rot, row0, 0, rows=128)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _box_4d(qkv: torch.Tensor, heads: int, slot: int, row: int, item: int, rows: int):
    """What a box of tensor_map_4d over qkv [B, n, 3 * heads * 64] holds, by
    the map's own dims and strides (elements: 64 columns stride 1, 3 * heads
    slots stride 64, n rows stride 3 * heads * 64, B items stride n times
    that), rows past n as zeros."""
    B, n, ld = qkv.shape
    view = qkv.reshape(-1).as_strided((B, n, 3 * heads, DH), (n * ld, ld, DH, 1))
    box = torch.zeros((rows, DH), dtype=qkv.dtype)
    part = view[item, row:row + rows, slot]
    box[:part.shape[0]] = part
    return box


@pytest.mark.parametrize("heads", [2, 16])
def test_4d_map_coordinates_are_the_unpacked_heads(heads):
    B, n = 3, 200
    qkv = torch.randn((B, n, 3 * heads * DH)).to(torch.bfloat16)
    parts = flash_prefix.qkv_unpack(qkv, heads)
    for item in range(B):
        for g in (0, heads - 1):
            for part, slot in zip(parts, (g, heads + g, 2 * heads + g)):
                for row, rows in ((0, 192), (192, 192), (128, 128)):  # q blocks, K/V tiles
                    want = torch.zeros((rows, DH), dtype=qkv.dtype)
                    piece = part[item, g, row:row + rows]
                    want[:piece.shape[0]] = piece
                    torch.testing.assert_close(_box_4d(qkv, heads, slot, row, item, rows), want,
                                               rtol=0, atol=0)

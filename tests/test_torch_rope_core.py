"""What kernel 18 on the attention core's rope form (csrc/flash_prefix_rope.cu
on csrc/attn_wgmma.cuh, the instantiation kernel 19 runs) is held to, on the
CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to its
plain version and to kernel 19 to the bit; chip_smoke.py phase 2 at the
core's edges). Here:

- its plain version (flash_prefix_rope_reference, which the wrapper takes on
  CPU tensors) against the TPU kernel _kernel_rope in interpret mode, at the
  edges the core's tiles bring (192 query rows a block, 128-key tiles): n
  100, 200 and 301, kv_len 1, 127, 128, 129 and n (those <= n), B 2-3, heads
  2 and 4, pe_attn_head None and 1. The JAX kernel takes n in multiples of
  128, so its rows are zero-padded: the padded keys lie past every kv_len
  and are masked, so its first n rows are the function at n. Tolerances, as
  tests/test_torch_qkv_core.py states them for 19: fp32 1e-5 relative L2,
  bf16 2e-2 (the TPU kernel multiplies the rotation in bf16 where the port
  rounds once from fp32);
- the coordinates of the strided 4-D tensor maps over the split heads
  [B, heads, n, 64] (hopper.cuh:tensor_map_4d with slot stride n * 64, row
  stride 64, item stride heads * n * 64; head g at slot g of each of the
  three maps): a box of rows is the head's rows of its item, zero past n;
- the split heads of a fused qkv array are the same values kernel 19 reads,
  so the plain versions of 18 and 19 agree to the bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models.modules import rope_cos_sin
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts

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
def test_rope_reference_matches_the_tpu_kernel_at_the_core_tile_edges(B, heads, n, lens, pe,
                                                                       dtype):
    rng = np.random.default_rng(1000 * n + 10 * heads + B + 7)
    n_pad = -(-n // 128) * 128
    jd = getattr(jnp, dtype)
    qkv = [np.pad(rng.standard_normal((B, heads, n, DH)).astype(np.float32),
                  ((0, 0), (0, 0), (0, n_pad - n), (0, 0))) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in qkv)
    cos, sin = rope_cos_sin(n_pad, DH)
    want = jfp.flash_prefix_rope_attention(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                                           jnp.asarray(cos), jnp.asarray(sin), pe, 128, 128,
                                           False)
    want = np.asarray(want.astype(jnp.float32))[:, :, :n]
    tq, tk, tv = (t(np.asarray(x.astype(jnp.float32))[:, :, :n]).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    got = flash_prefix.flash_prefix_rope_attention(tq, tk, tv, torch.tensor(lens), t(cos[:n]),
                                                   t(sin[:n]), pe)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, heads, n, DH)
    valid = np.concatenate([got.float().numpy()[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    ref = np.concatenate([want[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    assert rel_err(valid, ref) < (FP32_REL if dtype == "float32" else BF16_REL)


def _box_4d_heads(x: torch.Tensor, slot: int, row: int, item: int, rows: int):
    """What a box of kernel 18's tensor_map_4d over x [B, heads, n, 64] holds,
    by the map's own dims and strides (elements: 64 columns stride 1, heads
    slots stride n * 64, n rows stride 64, B items stride heads * n * 64),
    rows past n as zeros."""
    B, heads, n, _ = x.shape
    view = x.reshape(-1).as_strided((B, n, heads, DH), (heads * n * DH, DH, n * DH, 1))
    box = torch.zeros((rows, DH), dtype=x.dtype)
    part = view[item, row:row + rows, slot]
    box[:part.shape[0]] = part
    return box


@pytest.mark.parametrize("heads", [2, 16])
def test_split_head_4d_map_coordinates_are_the_heads(heads):
    B, n = 3, 200
    x = torch.randn((B, heads, n, DH)).to(torch.bfloat16)
    for item in range(B):
        for g in (0, heads - 1):
            for row, rows in ((0, 192), (192, 192), (128, 128)):  # q blocks, K/V tiles
                want = torch.zeros((rows, DH), dtype=x.dtype)
                piece = x[item, g, row:row + rows]
                want[:piece.shape[0]] = piece
                torch.testing.assert_close(_box_4d_heads(x, g, row, item, rows), want, rtol=0,
                                           atol=0)


@pytest.mark.parametrize("pe", [None, 1])
def test_the_plain_versions_of_18_and_19_agree_to_the_bit(pe):
    """18 reads the heads split from the fused qkv rows that 19 reads in place:
    on those values the two functions are one."""
    rng = np.random.default_rng(11)
    B, heads, n = 2, 3, 150
    qkv = t(rng.standard_normal((B, n, 3 * heads * DH)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (p.contiguous() for p in flash_prefix.qkv_unpack(qkv, heads))
    cos, sin = (t(a) for a in rope_cos_sin(n, DH))
    lens = torch.tensor([150, 77])
    got18 = flash_prefix.flash_prefix_rope_attention(q, k, v, lens, cos, sin, pe)
    got19 = flash_prefix.flash_prefix_qkv_attention(qkv, lens, heads, cos, sin, pe)
    torch.testing.assert_close(got18.transpose(1, 2).reshape(B, n, heads * DH), got19, rtol=0,
                               atol=0)

"""What the int8 TMA + wgmma core (csrc/gemm_int8.cuh) is held to, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py). Here:
the layout the int8 TMA probe is held to (scripts/probe_hopper.py:
swizzled_box on an int8 array), the shape rules the int8 wrappers check
before any launch, and the plain versions of kernels 4 and 5 against the JAX
package's kernels in interpret mode at the widths the new core admits beyond
the old one (d = 16 k, any k; kernel 4 at d = dff).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu_torch.ops import ff_block, fused_linears
from korean_f5_tts_tpu_torch.ops.qmatmul import I8_CORE_MAX_K, check_int8_linear
from korean_f5_tts_tpu_torch.scripts.probe_hopper import swizzled_box
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

FLIP_REL = 2e-3  # a few rounding-tie flips of the fp32 LN / GELU outputs (test_torch_quant.py)


@pytest.mark.parametrize("row,col", [(8, 128), (72, 256), (0, 0)])
def test_swizzled_box_of_an_int8_array(row, col):
    """An int8 box is 64 rows x 128 int8; 16-byte chunk c (16 values) of box
    row r sits at chunk c ^ (r % 8); reads past the array are zeros."""
    x = torch.arange(100 * 320, dtype=torch.int64).remainder(251).sub(125).to(torch.int8)
    x = x.reshape(100, 320)
    box = swizzled_box(x, row, col)
    assert box.shape == (64, 128) and box.dtype == torch.int8
    for r in range(64):
        for c in range(8):
            got = box[r, 16 * (c ^ (r % 8)):16 * (c ^ (r % 8)) + 16]
            want = torch.zeros(16, dtype=torch.int8)
            if row + r < 100:
                part = x[row + r, col + 16 * c:col + 16 * c + 16]
                want[:part.numel()] = part
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def _linear(n, k):
    return {"w_int8": torch.zeros((n, k), dtype=torch.int8),
            "w_scale": torch.ones(n, dtype=torch.float32),
            "b": torch.zeros(n, dtype=torch.bfloat16)}


@pytest.mark.parametrize("n,k,k_multiple,k_max,ok", [
    (256, 1024, 16, I8_CORE_MAX_K, True),    # kernel 5 at the main width
    (256, 1040, 16, I8_CORE_MAX_K, True),    # no multiple of 64 or 128: the new core takes it
    (256, 96, 16, I8_CORE_MAX_K, True),
    (256, 40, 16, I8_CORE_MAX_K, False),     # rows of 16 bytes for TMA
    (256, 4112, 16, I8_CORE_MAX_K, False),   # past the row pass's registers
    (192, 1024, 16, I8_CORE_MAX_K, False),   # n a multiple of 128
    (256, 4096, 128, I8_CORE_MAX_K, True),   # kernel 4 at its widest
    (256, 1088, 128, I8_CORE_MAX_K, False),  # kernel 4: d, dff multiples of 128
    (256, 96, 64, None, False),              # a rule of K % 64 (the old mma.sync product's)
    (256, 8192, 64, None, True),             # ... and no bound on K
])
def test_int8_shape_rules(n, k, k_multiple, k_max, ok):
    """The checks before a launch: a shape the kernel does not take raises
    ValueError before anything reaches the device; a shape it takes gets as
    far as the device check (these tensors lie on the CPU)."""
    qp = _linear(n, k)
    x = torch.zeros((4, k), dtype=torch.bfloat16)
    match = "CUDA device" if ok else "must be a multiple"
    with pytest.raises(ValueError, match=match):
        check_int8_linear("int8", x, qp["w_int8"], qp["w_scale"], qp["b"], n, k,
                          k_multiple=k_multiple, k_max=k_max)


def _rows(rng, m, k):
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    x[0, 1] = 0.0
    x[0, 5, 3] = 40.0
    return x


def _jax_qp(rng, k, n):
    """A JAX int8 linear ({w_int8 [k, n], ...}) from uniform +-1/sqrt(k) weights."""
    bound = k ** -0.5
    return jquant.quantize_linear({"w": rng.uniform(-bound, bound, (k, n)).astype(np.float32),
                                   "b": rng.uniform(-0.1, 0.1, (n,)).astype(np.float32)})


def _port_qp(jqp):
    """JAX int8 linear -> the port's, through the converter."""
    return params_from_jax({k: np.asarray(v) for k, v in jqp.items()}, device="cpu")


@pytest.mark.parametrize("d", [96, 144])
def test_ln_mod_matmul_int8_plain_matches_jax_at_the_new_widths(d, monkeypatch):
    """Kernel 5's plain version against the TPU kernel in interpret mode at a
    d the new core takes and the old one did not (no multiple of 64)."""
    monkeypatch.setattr(jfl, "_INTERPRET", True)
    rng = np.random.default_rng(20 + d)
    h = _rows(rng, 128, d)
    sc, sh = (rng.uniform(-0.3, 0.3, (d,)).astype(np.float32) for _ in range(2))
    jqps = [_jax_qp(rng, d, 128) for _ in range(3)]
    jcat = {k: jnp.concatenate([p[k] for p in jqps], axis=-1) for k in jqps[0]}
    want = np.asarray(jfl.ln_mod_matmul_int8(jnp.asarray(h), jnp.asarray(sc), jnp.asarray(sh),
                                             jcat, bm=64))
    got = fused_linears.ln_mod_matmul_int8(t(h), t(sc), t(sh), [_port_qp(p) for p in jqps])
    assert got.shape == (1, 128, 384)
    assert rel_err(got.numpy(), want) < FLIP_REL


def test_ff_block_int8_plain_matches_jax_at_d_equal_dff(monkeypatch):
    """Kernel 4's plain version against the TPU kernel in interpret mode at
    d = dff = 384 (the z row pass as long as the LN one, 128-wide tiles only
    on the card)."""
    monkeypatch.setattr(jff, "_INTERPRET", True)
    rng = np.random.default_rng(30)
    d = dff = 384
    h = _rows(rng, 128, d)
    sc, sh, gate = (rng.uniform(-b, b, (d,)).astype(np.float32) for b in (0.3, 0.3, 1.0))
    jin, jout = _jax_qp(rng, d, dff), _jax_qp(rng, dff, d)
    want = np.asarray(jff.ff_block_fused_int8(*(jnp.asarray(v) for v in (h, sc, sh, gate)),
                                              jin, jout, bm=64))
    got = ff_block.ff_block_fused_int8(t(h), t(sc), t(sh), t(gate), _port_qp(jin),
                                       _port_qp(jout)).numpy()
    assert rel_err(got - h, want - h) < FLIP_REL

"""What kernel 9 on the int8 TMA + wgmma core (csrc/qmatmul.cu on
csrc/gemm_int8.cuh) is held to, on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py). Here: its plain
version (qmatmul_reference, which the wrapper takes on CPU tensors) against
the TPU kernel _qmm_kernel run in interpret mode through a test-local
pallas_call (the JAX wrapper has no interpret switch), at the shapes the new
core admits and its tiles make edges of: M 1, 100 and 129 (the core's
128-row tiles; rows quantize independently, so the JAX side's M is
zero-padded to its 64-row blocks and the first M rows compared), K 1040 (no
multiple of the core's 128-deep k step) and 4096 (the row pass's limit), N
128 and 384 (no multiple of the 256-wide tiles). And the shape rule the
wrapper checks before a launch.

Tolerances: both sides quantize the same bf16 values, sum the integer
products exactly and round once. The port computes the row scale as
max|x| / 127 (an IEEE division, as the card's kernel does); the
interpret-mode TPU kernel, compiled by XLA on the CPU, multiplies by the
constant's reciprocal instead (XLA rewrites a division by a constant), so in
a few rows the scale differs by an ulp, which can flip a quantized value at a
rounding tie and moves the row's output by at most about one quantization
step. So without GELU every row whose scale agrees (_same_scale_rows) is
equal to the bit, and with GELU (tanh differs by implementation) or in the
other rows the output is held to INT8_REL (chip_smoke.py) relative L2 and 4
bf16 ulps at the output's scale, the bounds of a few tie flips.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import qmatmul as jqmm
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, qmatmul, reset_launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

INT8_REL = 2e-3
BLOCK_M, BLOCK_N = 64, 128


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    # on the CPU the wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _qmm_interpret(x, w, ws, b, activation):
    """_qmm_kernel through a test-local pallas_call with qmatmul's BlockSpecs
    (x [M, K] with M % 64 == 0, w [K, N] int8)."""
    m, k = x.shape
    n = w.shape[1]
    if b is None:
        b = jnp.zeros((n,), jnp.float32)
    return pl.pallas_call(
        functools.partial(jqmm._qmm_kernel, activation=activation),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        grid_spec=pl.GridSpec(
            grid=(m // BLOCK_M, n // BLOCK_N),
            in_specs=[
                pl.BlockSpec((BLOCK_M, k), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((k, BLOCK_N), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, BLOCK_N), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, BLOCK_N), lambda i, j: (0, j), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BLOCK_M, BLOCK_N), lambda i, j: (i, j),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(x, w, ws.reshape(1, n), b.reshape(1, n).astype(jnp.float32))


@functools.lru_cache(maxsize=8)
def _linear(k, n):
    """A JAX int8 linear from uniform +-1/sqrt(k) weights, and the port's
    through the converter."""
    rng = np.random.default_rng(k + n)
    bound = k ** -0.5
    jqp = jquant.quantize_linear({"w": rng.uniform(-bound, bound, (k, n)).astype(np.float32),
                                  "b": rng.uniform(-0.1, 0.1, (n,)).astype(np.float32)})
    qp = params_from_jax({key: np.asarray(v) for key, v in jqp.items()}, device="cpu")
    return jqp, qp


def _same_scale_rows(x):
    """[M] bool: rows whose scale is the same under the interpret kernel's
    arithmetic (max|x| times the reciprocal of 127) and the port's (max|x| /
    127)."""
    amax = np.maximum(np.abs(x).max(axis=1), np.float32(1e-6))
    return amax * np.float32(1.0 / 127.0) == amax / np.float32(127.0)


def _rows(m, k):
    """bf16 rows (as fp32 values) with a zero row (the 1e-6 scale floor) and
    an outlier row where M has them."""
    x = np.random.default_rng(m * k).standard_normal((m, k)).astype(np.float32)
    if m > 3:
        x[3] = 0.0
    if m > 7:
        x[7, 5] = 300.0
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


CASES = [(m, k, n) for m in (1, 100, 129) for k, n in ((1040, 128), (4096, 384))]


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,k,n", CASES, ids=[f"m{m}-k{k}-n{n}" for m, k, n in CASES])
def test_qmatmul_reference_matches_the_tpu_kernel_at_the_core_edges(m, k, n, bias, activation):
    jqp, qp = _linear(k, n)
    x = _rows(m, k)
    m_pad = -(-m // BLOCK_M) * BLOCK_M
    jx = jnp.asarray(np.pad(x, ((0, m_pad - m), (0, 0)))).astype(jnp.bfloat16)
    want = _qmm_interpret(jx, jqp["w_int8"], jqp["w_scale"], jqp["b"] if bias else None,
                          activation)
    want = np.asarray(want.astype(jnp.float32))[:m]
    got = qmatmul.qmatmul(t(x).to(torch.bfloat16), qp["w_int8"], qp["w_scale"],
                          qp["b"] if bias else None, activation)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    assert rel_err(got, want) <= INT8_REL
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    if activation is None:
        same = _same_scale_rows(x)
        assert same.sum() >= 0.9 * m
        np.testing.assert_array_equal(got[same], want[same])
    if m > 3 and activation is None:  # the zero row: q == 0, the output is the bias (or 0)
        np.testing.assert_array_equal(
            got[3], qp["b"].to(torch.bfloat16).float().numpy() if bias else 0.0)


@pytest.mark.parametrize("k,n,ok", [
    (1024, 1024, True),   # the main path's projections
    (1040, 384, True),    # K no multiple of 64 or 128, N no multiple of 256
    (96, 128, True),      # the mma.sync product this replaced refused K % 64 != 0
    (4096, 256, True),    # the row pass's longest row
    (40, 128, False),     # K a multiple of 16: TMA's 16-byte rows
    (4112, 128, False),   # past the row pass's registers
    (8192, 128, False),   # the old product took it; the TPU kernel keeps K <= 4096 in VMEM
    (1024, 192, False),   # N a multiple of 128
])
def test_qmatmul_shape_rule(k, n, ok):
    """The checks before kernel 9's launch: a shape the kernel does not take
    raises ValueError before anything reaches the device; a shape it takes
    gets as far as the device check (these tensors lie on the CPU)."""
    x = torch.zeros((4, k), dtype=torch.bfloat16)
    w = torch.zeros((n, k), dtype=torch.int8)
    ws = torch.ones(n, dtype=torch.float32)
    b = torch.zeros(n, dtype=torch.bfloat16)
    match = "CUDA device" if ok else "must be a multiple"
    for bias in (b, None):
        with pytest.raises(ValueError, match=match):
            qmatmul.check_qmatmul(x, w, ws, bias, None)

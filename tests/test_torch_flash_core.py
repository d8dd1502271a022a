"""The references that the attention core (kernel A at d = 64) and kernel 6 on
the int8 core are held to on the card, against the JAX package on the CPU.

Kernel A's plain version (prefix_attention_reference, through
flash_prefix_attention on CPU tensors) is held to the JAX Pallas kernel in
interpret mode at the edges the core's 128-key and 128-row tiles introduce:
n and kv_len on either side of 128. The Pallas kernel takes n in multiples
of 128, so its inputs are zero-padded to the next multiple; the padded keys
lie past every kv_len and are masked, so its first n rows are the function
at n. Tolerances as tests/test_torch_ops.py: fp32, 1e-5 (summation order and
the static-max against the online-max softmax, one function in exact
arithmetic).

The library yardstick chip_smoke.py times beside kernel A (SDPA without a
mask on keys sliced to the common kv_len) is held to the plain version in
fp32: equal when every head has the same kv_len, another function when the
lengths differ (so the yardstick refuses them).

Kernel 6's plain version against the JAX kernel in interpret mode at m =
200 rows (no multiple of 128 or of the JAX block), with a zero row (the
1e-6 scale floor) and an outlier row, din != d: both quantize a itself, so
the int8 values agree and the products are exact; the fp32 epilogue may
round differently by a few ulps (tests/test_torch_quant.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from _torch_port_util import t
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu_torch.ops import (
    KERNELS,
    flash_prefix,
    fused_linears,
    launch_counts,
    reset_launch_counts,
)
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET, jfl._INTERPRET = old


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pad_rows(x, n_pad):
    out = np.zeros(x.shape[:-2] + (n_pad, x.shape[-1]), np.float32)
    out[..., :x.shape[-2], :] = x
    return out


# --- kernel A: the reference at the core's tile edges -------------------------

EDGE_CASES = [(n, kv) for n in (127, 128, 129, 200) for kv in (1, 127, 128, 129, n) if kv <= n]
EDGE_CASES = list(dict.fromkeys(EDGE_CASES))  # kv == n repeats one of the fixed lengths


@pytest.mark.parametrize("n,kv", EDGE_CASES)
def test_prefix_attention_reference_at_the_core_tile_edges(n, kv):
    # H = 2 folded heads (two items of one head): one at kv, one at n
    b, h, d = 2, 1, 64
    q, k, v = (_randn((b, h, n, d), s) for s in (n, n + 1, n + 2))
    lens = np.asarray([kv, n], np.int32)
    n_pad = -(-n // 128) * 128
    want = jfp.flash_prefix_attention(*(jnp.asarray(_pad_rows(x, n_pad)) for x in (q, k, v)),
                                      jnp.asarray(lens), bq=128, bkv=128)
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :n], atol=ATOL, rtol=RTOL)


def test_prefix_attention_reference_against_the_eight_head_kernel():
    # H = 8 folded heads: the TPU default's heads-per-instance kernel
    # (_kernel_nomax_hn, the one the main path runs), n = 200 padded to 256
    b, h, n, d = 2, 4, 200, 64
    assert (b * h) % jfp.resolve_flash_heads(256) == 0
    q, k, v = (_randn((b, h, n, d), s) for s in (11, 12, 13))
    lens = np.asarray([129, 127], np.int32)
    want = jfp.flash_prefix_attention(*(jnp.asarray(_pad_rows(x, 256)) for x in (q, k, v)),
                                      jnp.asarray(lens), bq=128, bkv=128)
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :n], atol=ATOL, rtol=RTOL)


# --- kernel A's library yardstick ---------------------------------------------


def _folded(H, n, seed):
    return (torch.from_numpy(_randn((H, n, 64), seed + i)) for i in range(3))


@pytest.mark.parametrize("kv", [1, 129, 300])
def test_sdpa_on_sliced_keys_is_kernel_a_when_the_lengths_are_equal(kv):
    q, k, v = _folded(4, 300, 20)
    lens = torch.full((4,), kv, dtype=torch.int32)
    want = flash_prefix.prefix_attention_reference(q, k, v, lens)
    got = chip_smoke.sdpa_sliced(q, k, v, lens)()
    assert chip_smoke._rel(got, want) <= 1e-5


def test_sdpa_on_sliced_keys_is_another_function_when_the_lengths_differ():
    q, k, v = _folded(4, 300, 30)
    lens = torch.tensor([300, 129, 1, 77], dtype=torch.int32)
    want = flash_prefix.prefix_attention_reference(q, k, v, lens)
    with pytest.raises(ValueError, match="differ"):
        chip_smoke.sdpa_sliced(q, k, v, lens)
    # what the sliced call would compute at any one length is not kernel A's function
    for L in (1, 129, 300):
        got = torch.nn.functional.scaled_dot_product_attention(q[None], k[None, :, :L],
                                                               v[None, :, :L])[0]
        assert chip_smoke._rel(got, want) > 1e-2


# --- kernel 6: int8 out-projection + gated residual ---------------------------


@pytest.mark.parametrize("din,d", [(320, 128), (1024, 256)])
def test_proj_gated_residual_int8_reference_at_ragged_rows(din, d):
    rng = np.random.default_rng(din)
    m = 200
    a = rng.standard_normal((1, m, din)).astype(np.float32)
    a[0, 3] = 0.0           # the 1e-6 scale floor: q == 0
    a[0, 7, 5] = 300.0      # one outlier sets its row's scale
    h = rng.standard_normal((1, m, d)).astype(np.float32)
    gate = rng.uniform(-1, 1, (d,)).astype(np.float32)
    bound = din ** -0.5
    jqp = jquant.quantize_linear({"w": rng.uniform(-bound, bound, (din, d)).astype(np.float32),
                                  "b": rng.uniform(-0.1, 0.1, (d,)).astype(np.float32)})
    # the JAX kernel takes whole 256-row blocks: zero rows past m (a row's
    # quantization is its own, so they change nothing above them)
    want = np.asarray(jfl.proj_gated_residual_int8(
        jnp.asarray(_pad_rows(a, 256)), jnp.asarray(_pad_rows(h, 256)), jnp.asarray(gate),
        jqp))[:, :m]
    qp = params_from_jax({k: np.asarray(x) for k, x in jqp.items()}, device="cpu")
    got = fused_linears.proj_gated_residual_int8(t(a), t(h), t(gate), qp).numpy()
    bound_ulps = 4 * 2.0 ** -23 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound_ulps)
    # the zero row: its int8 values are 0, so the output is h + gate * b
    np.testing.assert_allclose(got[0, 3], h[0, 3] + gate * np.asarray(jqp["b"]), rtol=0,
                               atol=bound_ulps)

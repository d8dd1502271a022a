"""The reference that kernel C (grouped conv1d + bias + Mish, on TMA and
wgmma) is held to on the card, against the JAX package's Pallas kernel in
interpret mode on the CPU, at the edges the Hopper kernel introduces.

The kernel takes 128 output rows a block and a window of 128 + k - 1 input
rows that TMA fills with zeros outside [0, N) (the SAME padding), so N is 1,
15, 16, 17, 31 (at most one tap's reach), 127, 128, 129 (one block and a
row either side) or 300 (three blocks, the last ragged); without a bias and
without Mish at N 1, 129 and 300. C is 128 in two groups of 64 (the group
width the kernel takes; the JAX kernel packs its 128-lane blocks from two
such groups and pads N itself), k is 31, two items a case.

Tolerances: fp32 1e-5 absolute and relative (fp32 sums in another order);
bf16 inputs 2 bf16 ulps at the output's scale (2**-7 * max|want| each: both
sum the exact products of the same bf16 values in fp32 and round the output
once, in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_port_util import t
from korean_f5_tts_tpu.ops import grouped_conv as jgc
from korean_f5_tts_tpu_torch.ops import KERNELS, grouped_conv, launch_counts, reset_launch_counts

C, GROUPS, K = 128, 2, 31

CASES = [pytest.param(n, bias, mish, dtype, id=f"n{n}-{'b' if bias else 'nob'}-"
                      f"{'mish' if mish else 'nomish'}-{dtype}")
         for n, bias, mish in [(n, True, True) for n in (1, 15, 16, 17, 31, 127, 128, 129, 300)]
         + [(n, False, True) for n in (1, 129, 300)] + [(n, True, False) for n in (1, 129, 300)]
         for dtype in ("float32", "bfloat16")]


@pytest.fixture(autouse=True)
def _counts():
    reset_launch_counts()
    yield
    # on the CPU the wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("n,bias,mish,dtype", CASES)
def test_kernel_c_reference_at_the_wgmma_tile_edges(n, bias, mish, dtype):
    assert jgc.pallas_conv_supported(C, GROUPS, K)
    rng = np.random.default_rng(100 * n + 2 * bias + mish)
    bound = (C // GROUPS * K) ** -0.5
    x = rng.standard_normal((2, n, C)).astype(np.float32)
    w = rng.uniform(-bound, bound, (K, C // GROUPS, C)).astype(np.float32)
    b = rng.uniform(-bound, bound, (C,)).astype(np.float32) if bias else None
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    jb = None if b is None else jnp.asarray(b).astype(dtype)
    want = np.asarray(jgc.grouped_conv1d_mish(jx, jw, jb, groups=GROUPS, fuse_mish=mish,
                                              interpret=True).astype(jnp.float32))

    def same(a):  # the JAX inputs' values, in the torch dtype
        return t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))

    got = grouped_conv.grouped_conv1d_mish(same(jx), same(jw), None if jb is None else same(jb),
                                           GROUPS, mish)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, C)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2 * 2.0 ** -7 * np.abs(want).max(), rtol=0)

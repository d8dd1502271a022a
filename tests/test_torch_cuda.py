"""The Hopper kernels against their plain versions, on the card.

Marked `cuda`: without a CUDA device every test skips (decided in a fixture,
never at import). On the machine with the card, which has no jax, run them
without the jax-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

bf16 tolerances: 4 bf16 ulps at the output's scale (the kernels round P to
bf16 before P.V, or sum fp32 in another order, than the plain versions).
"""

import pytest
import torch

from korean_f5_tts_tpu_torch.ops import ff_block, flash_prefix, grouped_conv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert (g - w).abs().max().item() <= 2.0 ** -6 * max(1.0, w.abs().max().item())


def _bf16(shape, dev, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("n,d,lens", [(200, 64, [1, 64, 65, 200]), (130, 128, [130, 7, 128, 3])])
def test_prefix_attention_kernel(dev, n, d, lens):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_bf16((4, n, d), dev, gen) for _ in range(3))
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = flash_prefix.launches
    got = flash_prefix.flash_prefix_folded(q, k, v, kv)
    assert flash_prefix.launches == before + 1
    _close(got, flash_prefix.prefix_attention_reference(q, k, v, kv))


def test_ff_block_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    d, dff = 256, 512
    args = (_bf16((1, 200, d), dev, gen), _bf16((d,), dev, gen, 0.2), _bf16((d,), dev, gen, 0.2),
            _bf16((d,), dev, gen), _bf16((dff, d), dev, gen, d ** -0.5),
            _bf16((dff,), dev, gen, 0.1), _bf16((d, dff), dev, gen, dff ** -0.5),
            _bf16((d,), dev, gen, 0.1))
    _close(ff_block.ff_block_fused(*args), ff_block.ff_block_reference(*args))


def test_grouped_conv_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = _bf16((2, 100, 128), dev, gen)
    w = _bf16((31, 64, 128), dev, gen, (64 * 31) ** -0.5)
    b = _bf16((128,), dev, gen, 0.1)
    _close(grouped_conv.grouped_conv1d_mish(x, w, b, groups=2),
           grouped_conv.grouped_conv1d_mish_reference(x, w, b, groups=2))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 16, 96), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((31, 6, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        grouped_conv.grouped_conv1d_mish(x, w, None, groups=16)  # 6 channels per group
    q = torch.zeros((2, 16, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        flash_prefix.flash_prefix_folded(q, q, q, torch.ones(2, dtype=torch.int32, device=dev))
    f32 = torch.zeros((2, 16, 64), device=dev)
    with pytest.raises(TypeError):  # the kernel takes bf16 only
        flash_prefix.flash_prefix_folded(f32, f32, f32, torch.ones(2, dtype=torch.int32, device=dev))

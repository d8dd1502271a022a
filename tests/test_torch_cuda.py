"""The Hopper kernels against their plain versions, on the card.

Marked `cuda`: without a CUDA device every test skips (decided in a fixture,
never at import). On the machine with the card, which has no jax, run them
without the jax-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

bf16 tolerances: 4 bf16 ulps at the output's scale (the kernels round P to
bf16 before P.V, or sum fp32 in another order, than the plain versions). The
int8 kernels quantize the same values as their plain versions and sum the
integer products exactly: kernels 9 and 6, which quantize their input
itself, equal their plain versions bit for bit (GELU aside); where the
quantized value is computed first (LN statistics, GELU), a one-ulp
difference can flip a value at a rounding tie and move one product term by
one quantization step, about 1e-3 of the output's scale, well inside the
same bound.
"""

import pytest
import torch

from korean_f5_tts_tpu_torch.models.quant import quantize_linear
from korean_f5_tts_tpu_torch.ops import (
    ff_block,
    flash_prefix,
    fused_linears,
    grouped_conv,
    qmatmul,
)

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


# --- int8 kernels 9, 5, 6, 4 ---------------------------------------------------


def _qp(dev, gen, n, k):
    """An int8 linear {w_int8 [n, k], w_scale [n] fp32, b [n] bf16}."""
    qp = quantize_linear({"w": torch.randn((n, k), generator=gen, device=dev) * k ** -0.5})
    qp["b"] = _bf16((n,), dev, gen, 0.1)
    return qp


def _rows(m, k, dev, gen):
    """bf16 rows with a zero row (the 1e-6 scale floor) and an outlier row."""
    x = _bf16((m, k), dev, gen)
    x[3] = 0
    x[7, 5] = 300.0
    return x


def test_quantize_linear_on_the_card_matches_the_cpu(dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    w = torch.randn((512, 1024), generator=gen, device=dev)
    got = quantize_linear({"w": w})
    want = quantize_linear({"w": w.cpu()})
    for k in ("w_int8", "w_scale"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("bias,activation", [(True, None), (False, None), (True, "gelu_tanh")])
def test_qmatmul_kernel(dev, bias, activation):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rows(200, 256, dev, gen)  # ragged m
    qp = _qp(dev, gen, 384, 256)
    b = qp["b"] if bias else None
    before = qmatmul.launches
    got = qmatmul.qmatmul(x, qp["w_int8"], qp["w_scale"], b, activation)
    assert qmatmul.launches == before + 1
    want = qmatmul.qmatmul_reference(x, qp["w_int8"], qp["w_scale"], b, activation)
    _close(got, want)
    if activation is None:  # same q and s, exact products, same fp32 epilogue
        assert torch.equal(got, want)


def test_ln_mod_matmul_int8_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    d = 256
    h = _rows(200, d, dev, gen).reshape(1, 200, d)
    sc = _bf16((d,), dev, gen, 0.2)
    qps = [_qp(dev, gen, 128, d) for _ in range(3)]
    for sh in (_bf16((d,), dev, gen, 0.2), torch.zeros(d, dtype=torch.bfloat16, device=dev)):
        before = fused_linears.launches_ln_mod_int8
        got = fused_linears.ln_mod_matmul_int8(h, sc, sh, qps)
        assert fused_linears.launches_ln_mod_int8 == before + 1
        assert got.shape == (1, 200, 384)
        _close(got, fused_linears.ln_mod_matmul_int8_reference(h, sc, sh, qps))
    # one linear alone is the same kernel with one segment
    _close(fused_linears.ln_mod_matmul_int8(h, sc, sh, qps[1:2]),
           fused_linears.ln_mod_matmul_int8_reference(h, sc, sh, qps[1:2]))


def test_proj_gated_residual_int8_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    a = _rows(200, 384, dev, gen).reshape(2, 100, 384)
    h = _bf16((2, 100, 256), dev, gen)
    gate = _bf16((256,), dev, gen)
    qp = _qp(dev, gen, 256, 384)
    before = fused_linears.launches_proj_gated_int8
    got = fused_linears.proj_gated_residual_int8(a, h, gate, qp)
    assert fused_linears.launches_proj_gated_int8 == before + 1
    want = fused_linears.proj_gated_residual_int8_reference(a, h, gate, qp)
    _close(got, want)
    assert torch.equal(got, want)  # a is quantized as it is: bit for bit


def test_ff_block_int8_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    d, dff = 256, 512
    h = _rows(200, d, dev, gen).reshape(1, 200, d)
    sc, gate = _bf16((d,), dev, gen, 0.2), _bf16((d,), dev, gen)
    qp_in, qp_out = _qp(dev, gen, dff, d), _qp(dev, gen, d, dff)
    for sh in (_bf16((d,), dev, gen, 0.2), torch.zeros(d, dtype=torch.bfloat16, device=dev)):
        before = ff_block.launches_int8
        got = ff_block.ff_block_fused_int8(h, sc, sh, gate, qp_in, qp_out)
        assert ff_block.launches_int8 == before + 1
        _close(got, ff_block.ff_block_int8_reference(h, sc, sh, gate, qp_in, qp_out))


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _bf16((64, 256), dev, gen)
    qp = _qp(dev, gen, 256, 256)
    bad_scale = dict(qp, w_scale=qp["w_scale"].to(torch.bfloat16))  # scales are fp32
    bad_w = dict(qp, w_int8=qp["w_int8"].to(torch.bfloat16))       # weights are int8
    vec = _bf16((256,), dev, gen)
    h = x.reshape(1, 64, 256)
    # wrong dtypes
    with pytest.raises(TypeError):
        qmatmul.qmatmul(x, qp["w_int8"], bad_scale["w_scale"], qp["b"])
    with pytest.raises(TypeError):
        fused_linears.ln_mod_matmul_int8(h, vec, vec, [qp, bad_w, qp])
    with pytest.raises(TypeError):
        fused_linears.proj_gated_residual_int8(h, h, vec, bad_scale)
    with pytest.raises(TypeError):
        ff_block.ff_block_fused_int8(h, vec, vec, vec, bad_w, qp)
    # wrong shapes
    x96 = _bf16((64, 96), dev, gen)
    with pytest.raises(ValueError):  # K = 96 is not a multiple of 64
        qmatmul.qmatmul(x96, _qp(dev, gen, 256, 96)["w_int8"], qp["w_scale"])
    with pytest.raises(ValueError):  # sc must be [d]
        fused_linears.ln_mod_matmul_int8(h, vec[:128], vec, [qp])
    with pytest.raises(ValueError):  # a and h must have the same rows
        fused_linears.proj_gated_residual_int8(h, h[:, :32], vec, qp)
    qp_in = _qp(dev, gen, 200, 256)  # dff = 200 is not a multiple of 128
    with pytest.raises(ValueError):
        ff_block.ff_block_fused_int8(h, vec, vec, vec, qp_in, _qp(dev, gen, 256, 200))

"""fp32 operands through the wrappers of kernels A, B and C, conv-pos under
autograd in the input's dtype, and the tile choice of the bf16 product core.

On the CPU a wrapper runs its kernel's plain version, so these tests hold
the wrappers' dtype contract (all operands bf16 or all fp32, anything else
raises), the plain versions on fp32 inputs against the JAX kernels in
interpret mode (1e-5 absolute, as tests/test_torch_ops.py: only the order of
fp32 sums differs), the offline entry points with their own defaults (fp32
weights) and the sampler in fp32 against the JAX sampler. The fp32 kernels
themselves run in tests/test_torch_cuda.py, on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import rel_err, t, tiny_configs, tiny_dit
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import grouped_conv as jgc
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.ops import (
    KERNELS,
    ff_block,
    flash_prefix,
    grouped_conv,
    launch_counts,
    reset_launch_counts,
)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jff._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = True
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # nothing launches on the CPU
    jfp._INTERPRET, jff._INTERPRET = old


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _attn_args(dtype, h=2, n=48, d=64):
    q, k, v = (t(_randn((h, n, d), s)).to(dtype) for s in (1, 2, 3))
    return q, k, v, torch.tensor([n, 7], dtype=torch.int32)


def _ff_args(dtype, m=24, d=32, dff=64):
    rng = np.random.default_rng(5)
    shapes = [(1, m, d), (d,), (d,), (d,), (dff, d), (dff,), (d, dff), (d,)]
    return [t((0.3 * rng.standard_normal(s)).astype(np.float32)).to(dtype) for s in shapes]


def _conv_args(dtype, n=40, c=128, groups=16, k=31, seed=6):
    rng = np.random.default_rng(seed)
    bound = (c // groups * k) ** -0.5
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    w = rng.uniform(-bound, bound, (k, c // groups, c)).astype(np.float32)
    b = rng.uniform(-bound, bound, (c,)).astype(np.float32)
    return [t(a).to(dtype) for a in (x, w, b)]


WRAPPERS = {
    "A": (lambda a: flash_prefix.flash_prefix_folded(*a),
          lambda a: flash_prefix.prefix_attention_reference(*a), _attn_args, (0, 1, 2)),
    "B": (lambda a: ff_block.ff_block_fused(*a), lambda a: ff_block.ff_block_reference(*a),
          _ff_args, tuple(range(8))),
    "C": (lambda a: grouped_conv.grouped_conv1d_mish(*a, 16),
          lambda a: grouped_conv.grouped_conv1d_mish_reference(*a, 16), _conv_args, (0, 1, 2)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrapper_on_the_cpu_is_the_plain_version_in_the_operands_dtype(kernel, dtype):
    wrapper, plain, make, _ = WRAPPERS[kernel]
    args = make(dtype)
    got = wrapper(args)
    assert got.dtype == dtype and got.shape == args[0].shape
    torch.testing.assert_close(got, plain(args), rtol=0, atol=0)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wrapper_raises_on_mixed_dtypes_and_on_fp16(kernel):
    wrapper, _, make, floats = WRAPPERS[kernel]
    for i in floats:  # one bf16 operand among fp32 ones, each position in turn
        args = make(torch.float32)
        args = [a.to(torch.bfloat16) if j == i else a for j, a in enumerate(args)]
        with pytest.raises(TypeError, match="bfloat16 or all float32"):
            wrapper(args)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        wrapper(make(torch.float16))


# --- fp32 plain versions against the JAX kernels in interpret mode ----------------


@pytest.mark.parametrize("d,n,lens", [(128, 256, [256, 100]), (64, 384, [1, 129])])
def test_fp32_prefix_attention_matches_the_interpret_kernel(d, n, lens):
    """Head dims 64 and 128, prefixes that end inside a key block; the JAX
    kernel keeps the exact f32 dot on fp32 inputs, as the port's fp32 form
    does."""
    b, h = 2, 4
    q, k, v = (_randn((b, h, n, d), s) for s in (31, 32, 33))
    kv = np.asarray(lens, np.int32)
    want = jfp.flash_prefix_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(kv), bq=128, bkv=128)
    got = flash_prefix.flash_prefix_attention(t(q), t(k), t(v), t(kv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_fp32_ff_block_matches_the_interpret_kernel_on_ragged_rows():
    rng = np.random.default_rng(40)
    m, d, dff = 192, 128, 256

    def u(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    args = (rng.standard_normal((1, m, d)).astype(np.float32), u((d,), 0.3), u((d,), 0.3),
            u((d,), 1.0), u((d, dff), d ** -0.5), u((dff,), 0.1), u((dff, d), dff ** -0.5),
            u((d,), 0.1))
    h, sc, sh, gate, w1, b1, w2, b2 = args
    want = jff._ff_block_call(*(jnp.asarray(a) for a in args), bm=64, eps=1e-6)
    got = ff_block.ff_block_fused(t(h), t(sc), t(sh), t(gate), t(w1.T), t(b1), t(w2.T), t(b2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_fp32_grouped_conv_matches_the_interpret_kernel_on_ragged_rows():
    x, w, b = (a.numpy() for a in _conv_args(torch.float32, n=75, seed=41))
    want = jgc.grouped_conv1d_mish(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=16,
                                   fuse_mish=True, interpret=True)
    got = grouped_conv.grouped_conv1d_mish(t(x), t(w), t(b), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


# --- conv-pos under autograd --------------------------------------------------------

# bf16 against bf16: both sides convolve with fp32 sums inside the library's
# convolution and round its result, the bias add and Mish to bf16. Forward: 2
# bf16 ulps (2**-7 each) of the output's scale. Gradients (relative L2): both
# backward passes are bf16 convolutions whose operands were rounded at the same
# points; what differs is the order of fp32 sums and the pointwise Mish
# derivative's roundings, ~1 bf16 ulp (4e-3) per element: measured 3.6e-3 (dx),
# 3.5e-3 (dw). db is a sum of 128 bf16 values per channel, where the two
# libraries round the running sum at different points: measured 1.03e-2.
GRAD_REL = {"dx": 1e-2, "dw": 1e-2, "db": 3e-2}


@pytest.mark.parametrize("fuse_mish,bias", [(True, True), (False, False)])
def test_conv_pos_under_grad_convolves_in_bf16_like_jax(fuse_mish, bias):
    x, w, b = (a.numpy() for a in _conv_args(torch.float32, n=64, seed=50))
    g = _randn(x.shape, 51)
    jx, jw, jb, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b, g))

    def loss(x_, w_, b_):
        y = jgc.grouped_conv1d_mish(x_, w_, b_ if bias else None, groups=16,
                                    fuse_mish=fuse_mish, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * jg.astype(jnp.float32)), y

    (_, want_y), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jx, jw, jb)
    tx, tw, tb, tg = (t(a).to(torch.bfloat16) for a in (x, w, b, g))
    leaves = [a.clone().requires_grad_(True) for a in ((tx, tw, tb) if bias else (tx, tw))]
    y = grouped_conv.grouped_conv1d_mish(leaves[0], leaves[1], leaves[2] if bias else None, 16,
                                         fuse_mish)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad((y.float() * tg.float()).sum(), leaves)
    want_y = np.asarray(want_y.astype(jnp.float32))
    np.testing.assert_allclose(y.detach().float().numpy(), want_y,
                               atol=2 * 2.0 ** -7 * np.abs(want_y).max(), rtol=0)
    for name, got, want in zip(("dx", "dw", "db"), grads, want_grads):
        assert got.dtype == torch.bfloat16
        err = rel_err(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        assert err < GRAD_REL[name], (name, err)


def test_conv_pos_under_grad_rounds_where_the_plain_version_does_not():
    """The training conv rounds to bf16 after the conv, the bias and inside
    Mish; kernel C's plain version rounds once. Without a gradient the
    wrapper still returns the plain version."""
    x, w, b = _conv_args(torch.bfloat16, n=64, seed=52)
    plain = grouped_conv.grouped_conv1d_mish_reference(x, w, b, 16)
    torch.testing.assert_close(grouped_conv.grouped_conv1d_mish(x, w, b, 16), plain, rtol=0, atol=0)
    trained = grouped_conv.grouped_conv1d_mish(x.clone().requires_grad_(True), w, b, 16)
    assert trained.requires_grad and not torch.equal(trained.detach(), plain)
    scale = plain.float().abs().max().item()
    assert (trained.detach().float() - plain.float()).abs().max().item() <= 4 * 2.0 ** -7 * scale
    # fp32 masters meet bf16 activations in the training path: w, b are cast to x's dtype
    mixed = grouped_conv.grouped_conv1d_mish(x.clone().requires_grad_(True), w.float(), b.float(),
                                             16)
    torch.testing.assert_close(mixed, trained, rtol=0, atol=0)


# --- the offline entry point and the sampler in fp32 ----------------------------------


def test_f5tts_keeps_fp32_weights_without_a_compute_dtype(tmp_path):
    import yaml

    arch = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=2,
                text_num_embeds=256)
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": arch,
                              "tokenizer": "byte"}}, open(tmp_path / "tiny.yaml", "w"))
    tts = papi.F5TTS(str(tmp_path / "tiny.yaml"), device="cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    floats = {x.dtype for x in leaves(tts.ema_model.params) if x.is_floating_point()}
    assert floats == {torch.float32}
    assert pcfm._compute_dtype(tts.ema_model.params, torch.float32) == torch.float32
    assert {x.dtype for x in leaves(tts.vocoder.params) if x.is_floating_point()} == {torch.float32}


def test_fp32_sampler_without_a_duration_mask_matches_jax():
    """Batch 1, no duration mask: every block takes kernel A's and kernel B's
    wrappers (fp32 here) and conv-pos kernel C's, the dispatch of the offline
    path. Against the JAX sampler, relative 1e-4 (fp32 sums over 8 steps)."""
    rng = np.random.default_rng(60)
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    n, cond_len, total = 128, 40, 110
    ar = np.arange(n)
    cond_mask = (ar < cond_len)[None, :, None]
    step_cond = np.where(cond_mask, rng.standard_normal((1, n, 100)), 0.0).astype(np.float32)
    text = np.full((1, 64), -1, np.int32)
    text[0, :25] = rng.integers(0, 49, 25)
    y0 = rng.standard_normal((1, n, 100)).astype(np.float32)
    pad_mask = (ar < total)[None, :]
    want = jcfm._sample_core(jparams, jcfg, jnp.asarray(step_cond), jnp.asarray(text), None,
                             jnp.asarray(pad_mask), jnp.asarray(y0), jnp.asarray(2.0),
                             jnp.asarray(-1.0), steps=8, use_cfg=True, use_sway=True,
                             use_epss=True)
    got = pcfm._sample_core(pparams, pcfg, t(step_cond), t(text), None, t(pad_mask), t(y0), 2.0,
                            -1.0, steps=8, use_cfg=True, use_sway=True, use_epss=True)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy()[:, :total], np.asarray(want)[:, :total]) < 1e-4


# --- the bf16 product core's shared-memory layout --------------------------------------


def test_swizzled_box_is_the_layout_the_core_addresses():
    """scripts/probe_hopper.py:swizzled_box, the expectation the TMA probe is
    held to: 16-byte chunk c of box row r sits at chunk c ^ (r % 8)
    (csrc/hopper.cuh:swz_chunk_addr), reads past the array's edges are zeros,
    and rows that are multiples of 8 are not permuted."""
    from korean_f5_tts_tpu_torch.scripts.probe_hopper import swizzled_box

    x = torch.arange(100 * 200, dtype=torch.float32).reshape(100, 200).to(torch.bfloat16)
    box = swizzled_box(x, 8, 64)
    for r, c in ((0, 0), (1, 0), (5, 3), (63, 7), (9, 6)):
        torch.testing.assert_close(box[r, 8 * (c ^ (r % 8)):8 * (c ^ (r % 8)) + 8],
                                   x[8 + r, 64 + 8 * c:64 + 8 * c + 8], rtol=0, atol=0)
    torch.testing.assert_close(box[::8], x[8:72:8, 64:128], rtol=0, atol=0)
    edge = swizzled_box(x, 72, 176)  # rows 100.. and columns 200.. do not exist
    assert edge[28:].abs().max() == 0
    # row 3 of the box: logical chunks 0..2 exist (columns 176..199), 3..7 are zero fill
    assert all(edge[3, 8 * (c ^ 3):8 * (c ^ 3) + 8].abs().max() == 0 for c in range(3, 8))
    torch.testing.assert_close(edge[3, 8 * (2 ^ 3):8 * (2 ^ 3) + 8], x[75, 192:200], rtol=0, atol=0)

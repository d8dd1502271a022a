"""The port's int8-weight path against the JAX package, on the CPU.

Quantization and the converter must agree with the JAX package exactly. The
plain versions of kernels 4, 5, 6 and 9 are held to the JAX kernels run in
interpret mode (kernel 9 through a test-local pallas_call of _qmm_kernel,
which has no interpret switch) and to the JAX plain qlinear; one int8 CFG
step of a tiny DiT is held to the JAX dispatch at batch 1 (kernels 5, A, 6,
4) and batch 2 with a duration mask (qlinear per projection, kernel 4).

Tolerances. Where the two sides quantize identical fp32 values (kernels 6
and 9: the input itself), the int8 values agree exactly and the integer
products are exact; only the fp32 epilogue differs, where XLA may
reassociate acc * x_scale * w_scale or contract a multiply-add, and tanh
differs by implementation: 4 fp32 ulps of the output's scale. Where the quantized value
is computed first (LN statistics in kernels 4 and 5, the GELU output in
kernel 4), the two sides sum in another order; a one-ulp difference can
flip a value at a rounding tie, which moves one product term by one
quantization step: about 1/127 of one term among K, a few 1e-4 of that
row's output. The bounds below allow a handful of such flips.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch

from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.ops import qmatmul as jqmm
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig, MelConfig, ModelConfig
from korean_f5_tts_tpu_torch.infer.model import load_model
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import quant as pquant
from korean_f5_tts_tpu_torch.models.modules import cast_params, linear
from korean_f5_tts_tpu_torch.ops import (
    KERNELS,
    ff_block,
    fused_linears,
    launch_counts,
    qmatmul,
    reset_launch_counts,
)
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as port_flatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax, params_to_jax

# dims the JAX kernels take in interpret mode: dim_head 64, m % 256 == 0
INT8_TINY = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                 conv_layers=1, text_num_embeds=50)
FLIP_REL = 2e-3  # relative L2 bound where a tie flip can move one product term


def _assert_ulps(got, want, ulps=4):
    """|got - want| <= ulps fp32 ulps of the output's scale (max |want|)."""
    bound = ulps * 2.0 ** -23 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_linear(rng, d_in, d_out):
    """A JAX-layout float linear {w [d_in, d_out], b [d_out]}."""
    bound = d_in ** -0.5
    return {"w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32),
            "b": rng.uniform(-0.1, 0.1, (d_out,)).astype(np.float32)}


def _port_qp(jqp):
    """JAX int8 linear -> the port's, through the converter."""
    return params_from_jax({k: np.asarray(v) for k, v in jqp.items()}, device="cpu")


def _rows(rng, m, d, zero_row=None, outlier_row=None):
    x = rng.standard_normal((1, m, d)).astype(np.float32)
    if zero_row is not None:
        x[0, zero_row] = 0.0
    if outlier_row is not None:
        x[0, outlier_row, 5] = 300.0
    return x


# --- quantization and the converter -----------------------------------------


@functools.lru_cache(maxsize=2)
def _tiny_flat(seed=0):
    jcfg = JaxDiTConfig(**INT8_TINY)
    flat = flatten_tree(jdit.init_dit(jax.random.PRNGKey(seed), jcfg))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_equals_jax_exactly(dtype):
    flat = _tiny_flat()
    jtree = unflatten_tree({k: jnp.asarray(v).astype(dtype) for k, v in flat.items()})
    want = {k: np.asarray(v) for k, v in flatten_tree(jquant.quantize_params(jtree)).items()}
    port = pquant.quantize_params(cast_params(params_from_jax(flat, device="cpu"), getattr(torch, dtype)))
    got = port_flatten(port)
    assert got.keys() == want.keys()
    n_int8 = 0
    for k, w in want.items():
        g = got[k]
        if k.endswith("/w_int8"):
            n_int8 += 1
            assert g.dtype == torch.int8 and g.shape == w.T.shape
            np.testing.assert_array_equal(g.numpy(), w.T)
        elif k.endswith("/w_scale"):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
    assert n_int8 == 6 * INT8_TINY["depth"]  # to_q/k/v/out, ff in/out per block
    assert "w" in port["blocks"][0]["attn_norm"]["linear"]  # not a quant pattern


def test_converter_transposes_int8_and_keeps_scales_fp32():
    """A quantized JAX tree reaches the port with w_int8 in the torch layout
    and w_scale in fp32 under dtype=bf16, and round-trips exactly."""
    flat = _tiny_flat()
    jq = jquant.quantize_params(unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}))
    qflat = {k: np.asarray(v) for k, v in flatten_tree(jq).items()}
    port = params_from_jax(qflat, device="cpu", dtype=torch.bfloat16)
    ff_in = port["blocks"][1]["ff"]["in"]
    d, dff = INT8_TINY["dim"], INT8_TINY["dim"] * INT8_TINY["ff_mult"]
    assert ff_in["w_int8"].shape == (dff, d) and ff_in["w_int8"].dtype == torch.int8
    np.testing.assert_array_equal(ff_in["w_int8"].numpy(), qflat["blocks/1/ff/in/w_int8"].T)
    assert ff_in["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(ff_in["w_scale"].numpy(), qflat["blocks/1/ff/in/w_scale"])
    assert ff_in["b"].dtype == torch.bfloat16
    back = params_to_jax(params_from_jax(qflat, device="cpu"))
    assert back.keys() == qflat.keys()
    for k in qflat:
        assert back[k].dtype == qflat[k].dtype, k
        np.testing.assert_array_equal(back[k], qflat[k])


def test_load_model_quantizes_after_the_dtype_cast():
    model = load_model(ModelConfig(arch=DiTConfig(**INT8_TINY), mel=MelConfig()),
                       dtype=torch.bfloat16, quantize=True, device="cpu")
    blk = model.params["blocks"][0]
    assert set(blk["attn"]["to_q"]) == {"w_int8", "w_scale", "b"}
    assert blk["attn"]["to_q"]["w_scale"].dtype == torch.float32
    assert blk["ff"]["out"]["b"].dtype == torch.bfloat16
    plain = load_model(ModelConfig(arch=DiTConfig(**INT8_TINY), mel=MelConfig()),
                       dtype=torch.bfloat16, device="cpu")
    want = pquant.quantize_linear(plain.params["blocks"][0]["ff"]["in"])
    torch.testing.assert_close(blk["ff"]["in"]["w_int8"], want["w_int8"], rtol=0, atol=0)


# --- kernel 9: dynamic-int8 matmul -------------------------------------------


def _qmm_interpret(x, w, ws, b, activation, block_m=64, block_n=128):
    """_qmm_kernel through a test-local pallas_call with qmatmul's BlockSpecs."""
    m, k = x.shape
    n = w.shape[1]
    if b is None:
        b = jnp.zeros((n,), jnp.float32)
    return pl.pallas_call(
        functools.partial(jqmm._qmm_kernel, activation=activation),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        grid_spec=pl.GridSpec(
            grid=(m // block_m, n // block_n),
            in_specs=[
                pl.BlockSpec((block_m, k), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((k, block_n), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, block_n), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, block_n), lambda i, j: (0, j), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((block_m, block_n), lambda i, j: (i, j),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(x, w, ws.reshape(1, n), b.reshape(1, n).astype(jnp.float32))


@pytest.mark.parametrize("bias,activation", [(True, None), (False, None), (True, "gelu_tanh")])
def test_qmatmul_matches_interpret_kernel_and_jax_qlinear(bias, activation):
    rng = _rng(1)
    x = _rows(rng, 128, 128, zero_row=3, outlier_row=7)[0]
    jqp = jquant.quantize_linear(_jax_linear(rng, 128, 256))
    if not bias:
        del jqp["b"]
    qp = _port_qp(jqp)
    got = qmatmul.qmatmul(t(x), qp["w_int8"], qp["w_scale"], qp.get("b"), activation).numpy()
    kern = np.asarray(_qmm_interpret(jnp.asarray(x), jqp["w_int8"], jqp["w_scale"],
                                     jqp.get("b"), activation))
    _assert_ulps(got, kern)
    if activation is None:
        _assert_ulps(got, np.asarray(jquant.qlinear(jqp, jnp.asarray(x))))
        # the zero row: q == 0, so the output is the bias (or 0) exactly
        np.testing.assert_array_equal(got[3], np.asarray(jqp["b"]) if bias else 0.0)


def test_linear_dispatches_int8_layouts_to_kernel_9():
    rng = _rng(2)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    jqp = jquant.quantize_linear(_jax_linear(rng, 128, 128))
    want = np.asarray(jquant.qlinear(jqp, jnp.asarray(x)))
    for kernels in (True, False):
        got = linear(_port_qp(jqp), t(x), kernels=kernels)
        assert got.shape == (2, 64, 128)
        _assert_ulps(got.numpy(), want)


# --- kernels 5 and 6: int8 fused attention linears ---------------------------


@pytest.mark.parametrize("zero_sh", [False, True])
def test_ln_mod_matmul_int8_matches_interpret_kernel(zero_sh):
    rng = _rng(3)
    d, n = 128, 128
    h = _rows(rng, 256, d, zero_row=0 if zero_sh else None, outlier_row=9)
    sc = rng.uniform(-0.3, 0.3, (d,)).astype(np.float32)
    sh = np.zeros((d,), np.float32) if zero_sh else rng.uniform(-0.3, 0.3, (d,)).astype(np.float32)
    jqps = [jquant.quantize_linear(_jax_linear(rng, d, n)) for _ in range(3)]
    jcat = {k: jnp.concatenate([p[k] for p in jqps], axis=-1) for k in jqps[0]}
    want = np.asarray(jfl.ln_mod_matmul_int8(jnp.asarray(h), jnp.asarray(sc),
                                             jnp.asarray(sh), jcat, bm=64))
    got = fused_linears.ln_mod_matmul_int8(t(h), t(sc), t(sh), [_port_qp(p) for p in jqps])
    assert got.shape == (1, 256, 3 * n)
    assert rel_err(got.numpy(), want) < FLIP_REL
    if zero_sh:  # y == 0: q == 0, the output is the bias alone
        np.testing.assert_array_equal(got.numpy()[0, 0], want[0, 0])
        np.testing.assert_array_equal(got.numpy()[0, 0], np.asarray(jcat["b"]))


def test_proj_gated_residual_int8_matches_interpret_kernel():
    rng = _rng(4)
    din, d = 256, 128
    a = _rows(rng, 256, din, zero_row=2, outlier_row=5)
    h = rng.standard_normal((1, 256, d)).astype(np.float32)
    gate = rng.uniform(-1, 1, (d,)).astype(np.float32)
    jqp = jquant.quantize_linear(_jax_linear(rng, din, d))
    want = np.asarray(jfl.proj_gated_residual_int8(jnp.asarray(a), jnp.asarray(h),
                                                   jnp.asarray(gate), jqp, bm=64))
    got = fused_linears.proj_gated_residual_int8(t(a), t(h), t(gate), _port_qp(jqp))
    # the quantized input is a itself: identical q, exact products
    _assert_ulps(got.numpy(), want)


# --- kernel 4: int8 FF half-block --------------------------------------------


@pytest.mark.parametrize("zero_sh", [False, True])
def test_ff_block_int8_matches_interpret_kernel(zero_sh):
    rng = _rng(5)
    d, dff = 128, 256
    h = _rows(rng, 256, d, zero_row=4 if zero_sh else None, outlier_row=11)
    sc, gate = (rng.uniform(-b, b, (d,)).astype(np.float32) for b in (0.3, 1.0))
    sh = np.zeros((d,), np.float32) if zero_sh else rng.uniform(-0.3, 0.3, (d,)).astype(np.float32)
    jin = jquant.quantize_linear(_jax_linear(rng, d, dff))
    jout = jquant.quantize_linear(_jax_linear(rng, dff, d))
    args = [jnp.asarray(v) for v in (h, sc, sh, gate)]
    kern = np.asarray(jff.ff_block_fused_int8(*args, jin, jout, bm=64))
    xla = np.asarray(jff._xla_reference_int8(*args, jin, jout))
    got = ff_block.ff_block_fused_int8(t(h), t(sc), t(sh), t(gate), _port_qp(jin),
                                       _port_qp(jout)).numpy()
    # the residual h dominates the output; hold the FF part h - out to the bound
    assert rel_err(got - h, kern - h) < FLIP_REL
    assert rel_err(got - h, xla - h) < FLIP_REL


# --- the int8 slice: one CFG step of a quantized tiny DiT --------------------


@functools.lru_cache(maxsize=1)
def _int8_dit():
    jcfg, pcfg = JaxDiTConfig(**INT8_TINY), DiTConfig(**INT8_TINY)
    flat = _tiny_flat()
    jparams = jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)))
    return jcfg, pcfg, jparams, pquant.quantize_params(params_from_jax(flat, device="cpu"))


@pytest.mark.parametrize("batch", [1, 2])
def test_int8_dit_cfg_step_matches_jax_dispatch(batch, monkeypatch):
    # batch 1 (no duration mask): the JAX fused dispatch, kernels 5, A, 6, 4 in
    # interpret mode; batch 2 (duration mask): qlinear per projection + kernel 4
    monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
    jcfg, pcfg, jp, pp = _int8_dit()
    n, mel = 128, jcfg.mel_dim
    rng = _rng(6)
    durs = np.asarray([128, 100][:batch])
    dur_mask = np.arange(n)[None, :] < durs[:, None]
    mask = dur_mask if batch > 1 else None
    pad_mask = (np.arange(n) < durs.max())[None, :]
    y0 = np.where(dur_mask[..., None], rng.standard_normal((batch, n, mel)), 0).astype(np.float32)
    cond = np.where(np.arange(n)[None, :, None] < 30, rng.standard_normal((batch, n, mel)),
                    0).astype(np.float32)
    text = rng.integers(0, 49, (batch, 40)).astype(np.int32)
    ts = np.asarray([0.4], np.float32)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=dr,
                              pad_mask=jnp.asarray(pad_mask)) for dr in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray(ts))
    want = np.asarray(jdit.dit_forward_cfg_premod(
        jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te, mods[0], mod_final[0], 2.0,
        mask=None if mask is None else jnp.asarray(mask), pad_mask=jnp.asarray(pad_mask)))
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(text), n, drop_text=dr,
                              pad_mask=t(pad_mask)) for dr in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, t(ts))
    outs = [pdit.dit_forward_cfg_premod(
        pp, pcfg, t(y0), t(cond), *tp, pmods[0], pfinal[0], 2.0,
        mask=None if mask is None else t(mask), pad_mask=t(pad_mask), kernels=k).numpy()
        for k in (True, False)]
    np.testing.assert_array_equal(outs[0], outs[1])  # on the CPU both are the plain path
    valid = np.concatenate([outs[0][i, :d] for i, d in enumerate(durs)])
    ref = np.concatenate([want[i, :d] for i, d in enumerate(durs)])
    assert np.abs(valid).max() > 0.1  # not gated off
    assert rel_err(valid, ref) < FLIP_REL

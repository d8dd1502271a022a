"""int8 weights on fp32 rows (kernels 4, 5, 6, 9; `quantize` on F5TTS and
the CLI) against the JAX package, on the CPU.

The JAX int8 kernels read their rows as fp32 whatever the input's dtype and
write the input's dtype, and infer/model.py:load_model quantizes after an
optional cast, so an fp32 model with int8 weights runs them on fp32 rows.
The port's kernels take fp32 rows with fp32 vectors (modulation, gate,
biases) and refuse a mix; on the CPU the wrappers take the plain versions,
which these tests hold to the JAX kernels in interpret mode on fp32 rows
(the card holds the kernels to the same plain versions: chip_smoke.py phase
2, tests/test_torch_cuda.py).

Tolerances, as tests/test_torch_quant.py states them: kernels 6 and 9
quantize their input itself, so the int8 values agree exactly and only the
fp32 epilogue differs (XLA may reassociate or contract it, tanh differs by
implementation): 4 fp32 ulps of the output's scale. Kernels 4 and 5
quantize a value computed first (LN statistics, the GELU output), summed in
another order: a tie flip moves one product term by one quantization step,
relative L2 2e-3 (kernel 4 on its FF part, out - h).

Entry points: F5TTS(quantize=True, device="cpu") and the CLI's --quantize
at depth 2 load the same .npz as the JAX load_model(quantize=True): the int8
weights are the JAX package's exactly, and the sampler on the same inputs
and noise agrees within the int8 bound of the sampler tests (1e-2 over four
Euler steps of two blocks: each call adds a few tie flips).
"""

import functools

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch
from scipy.io import wavfile

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.config import load_model_config as jax_load_model_config
from korean_f5_tts_tpu.infer import model as jmodel
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.ops import qmatmul as jqmm
from korean_f5_tts_tpu.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.infer import cli as pcli
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.ops import (
    KERNELS,
    ff_block,
    fused_linears,
    launch_counts,
    qmatmul,
    reset_launch_counts,
)
from korean_f5_tts_tpu_torch.ops.qmatmul import check_int8_rows
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as port_flatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax, params_to_jax

FLIP_REL = 2e-3
SAMPLE_REL = 1e-2
BM = 64  # the JAX kernels' row block in interpret mode
TINY_ARCH = dict(dim=64, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
                 text_num_embeds=256)
SR = 24_000


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


def _assert_ulps(got, want, ulps=4):
    bound = ulps * 2.0 ** -23 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@functools.lru_cache(maxsize=8)
def _linear(d_in, d_out, seed):
    """(JAX int8 linear, the port's through the converter) from uniform
    +-1/sqrt(d_in) fp32 weights; the bias stays fp32 on both sides."""
    rng = np.random.default_rng(seed)
    bound = d_in ** -0.5
    jqp = jquant.quantize_linear({"w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32),
                                  "b": rng.uniform(-0.1, 0.1, (d_out,)).astype(np.float32)})
    qp = params_from_jax({k: np.asarray(v) for k, v in jqp.items()}, device="cpu")
    return jqp, qp


def _rows(seed, m, d, edges):
    """fp32 rows (not bf16 values) with, where asked, a zero row and an outlier row."""
    x = np.random.default_rng(seed).standard_normal((1, m, d)).astype(np.float32) * 1.7
    if edges:
        x[0, 3] = 0.0
        x[0, 7, 5] = 300.0
    return x


def _vec(seed, d, bound):
    return np.random.default_rng(seed).uniform(-bound, bound, (d,)).astype(np.float32)


CASES = [pytest.param(m, d, edges, id=f"m{m}-d{d}{'-edges' if edges else ''}")
         for m, d, edges in ((256, 128, False), (256, 128, True), (128, 256, True))]


@pytest.mark.parametrize("bias,activation", [(True, None), (False, None), (True, "gelu_tanh")])
@pytest.mark.parametrize("m,d,edges", CASES)
def test_kernel_9_on_fp32_rows_matches_the_tpu_kernel(m, d, edges, bias, activation):
    jqp, qp = _linear(d, 256, d)
    x = _rows(m + d, m, d, edges)[0]
    b = jqp["b"] if bias else jnp.zeros((256,), jnp.float32)
    want = pl.pallas_call(
        functools.partial(jqmm._qmm_kernel, activation=activation),
        out_shape=jax.ShapeDtypeStruct((m, 256), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(m // BM, 2),
            in_specs=[
                pl.BlockSpec((BM, d), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((d, 128), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 128), lambda i, j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 128), lambda i, j: (0, j), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BM, 128), lambda i, j: (i, j), memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(jnp.asarray(x), jqp["w_int8"], jqp["w_scale"].reshape(1, 256), b.reshape(1, 256))
    got = qmatmul.qmatmul(t(x), qp["w_int8"], qp["w_scale"], qp["b"] if bias else None,
                          activation)
    assert got.dtype == torch.float32 and got.shape == (m, 256)
    _assert_ulps(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("zero_sh", [False, True])
@pytest.mark.parametrize("m,d,edges", CASES)
def test_kernel_5_on_fp32_rows_matches_the_tpu_kernel(m, d, edges, zero_sh):
    h = _rows(m * d + 1, m, d, edges)
    sc = _vec(1, d, 0.3)
    sh = np.zeros((d,), np.float32) if zero_sh else _vec(2, d, 0.3)
    pairs = [_linear(d, 128, 10 + i) for i in range(3)]
    jcat = {k: jnp.concatenate([p[0][k] for p in pairs], axis=-1) for k in pairs[0][0]}
    want = np.asarray(jfl.ln_mod_matmul_int8(jnp.asarray(h), jnp.asarray(sc), jnp.asarray(sh),
                                             jcat, bm=BM))
    got = fused_linears.ln_mod_matmul_int8(t(h), t(sc), t(sh), [p[1] for p in pairs])
    assert got.dtype == torch.float32 and got.shape == (1, m, 3 * 128)
    assert rel_err(got.numpy(), want) < FLIP_REL


@pytest.mark.parametrize("m,d,edges", CASES)
def test_kernel_6_on_fp32_rows_matches_the_tpu_kernel(m, d, edges):
    a = _rows(m * d + 2, m, d, edges)
    h = _rows(m * d + 3, m, 128, False)
    gate = _vec(3, 128, 1.0)
    jqp, qp = _linear(d, 128, 20 + d)
    want = np.asarray(jfl.proj_gated_residual_int8(jnp.asarray(a), jnp.asarray(h),
                                                   jnp.asarray(gate), jqp, bm=BM))
    got = fused_linears.proj_gated_residual_int8(t(a), t(h), t(gate), qp)
    assert got.dtype == torch.float32
    _assert_ulps(got.numpy(), want)


@pytest.mark.parametrize("zero_sh", [False, True])
@pytest.mark.parametrize("m,d,edges", CASES)
def test_kernel_4_on_fp32_rows_matches_the_tpu_kernel(m, d, edges, zero_sh):
    h = _rows(m * d + 4, m, d, edges)
    sc, gate = _vec(4, d, 0.3), _vec(5, d, 1.0)
    sh = np.zeros((d,), np.float32) if zero_sh else _vec(6, d, 0.3)
    (jin, qin), (jout, qout) = _linear(d, 2 * d, 30 + d), _linear(2 * d, d, 40 + d)
    args = [jnp.asarray(v) for v in (h, sc, sh, gate)]
    want = np.asarray(jff.ff_block_fused_int8(*args, jin, jout, bm=BM))
    got = ff_block.ff_block_fused_int8(t(h), t(sc), t(sh), t(gate), qin, qout)
    assert got.dtype == torch.float32 and got.shape == h.shape
    # the residual h dominates the output; hold the FF part out - h to the bound
    assert rel_err(got.numpy() - h, want - h) < FLIP_REL


def test_the_int8_kernels_take_bf16_or_fp32_rows_with_vectors_of_their_dtype():
    """The dtype rule the wrappers check before a launch (raised on the card;
    CPU tensors never reach it): the rows and their vectors all bf16 or all
    fp32, the flag the kernels take is 1 for fp32."""
    f, b = torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16)
    assert check_int8_rows("k", f, sc=f, gate=f) == 1
    assert check_int8_rows("k", b, sc=b, gate=b) == 0
    assert check_int8_rows("k", f) == 1
    for rows, vec in ((f, b), (b, f), (f.half(), f.half()), (f.double(), f.double())):
        with pytest.raises(TypeError, match="all bfloat16 or all float32"):
            check_int8_rows("k", rows, bias=vec)


# --- the entry points: F5TTS(quantize=True) and the CLI's --quantize ---------


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """A model config yaml, a JAX-layout .npz checkpoint (fp32) and a
    reference wav (a chirp over a noise floor)."""
    d = tmp_path_factory.mktemp("int8_fp32")
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": TINY_ARCH,
                              "tokenizer": "byte"}}, open(d / "tiny.yaml", "w"))
    params = redraw_zero_init(init_dit(DiTConfig(**TINY_ARCH), seed=0, device="cpu"), seed=1)
    np.savez(d / "tiny.npz", **{f"params/{k}": v for k, v in params_to_jax(params).items()})
    rng = np.random.default_rng(0)
    tt = np.arange(int(3.0 * SR)) / SR
    wav = 0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * tt) * tt) + 0.01 * rng.standard_normal(tt.size)
    wavfile.write(d / "ref.wav", SR, (wav * 32767).astype(np.int16))
    return d


def _jax_quantized(d):
    jm = jmodel.load_model(jax_load_model_config(str(d / "tiny.yaml")),
                           ckpt_path=str(d / "tiny.npz"), quantize=True)
    return jm, {k: np.asarray(v) for k, v in flatten_tree(jm.params).items()}


def _assert_same_int8_weights(port_params, jflat):
    got = port_flatten(port_params)
    n_int8 = 0
    for k, w in jflat.items():
        if k.endswith("/w_int8"):
            n_int8 += 1
            assert got[k].dtype == torch.int8
            np.testing.assert_array_equal(got[k].numpy(), w.T)
        elif k.endswith("/w_scale"):
            np.testing.assert_array_equal(got[k].numpy(), w)
        elif k.endswith("/b") and got[k].dtype != torch.int8:
            assert got[k].dtype == torch.float32, k  # fp32 rows, fp32 vectors
    assert n_int8 == 6 * TINY_ARCH["depth"]


def _sample_both(jm, port_params, steps=4):
    """cfm_sample of both packages on the same inputs and noise, batch 1 (no
    duration mask: kernels 5, A, 6, 4) and batch 2 (a duration mask: kernel
    9 per projection, A, 4); (port, jax) mels over the valid rows."""
    rng = np.random.default_rng(5)
    out = []
    for durs in ([100], [100, 120]):
        b = len(durs)
        cond = rng.standard_normal((b, 30, 100)).astype(np.float32)
        text = np.full((b, 40), -1, np.int32)
        text[:, :20] = rng.integers(0, 200, (b, 20))
        y0 = rng.standard_normal((b, 128, 100)).astype(np.float32)
        kw = dict(steps=steps, cfg_strength=2.0, sway_sampling_coef=-1.0)
        want, _ = jcfm.cfm_sample(jm.params, jm.arch, cond, text, np.asarray(durs),
                                  y0=jnp.asarray(y0), **kw)
        got, _ = pcfm.cfm_sample(port_params, DiTConfig(**TINY_ARCH), cond, text,
                                 np.asarray(durs), y0=t(y0), duration_bucket=128, **kw)
        for i, n in enumerate(durs):
            out.append((got.numpy()[i, :n], np.asarray(want)[i, :n]))
    return out


def test_f5tts_quantize_matches_the_jax_load_model(tiny_files, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    d = tiny_files
    tts = papi.F5TTS(str(d / "tiny.yaml"), ckpt_file=str(d / "tiny.npz"), device="cpu",
                     quantize=True)
    jm, jflat = _jax_quantized(d)
    _assert_same_int8_weights(tts.ema_model.params, jflat)
    for got, want in _sample_both(jm, tts.ema_model.params):
        assert np.abs(got).max() > 0.1  # not gated off
        assert rel_err(got, want) < SAMPLE_REL
    wav, sr, spec = tts.infer(str(d / "ref.wav"), "A reference.", "A short sentence to say.",
                              nfe_step=2, seed=1, show_info=lambda m: None)
    assert sr == SR and np.isfinite(wav).all() and np.abs(wav).max() > 0
    plain = papi.F5TTS(str(d / "tiny.yaml"), ckpt_file=str(d / "tiny.npz"), device="cpu")
    assert "blocks/0/attn/to_q/w" in port_flatten(plain.ema_model.params)  # the default: no int8


def test_cli_quantize_matches_the_jax_load_model(tiny_files, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    d = tiny_files
    loaded = []
    real = pcli.load_model

    def spy(*args, **kwargs):
        loaded.append(real(*args, **kwargs))
        return loaded[-1]

    monkeypatch.setattr(pcli, "load_model", spy)
    pcli.main(["--model_cfg", str(d / "tiny.yaml"), "-p", str(d / "tiny.npz"), "-r",
               str(d / "ref.wav"), "-s", "A reference.", "-t", "A short sentence to say.",
               "-o", str(d), "-w", "cli_int8.wav", "--device", "cpu", "--nfe_step", "2",
               "--seed", "3", "--quantize"])
    (model,) = loaded
    jm, jflat = _jax_quantized(d)
    _assert_same_int8_weights(model.params, jflat)
    for got, want in _sample_both(jm, model.params):
        assert rel_err(got, want) < SAMPLE_REL
    sr, wav = wavfile.read(d / "cli_int8.wav")
    assert sr == SR and wav.dtype == np.int16 and np.abs(wav).max() > 0

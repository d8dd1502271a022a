"""Tensor-parallel serving of the port against the JAX package's, on the CPU.

The mirror of tests/test_tp_inference.py. The JAX side runs make_mesh +
shard_params on the 8 forced CPU devices of tests/conftest.py (a data x
model mesh of 1 x 2), its Pallas kernels in interpret mode under shard_map
(parallel/tp_kernels.py). The port side runs two gloo processes
(tests/_torch_parallel_worker.py), each with its share of the weights:
kernels B, 4, 7 / 5, A / 14, 8 / 6 per rank (their plain versions on the
CPU) and the all-reduce over the model group. The workers start once for
the module: the fixture runs every case and hands the results to the tests.

Both sides compute the same function at tp 2, int8 included: kernels 4 and 6
quantize each rank's own slice with its own amax under tensor parallelism,
in both packages, which is another function than one device's int8 path
(that difference is held to the JAX test's own bound against one device).
Tolerances: fp32 1e-5 relative L2 for a kernel, 1e-4 for a sampler run (the
sampler tests' REL); int8 2e-3 (a rounding tie can flip one product term,
tests/test_torch_quant.py's FLIP_REL); bf16 5e-2 (XLA on the CPU rounds bf16
at other points than PyTorch, over two CFG steps).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import redraw_zero_layers, rel_err, run_two_processes, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.dit import _rope_table as jax_rope_table
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.quant import quantize_linear, quantize_params
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.parallel import tp_kernels as jtp
from korean_f5_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from korean_f5_tts_tpu.parallel.mesh import param_partition_spec as jax_spec
from korean_f5_tts_tpu.parallel.mesh import shard_params as jax_shard_params
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.parallel.mesh import param_partition_spec
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree as pflatten
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

FP32_REL, SAMPLER_REL, INT8_REL, BF16_REL = 1e-5, 1e-4, 2e-3, 5e-2
ARCH = dict(dim=128, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=10, text_num_embeds=20,
            text_dim=16, conv_layers=1, pe_attn_head=1)
N, DUR = 128, 100
JAX_SWITCH = {"linear_fused": "F5_TTS_ATTN_LINEAR_FUSED"}


def _jax_interpret(env: dict | None = None):
    """The JAX package's kernels in interpret mode (test_tp_inference.py:
    interpret_kernels), with its env switches; returns an undo function."""
    import os

    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    env = {"F5_TTS_PALLAS_INTERPRET": "1", **(env or {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def undo():
        jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    return undo


def _port_linear(p: dict) -> dict:
    """A JAX-layout linear ({w [in, out]} or {w_int8 [in, out], ...}) in the port's layout."""
    return {k: (np.ascontiguousarray(np.asarray(v).T) if k in ("w", "w_int8")
                else np.asarray(v)) for k, v in p.items()}


def _model_flat(seed: int) -> dict:
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), JaxDiTConfig(**ARCH)))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)


def _sampler_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ar = np.arange(N)
    step_cond = np.where((ar < 40)[None, :, None],
                         rng.standard_normal((1, N, 10)), 0.0).astype(np.float32)
    y0 = np.where((ar < DUR)[None, :, None], rng.standard_normal((1, N, 10)), 0.0)
    text = np.full((1, 16), -1, np.int32)
    text[0, :9] = rng.integers(0, 19, 9)
    return {"step_cond": step_cond, "text": text, "mask": None,
            "pad_mask": (ar < DUR)[None, :], "y0": y0.astype(np.float32), "steps": 2}


def _jax_sampler(flat: dict, x: dict, dtype=jnp.float32, int8: bool = False,
                 attn_path: str = "default"):
    """JAX's sampler under the 1 x 2 mesh on the sharded weights."""
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v).astype(dtype)
                                    if np.asarray(v).dtype == np.float32 else jnp.asarray(v),
                                    unflatten_tree(flat))
    if int8:
        params = quantize_params(params)
    undo = _jax_interpret({JAX_SWITCH[attn_path]: "1"} if attn_path in JAX_SWITCH else None)
    try:
        mesh = jax_make_mesh(n_data=1, n_model=2)
        with mesh:
            mel = jcfm._sample_core(
                jax_shard_params(params, mesh), JaxDiTConfig(**ARCH),
                jnp.asarray(x["step_cond"]).astype(dtype), jnp.asarray(x["text"]), None,
                jnp.asarray(x["pad_mask"]), jnp.asarray(x["y0"]).astype(dtype), jnp.asarray(2.0),
                jnp.asarray(-1.0), steps=x["steps"], use_cfg=True, use_sway=True, use_epss=True)
            mel = np.asarray(jnp.asarray(mel).astype(jnp.float32))
    finally:
        undo()
    return mel, params


def _kernel_cases(rng) -> tuple[list, dict]:
    """The JAX side of every kernel-level case and the port's job for it."""
    cases, want = [], {}
    mesh = jax_make_mesh(n_data=1, n_model=2)
    undo = _jax_interpret()
    try:
        # ff half-block, fp32 and int8 (test_tp_inference.py:117-170)
        b, n, d, ff = 2, 128, 64, 128
        h = rng.standard_normal((b, n, d)).astype(np.float32)
        sc, sh, gate = (rng.standard_normal((d,)).astype(np.float32) * 0.1 for _ in range(3))
        lin = {k: {"w": rng.standard_normal(s).astype(np.float32) * 0.05,
                   "b": rng.standard_normal(s[1:]).astype(np.float32) * 0.05}
               for k, s in (("in", (d, ff)), ("out", (ff, d)))}
        row = lambda v: jnp.asarray(v)[None]  # noqa: E731
        with mesh:
            want["ff"] = jtp.ff_block_tp(jnp.asarray(h), row(sc), row(sh), row(gate),
                                         *(jnp.asarray(lin[k][x]) for k in ("in", "out")
                                           for x in ("w", "b")), mesh, bm=64)
        cases.append(("ff", "ff_block", dict(h=h, sc=sc, sh=sh, gate=gate, ff={
            k: _port_linear(v) for k, v in lin.items()})))
        q8 = {k: quantize_linear(v) for k, v in lin.items()}
        with mesh:
            want["ff_int8"] = jtp.ff_block_int8_tp(jnp.asarray(h), row(sc), row(sh), row(gate),
                                                   q8["in"], q8["out"], mesh, bm=64)
        want["ff_int8_one_device"] = jff.ff_block_fused_int8(
            jnp.asarray(h), row(sc), row(sh), row(gate), q8["in"], q8["out"], 128)
        cases.append(("ff_int8", "ff_block", dict(h=h, sc=sc, sh=sh, gate=gate, int8=True, ff={
            k: _port_linear(v) for k, v in q8.items()})))
        # fused attention half-block with pe_attn_head = 1 (:172-219, :292-343)
        b, n, dim, heads, dh = 2, 128, 128, 4, 64
        inner = heads * dh
        h = rng.standard_normal((b, n, dim)).astype(np.float32)
        sc, sh, gate = (rng.standard_normal((dim,)).astype(np.float32) * 0.1 for _ in range(3))
        ap = {k: {"w": rng.standard_normal((dim, inner)).astype(np.float32) * 0.05,
                  "b": rng.standard_normal((inner,)).astype(np.float32) * 0.02}
              for k in ("to_q", "to_k", "to_v")}
        ap["to_out"] = {"w": rng.standard_normal((inner, dim)).astype(np.float32) * 0.05,
                        "b": rng.standard_normal((dim,)).astype(np.float32) * 0.02}
        lens = np.array([96, 128], np.int32)
        cos, sin = jax_rope_table(n, dh)
        for name, weights in (("attn", ap), ("attn_int8", {k: quantize_linear(v)
                                                           for k, v in ap.items()})):
            jw = jax.tree_util.tree_map(jnp.asarray, weights)
            with mesh:
                want[name] = jtp.attn_half_block_tp(
                    jnp.asarray(h), row(sc), row(sh), row(gate), jw, heads,
                    (jnp.asarray(cos), jnp.asarray(sin)), 1, jnp.asarray(lens), False, mesh,
                    bq=128, bkv=128, bm=64)
            cases.append((name, "attn_half", dict(
                h=h, sc=sc, sh=sh, gate=gate, heads=heads, pe_attn_head=1, lens=lens,
                attn={k: _port_linear(v) for k, v in weights.items()})))
        # attention cores on the rank's heads (:92-116, :221-246)
        b, hh, n, d = 2, 8, 128, 64
        q, k, v = (rng.standard_normal((b, hh, n, d)).astype(np.float32) for _ in range(3))
        lens = np.array([100, 128], np.int32)
        jq = [jnp.asarray(x) for x in (q, k, v)]
        with mesh:
            want["flash"] = jtp.flash_prefix_tp(*jq, jnp.asarray(lens), 128, 128, True, mesh)
            want["flash_i8"] = jtp.flash_prefix_i8_tp(*jq, jnp.asarray(lens), 128, 512, False,
                                                      True, mesh)
        cases.append(("flash", "flash", dict(q=q, k=k, v=v, lens=lens)))
        cases.append(("flash_i8", "flash", dict(q=q, k=k, v=v, lens=lens, pv_i8=True)))
    finally:
        undo()
    return cases, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case, both sides: the JAX results, the two ranks' results, and
    the port's one-process sampler runs."""
    rng = np.random.default_rng(0)
    cases, want = _kernel_cases(rng)
    flat = _model_flat(3)
    x = _sampler_inputs(4)
    sampler_runs = {"fp32": {}, "linear_fused": dict(attn_path="linear_fused"),
                    "bf16": dict(dtype="bf16"), "int8": dict(int8=True),
                    "int8_attn_qkpv": dict(attn_int8="qkpv")}
    one_device = {}
    for name, kw in sampler_runs.items():
        jdt = jnp.bfloat16 if kw.get("dtype") == "bf16" else jnp.float32
        if name != "int8_attn_qkpv":
            want[f"sampler_{name}"], jparams = _jax_sampler(
                flat, x, jdt, kw.get("int8", False), kw.get("attn_path", "default"))
        else:
            jparams = unflatten_tree(flat)
        pflat = {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
                 if jnp.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
                 for k, v in flatten_tree(jparams).items()}
        job = dict(flat=pflat, arch=ARCH, inputs=x, dtype=kw.get("dtype", "fp32"),
                   attn_path=kw.get("attn_path", "default"), attn_int8=kw.get("attn_int8"))
        cases.append((f"sampler_{name}", "sampler", job))
        p = params_from_jax(pflat, device="cpu")
        td = torch.float32
        if kw.get("dtype") == "bf16":
            p, td = cast_params(p, torch.bfloat16), torch.bfloat16
        one_device[name] = pcfm._sample_core(
            p, DiTConfig(**ARCH), t(x["step_cond"]).to(td), t(x["text"]), None,
            t(x["pad_mask"]), t(x["y0"]).to(td), 2.0, -1.0, steps=x["steps"], use_cfg=True,
            use_sway=True, use_epss=True, attn_path=job["attn_path"],
            attn_int8=job["attn_int8"]).float().numpy()
    ranks = run_two_processes(str(tmp_path_factory.mktemp("tp")), cases)
    return {"want": want, "ranks": ranks, "one_device": one_device}


def _both(run, name):
    """Rank 0's result, after checking rank 1 holds the same (replicated)."""
    r0, r1 = run["ranks"][0][name], run["ranks"][1][name]
    np.testing.assert_array_equal(r0, r1)
    return r0


def test_partition_specs_mirror_the_jax_rules():
    """param_partition_spec on the port's [out, in] layouts is JAX's on
    [in, out]: the same leaves split, along the transposed dim."""
    flat = _model_flat(0)
    flat.update({f"blocks/0/attn/to_q/{k}": v for k, v in
                 quantize_linear({"w": flat["blocks/0/attn/to_q/w"],
                                  "b": flat["blocks/0/attn/to_q/b"]}).items()})
    port = pflatten(params_from_jax(flat, device="cpu"))
    split = 0
    for k, v in flat.items():
        js = tuple(jax_spec(tuple(jax.tree_util.DictKey(p) for p in k.split("/")), np.asarray(v)))
        ps = param_partition_spec(k, port[k])
        want = tuple(reversed(js)) if len(js) == 2 else js
        assert ps == want, (k, js, ps)
        split += "model" in ps
    # a block's q, k, v (w, b), out w, ff in (w, b), ff out w; block 0's int8 q twice more
    assert split == ARCH["depth"] * 10 + 2


def test_ff_block_tp_matches_jax(run):
    assert rel_err(_both(run, "ff"), run["want"]["ff"]) < FP32_REL


def test_ff_block_int8_tp_matches_jax(run):
    got = _both(run, "ff_int8")
    assert rel_err(got, run["want"]["ff_int8"]) < INT8_REL
    # per-rank second quantization: a different function from one device's (JAX's bound)
    one = run["want"]["ff_int8_one_device"]
    assert np.abs(got - one).max() < 5e-3 * (np.abs(one).mean() + 1e-9)


@pytest.mark.parametrize("name", ["attn", "attn_int8"])
def test_attn_half_block_tp_with_pe_attn_head_1_matches_jax(run, name):
    bound = FP32_REL if name == "attn" else INT8_REL
    assert rel_err(_both(run, name), run["want"][name]) < bound


@pytest.mark.parametrize("name", ["flash", "flash_i8"])
def test_flash_prefix_tp_matches_jax(run, name):
    """Each rank's heads; the two ranks together are JAX's output. Rows past
    a head's prefix hold the masked softmax's leftovers: compared too, both
    packages give them the same function."""
    got = np.concatenate([run["ranks"][r][name] for r in (0, 1)], axis=1)
    assert rel_err(got, run["want"][name]) < (FP32_REL if name == "flash" else INT8_REL)


@pytest.mark.parametrize("name", ["fp32", "linear_fused", "bf16", "int8"])
def test_tp_sampler_matches_jax(run, name):
    """Two CFG steps of the sampler at tp 2 (kernels B, A per rank; 7, A, 8 on
    linear_fused; 5, A, 6 and 4 with int8 weights) against JAX's at tp 2, and
    against one process of the port."""
    got = _both(run, f"sampler_{name}")
    want = run["want"][f"sampler_{name}"]
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    bound = {"fp32": SAMPLER_REL, "linear_fused": SAMPLER_REL, "bf16": BF16_REL,
             "int8": INT8_REL}[name]
    assert rel_err(got, want) < bound
    one = run["one_device"][name]
    if name == "int8":  # per-rank quantization: JAX's bound against one device
        d = np.abs(got - one)
        assert d.mean() < 5e-3 * np.abs(one).mean() and d.max() < 5e-2 * np.abs(one).mean()
    else:
        assert rel_err(got, one) < bound


def test_tp_sampler_with_int8_attention(run):
    """attn_int8="qkpv" under tp 2: kernel 14 and its pass on each rank's
    heads (flash_prefix_i8_tp), which equals one device's kernel 14 on those
    heads; the rest of the step is the fp32 path."""
    got = _both(run, "sampler_int8_attn_qkpv")
    assert rel_err(got, run["one_device"]["int8_attn_qkpv"]) < SAMPLER_REL
    assert 1e-5 < rel_err(got, run["one_device"]["fp32"]) < 0.2  # the int8 branch ran

"""fp32 models on the opt-in attention paths, and the split 3xTF32 products
of the fp32 forms of kernels 11-13, on the CPU.

The fp32 forms of kernels 7, 8, 18, 19, 14 and its quantization pass run on
the card only (tests/test_torch_cuda.py, chip_smoke.py phases 2 and 8 hold
them to these plain versions). Here:

- one CFG step of a tiny fp32 DiT (dim 64, depth 2, one head of 64) under
  each attn_path and under attn_int8 "qk" and "qkpv" (alone, after
  "linear_fused", and over int8 block linears) against the JAX package with
  the matching switch (F5_TTS_ATTN_LINEAR_FUSED, F5_TTS_ROPE_IN_KERNEL,
  F5_TTS_QKV_KERNEL, F5_TTS_INT8_ATTN at its default key chunk, the port's
  I8_KEY_CHUNK; Pallas in interpret mode). Tolerances (relative L2 over the
  valid rows): 1e-4 for every fp32 path and for "qk" (fp32 throughout; sums
  in another order; 6e-7 to 3e-6 read), 2e-3 for "qkpv" (exp2 of the two
  frameworks can flip a p8 = rint(127 p) at a tie, one 1/127 step of one
  term; 4e-6 read), 4e-3 over int8 block linears (their own rounding ties,
  tests/test_torch_attn_int8.py's bound; 1.1e-4 and 1.6e-4 read);
- kernel 14's plain version on fp32 in "qk" mode against the JAX
  flash_prefix_attention_i8(pv_i8=False) in interpret mode, both at their
  default key chunk (512; n 384 and 640): fp32 out, p kept fp32 before p.v on both sides. Heads
  whose score scale c agrees with the JAX one to the bit are held to 2e-6
  relative (fp32 sums in another order), the others to 1e-4 (a scale an ulp
  apart moves every score of the head by that ulp);
- a numpy emulation of cvt.rna.tf32 and of the split product at a small
  attention shape: the three-product split holds rel <= 1e-5 against fp64
  for S = q.K^T, dP, dq = dS.K and dK = dS^T.q, while one TF32 product does
  not (rel > 1e-4: the bound the card's checks hold the fp32 forms to can
  see a TF32 product);
- a mirror of the kernels' fragment arithmetic (csrc/mma.cuh,
  csrc/attn_tf32.cuh; tests/_tf32_mirror.py): mma.sync m16n8k8 .tf32 and
  ldmatrix on 32-bit words as the PTX ISA lays them out, the A and B fragment addresses
  of lda_tf32 / ldb2_tf32, the accumulator reused as the next product's A
  fragment with its columns taken in the order 2t, 2t + 1 (mm_acc), and the
  float2 stores of the epilogue, against plain matrix products;
- the slot order of v8 that the attention core's int8 P.V takes (csrc/
  attn_wgmma.cuh's header, which kernel 14's "qkpv" runs on fp32 inputs
  too), inverted slot by slot, against _v8_kernel_layout.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _tf32_mirror import (
    from_acc,
    mm_3xtf32,
    mm_acc,
    mm_rows,
    split_tf32,
    tf32_rna,
)
from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import quant as pquant
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.attention import ATTN_PATHS
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY = dict(dim=64, depth=2, heads=1, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
            text_num_embeds=50)
JAX_SWITCH = {"linear_fused": "F5_TTS_ATTN_LINEAR_FUSED", "rope_in_kernel": "F5_TTS_ROPE_IN_KERNEL",
              "qkv_kernel": "F5_TTS_QKV_KERNEL"}
JAX_INT8 = {"qk": "qk", "qkpv": "1"}
STEP_REL = {None: 1e-4, "qk": 1e-4, "qkpv": 2e-3, "int8 weights": 4e-3}


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


def _rng(seed):
    return np.random.default_rng(seed)


# --- one CFG step of an fp32 model per attention path ----------------------------


@functools.lru_cache(maxsize=1)
def _tiny():
    jcfg, pcfg = JaxDiTConfig(**TINY), DiTConfig(**TINY)
    flat = flatten_tree(jdit.init_dit(jax.random.PRNGKey(3), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 11)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu")


@functools.lru_cache(maxsize=1)
def _tiny_int8():
    jcfg, pcfg, jp, pp = _tiny()
    return jcfg, pcfg, jquant.quantize_params(jp), pquant.quantize_params(pp)


def _step_inputs(n=256):
    rng = _rng(20)
    dur = 230
    pad_mask = (np.arange(n) < dur)[None, :]
    y0 = np.where(pad_mask[..., None], rng.standard_normal((1, n, 100)), 0).astype(np.float32)
    cond = np.where(np.arange(n)[None, :, None] < 40, rng.standard_normal((1, n, 100)),
                    0).astype(np.float32)
    text = rng.integers(0, 49, (1, 40)).astype(np.int32)
    return n, dur, pad_mask, y0, cond, text


def _jax_step(jcfg, jp):
    n, dur, pad_mask, y0, cond, text = _step_inputs()
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=dr,
                              pad_mask=jnp.asarray(pad_mask)) for dr in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray([0.4], jnp.float32))
    out = jdit.dit_forward_cfg_premod(jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te, mods[0],
                                      mod_final[0], 2.0, pad_mask=jnp.asarray(pad_mask))
    return np.asarray(out)[0, :dur]


def _port_step(pcfg, pp, attn_path, attn_int8):
    n, dur, pad_mask, y0, cond, text = _step_inputs()
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(text), n, drop_text=dr,
                              pad_mask=t(pad_mask)) for dr in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, torch.tensor([0.4]))
    with torch.inference_mode():
        out = pdit.dit_forward_cfg_premod(pp, pcfg, t(y0), t(cond), *tp, pmods[0], pfinal[0], 2.0,
                                          pad_mask=t(pad_mask), attn_path=attn_path,
                                          attn_int8=attn_int8)
    assert out.dtype == torch.float32
    return out.numpy()[0, :dur]


CASES = [(path, None, "fp32") for path in ATTN_PATHS] + [
    ("default", "qk", "fp32"), ("default", "qkpv", "fp32"), ("linear_fused", "qk", "fp32"),
    ("linear_fused", "qkpv", "fp32"), ("default", "qk", "int8"), ("default", "qkpv", "int8")]


@pytest.mark.parametrize("attn_path,attn_int8,weights", CASES)
def test_fp32_cfg_step_matches_jax(attn_path, attn_int8, weights, monkeypatch):
    monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
    if attn_path != "default":
        monkeypatch.setenv(JAX_SWITCH[attn_path], "1")
    if attn_int8 is not None:
        monkeypatch.setenv("F5_TTS_INT8_ATTN", JAX_INT8[attn_int8])
        monkeypatch.delenv("F5_TTS_PREFIX_BKV", raising=False)
    jcfg, pcfg, jp, pp = _tiny() if weights == "fp32" else _tiny_int8()
    want = _jax_step(jcfg, jp)
    got = _port_step(pcfg, pp, attn_path, attn_int8)
    assert np.abs(got).max() > 0.1  # not gated off
    assert rel_err(got, want) < STEP_REL["int8 weights" if weights == "int8" else attn_int8]


def test_attn_int8_on_fp32_is_the_quantized_function():
    """"qk" keeps p in fp32 on fp32 v and differs from the unquantized step
    by the quantization of q.k^T alone, less than "qkpv" does."""
    _, pcfg, _, pp = _tiny()
    base = _port_step(pcfg, pp, "default", None)
    qk, qkpv = (rel_err(_port_step(pcfg, pp, "default", m), base) for m in ("qk", "qkpv"))
    assert 1e-5 < qk < qkpv < 0.2


# --- kernel 14's plain version on fp32, "qk" mode ------------------------------------


@pytest.mark.parametrize("lens", [[384, 200], [1, 129], [640, 600]])
def test_i8_qk_plain_on_fp32_keeps_p_fp32(lens):
    rng = _rng(21)
    b, h, n, d = 2, 2, max(384, *lens), 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * s for s in (1.5, 1.2, 0.8))
    chunk = flash_prefix.I8_KEY_CHUNK
    want = np.asarray(jfp.flash_prefix_attention_i8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens, jnp.int32), bq=128,
        pv_i8=False))
    assert want.dtype == np.float32
    lens_h = flash_prefix._fold_lens(torch.tensor(lens), b, h, "cpu")
    got = flash_prefix.flash_prefix_i8_reference(t(q), t(k), t(v), lens_h, pv_i8=False)
    assert got.dtype == torch.float32
    got = got.reshape(b, h, n, d).numpy()
    # the JAX pass's score scale per head, against the port's
    _, aq = jfp._quant_head(jnp.asarray(q).reshape(b * h, n, d))
    _, ak = jfp._quant_head(jnp.asarray(k).reshape(b * h, n, d))
    c_jax = np.asarray(aq * ak * ((1.0 / 127.0 ** 2) * jfp.LOG2E / np.sqrt(d)))
    c_port = flash_prefix._quantize_qkv(t(q), t(k), t(v), False)[3].numpy()
    same = (c_jax == c_port).reshape(b, h)
    assert same.any()
    for i in range(b):
        for j in range(h):
            L = lens[i]
            e = rel_err(got[i, j, :L], want[i, j, :L])
            assert e < (2e-6 if same[i, j] else 1e-4), (i, j, e)
    # p rounded to bf16 before p.v (the bf16 form's product) is another
    # function on these values, and the bound above tells the two apart
    q8, k8, _, c, sv = flash_prefix._quantize_qkv(t(q), t(k), t(v), False)
    vb = t(v).to(torch.bfloat16).float().reshape(b * h, n, d)
    pb = flash_prefix._i8_attention_plain(q8, k8, vb.to(torch.bfloat16), c, sv, lens_h, False,
                                          chunk)
    pf = flash_prefix._i8_attention_plain(q8, k8, vb, c, sv, lens_h, False, chunk)
    i = int(np.argmax(lens))  # (one valid key gives p = 1, which bf16 holds exactly)
    L = lens[i]
    assert rel_err(pb.reshape(b, h, n, d).numpy()[i, :, :L],
                   pf.reshape(b, h, n, d).numpy()[i, :, :L]) > 1e-4


def test_folded_i8_keeps_the_dtype_of_v():
    rng = _rng(22)
    q, k, v = (t(rng.standard_normal((2, 100, 64)).astype(np.float32)) for _ in range(3))
    lens = torch.tensor([100, 33], dtype=torch.int32)
    q8, k8, vq, c, sv = flash_prefix._quantize_qkv(q, k, v, False)
    out = flash_prefix.flash_prefix_folded_i8(q8, k8, vq, c, sv, lens, pv_i8=False)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, flash_prefix.flash_prefix_i8_reference(q, k, v, lens,
                                                                          pv_i8=False),
                               rtol=0, atol=0)
    q8, k8, v8, c, sv = flash_prefix._quantize_qkv(q, k, v, True)
    vk = flash_prefix._v8_kernel_layout(v8)
    out = flash_prefix.flash_prefix_folded_i8(q8, k8, vk, c, sv, lens, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, flash_prefix.flash_prefix_i8_reference(q, k, v, lens),
                               rtol=0, atol=0)
    assert flash_prefix.flash_prefix_folded_i8(q8, k8, vk, c, sv, lens).dtype == torch.bfloat16


# --- 3xTF32: a numpy emulation (tests/_tf32_mirror.py) ----------------------------


def test_tf32_rounding():
    x = np.float32(1.0) + np.float32(2.0 ** -11)  # exactly half a tf32 ulp above 1: away
    assert tf32_rna(x) == np.float32(1.0 + 2.0 ** -10)
    assert tf32_rna(-x) == np.float32(-(1.0 + 2.0 ** -10))
    y = np.float32(1.0) + np.float32(2.0 ** -12)
    assert tf32_rna(y) == np.float32(1.0)
    rng = _rng(23)
    v = rng.standard_normal(10000).astype(np.float32)
    hi, lo = split_tf32(v)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0) and np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    assert np.abs(hi.astype(np.float64) - v).max() <= 2.0 ** -11 * np.abs(v).max()
    # hi + lo holds v to ~22 bits
    assert np.abs((hi.astype(np.float64) + lo) - v).max() <= 2.0 ** -21 * np.abs(v).max()


def test_3xtf32_holds_fp32_accuracy_where_one_tf32_product_does_not():
    """The products of kernels 11 and 13 at n 100, kv_len 77: S = q.K^T, dP =
    dO.V^T, dq = dS.K and dK = dS^T.q, each against fp64."""
    rng = _rng(24)
    n, d, kv = 100, 64, 77
    q, k, v, do = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(4))
    scale_log2 = np.float32(np.log2(np.e) / 8.0)
    s64 = q.astype(np.float64) @ k.astype(np.float64).T
    s64[:, kv:] = -np.inf
    lse = np.log2(np.exp2(s64 * scale_log2).sum(1, keepdims=True))
    p = np.exp2(s64 * scale_log2 - lse).astype(np.float32)
    dp64 = do.astype(np.float64) @ v.astype(np.float64).T
    o = p.astype(np.float64) @ v
    dvec = (do.astype(np.float64) * o).sum(1, keepdims=True)
    ds = (p * (dp64 - dvec)).astype(np.float32)
    products = {"S": (q, k.T), "dP": (do, v.T), "dq": (ds, k), "dK": (ds.T, q)}
    for name, (a, b) in products.items():
        exact = a.astype(np.float64) @ b.astype(np.float64)
        three = rel_err(mm_3xtf32(a, b), exact)
        one = rel_err(tf32_rna(a) @ tf32_rna(b), exact)
        assert three <= 1e-5, (name, three)
        assert one > 1e-4, (name, one)


# --- the kernels' fragment arithmetic, mirrored (tests/_tf32_mirror.py) -------------


def test_fragment_arithmetic_of_the_3xtf32_kernels():
    rng = _rng(25)
    q = rng.integers(-8, 9, (128, 64)).astype(np.float64)   # integers: every sum exact
    k = rng.integers(-8, 9, (64, 64)).astype(np.float64)
    for warp in (0, 3, 7):
        s = mm_rows(q, k, warp * 16)                         # S of the warp's 16 rows
        want = q[warp * 16:warp * 16 + 16] @ k.T
        np.testing.assert_array_equal(from_acc(s), want)
        dq = mm_acc(s, k)                                    # the accumulator as next A
        np.testing.assert_array_equal(from_acc(dq), want @ k)


def test_v8_key_inverts_the_kernel_layout():
    """attn_wgmma.cuh stores key 16h + 8j + 2t + e of each group of 32 at slot
    16h + 4t + 2j + e; v8_key inverts that, and _v8_kernel_layout[:, :, s] is
    key v8_key(s) of every 128-key chunk."""
    def v8_key(s):
        return (s & ~15) | (((s >> 1) & 1) << 3) | (((s >> 2) & 3) << 1) | (s & 1)

    rng = _rng(26)
    n = 256
    v8 = t(rng.integers(-127, 128, (2, n, 64)).astype(np.int8))
    vk = flash_prefix._v8_kernel_layout(v8)
    slots = np.arange(n)
    keys = (slots // 128) * 128 + v8_key(slots % 128)
    assert sorted(keys.tolist()) == list(range(n))
    torch.testing.assert_close(vk.permute(0, 2, 1), v8[:, keys], rtol=0, atol=0)

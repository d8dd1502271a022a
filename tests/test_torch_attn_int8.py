"""int8 attention (kernel 14) of the port against the JAX package, on the CPU.

Kernel level: the port's quantizer equals the JAX _quant_head bit for bit;
the plain version, repeated at the JAX call's key chunk (ck == bkv), is held
to the Pallas kernel in interpret mode for both modes ("qkpv": int8 q.k^T and
p.v; "qk": int8 q.k^T only), both `prune` values and [b] and [1] lens.

Tolerances. "qkpv": the integer products are exact on both sides; exp2 of the
two frameworks differs by an ulp, which can flip a p8 = rint(127 p) at a tie
(one 1/127 step of one term) and the last bf16 rounding: at most 1 bf16 ulp
of the output's scale on a few elements, relative L2 1e-4. "qk": the port
rounds p to bf16 before p.v (Hopper has no fp32 tensor-core product; the JAX
kernel multiplies fp32 p by fp32 v), one relative 2^-9 per term: relative L2
2e-3, at most 2 bf16 ulps of the scale. The trap of `127.0 / tensor`
(Tensor.__rtruediv__ is a reciprocal multiply) changes nothing on the CPU,
where both forms divide; it shows on the card only, where chip_smoke.py holds
the kernel to the plain version and tests/test_torch_cuda.py the quantizer.

Model level: sdpa, attention, one CFG step and the sampler with attn_int8
against the JAX functions under F5_TTS_INT8_ATTN with the kernels forced to
interpret mode (F5_TTS_PALLAS_INTERPRET), each side at its default key chunk
(the JAX F5_TTS_PREFIX_BKV unset: 512; the port's I8_KEY_CHUNK), with fp32
and with int8 block linears; sdpa also at n 640, two chunks.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import modules as jmod
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.ops import attention as jattn
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import modules as pmod
from korean_f5_tts_tpu_torch.models import quant as pquant
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import attention as pattn
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
            text_num_embeds=50)
JAX_MODE = {"qk": "qk", "qkpv": "1"}


@pytest.fixture(autouse=True)
def _interpret():
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(x):
    return jnp.asarray(x).astype(jnp.bfloat16), t(x).to(torch.bfloat16)


# --- the quantizer ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_quant_head_equals_jax_bit_for_bit(dtype):
    rng = _rng(0)
    x = rng.standard_normal((6, 96, 64)).astype(np.float32) * rng.uniform(0.01, 30, (6, 1, 1))
    x[1] = 0.0            # the amax floor
    x[2, 3, 5] = 1e4      # one outlier takes the whole range
    x = x.astype(np.float32)
    jx, px = (jnp.asarray(x), t(x)) if dtype == "fp32" else _bf16_pair(x)
    j8, ja = jfp._quant_head(jx)
    p8, pa = flash_prefix._quant_head(px)
    assert p8.dtype == torch.int8 and pa.dtype == torch.float32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(p8.numpy(), np.asarray(j8))
    assert np.abs(p8.numpy()).max() == 127 and pa[1].item() == np.float32(1e-8)


def test_quant_scales_follow_the_jax_order_of_multiplication():
    rng = _rng(1)
    q, k, v = (rng.standard_normal((4, 64, 64)).astype(np.float32) * s for s in (3.0, 0.7, 11.0))
    _, aq = jfp._quant_head(jnp.asarray(q))
    _, ak = jfp._quant_head(jnp.asarray(k))
    _, av = jfp._quant_head(jnp.asarray(v))
    c = aq * ak * ((1.0 / 127.0 ** 2) * jfp.LOG2E / np.sqrt(64))
    sv = av * (1.0 / (127.0 * 127.0))
    _, _, v8, pc, psv = flash_prefix._quantize_qkv(t(q), t(k), t(v), True)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(psv.numpy(), np.asarray(sv))
    assert v8.dtype == torch.int8
    _, _, vv, _, zero = flash_prefix._quantize_qkv(t(q), t(k), t(v), False)
    assert vv.dtype == torch.float32 and zero.abs().max().item() == 0


@pytest.mark.parametrize("n", [64, 100, 300])
def test_v8_kernel_layout_is_the_documented_permutation(n):
    rng = _rng(2)
    v8 = t(rng.integers(-127, 128, (3, n, 64)).astype(np.int8))
    vk = flash_prefix._v8_kernel_layout(v8)
    tile = flash_prefix.I8_KEY_TILE  # n is padded to the kernel's key tile
    n_pad = -(-n // tile) * tile
    assert vk.shape == (3, 64, n_pad) and vk.is_contiguous()
    torch.testing.assert_close(flash_prefix._v8_natural_layout(vk, n), v8, rtol=0, atol=0)
    assert flash_prefix._v8_natural_layout(vk, n_pad)[:, n:].abs().sum().item() == 0  # zero pad
    # key 32b + 16h + 8j + 2t + e lies at slot 32b + 16h + 4t + 2j + e
    for key in (0, 1, 2, 9, 17, 31, 33, 63):
        b, r = divmod(key, 32)
        h, r = divmod(r, 16)
        j, r = divmod(r, 8)
        tt, e = divmod(r, 2)
        slot = 32 * b + 16 * h + 4 * tt + 2 * j + e
        torch.testing.assert_close(vk[:, :, slot], v8[:, key, :], rtol=0, atol=0)


# --- the attention against the Pallas kernel in interpret mode -------------------


def _valid_rows(x, lens):
    return np.concatenate([x[i, :, :L].reshape(-1) for i, L in enumerate(lens)])


@pytest.mark.parametrize("lens", [[200, 384], [384], [1, 129]])
@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_attention_i8_plain_vs_pallas(mode, prune, lens):
    rng = _rng(3)
    b, h, n, d = 2, 2, 384, 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * s for s in (1.5, 1.2, 0.8))
    (jq, pq), (jk, pk), (jv, pv) = (_bf16_pair(x) for x in (q, k, v))
    want = _f32(jfp.flash_prefix_attention_i8(jq, jk, jv, jnp.asarray(lens, jnp.int32), bq=128,
                                              bkv=128, prune=prune, pv_i8=mode == "qkpv"))
    lens_h = flash_prefix._fold_lens(torch.tensor(lens), b, h, pq.device)
    got = flash_prefix.flash_prefix_i8_reference(pq, pk, pv, lens_h, pv_i8=mode == "qkpv",
                                                 ck=128).reshape(b, h, n, d)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, d)
    got = got.float().numpy()
    full = lens * b if len(lens) == 1 else lens
    ulp = 2.0 ** -8 * max(1.0, np.abs(want).max())  # one bf16 ulp at the output's scale
    diff = np.abs(got - want)
    if mode == "qkpv":
        assert diff.max() <= ulp, diff.max()
        assert rel_err(_valid_rows(got, full), _valid_rows(want, full)) < 1e-4
    else:
        assert diff.max() <= 2 * ulp, diff.max()
        assert rel_err(_valid_rows(got, full), _valid_rows(want, full)) < 2e-3
    # the wrapper on CPU tensors, and with kernels=False, is the plain version
    # at the kernel's own key chunk
    chunk = flash_prefix.flash_prefix_i8_reference(pq, pk, pv, lens_h, pv_i8=mode == "qkpv",
                                                   ck=flash_prefix.I8_KEY_CHUNK)
    for kernels in (True, False):
        same = flash_prefix.flash_prefix_attention_i8(pq, pk, pv, torch.tensor(lens),
                                                      pv_i8=mode == "qkpv", kernels=kernels)
        assert torch.equal(same, chunk.reshape(b, h, n, d))


def test_the_key_chunk_is_part_of_the_arithmetic():
    """p8 sees the running max of the chunks visited so far: another chunk
    size gives other p8 values, so the plain version takes ck; its default
    is the JAX default bkv, 512 (n 640: two chunks, the last partial)."""
    rng = _rng(4)
    q, k, v = (t(rng.standard_normal((2, 640, 64)).astype(np.float32) * 1.5).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([640, 600])
    a = flash_prefix.flash_prefix_i8_reference(q, k, v, lens, ck=512).float()
    for other in (128, 256):
        b = flash_prefix.flash_prefix_i8_reference(q, k, v, lens, ck=other).float()
        assert not torch.equal(a, b)
        assert rel_err(a.numpy(), b.numpy()) < 5e-2
    default = flash_prefix.flash_prefix_i8_reference(q, k, v, lens).float()
    assert flash_prefix.I8_KEY_CHUNK == 512 and torch.equal(default, a)


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_quantization_error_within_the_jax_tests_bounds(mode):
    """The error of the int8 attention itself, against the unquantized plain
    attention: the bounds of the JAX package's own test of its kernel."""
    rng = _rng(111)
    b, h, n, d = 2, 2, 256, 64
    q, k, v = (t(rng.standard_normal((b, h, n, d)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    lens = [150, 256]
    got = flash_prefix.flash_prefix_attention_i8(q, k, v, torch.tensor(lens),
                                                 pv_i8=mode == "qkpv").float()
    want = flash_prefix.flash_prefix_attention(q, k, v, torch.tensor(lens)).float()
    for i, L in enumerate(lens):
        err = (got[i, :, :L] - want[i, :, :L]).abs()
        assert err.max().item() < 0.03 and err.mean().item() < 0.005


def test_a_head_without_valid_keys_gives_zeros():
    rng = _rng(5)
    q = t(rng.standard_normal((2, 1, 128, 64)).astype(np.float32))
    out = flash_prefix.flash_prefix_attention_i8(q, q, q, torch.tensor([0, 5]))
    assert out[0].abs().max().item() == 0 and out[1].abs().max().item() > 0


def test_folded_wrapper_takes_the_kernel_layout_on_the_cpu():
    rng = _rng(6)
    q, k, v = (t(rng.standard_normal((3, 100, 64)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([100, 7, 64], dtype=torch.int32)
    q8, k8, v8, c, sv = flash_prefix._quantize_qkv(q, k, v, True)
    got = flash_prefix.flash_prefix_folded_i8(q8, k8, flash_prefix._v8_kernel_layout(v8), c, sv,
                                              lens)
    want = flash_prefix.flash_prefix_i8_reference(q, k, v, lens)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- dispatch, validation --------------------------------------------------------


def test_check_attn_int8():
    assert pattn.ATTN_INT8 == (None, "qk", "qkpv")
    assert pattn.check_attn_int8(None, "qkv_kernel") is None
    assert pattn.check_attn_int8("qk") == "qk"
    assert pattn.check_attn_int8("qkpv", "linear_fused") == "qkpv"
    with pytest.raises(ValueError, match="attn_int8"):
        pattn.check_attn_int8("1")
    for path in ("rope_in_kernel", "qkv_kernel"):
        with pytest.raises(ValueError, match="attn_path"):
            pattn.check_attn_int8("qkpv", path)
    with pytest.raises(ValueError, match="attn_path"):
        pattn.check_attn_int8("qk", "fastest")


def test_attn_int8_raises_on_inputs_that_require_a_gradient():
    rng = _rng(7)
    q = t(rng.standard_normal((1, 2, 64, 64)).astype(np.float32))
    g = q.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        pattn.sdpa(q, g, q, attn_int8="qk")
    with torch.no_grad():
        assert torch.isfinite(pattn.sdpa(q, g, q, attn_int8="qk")).all()
    with pytest.raises(ValueError, match="attn_int8"):
        pattn.sdpa(q, q, q, attn_int8="int8")


def test_cfm_loss_refuses_attn_int8():
    _, pcfg, _, pp = _tiny()
    mel = torch.zeros((1, 64, 100))
    with pytest.raises(ValueError, match="inference only"):
        pcfm.cfm_loss(pp, pcfg, mel, torch.zeros((1, 8), dtype=torch.int64),
                      torch.tensor([64]), seed=0, attn_int8="qkpv")


# --- sdpa, attention, one CFG step and the sampler under the JAX switch ----------


@pytest.fixture
def jax_int8(monkeypatch):
    """The JAX dispatch reads its switches from the environment; both sides
    keep their default key chunk (no F5_TTS_PREFIX_BKV)."""
    def set_mode(mode):
        monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
        monkeypatch.delenv("F5_TTS_PREFIX_BKV", raising=False)
        monkeypatch.setenv("F5_TTS_INT8_ATTN", JAX_MODE[mode])
    return set_mode


# relative L2 of a model-level comparison in fp32: "qkpv" repeats the JAX
# arithmetic (a few p8 ties per call); "qk" keeps p in fp32 on fp32 v, as
# JAX does (the bound dates from when the port rounded p to bf16 there, 2^-9
# per term; tests/test_torch_fp32_attn_paths.py holds fp32 "qk" to 1e-4)
MODEL_REL = {"qkpv": 2e-3, "qk": 5e-3}


@pytest.mark.parametrize("prefix", [None, [200, 256]])
@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_sdpa_matches_jax_under_the_switch(mode, prefix, jax_int8):
    _sdpa_against_jax(mode, prefix, 256, jax_int8)


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_sdpa_matches_jax_over_several_chunks(mode, jax_int8):
    """n 640: two 512-key chunks on both sides, the last partial, one item's
    prefix inside it and one on the chunk boundary."""
    _sdpa_against_jax(mode, [600, 512], 640, jax_int8)


def _sdpa_against_jax(mode, prefix, n, jax_int8):
    jax_int8(mode)
    rng = _rng(8)
    b, h, d = 2, 2, 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    jl = None if prefix is None else jnp.asarray(prefix, jnp.int32)
    jmask = None if prefix is None else jnp.arange(n)[None, :] < jl[:, None]
    want = _f32(jattn.sdpa(*(jnp.asarray(x) for x in (q, k, v)), mask=jmask, prefix_lens=jl))
    got = pattn.sdpa(t(q), t(k), t(v), prefix_lens=None if prefix is None else torch.tensor(prefix),
                     attn_int8=mode).numpy()
    lens = prefix or [n, n]
    assert rel_err(_valid_rows(got, lens), _valid_rows(want, lens)) < MODEL_REL[mode]
    plain = pattn.sdpa(t(q), t(k), t(v),
                       prefix_lens=None if prefix is None else torch.tensor(prefix)).numpy()
    err = rel_err(_valid_rows(got, lens), _valid_rows(plain, lens))
    assert 1e-4 < err < 0.2  # it is the quantized attention, not kernel A's function


@functools.lru_cache(maxsize=1)
def _tiny():
    jcfg, pcfg = JaxDiTConfig(**TINY), DiTConfig(**TINY)
    flat = flatten_tree(jdit.init_dit(jax.random.PRNGKey(0), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 7)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu")


@functools.lru_cache(maxsize=1)
def _tiny_int8():
    jcfg, pcfg, jp, pp = _tiny()
    return jcfg, pcfg, jquant.quantize_params(jp), pquant.quantize_params(pp)


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_attention_module_matches_jax_under_the_switch(mode, jax_int8):
    jax_int8(mode)
    jcfg, pcfg, jp, pp = _tiny()
    rng = _rng(9)
    n = 256
    x = rng.standard_normal((2, n, 128)).astype(np.float32)
    lens = [256, 180]
    mask = np.arange(n)[None, :] < np.asarray(lens)[:, None]
    cos, sin = jmod.rope_cos_sin(n, 64)
    want = np.asarray(jmod.attention(jp["blocks"][0]["attn"], jnp.asarray(x), jcfg.heads,
                                     mask=jnp.asarray(mask), rope=(jnp.asarray(cos),
                                                                   jnp.asarray(sin))))
    got = pmod.attention(pp["blocks"][0]["attn"], t(x), pcfg.heads, mask=t(mask),
                         rope=(t(cos), t(sin)), attn_int8=mode).numpy()
    assert rel_err(got, want) < MODEL_REL[mode]
    with pytest.raises(ValueError, match="attn_path"):
        pmod.attention(pp["blocks"][0]["attn"], t(x), pcfg.heads, mask=t(mask),
                       rope=(t(cos), t(sin)), attn_int8=mode, attn_path="qkv_kernel")


def _step_inputs(batch, n=256):
    rng = _rng(10)
    durs = np.asarray([n, 200][:batch])
    dur_mask = np.arange(n)[None, :] < durs[:, None]
    mask = dur_mask if batch > 1 else None
    pad_mask = (np.arange(n) < durs.max())[None, :]
    y0 = np.where(dur_mask[..., None], rng.standard_normal((batch, n, 100)), 0).astype(np.float32)
    cond = np.where(np.arange(n)[None, :, None] < 30, rng.standard_normal((batch, n, 100)),
                    0).astype(np.float32)
    text = rng.integers(0, 49, (batch, 40)).astype(np.int32)
    return n, durs, mask, pad_mask, y0, cond, text


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_cfg_step_matches_jax_under_the_switch(mode, batch, weights, jax_int8):
    """dit_backbone_premod through dit_forward_cfg_premod: batch 1 takes the
    fused attention half with int8 weights (kernels 5, 14, 6) and attention()
    with fp32 ones; batch 2 carries a duration mask."""
    jax_int8(mode)
    jcfg, pcfg, jp, pp = _tiny() if weights == "fp32" else _tiny_int8()
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(batch)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=dr,
                              pad_mask=jnp.asarray(pad_mask)) for dr in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray([0.4], jnp.float32))
    want = np.asarray(jdit.dit_forward_cfg_premod(
        jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te, mods[0], mod_final[0], 2.0,
        mask=None if mask is None else jnp.asarray(mask), pad_mask=jnp.asarray(pad_mask)))
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(text), n, drop_text=dr,
                              pad_mask=t(pad_mask)) for dr in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, torch.tensor([0.4]))

    def step(attn_int8, attn_path="default"):
        with torch.inference_mode():
            out = pdit.dit_forward_cfg_premod(
                pp, pcfg, t(y0), t(cond), *tp, pmods[0], pfinal[0], 2.0,
                mask=None if mask is None else t(mask), pad_mask=t(pad_mask),
                attn_int8=attn_int8, attn_path=attn_path).numpy()
        return np.concatenate([out[i, :d] for i, d in enumerate(durs)])

    ref = np.concatenate([want[i, :d] for i, d in enumerate(durs)])
    got = step(mode)
    assert np.abs(got).max() > 0.1  # not gated off
    # int8 weights add their own rounding ties on top of the attention's
    assert rel_err(got, ref) < MODEL_REL[mode] * (2 if weights == "int8" else 1)
    assert 1e-5 < rel_err(got, step(None)) < 0.2  # the int8 branch ran
    if weights == "fp32":  # with bf16/fp32 weights "linear_fused" fuses the linears around it
        assert rel_err(step(mode, "linear_fused"), got) < 1e-5
    with pytest.raises(ValueError, match="attn_path"):
        step(mode, "rope_in_kernel")


@pytest.mark.parametrize("use_cfg", [True, False])
def test_sample_core_matches_jax_under_the_switch(use_cfg, jax_int8):
    """Four Euler steps of the sampler with int8 attention over int8 weights
    (CFG: dit_forward_cfg_premod; without: dit_forward), batch 1."""
    jax_int8("qkpv")
    jcfg, pcfg, jp, pp = _tiny_int8()
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(1)
    cfg_strength = 2.0 if use_cfg else 0.0
    # the un-jitted function: the JAX switches are read when it is traced
    want = np.asarray(jcfm._sample_core.__wrapped__(
        jp, jcfg, jnp.asarray(cond), jnp.asarray(text), None, jnp.asarray(pad_mask),
        jnp.asarray(y0), jnp.asarray(cfg_strength), jnp.asarray(-1.0), steps=4, use_cfg=use_cfg,
        use_sway=True, use_epss=True))
    got = pcfm._sample_core(pp, pcfg, t(cond), t(text), None, t(pad_mask), t(y0), cfg_strength,
                            -1.0, steps=4, use_cfg=use_cfg, use_sway=True, use_epss=True,
                            attn_int8="qkpv").numpy()
    assert np.abs(got).max() > 0.1
    # four steps of two blocks, each call a few p8 and int8-weight ties
    assert rel_err(got, want) < 1e-2
    base = pcfm._sample_core(pp, pcfg, t(cond), t(text), None, t(pad_mask), t(y0), cfg_strength,
                             -1.0, steps=4, use_cfg=use_cfg, use_sway=True,
                             use_epss=True).numpy()
    assert 1e-5 < rel_err(got, base) < 0.3


# --- scripts/int8_quality.py -----------------------------------------------------


def test_int8_quality_protocol_on_the_cpu():
    """The six modes of the JAX script, each one JSON line with its keys; the
    attention-only modes differ from the unquantized sampler by the
    quantization error alone, "qk" by less than "qkpv"."""
    import json

    from korean_f5_tts_tpu_torch.scripts import int8_quality

    assert list(int8_quality.MODES) == ["int8_ff", "int8_all", "bf16+attn_i8qk", "bf16+attn_i8",
                                        "int8_all+attn_i8qk", "int8_all+attn_i8"]
    lines = []
    results = int8_quality.run(device="cpu", dim=128, depth=1, heads=2, n=128, cond_len=30,
                               total_len=100, steps=2, dtype=torch.float32, emit=lines.append)
    assert [json.loads(line) for line in lines] == results
    by_mode = {r["mode"]: r for r in results}
    assert list(by_mode) == list(int8_quality.MODES)
    assert all(set(r) == {"mode", "mel_mae_vs_bf16", "relative"} for r in results)
    assert all(0 < r["relative"] < 0.5 for r in results)
    assert by_mode["bf16+attn_i8qk"]["mel_mae_vs_bf16"] <= by_mode["bf16+attn_i8"]["mel_mae_vs_bf16"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            int8_quality.main(["--modes", "int8_ff"])

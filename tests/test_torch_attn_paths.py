"""The opt-in bf16 attention paths (kernels 7, 8, 18, 19) against the JAX package.

Kernel level: the port's plain versions against the Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU
(tests/test_fused_linears.py, tests/test_flash_prefix.py). fp32 agrees to
1e-5 relative L2 (the same arithmetic, sums in another order); bf16 to 2e-2:
the rope kernels multiply in bf16 on the TPU where the port rounds once from
fp32, and the softmax probabilities round at other points.

Model level: one CFG step of a tiny DiT (dim 128, depth 2, 2 heads x 64,
n 128) per attn_path at batch 1 and batch 2, the weights carried across by
the converter. The JAX side sets the matching switch. F5_TTS_ATTN_LINEAR_FUSED
with F5_TTS_PALLAS_INTERPRET runs its kernels 7 and 8 (and the FF kernel) in
interpret mode; F5_TTS_ROPE_IN_KERNEL and F5_TTS_QKV_KERNEL dispatch only on
a TPU, so off it the JAX step is the XLA formulation of the same function,
which is what the two kernels' plain versions are held to above.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models.modules import rope_cos_sin
from korean_f5_tts_tpu.ops import ff_block as jff
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import modules as pmod
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, fused_linears, launch_counts
from korean_f5_tts_tpu_torch.ops import reset_launch_counts
from korean_f5_tts_tpu_torch.ops.attention import ATTN_PATHS, check_attn_path
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

FP32_REL, BF16_REL = 1e-5, 2e-2
TINY = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
            text_num_embeds=50)
JAX_SWITCH = {"linear_fused": "F5_TTS_ATTN_LINEAR_FUSED", "rope_in_kernel": "F5_TTS_ROPE_IN_KERNEL",
              "qkv_kernel": "F5_TTS_QKV_KERNEL"}


@pytest.fixture(autouse=True)
def _interpret():
    old = jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jff._INTERPRET = jfl._INTERPRET = True
    yield
    jfp._INTERPRET, jff._INTERPRET, jfl._INTERPRET = old


def _rng(seed):
    return np.random.default_rng(seed)


def _dt(name):
    return (jnp.float32, torch.float32) if name == "fp32" else (jnp.bfloat16, torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- kernels 7 and 8 -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ln_mod_matmul_plain_vs_pallas(dtype):
    jd, td = _dt(dtype)
    rng = _rng(0)
    B, n, d, seg = 2, 64, 128, 128
    h = rng.standard_normal((B, n, d)).astype(np.float32)
    sc, sh = (rng.uniform(-0.3, 0.3, (d,)).astype(np.float32) for _ in range(2))
    ws = [rng.uniform(-1, 1, (d, seg)).astype(np.float32) * d ** -0.5 for _ in range(3)]
    bs = [rng.uniform(-1, 1, (seg,)).astype(np.float32) * d ** -0.5 for _ in range(3)]
    want = jfl.ln_mod_matmul(*(jnp.asarray(v).astype(jd) for v in
                               (h, sc, sh, np.concatenate(ws, 1), np.concatenate(bs))), 64)
    # the port takes q, k, v as three linears in torch layout [d_out, d_in]
    ps = [{"w": t(w.T).to(td), "b": t(b).to(td)} for w, b in zip(ws, bs)]
    got = fused_linears.ln_mod_matmul(t(h).to(td), t(sc).to(td), t(sh).to(td), ps)
    assert got.dtype == td and got.shape == (B, n, 3 * seg)
    assert rel_err(got.float().numpy(), _f32(want)) < (FP32_REL if dtype == "fp32" else BF16_REL)
    one = fused_linears.ln_mod_matmul(t(h).to(td), t(sc).to(td), t(sh).to(td), ps[:1])
    torch.testing.assert_close(one, got[..., :seg], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_proj_gated_residual_plain_vs_pallas(dtype):
    jd, td = _dt(dtype)
    rng = _rng(1)
    B, n, din, d = 2, 64, 256, 128
    a = rng.standard_normal((B, n, din)).astype(np.float32)
    h = rng.standard_normal((B, n, d)).astype(np.float32)
    gate = rng.uniform(-1, 1, (d,)).astype(np.float32)
    w = rng.uniform(-1, 1, (din, d)).astype(np.float32) * din ** -0.5
    b = rng.uniform(-1, 1, (d,)).astype(np.float32) * din ** -0.5
    want = jfl.proj_gated_residual(*(jnp.asarray(v).astype(jd) for v in (a, h, gate, w, b)), 64)
    got = fused_linears.proj_gated_residual(t(a).to(td), t(h).to(td), t(gate).to(td),
                                            {"w": t(w.T).to(td), "b": t(b).to(td)})
    assert got.dtype == td
    assert rel_err(got.float().numpy(), _f32(want)) < (FP32_REL if dtype == "fp32" else BF16_REL)


# --- kernels 18 and 19 -----------------------------------------------------------


def _valid_rows(x, lens, axis):
    """Concatenate each item's rows [0, len) (rows past it hold whatever the
    kernel's masked softmax left there, in either package)."""
    return np.concatenate([np.take(x[i], np.arange(L), axis=axis - 1).reshape(-1)
                           for i, L in enumerate(lens)])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_rope_attention_plain_vs_pallas(pe_attn_head, dtype):
    jd, td = _dt(dtype)
    rng = _rng(2)
    b, h, n, d = 2, 2, 256, 64
    lens = [200, 256]
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    cos, sin = rope_cos_sin(n, d)
    want = jfp.flash_prefix_rope_attention(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)), jnp.asarray(lens, jnp.int32),
        jnp.asarray(cos), jnp.asarray(sin), pe_attn_head, 128, 128, False)
    got = flash_prefix.flash_prefix_rope_attention(
        t(q).to(td), t(k).to(td), t(v).to(td), torch.tensor(lens), t(cos), t(sin), pe_attn_head)
    assert got.dtype == td and got.shape == (b, h, n, d)
    assert rel_err(_valid_rows(got.float().numpy(), lens, 2), _valid_rows(_f32(want), lens, 2)) \
        < (FP32_REL if dtype == "fp32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_qkv_attention_plain_vs_pallas(pe_attn_head, dtype):
    jd, td = _dt(dtype)
    rng = _rng(3)
    b, heads, n, dh = 2, 2, 256, 64
    lens = [130, 256]
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    cos, sin = rope_cos_sin(n, dh)
    want = jfp.flash_prefix_qkv_attention(jnp.asarray(qkv).astype(jd),
                                          jnp.asarray(lens, jnp.int32), heads, jnp.asarray(cos),
                                          jnp.asarray(sin), pe_attn_head, 128, 128)
    got = flash_prefix.flash_prefix_qkv_attention(t(qkv).to(td), torch.tensor(lens), heads,
                                                  t(cos), t(sin), pe_attn_head)
    assert got.dtype == td and got.shape == (b, n, heads * dh)
    assert rel_err(_valid_rows(got.float().numpy(), lens, 1), _valid_rows(_f32(want), lens, 1)) \
        < (FP32_REL if dtype == "fp32" else BF16_REL)


def test_rope_and_qkv_plain_versions_are_one_function():
    """Kernel 19 is kernel 18 on another layout: same values, [1] lens broadcast."""
    rng = _rng(4)
    b, heads, n, dh = 2, 4, 96, 64
    qkv = t(rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32))
    cos, sin = (t(x) for x in rope_cos_sin(n, dh))
    lens = torch.tensor([70])
    merged = flash_prefix.flash_prefix_qkv_attention(qkv, lens, heads, cos, sin, 2)
    q, k, v = flash_prefix.qkv_unpack(qkv, heads)
    split = flash_prefix.flash_prefix_rope_attention(q, k, v, lens, cos, sin, 2)
    torch.testing.assert_close(merged, split.transpose(1, 2).reshape(b, n, heads * dh),
                               rtol=0, atol=0)
    # and both are torch rope + the plain prefix attention
    want = flash_prefix.flash_prefix_attention(pmod.apply_rope(q, cos, sin, 2),
                                               pmod.apply_rope(k, cos, sin, 2), v, lens)
    assert rel_err(split.numpy(), want.numpy()) < FP32_REL


# --- one CFG step per attn_path --------------------------------------------------


@functools.lru_cache(maxsize=1)
def _tiny():
    jcfg, pcfg = JaxDiTConfig(**TINY), DiTConfig(**TINY)
    flat = flatten_tree(jdit.init_dit(jax.random.PRNGKey(0), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 7)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu")


def _step_inputs(batch):
    n = 128
    rng = _rng(6)
    durs = np.asarray([128, 100][:batch])
    dur_mask = np.arange(n)[None, :] < durs[:, None]
    mask = dur_mask if batch > 1 else None
    pad_mask = (np.arange(n) < durs.max())[None, :]
    y0 = np.where(dur_mask[..., None], rng.standard_normal((batch, n, 100)), 0).astype(np.float32)
    cond = np.where(np.arange(n)[None, :, None] < 30, rng.standard_normal((batch, n, 100)),
                    0).astype(np.float32)
    text = rng.integers(0, 49, (batch, 40)).astype(np.int32)
    return n, durs, mask, pad_mask, y0, cond, text


def _port_step(batch, attn_path, kernels=True, dtype=torch.float32):
    _, pcfg, _, pp = _tiny()
    pp = pmod.cast_params(pp, dtype)
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(batch)
    ts = torch.tensor([0.4], dtype=dtype)
    tp = [pdit.text_embedding(pp["text_embed"], pcfg, t(text), n, drop_text=dr,
                              pad_mask=t(pad_mask)) for dr in (False, True)]
    pmods, pfinal, _ = pdit.precompute_step_modulations(pp, pcfg, ts)
    with torch.inference_mode():
        out = pdit.dit_forward_cfg_premod(
            pp, pcfg, t(y0).to(dtype), t(cond).to(dtype), *tp, pmods[0], pfinal[0], 2.0,
            mask=None if mask is None else t(mask), pad_mask=t(pad_mask), kernels=kernels,
            attn_path=attn_path)
    return np.concatenate([out.float().numpy()[i, :d] for i, d in enumerate(durs)])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("attn_path", ATTN_PATHS)
def test_cfg_step_matches_jax_under_each_attn_path(attn_path, batch, monkeypatch):
    """A JAX tree goes through the converter and both packages compute the
    same step: params_from_jax carries every leaf these paths read."""
    monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
    if attn_path != "default":
        monkeypatch.setenv(JAX_SWITCH[attn_path], "1")
    jcfg, _, jp, _ = _tiny()
    n, durs, mask, pad_mask, y0, cond, text = _step_inputs(batch)
    te = [jdit.text_embedding(jp["text_embed"], jcfg, jnp.asarray(text), n, drop_text=dr,
                              pad_mask=jnp.asarray(pad_mask)) for dr in (False, True)]
    mods, mod_final, _ = jdit.precompute_step_modulations(jp, jcfg, jnp.asarray([0.4], jnp.float32))
    want = np.asarray(jdit.dit_forward_cfg_premod(
        jp, jcfg, jnp.asarray(y0), jnp.asarray(cond), *te, mods[0], mod_final[0], 2.0,
        mask=None if mask is None else jnp.asarray(mask), pad_mask=jnp.asarray(pad_mask)))
    ref = np.concatenate([want[i, :d] for i, d in enumerate(durs)])
    reset_launch_counts()
    got = _port_step(batch, attn_path)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU takes the plain versions
    assert np.abs(got).max() > 0.1  # not gated off
    assert rel_err(got, ref) < 1e-4  # fp32, two blocks: sums in another order
    np.testing.assert_array_equal(got, _port_step(batch, attn_path, kernels=False))


@pytest.mark.parametrize("batch", [1, 2])
def test_attn_paths_agree_with_each_other(batch):
    """In fp32 the four paths are one function up to summation order; in bf16
    they round at other points (kernel 7 rounds the modulated rows once,
    kernels 18 and 19 the roped values once) and stay within bf16 tolerance."""
    base32 = _port_step(batch, "default")
    base16 = _port_step(batch, "default", dtype=torch.bfloat16)
    assert rel_err(base16, base32) < BF16_REL
    for path in ATTN_PATHS[1:]:
        assert rel_err(_port_step(batch, path), base32) < 1e-5
        assert rel_err(_port_step(batch, path, dtype=torch.bfloat16), base16) < BF16_REL


def test_linear_fused_falls_back_to_attention_under_a_duration_mask():
    """A batch of 2 carries a duration mask: "linear_fused" then takes
    attention() and is the default path bit for bit (dit.py:373-379, 468-474)."""
    np.testing.assert_array_equal(_port_step(2, "linear_fused", dtype=torch.bfloat16),
                                  _port_step(2, "default", dtype=torch.bfloat16))
    assert not np.array_equal(_port_step(1, "linear_fused", dtype=torch.bfloat16),
                              _port_step(1, "default", dtype=torch.bfloat16))


def test_unknown_attn_path_raises():
    assert check_attn_path("qkv_kernel") == "qkv_kernel"
    with pytest.raises(ValueError, match="attn_path"):
        check_attn_path("fastest")
    with pytest.raises(ValueError, match="attn_path"):
        _port_step(1, "rope")


# --- wrappers under autograd -----------------------------------------------------


def _grad_cases():
    """(kernel call, its plain formulation, the input that takes a gradient)."""
    rng = _rng(8)
    x = t(rng.standard_normal((1, 64, 128)).astype(np.float32))
    vec = t(rng.standard_normal((128,)).astype(np.float32))
    lin = {"w": t(rng.standard_normal((128, 128)).astype(np.float32)), "b": vec.clone()}
    q = t(rng.standard_normal((1, 2, 64, 64)).astype(np.float32))
    qkv = t(rng.standard_normal((1, 64, 3 * 2 * 64)).astype(np.float32))
    cos, sin = (t(v) for v in rope_cos_sin(64, 64))
    lens = torch.tensor([64])
    rope_plain = flash_prefix._xla_rope_prefix

    def qkv_plain(z):
        o = rope_plain(*flash_prefix.qkv_unpack(z, 2), lens, cos, sin, None)
        return o.transpose(1, 2).reshape(1, 64, 128)

    return {
        "ln_mod_matmul": (lambda z: fused_linears.ln_mod_matmul(z, vec, vec, [lin]),
                          lambda z: fused_linears.ln_mod_matmul_xla(z, vec, vec, [lin]), x),
        "ln_mod_matmul_weight": (
            lambda z: fused_linears.ln_mod_matmul(x, vec, vec, [{"w": z, "b": lin["b"]}]),
            lambda z: fused_linears.ln_mod_matmul_xla(x, vec, vec, [{"w": z, "b": lin["b"]}]),
            lin["w"]),
        "proj_gated_residual": (lambda z: fused_linears.proj_gated_residual(x, z, vec, lin),
                                lambda z: fused_linears.proj_gated_xla(x, z, vec, lin), x),
        "flash_prefix_rope": (
            lambda z: flash_prefix.flash_prefix_rope_attention(q, z, q, lens, cos, sin),
            lambda z: rope_plain(q, z, q, lens, cos, sin, None), q),
        "flash_prefix_qkv": (
            lambda z: flash_prefix.flash_prefix_qkv_attention(z, lens, 2, cos, sin),
            qkv_plain, qkv),
    }


@pytest.mark.parametrize("name", ["ln_mod_matmul", "ln_mod_matmul_weight", "proj_gated_residual",
                                  "flash_prefix_rope", "flash_prefix_qkv"])
def test_wrappers_raise_on_inputs_that_require_a_gradient(name):
    """Kernels 7, 8, 18 and 19 were forward-only and raised here; they run
    under autograd now (fused_linears.py:82-100, 237-254; flash_prefix.py:
    1496-1542, 1696-1745). The call with a gradient gives the no-gradient
    call's output, and the gradient of the plain formulation."""
    call, plain, z = _grad_cases()[name]
    zg = z.clone().requires_grad_(True)
    out = call(zg)
    with torch.no_grad():  # no gradient is being taken: the same call serves
        torch.testing.assert_close(out.detach(), call(z), rtol=0, atol=0)
    g = t(_rng(9).standard_normal(tuple(out.shape)).astype(np.float32))
    (got,) = torch.autograd.grad(out, zg, g)
    zp = z.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(plain(zp), zp, g)
    assert torch.isfinite(got).all() and got.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)

"""The port at head dim 128, at head dim 96 and at 8 channels a conv-pos group,
on the CPU, against the JAX package.

Seeded numpy inputs go through the JAX function and the port's counterpart.
Where a kernel is held, the JAX side runs its Pallas kernel in interpret
mode (flash_prefix._INTERPRET, F5_TTS_PALLAS_INTERPRET), as the JAX
package's own tests run it; the model-level tests take JAX's CPU path. The
port takes its plain versions (CPU tensors), so every launch counter stays
0.

Tolerances, with their reasons:
  - kernels 10-13 and 18: as tests/test_torch_flash_bwd.py and
    test_torch_rope_core.py at d = 64 (fp32: 1e-5 for o and lse, 1e-4 for
    the gradients, summation order; bf16: 4 bf16 ulps at the output's scale,
    the JAX kernels round q * scale and dS to bf16 where the plain versions
    keep fp32; 18 in bf16 relative 2e-2);
  - kernel 14 and its pass: the pass's int8 values to the bit, c and sv to
    fp32's rounding; the output as tests/test_torch_int8_attn_core.py
    (one bf16 ulp and 1e-4 in "qkpv", two and 2e-3 in "qk");
  - the plain attention at d = 96: fp32 1e-5 (the same formulation); bf16
    2e-2 (JAX's XLA path keeps bf16 logits, the port fp32 ones);
  - kernel C's packing: float64 exact, fp32 1e-6 (zeros added in another
    order), and against the TPU kernel fp32 1e-5, bf16 4 ulps;
  - the dim-128 DiT: forward and loss 1e-4 / 1e-5 relative, the gradient
    relative L2 1e-4 (fp32 summation order);
  - the converter: exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from _torch_port_util import jax_draws, redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.ops import attention as jattn
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import grouped_conv as jgc
from korean_f5_tts_tpu.train import checkpoint as jckpt
from korean_f5_tts_tpu.utils import torch_ckpt as jtorch_ckpt
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models import dit as pdit
from korean_f5_tts_tpu_torch.models import modules as pmod
from korean_f5_tts_tpu_torch.models.modules import rope_cos_sin
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import attention as pattn
from korean_f5_tts_tpu_torch.ops import flash_prefix as fp
from korean_f5_tts_tpu_torch.ops import grouped_conv as pgc
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.utils import torch_ckpt

D = 128
SCALE = D ** -0.5
# a DiT of dim 128: one head of 128, conv-pos at 16 groups of 8 channels
DIM128 = dict(dim=128, depth=2, heads=1, dim_head=128, ff_mult=2, text_dim=32, conv_layers=2,
              text_num_embeds=50, dropout=0.0)
B, N = 2, 128
LENS = np.asarray([128, 97], np.int32)


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def _close(got, want, dtype, fp32_tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=fp32_tol, rtol=fp32_tol)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)


def _pair(jax_dtype, *arrays):
    """The same values as JAX arrays of jax_dtype and as torch tensors."""
    j = [jnp.asarray(a).astype(jax_dtype) for a in arrays]
    return j, [t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, jax_dtype)) for x in j]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_10_to_13_at_head_dim_128_match_the_interpret_kernels(dtype):
    rng = np.random.default_rng(128)
    lens = [256, 1]  # every key, and one head of a single key
    (q, k, v, do), (tq, tk, tv, tdo) = _pair(
        dtype, *(rng.standard_normal((2, 256, D)).astype(np.float32) for _ in range(4)))
    kv, tkv = jnp.asarray(lens, jnp.int32), torch.tensor(lens, dtype=torch.int32)

    o_j, lse_j = jfp._flash_prefix_folded_lse(q, k, v, kv, SCALE, bq=128, ck=128, prune=False)
    o_p, lse_p = fp.flash_prefix_folded_lse(tq, tk, tv, tkv)
    _close(o_p.float().numpy(), o_j.astype(jnp.float32), dtype, 1e-5)
    lse_tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0], atol=lse_tol,
                               rtol=lse_tol)
    dvec = jnp.sum(do.astype(jnp.float32) * o_j.astype(jnp.float32), axis=-1, keepdims=True)
    tdvec, tlse = t(np.asarray(dvec)[..., 0]), t(np.asarray(lse_j)[..., 0])
    dq_j = jfp._flash_prefix_dq_lsein(q, k, v, do, dvec, lse_j, kv, SCALE, bq=128, ck=128,
                                      cast=True)
    _close(fp.flash_prefix_dq_lsein(tq, tk, tv, tdo, tdvec, tlse, tkv).float().numpy(),
           dq_j.astype(jnp.float32), dtype, 1e-4)
    dq12_j, lse12_j = jfp._flash_prefix_dq(q, k, v, do, dvec, kv, SCALE, bq=128, ck=128,
                                           prune=False, cast=True)
    dq12_p, lse12_p = fp.flash_prefix_dq(tq, tk, tv, tdo, tdvec, tkv)
    _close(dq12_p.float().numpy(), dq12_j.astype(jnp.float32), dtype, 1e-4)
    np.testing.assert_allclose(lse12_p.numpy(), np.asarray(lse12_j)[..., 0], atol=lse_tol,
                               rtol=lse_tol)
    dk_j, dv_j = jfp._flash_prefix_dkv(q, k, v, do, dvec.transpose(0, 2, 1),
                                       lse_j.transpose(0, 2, 1), kv, SCALE, bkv=128, cq=128,
                                       cast=True)
    dk_p, dv_p = fp.flash_prefix_dkv(tq, tk, tv, tdo, tdvec, tlse, tkv)
    _close(dk_p.float().numpy(), dk_j.astype(jnp.float32), dtype, 1e-4)
    _close(dv_p.float().numpy(), dv_j.astype(jnp.float32), dtype, 1e-4)
    assert not dk_p[1, 1:].any() and not dv_p[1, 1:].any()  # keys past kv_len


def _padded(n, lens, dtype, seed):
    """q, k, v, dO [H, n, 128] in `dtype` (seeded numpy, rounded once) as
    torch tensors, and the same as JAX arrays zero-padded to a multiple of
    128 rows (the JAX kernels' n), as tests/test_torch_flash_train_core.py
    does at d = 64: padded keys lie past every kv_len; a padded query has dO
    0, and gets lse 0 and D 0, so it adds nothing to dk or dv."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((len(lens), n, D)).astype(np.float32) for _ in range(4)]
    n_pad = -(-n // 128) * 128
    jx = [jnp.asarray(np.pad(a, ((0, 0), (0, n_pad - n), (0, 0)))).astype(dtype) for a in x]
    tx = [t(np.asarray(a.astype(jnp.float32))[:, :n]).to(getattr(torch, dtype)) for a in jx]
    return tx, jx, np.asarray(lens, np.int32)


# kernel 13 at d = 128 on the backward core: 128 keys a block on two
# warpgroups of 64, 64-query tiles; n 100 and 301 (an [H, n] fp32 row of lse
# and D at no 16-byte boundary), kv_len 1, 63-65, 127-129 and n
@pytest.mark.parametrize("n,lens", [(100, [1, 63, 64, 65, 100]), (301, [1, 127, 128, 129, 301])],
                         ids=["n100", "n301"])
def test_kernel_13_reference_at_head_dim_128_at_the_backward_core_edges(n, lens):
    (tq, tk, tv, tdo), jx, lens_np = _padded(n, lens, "bfloat16", 1300 + n)
    q, k, v, do = jx
    kv = jnp.asarray(lens_np)
    o_j, lse_j = jfp._flash_prefix_folded_lse(q, k, v, kv, SCALE, bq=128, ck=128, prune=False)
    rows = np.arange(q.shape[1]) < n
    dvec = np.asarray(jnp.sum(do.astype(jnp.float32) * o_j.astype(jnp.float32), axis=-1))
    lse = np.asarray(lse_j)[..., 0]
    dvec, lse = (np.where(rows, a, 0.0).astype(np.float32) for a in (dvec, lse))
    dk_j, dv_j = jfp._flash_prefix_dkv(q, k, v, do, jnp.asarray(dvec[:, None, :]),
                                       jnp.asarray(lse[:, None, :]), kv, SCALE, bkv=128, cq=128,
                                       cast=True)
    dk_p, dv_p = fp.flash_prefix_dkv(tq, tk, tv, tdo, t(dvec[:, :n]), t(lse[:, :n]), t(lens_np))
    assert dk_p.dtype == dv_p.dtype == torch.bfloat16
    _close(dk_p.float().numpy(), np.asarray(dk_j.astype(jnp.float32))[:, :n], "bfloat16", 0)
    _close(dv_p.float().numpy(), np.asarray(dv_j.astype(jnp.float32))[:, :n], "bfloat16", 0)
    for h, length in enumerate(lens):  # keys at or past kv_len get no gradient
        assert not dk_p[h, length:].any() and not dv_p[h, length:].any()


# kernel 10 in fp32 at d = 128 on split 3xTF32: 32-key tiles, 128 queries a
# block; kv_len 31-33 and n at n 129 (two query blocks), and kv_len 0 at n
# 128, where the JAX kernel needs no padded keys (with none valid it averages
# v over every key it is given, padded ones included). A head with kv_len 0
# has the port's lse 0 (the module's convention, the kernels' too); the JAX
# kernel's is the finite mask value's, MASK_VALUE + log2(n)
@pytest.mark.parametrize("n,lens", [(129, [31, 32, 33, 129]), (128, [0, 33, 128])],
                         ids=["n129", "n128-kv0"])
def test_kernel_10_fp32_reference_at_head_dim_128_at_the_3xtf32_tile_edges(n, lens):
    (tq, tk, tv, _), (q, k, v, _), lens_np = _padded(n, lens, "float32", 1000 + n)
    o_j, lse_j = jfp._flash_prefix_folded_lse(q, k, v, jnp.asarray(lens_np), SCALE, bq=128,
                                              ck=128, prune=False)
    o_p, lse_p = fp.flash_prefix_folded_lse(tq, tk, tv, t(lens_np))
    assert o_p.dtype == lse_p.dtype == torch.float32
    _close(o_p.numpy(), np.asarray(o_j)[:, :n], "float32", 1e-5)
    live = lens_np > 0
    np.testing.assert_allclose(lse_p.numpy()[live], np.asarray(lse_j)[live, :n, 0], atol=1e-5,
                               rtol=1e-5)
    assert not lse_p[~torch.from_numpy(live)].any()


@pytest.mark.parametrize("lens", [[0, 1, 127, 129], [256, 1], [0, 1, 127, 129, 256, 256, 1, 129]],
                         ids=["4 heads", "2 heads", "8 heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_a_at_head_dim_128_matches_the_interpret_kernel(dtype, lens):
    """Kernel A's own function at d = 128: the JAX serving forward (its
    static-max kernel, _kernel_nomax; _kernel_nomax_hn at 8 heads, which
    it groups 8 to a block at n 256) against the port's plain version. A
    head with kv_len 0 gets zeros from the JAX kernel (and from the port's
    kernels); the plain version gives it the uniform mean of v."""
    rng = np.random.default_rng(1280)
    H = len(lens)
    (q, k, v), (tq, tk, tv) = _pair(
        dtype, *(rng.standard_normal((H, 256, D)).astype(np.float32) for _ in range(3)))
    want = np.asarray(jfp._flash_prefix_folded(q, k, v, jnp.asarray(lens, jnp.int32), SCALE,
                                               bq=128, ck=128).astype(jnp.float32))
    got = fp.flash_prefix_folded(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == getattr(torch, dtype) and got.shape == (H, 256, D)
    live = [h for h, length in enumerate(lens) if length > 0]
    _close(got.float().numpy()[live], want[live], dtype, 1e-5)
    for h, length in enumerate(lens):
        if length == 0:
            assert not want[h].any()
            _close(got.float().numpy()[h], tv[h].float().mean(0).expand(256, D).numpy(),
                   dtype, 1e-5)


@pytest.mark.parametrize("pe", [None, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_18_at_head_dim_128_matches_the_interpret_kernel(dtype, pe):
    rng = np.random.default_rng(18)
    lens = [128, 70]
    (q, k, v), (tq, tk, tv) = _pair(
        dtype, *(rng.standard_normal((2, 2, 128, D)).astype(np.float32) for _ in range(3)))
    cos, sin = rope_cos_sin(128, D)
    want = jfp.flash_prefix_rope_attention(q, k, v, jnp.asarray(lens, jnp.int32),
                                           jnp.asarray(cos), jnp.asarray(sin), pe, 128, 128,
                                           False)
    got = fp.flash_prefix_rope_attention(tq, tk, tv, torch.tensor(lens), t(cos), t(sin), pe)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, 128, D)
    want = np.asarray(want.astype(jnp.float32))
    valid = np.concatenate([got.float().numpy()[i, :, :L].ravel() for i, L in enumerate(lens)])
    ref = np.concatenate([want[i, :, :L].ravel() for i, L in enumerate(lens)])
    assert rel_err(valid, ref) < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_kernel_14_and_its_pass_at_head_dim_128_match_jax(mode):
    rng = np.random.default_rng(14)
    lens = [256, 100]
    (q, k, v), (tq, tk, tv) = _pair(
        "bfloat16", *(rng.standard_normal((2, 1, 256, D)).astype(np.float32) * s
                      for s in (1.5, 1.2, 0.8)))
    pv_i8 = mode == "qkpv"
    # the pass: the JAX _quant_head's int8 values and amax, the wrapper's scales
    q8, k8, vq, c, sv = fp.quantize_heads(tq, tk, tv, pv_i8)
    for x, x8 in ((q, q8), (k, k8)):
        np.testing.assert_array_equal(x8.numpy(), np.asarray(jfp._quant_head(x.reshape(2, 256, D))[0]))
    aq, ak = (np.asarray(jfp._quant_head(x.reshape(2, 256, D))[1]) for x in (q, k))
    np.testing.assert_allclose(c.numpy(), aq * ak * (np.log2(np.e) / 127.0 ** 2 / np.sqrt(D)),
                               rtol=1e-6)
    if pv_i8:
        v8, av = jfp._quant_head(v.reshape(2, 256, D))
        np.testing.assert_array_equal(fp._v8_natural_layout(vq, 256).numpy(), np.asarray(v8))
        np.testing.assert_allclose(sv.numpy(), np.asarray(av) / 127.0 ** 2, rtol=1e-6)
    want = np.asarray(jfp.flash_prefix_attention_i8(q, k, v, jnp.asarray(lens, jnp.int32),
                                                    bq=128, pv_i8=pv_i8).astype(jnp.float32))
    got = fp.flash_prefix_attention_i8(tq, tk, tv, torch.tensor(lens), pv_i8=pv_i8)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 256, D)
    valid = np.concatenate([got.float().numpy()[i, :, :L].ravel() for i, L in enumerate(lens)])
    ref = np.concatenate([want[i, :, :L].ravel() for i, L in enumerate(lens)])
    ulp = 2.0 ** -8 * max(1.0, np.abs(ref).max())  # one bf16 ulp at the output's scale
    if pv_i8:
        assert np.abs(valid - ref).max() <= ulp and rel_err(valid, ref) < 1e-4
    else:
        assert np.abs(valid - ref).max() <= 2 * ulp and rel_err(valid, ref) < 2e-3


@pytest.mark.parametrize("attn_int8", [None, "qk", "qkpv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_96_takes_the_plain_attention_as_jax_does(monkeypatch, dtype, attn_int8):
    """At d = 96 the JAX dispatch runs XLA, its int8 setting included (the
    int8 branch sits inside `d in (64, 128)`); the port's sdpa takes the
    plain attention in the operands' dtype, not the plain int8 version."""
    monkeypatch.setenv("F5_TTS_PALLAS_INTERPRET", "1")
    if attn_int8:
        monkeypatch.setenv("F5_TTS_INT8_ATTN", attn_int8)
    rng = np.random.default_rng(96)
    lens = [128, 77]
    (q, k, v), (tq, tk, tv) = _pair(
        dtype, *(rng.standard_normal((2, 2, 128, 96)).astype(np.float32) for _ in range(3)))
    mask = np.arange(128)[None, :] < np.asarray(lens)[:, None]
    want = np.asarray(jattn.sdpa(q, k, v, jnp.asarray(mask),
                                 prefix_lens=jnp.asarray(lens, jnp.int32)).astype(jnp.float32))
    tl = torch.tensor(lens, dtype=torch.int32)
    got = pattn.sdpa(tq, tk, tv, tl, attn_int8=attn_int8)
    assert torch.equal(got, pattn.sdpa(tq, tk, tv, tl, kernels=False))
    assert rel_err(got.float().numpy(), want) < (1e-5 if dtype == "float32" else 2e-2)
    if attn_int8:  # not the int8 function
        i8 = fp.flash_prefix_attention_i8(tq, tk, tv, tl, pv_i8=attn_int8 == "qkpv")
        assert not torch.equal(got, i8)


def _dit(cfg_kw: dict, seed: int = 0):
    """(jax config, port config, jax params, port params) of one DiT."""
    jcfg, pcfg = JaxDiTConfig(**cfg_kw), DiTConfig(**cfg_kw)
    flat = jckpt.flatten_tree(jdit.init_dit(jax.random.PRNGKey(seed), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_tree(flat))
    return jcfg, pcfg, jparams, pckpt.params_from_jax(flat, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    mel[1, LENS[1]:] = 0.0
    text = np.full((B, 40), -1, np.int32)
    text[0, :31] = rng.integers(0, 49, 31)
    text[1, :17] = rng.integers(0, 49, 17)
    return {"mel": mel, "text": text, "lens": LENS}


@pytest.mark.parametrize("attn_path,dim_head", [("qkv_kernel", 128), ("rope_in_kernel", 96),
                                                ("qkv_kernel", 96)])
def test_in_kernel_rope_paths_step_aside_by_shape_as_jax(monkeypatch, attn_path, dim_head):
    """Kernel 19 takes dh 64 only (JAX: dh == 64), kernel 18 d 64 and 128: at
    another head dim the block takes JAX's unfused path, rope in the
    activations' dtype, then the attention (at 128 kernel A; at 96 the plain
    attention). Kernel 19's wrapper must not be reached. The JAX side runs
    its CPU path (XLA attention): the kernels themselves are held above."""
    monkeypatch.setenv({"qkv_kernel": "F5_TTS_QKV_KERNEL",
                        "rope_in_kernel": "F5_TTS_ROPE_IN_KERNEL"}[attn_path], "1")

    def refuse(*a, **k):
        raise AssertionError("kernel 19's path ran at a head dim it does not take")

    monkeypatch.setattr(pmod, "qkv_fused_sdpa", refuse)
    kw = dict(DIM128, dim=2 * dim_head, heads=2, dim_head=dim_head)
    jcfg, pcfg, jp, pp = _dit(kw)
    batch = _batch(1)
    rng = np.random.default_rng(2)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    time = rng.uniform(size=B).astype(np.float32)
    mask = np.arange(N)[None, :] < LENS[:, None]
    want = jax.jit(lambda p, *a: jdit.dit_forward(p, jcfg, *a, mask=jnp.asarray(mask)))(
        jp, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(batch["text"]), jnp.asarray(time))
    got = pdit.dit_forward(pp, pcfg, t(x), t(cond), t(batch["text"]), t(time), mask=t(mask),
                           attn_path=attn_path)
    assert np.abs(got.numpy()).max() > 0.1  # not gated off
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-4


@pytest.mark.parametrize("fuse_mish", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_pos_at_8_channels_a_group_packs_pairs_as_the_tpu_kernel(dtype, fuse_mish):
    """pack_group_pairs: the packed weights at groups / 2 are the unpacked
    grouped conv (float64 exact), and the plain conv on them equals the TPU
    kernel _gc_kernel in interpret mode, which packs 16 groups of 8 into its
    128-lane block (grouped_conv.py:53-64)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 100, 128)).astype(np.float32)
    w = (rng.uniform(-1, 1, (31, 8, 128)) * (8 * 31) ** -0.5).astype(np.float32)
    b = (rng.uniform(-1, 1, 128) * 0.1).astype(np.float32)
    packed = pgc.pack_group_pairs(t(w).double(), 16)
    assert packed.shape == (31, 16, 128)
    x64, w64 = t(x).double().transpose(1, 2), t(w).double()
    want64 = F.conv1d(x64, w64.permute(2, 1, 0), t(b).double(), padding=15, groups=16)
    got64 = F.conv1d(x64, packed.permute(2, 1, 0), t(b).double(), padding=15, groups=8)
    assert torch.equal(got64, want64)
    (jx, jw, jb), (tx, tw, tb) = _pair(dtype, x, w, b)
    unpacked = pgc.grouped_conv1d_mish_reference(tx, tw, tb, 16, fuse_mish)
    got = pgc.grouped_conv1d_mish_reference(tx, pgc.pack_group_pairs(tw, 16), tb, 8, fuse_mish)
    want = jgc._pallas_fwd(jx, jw, jb, 16, fuse_mish, interpret=True)
    if dtype == "float32":
        torch.testing.assert_close(got, unpacked, rtol=1e-6, atol=1e-6)
    _close(got.float().numpy(), want.astype(jnp.float32), dtype, 1e-5)


def test_dim_128_dit_forward_and_training_step_match_jax():
    """A DiT of dim 128 (one head of 128; conv-pos at 16 groups of 8): the
    JAX package on its CPU path against the port's plain versions, the
    forward, and one step's loss and whole gradient on the JAX draws (the
    kernels this model reaches, 10, 11, 13 at d = 128 and C at 8 channels,
    are held to their interpret-mode Pallas kernels above)."""
    jcfg, pcfg, jp, pp = _dit(DIM128)
    batch = _batch(3)
    rng = np.random.default_rng(4)
    x, cond = (rng.standard_normal((B, N, 100)).astype(np.float32) for _ in range(2))
    time = rng.uniform(size=B).astype(np.float32)
    want = jax.jit(lambda p, *a: jdit.dit_forward(p, jcfg, *a))(
        jp, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(batch["text"]), jnp.asarray(time))
    got = pdit.dit_forward(pp, pcfg, t(x), t(cond), t(batch["text"]), t(time))
    assert np.abs(got.numpy()).max() > 0.1
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-4

    key = jax.random.PRNGKey(5)

    def loss_fn(params):
        return jcfm.cfm_loss(params, jcfg, *(jnp.asarray(batch[k]) for k in
                                             ("mel", "text", "lens")), key, use_dropout=False)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(jp)
    draws = jax_draws(key, (B, N, 100), LENS)
    loss_p, grads_p = pstep.loss_and_grads(pp, {k: t(v) for k, v in batch.items()}, 0, pcfg,
                                           draws=draws)
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=1e-5)
    flat_j = jckpt.flatten_tree(grads_j)
    # the port's gradients in the JAX layout (linear weights [d_in, d_out])
    flat_p = pckpt.params_to_jax(pckpt.unflatten_tree(dict(zip(pckpt.flatten_tree(pp),
                                                                grads_p))))
    assert flat_p.keys() == flat_j.keys()
    gp = np.concatenate([flat_p[k].ravel() for k in flat_j])
    gj = np.concatenate([np.asarray(flat_j[k]).ravel() for k in flat_j])
    assert rel_err(gp, gj) < 1e-4


def test_the_converter_takes_head_dim_128():
    """A reference-format state dict of a DiT with 128-wide heads: the rope
    permutation (interleaved pairs to the half-split layout) per head of 128,
    the port's converter equal to the JAX package's and to the tree it came
    from, to the bit."""
    kw = dict(DIM128, dim=256, heads=2)
    _, _, jp, _ = _dit(kw, seed=2)
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jp).items()}
    sd = torch_ckpt.dit_state_dict(jckpt.unflatten_tree(flat), 2, D)
    # the reference layout: q's output feature h * 128 + 2i is the half-split 64 * ... + i
    w = flat["blocks/0/attn/to_q/w"]
    ref = sd["transformer_blocks.0.attn.to_q.weight"]
    for h in range(2):
        for i in range(D // 2):
            np.testing.assert_array_equal(ref[h * D + 2 * i], w[:, h * D + i])
            np.testing.assert_array_equal(ref[h * D + 2 * i + 1], w[:, h * D + D // 2 + i])
    args = (2, D, kw["depth"], kw["conv_layers"])
    back_p = jckpt.flatten_tree(torch_ckpt.convert_dit_state_dict(sd, *args))
    back_j = jckpt.flatten_tree(jtorch_ckpt.convert_dit_state_dict(sd, *args))
    assert back_p.keys() == back_j.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back_p[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(back_j[k]), flat[k], err_msg=k)


def test_the_dispatch_predicates_follow_jax():
    assert pattn.ATTENTION_KERNEL_DIMS == (64, 128) == fp.KERNEL_HEAD_DIMS
    assert [pattn.qkv_kernel_takes(d) for d in (64, 96, 128)] == [True, False, False]
    assert pgc.KERNEL_GROUP_WIDTHS == (8, 16, 32, 64, 128)
    for c, groups in ((128, 16), (256, 16), (1024, 16), (768, 16), (64, 16)):
        assert pgc.pallas_conv_supported(c, groups, 31) == jgc.pallas_conv_supported(c, groups, 31)

"""The rest of training in the port, against the JAX package, on the CPU:
kernels 7, 8, 18 and 19 under autograd, the "dots" remat policy, the wandb
logger and sample logging, bench_train's --remat dots and --io_overlap, the
forward-only kernels' guard and one process's sharded checkpoint.

The vjps: each autograd Function's gradient (its forward the kernel's plain
version on the CPU, its backward the XLA formulation) against jax.vjp of the
JAX op, whose custom_vjp differentiates the same formulation, the Pallas
forward run in interpret mode (tests/test_torch_attn_paths.py's way); fp32,
relative L2 1e-5. The formulations themselves pass torch.autograd.gradcheck
in float64. "dots" keeps products, never changes them: its gradients equal
"full" remat's to the bit on the CPU, and the attention kernel's launch is
not repeated in the backward.
"""

import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.modules import rope_cos_sin
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu.ops import fused_linears as jfl
from korean_f5_tts_tpu.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.quant import quantize_linear
from korean_f5_tts_tpu_torch.ops import KERNELS, ff_block, flash_prefix, fused_linears
from korean_f5_tts_tpu_torch.ops import launch_counts, qmatmul, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import bench_train
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.train.trainer import Trainer

FP32_REL = 1e-5
ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=8, text_num_embeds=20,
            text_dim=16, conv_layers=1, pe_attn_head=1)


@pytest.fixture(autouse=True)
def _interpret_and_no_launches():
    old = jfp._INTERPRET, jfl._INTERPRET
    jfp._INTERPRET = jfl._INTERPRET = True
    reset_launch_counts()
    yield
    jfp._INTERPRET, jfl._INTERPRET = old
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _rng(seed):
    return np.random.default_rng(seed)


def _port_grads(fn, inputs: list[np.ndarray], g: np.ndarray) -> list[np.ndarray]:
    xs = [t(x).requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return [x.numpy() for x in torch.autograd.grad(out, xs, t(g))]


def _jax_grads(fn, inputs: list[np.ndarray], g: np.ndarray) -> list[np.ndarray]:
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    return [np.asarray(x) for x in vjp(jnp.asarray(g, out.dtype))]


# --- kernels 7, 8, 18, 19 under autograd ------------------------------------------


def test_kernel_7_vjp_matches_jax():
    rng = _rng(0)
    B, n, d, seg = 2, 64, 128, 128
    h = rng.standard_normal((B, n, d)).astype(np.float32)
    sc, sh = (rng.uniform(-0.3, 0.3, (d,)).astype(np.float32) for _ in range(2))
    w = rng.uniform(-1, 1, (d, 3 * seg)).astype(np.float32) * d ** -0.5
    b = rng.uniform(-1, 1, (3 * seg,)).astype(np.float32) * d ** -0.5
    g = rng.standard_normal((B, n, 3 * seg)).astype(np.float32)
    want = _jax_grads(lambda *a: jfl.ln_mod_matmul(*a, 64), [h, sc, sh, w, b], g)

    def port(h, sc, sh, wt, b):  # q, k, v as three linears of the port's layout
        ps = [{"w": wt[i * seg:(i + 1) * seg], "b": b[i * seg:(i + 1) * seg]} for i in range(3)]
        return fused_linears.ln_mod_matmul(h, sc, sh, ps)

    got = _port_grads(port, [h, sc, sh, np.ascontiguousarray(w.T), b], g)
    got[3] = got[3].T
    for gv, wv in zip(got, want):
        assert rel_err(gv, wv) < FP32_REL


def test_kernel_8_vjp_matches_jax():
    rng = _rng(1)
    B, n, din, d = 2, 64, 256, 128
    a = rng.standard_normal((B, n, din)).astype(np.float32)
    h = rng.standard_normal((B, n, d)).astype(np.float32)
    gate = rng.uniform(-1, 1, (d,)).astype(np.float32)
    w = rng.uniform(-1, 1, (din, d)).astype(np.float32) * din ** -0.5
    b = rng.uniform(-1, 1, (d,)).astype(np.float32) * din ** -0.5
    g = rng.standard_normal((B, n, d)).astype(np.float32)
    want = _jax_grads(lambda *x: jfl.proj_gated_residual(*x, 64), [a, h, gate, w, b], g)
    got = _port_grads(lambda a, h, gate, wt, b: fused_linears.proj_gated_residual(
        a, h, gate, {"w": wt, "b": b}), [a, h, gate, np.ascontiguousarray(w.T), b], g)
    got[3] = got[3].T
    for gv, wv in zip(got, want):
        assert rel_err(gv, wv) < FP32_REL


@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_kernel_18_vjp_matches_jax(pe_attn_head):
    """No gradient flows to kv_lens, cos or sin (the JAX _fpr_bwd gives zeros)."""
    rng = _rng(2)
    b, h, n, d = 2, 2, 256, 64
    lens = np.array([200, 256], np.int32)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    cos, sin = rope_cos_sin(n, d)
    want = _jax_grads(lambda q, k, v: jfp.flash_prefix_rope_attention(
        q, k, v, jnp.asarray(lens), jnp.asarray(cos), jnp.asarray(sin), pe_attn_head, 128, 128,
        False), [q, k, v], g)
    tc, ts = t(cos).requires_grad_(True), t(sin)
    got = _port_grads(lambda q, k, v: flash_prefix.flash_prefix_rope_attention(
        q, k, v, t(lens), tc, ts, pe_attn_head), [q, k, v], g)
    for gv, wv in zip(got, want):
        assert rel_err(gv, wv) < FP32_REL
    assert tc.grad is None


@pytest.mark.parametrize("pe_attn_head", [None, 1])
def test_kernel_19_vjp_matches_jax(pe_attn_head):
    rng = _rng(3)
    b, heads, n, dh = 2, 2, 256, 64
    lens = np.array([130, 256], np.int32)
    qkv = rng.standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    g = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    cos, sin = rope_cos_sin(n, dh)
    want = _jax_grads(lambda x: jfp.flash_prefix_qkv_attention(
        x, jnp.asarray(lens), heads, jnp.asarray(cos), jnp.asarray(sin), pe_attn_head, 128, 128),
        [qkv], g)
    got = _port_grads(lambda x: flash_prefix.flash_prefix_qkv_attention(
        x, t(lens), heads, t(cos), t(sin), pe_attn_head), [qkv], g)
    assert rel_err(got[0], want[0]) < FP32_REL


def test_plain_formulations_pass_gradcheck_in_float64():
    """The functions the four backward passes differentiate, at a few
    elements an input (gradcheck's numerical Jacobian costs two forwards an
    input element)."""
    rng = _rng(4)
    f64 = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)  # noqa: E731
    h, sc, sh = f64(1, 3, 8), f64(8), f64(8)
    w, b = f64(8, 8), f64(8)
    assert torch.autograd.gradcheck(lambda h, sc, sh, w, b: fused_linears.ln_mod_matmul_xla(
        h, sc, sh, [{"w": w, "b": b}]), (h, sc, sh, w, b))
    a, gate = f64(1, 3, 8), f64(8)
    assert torch.autograd.gradcheck(lambda a, h, gate, w, b: fused_linears.proj_gated_xla(
        a, h, gate, {"w": w, "b": b}), (a, h, gate, w, b))
    n, d = 5, 4
    q, k, v = f64(1, 2, n, d), f64(1, 2, n, d), f64(1, 2, n, d)
    cos, sin = (torch.from_numpy(x).double() for x in rope_cos_sin(n, d))
    lens = torch.tensor([4])
    assert torch.autograd.gradcheck(lambda q, k, v: flash_prefix._xla_rope_prefix(
        q, k, v, lens, cos, sin, 1), (q, k, v))
    qkv = f64(1, n, 3 * 2 * d)
    assert torch.autograd.gradcheck(lambda x: flash_prefix._xla_rope_prefix(
        *flash_prefix.qkv_unpack(x, 2), lens, cos, sin, None), (qkv,))


def test_forward_only_kernels_still_raise_under_a_gradient():
    """14 and its pass, 4, 5, 6 and 9 have no backward (nor do the JAX kernels)."""
    rng = _rng(5)
    x = t(rng.standard_normal((1, 8, 128)).astype(np.float32)).requires_grad_(True)
    vec = t(rng.standard_normal((128,)).astype(np.float32))
    q8 = quantize_linear({"w": t(rng.standard_normal((128, 128)).astype(np.float32)),
                          "b": vec.clone()})
    q = t(rng.standard_normal((1, 2, 64, 64)).astype(np.float32)).requires_grad_(True)
    calls = {
        "flash_prefix_attention_i8": lambda: flash_prefix.flash_prefix_attention_i8(
            q, q, q, torch.tensor([64])),
        "ff_block_fused_int8": lambda: ff_block.ff_block_fused_int8(x, vec, vec, vec, q8, q8),
        "ln_mod_matmul_int8": lambda: fused_linears.ln_mod_matmul_int8(x, vec, vec, [q8]),
        "proj_gated_residual_int8": lambda: fused_linears.proj_gated_residual_int8(
            x, x, vec, q8),
        "qmatmul": lambda: qmatmul.qmatmul(x[0], q8["w_int8"], q8["w_scale"], q8["b"]),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="forward-only"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all(), name


# --- training through each attn_path; "dots" ---------------------------------------


def _model(seed=0, **flags):
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), JaxDiTConfig(**ARCH)))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    return pckpt.params_from_jax(flat, device="cpu"), DiTConfig(**ARCH, **flags)


def _batch():
    rng = _rng(6)
    lens = np.array([128, 90], np.int32)
    text = np.full((2, 16), -1, np.int32)
    text[0, :12], text[1, :7] = rng.integers(0, 19, 12), rng.integers(0, 19, 7)
    return {"mel": t(rng.standard_normal((2, 128, 8)).astype(np.float32)), "text": t(text),
            "lens": t(lens)}


@pytest.mark.parametrize("attn_path", ["linear_fused", "rope_in_kernel", "qkv_kernel"])
def test_a_step_trains_through_each_attn_path(attn_path, monkeypatch):
    """dit_forward under each opt-in attn_path takes its kernels' autograd
    Functions (7 and 8 once per item around 10, 11, 13; 18; 19) and gives
    the default path's loss and gradient."""
    seen = []
    name = {"linear_fused": "_ln_mod_matmul_fwd", "rope_in_kernel": "_rope_fwd",
            "qkv_kernel": "_qkv_fwd"}[attn_path]
    mod = fused_linears if attn_path == "linear_fused" else flash_prefix
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: seen.append(1) or orig(*a))
    params, arch = _model()
    want_loss, want = pstep.loss_and_grads(params, _batch(), 3, arch)
    got_loss, got = pstep.loss_and_grads(params, _batch(), 3, arch, attn_path=attn_path)
    b = _batch()["mel"].shape[0]  # 7 launches once per item (one modulation a launch)
    assert len(seen) == ARCH["depth"] * (b if attn_path == "linear_fused" else 1)
    assert abs(float(got_loss) - float(want_loss)) <= FP32_REL * float(want_loss)
    assert rel_err(torch.cat([g.ravel() for g in got]).numpy(),
                   torch.cat([g.ravel() for g in want]).numpy()) < FP32_REL


@pytest.mark.parametrize("attn_path", ["default", "linear_fused"])
def test_dots_equals_full_and_keeps_the_kernel_outputs(attn_path, monkeypatch):
    """A step's loss and gradient under "dots" equal "full" remat's (dropout
    on: the generators are made inside the recomputed function); the
    launches of kernels 10 (and 7, 8) are kept, not run again."""
    calls = {"lse": 0, "lmm": 0}
    lse, lmm = flash_prefix.flash_prefix_folded_lse, fused_linears._ln_mod_matmul_fwd

    def count_lse(*a):
        calls["lse"] += 1
        return lse(*a)

    def count_lmm(*a):
        calls["lmm"] += 1
        return lmm(*a)

    monkeypatch.setattr(flash_prefix, "flash_prefix_folded_lse", count_lse)
    monkeypatch.setattr(fused_linears, "_ln_mod_matmul_fwd", count_lmm)
    out = {}
    for policy in ("full", "dots"):
        params, arch = _model(checkpoint_activations=True, remat_policy=policy)
        calls.update(lse=0, lmm=0)
        out[policy] = pstep.loss_and_grads(params, _batch(), 4, arch, attn_path=attn_path)
        out[policy + "_calls"] = dict(calls)
    assert float(out["dots"][0]) == float(out["full"][0])
    for a, b in zip(out["dots"][1], out["full"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    per_pass = ARCH["depth"] * (2 if attn_path == "linear_fused" else 1)  # 7 per item
    key = "lmm" if attn_path == "linear_fused" else "lse"
    assert out["full_calls"][key] == 2 * per_pass  # the forward and its recompute
    assert out["dots_calls"][key] == per_pass


# --- wandb and sample logging ----------------------------------------------------------


class _Data:
    def __init__(self, n=6):
        rng = _rng(7)
        self.items = [{"mel_spec": rng.standard_normal((8, 24 + 4 * (i % 3))).astype(np.float32),
                       "text": [1 + i % 5, 2, 3]} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def get_frame_len(self, i):
        return self.items[i]["mel_spec"].shape[1]

    def __getitem__(self, i):
        return self.items[i]


def _stub_wandb(monkeypatch) -> list:
    log = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: log.append(("init", kw))
    stub.log = lambda d, step: log.append(("log", step, d))
    stub.Audio = lambda audio, sample_rate: ("audio", tuple(audio.shape), sample_rate)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return log


def _trainer(tmp_path, **kw):
    params, _ = _model()
    small = DiTConfig(**dict(ARCH, dropout=0.0))
    return Trainer(params, small, epochs=1, learning_rate=1e-3, num_warmup_updates=1,
                   batch_size_per_gpu=64, batch_size_type="frame", max_samples=2,
                   checkpoint_path=str(tmp_path), last_per_updates=1000,
                   tokenize_fn=lambda x: x, **kw)


def test_wandb_logger_and_sample_logging(tmp_path, monkeypatch):
    """logger="wandb" (trainer.py:77-91, 165-176) logs the loss through wandb;
    log_samples calls sample_fn(ema_params, update) at every save and logs
    its audio (trainer.py:374-385)."""
    log = _stub_wandb(monkeypatch)
    seen = []

    def sample_fn(ema, update):
        seen.append((update, sorted(ema) == sorted(_model()[0])))
        return np.zeros(2400, np.float32), 24_000

    tr = _trainer(tmp_path, logger="wandb", save_per_updates=1, log_samples=True,
                  sample_fn=sample_fn)
    tr.train(_Data(), max_updates=2, log_every=1)
    assert log[0][0] == "init"
    assert [e[1] for e in log if e[0] == "log" and "loss" in e[2]] == [1, 2]
    assert [e[2]["sample"] for e in log if e[0] == "log" and "sample" in e[2]] == [
        ("audio", (1, 2400), 24_000)] * 2
    assert seen == [(1, True), (2, True)]


def test_sample_logging_survives_a_failing_sampler_and_a_missing_wandb(tmp_path, monkeypatch,
                                                                       capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError

    def broken(ema, update):
        raise RuntimeError("no vocoder")

    tr = _trainer(tmp_path, logger="wandb", save_per_updates=1, log_samples=True,
                  sample_fn=broken)
    assert tr.writer is None
    assert tr.train(_Data(), max_updates=1)["updates"] == 1
    out = capsys.readouterr().out
    assert "wandb package is not installed" in out and "sample logging failed" in out


def test_trainer_writes_and_resumes_a_sharded_checkpoint_on_one_process(tmp_path):
    """ckpt_format="orbax" without a mesh: a torch.distributed.checkpoint
    directory, resumed by a new Trainer at its update with equal weights."""
    tr = _trainer(tmp_path, logger=None, save_per_updates=1000, ckpt_format="orbax")
    tr.train(_Data(), max_updates=2)
    assert (tmp_path / "model_last_orbax" / ".metadata").exists()
    again = _trainer(tmp_path, logger=None, save_per_updates=1000, ckpt_format="orbax")
    assert again.load_checkpoint() == 2
    for a, b in ((tr.state.params, again.state.params),
                 (tr.state.opt_state["mu"], again.state.opt_state["mu"])):
        for x, y in zip(pckpt.flatten_tree(a).values(), pckpt.flatten_tree(b).values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert again.state.opt_state["count"] == tr.state.opt_state["count"] == 2


def test_bench_train_remat_dots_and_io_overlap_on_the_cpu():
    out = bench_train.run(frames=64, seq_len=64, iters=1, device="cpu", dim=64, depth=1,
                          remat="dots")
    assert "remat dots" in out["unit"] and out["value"] > 0
    # the overlap measurement's own loop, around a step that costs nothing
    io = bench_train._io_overlap(lambda seed: torch.zeros(()), lambda: None, 1, 16, _rng(8),
                                 steps=2)
    assert io["io_sync_step_ms"] > 0 and io["io_prefetch_step_ms"] > 0
    assert io["io_overlap_gain"] > 0

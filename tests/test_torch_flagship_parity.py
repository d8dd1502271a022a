"""The port's flagship parity protocol (korean_f5_tts_tpu_torch/scripts/
flagship_parity.py) against the JAX package, on the CPU.

The repository's scripts/flagship_parity.py writes PARITY_FLAGSHIP.json from
every mode, so no test here calls its modes: its inputs are taken by
executing the statements that make them, cut from the script's own source,
and its functions' counterparts are the JAX package's cfm_sample,
quantize_params and train_step, called directly. The models are tiny DiTs
(dim 64, depth 2) with the F5TTS_Base flags (text_mask_padding False,
pe_attn_head 1); on the CPU the port takes its kernels' plain versions.

Tolerances, with their reasons:
  - the corpus, the noise and the cond are equal to the bit: the same numpy
    and torch calls;
  - the fp32 mel: relative L2 1e-5 (fp32 summation order, depth 2);
  - the bf16 and int8 mels: relative L2 2e-3. Both samplers keep cond's
    fp32 beside the narrow weights, so only the bf16 text embedding rounds
    below fp32, and XLA on the CPU rounds its ConvNeXt chain at other points
    than PyTorch (measured 7.1e-4 and 7.7e-4; given JAX's text embedding the
    rest of the sampler agrees at 2e-7); a deviation the port reports and
    the same deviation of the JAX mels differ by at most 5e-2 in rel;
  - each fast mode's MAE against fp32: within 1.25x of the JAX sampler's
    (measured 1.035x bf16, 1.038x int8);
  - three fp32 training steps: loss 1e-5, mu, nu and the parameters' change
    relative L2 1e-4, the fp32 bounds of tests/test_torch_train.py;
  - trained_int8: rel 1e-2 for bf16 and int8, the script's north star.
"""

import ast
import contextlib
import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_util import jax_draws, redraw_zero_layers, rel_err
from korean_f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.models import quant as jquant
from korean_f5_tts_tpu.train import checkpoint as jckpt
from korean_f5_tts_tpu.train import step as jstep
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import flagship_parity as fp
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "flagship_parity.py"
PARITY = ROOT / "PARITY_FLAGSHIP.json"
# one head of 64: int8 attention takes head dims 64 and 128 only
TINY = dict(fp.FLAGSHIP, dim=64, depth=2, heads=1, dim_head=64, text_dim=32, conv_layers=2)
# the sampling case: n a whole duration bucket, as the protocol's 1536 of 512
N, COND, N_TEXT, BUCKET = 256, 48, 40, 256
# the training case: a corpus cut to 2 x 120 frames padded to 128
B, FRAMES, PAD, TEXT = 2, 120, 128, 16


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_launch_counts()
    yield
    torch.set_num_threads(before)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


# --- the script's own inputs ----------------------------------------------------


def _assigned(stmt) -> set[str]:
    names = set()
    for target in getattr(stmt, "targets", ()):
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                names.add(node.id)
    return names


def _function(name: str) -> ast.FunctionDef:
    tree = ast.parse(SCRIPT.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _run_statements(func: str, first: str, last: str, ns: dict) -> dict:
    """Execute the statements of the script's function `func` from the one
    that assigns `first` to the one that assigns `last`, in ns."""
    body = _function(func).body
    start = next(i for i, s in enumerate(body) if first in _assigned(s))
    stop = next(i for i, s in enumerate(body) if i >= start and last in _assigned(s))
    code = compile(ast.Module(body=body[start:stop + 1], type_ignores=[]), str(SCRIPT), "exec")
    with torch.random.fork_rng():  # the script seeds torch's default generator
        exec(code, ns)
    return ns


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_corpus_and_noise_equal_the_scripts_to_the_bit():
    ns = _run_statements("mode_trained_flagship", "rng", "text_np", {"np": np})
    corpus = fp.make_corpus()
    _equal(corpus["mel"], ns["mel"])
    _equal(corpus["frames"], ns["mel_np"])
    _equal(corpus["text"], ns["text_np"])
    _equal(corpus["lens"], np.full((ns["b"],), ns["n_frames"], np.int32))
    # the trained weights' sampling inputs: cond from the corpus, the noise
    _run_statements("mode_trained_flagship", "n", "y0", ns)
    assert (ns["n"], ns["cond_len"], ns["steps"], ns["seed"]) == (
        fp.N, fp.COND_LEN, fp.NFE, fp.NOISE_SEED)
    _equal(corpus["frames"][0:1, :fp.COND_LEN], ns["cond"])
    _equal(fp.card_text(), ns["text"])
    _equal(fp.draw_y0(fp.N), ns["y0"])


def test_card_inputs_and_protocol_equal_the_scripts():
    ns = _run_statements("mode_tpu", "n", "y0", {"np": np, "torch": torch})
    cond, text, y0 = fp.card_inputs()
    _equal(cond, ns["cond"])
    _equal(text, ns["text"])
    _equal(y0, ns["y0"])
    tree = ast.parse(SCRIPT.read_text())
    flagship = next(s for s in tree.body if "FLAGSHIP" in _assigned(s))
    assert eval(compile(ast.Expression(flagship.value), str(SCRIPT), "eval")) == fp.FLAGSHIP
    call = next(n for n in ast.walk(_function("mode_tpu")) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "cfm_sample")
    consts = {}
    for k in call.keywords:
        with contextlib.suppress(ValueError):  # the names: steps, y0
            consts[k.arg] = ast.literal_eval(k.value)
    assert consts == {**fp.SAMPLER, "duration_bucket": fp.BUCKET}


# --- sampling: fast_mode_deviation against the JAX sampler ----------------------


@pytest.fixture(scope="module")
def jax_flat():
    """One tiny DiT of the JAX package's init_dit (jitted: one compile), its
    AdaLN-zero layers re-drawn, as flat numpy leaves; dropout and remat do
    not change the tree, so the training case takes it too."""
    flat = jckpt.flatten_tree(jax.jit(jdit.init_dit, static_argnums=1)(
        jax.random.PRNGKey(0), JaxDiTConfig(**TINY)))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 100)


@pytest.fixture(scope="module")
def sampled(jax_flat):
    """The port's entry and mels, and the JAX package's fp32, bf16 and int8
    mels, on the tiny DiT."""
    torch.set_num_threads(2)
    jcfg, flat = JaxDiTConfig(**TINY), jax_flat
    jp32 = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_tree(flat))
    jbf16 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, jp32)
    cond, text, y0 = fp.card_inputs(N, COND, N_TEXT)
    jax_mels = {}
    for mode, p in (("fp32", jp32), ("bf16", jbf16), ("int8", jquant.quantize_params(jbf16))):
        got, _ = jcfm.cfm_sample(p, jcfg, cond, text, N, steps=fp.NFE, y0=y0,
                                 duration_bucket=BUCKET, **fp.SAMPLER)
        jax_mels[mode] = np.asarray(got).astype(np.float32)
    entry, mels = fp.fast_mode_deviation(pckpt.params_from_jax(flat, device="cpu"),
                                         fp.flagship_cfg(**TINY), cond, text, y0,
                                         duration_bucket=BUCKET, log=lambda msg: None)
    return entry, mels, jax_mels


@pytest.mark.parametrize("mode,bound", [("fp32", 1e-5), ("bf16", 2e-3), ("int8", 2e-3)])
def test_fast_mode_mels_match_the_jax_sampler(sampled, mode, bound):
    entry, mels, jax_mels = sampled
    assert mels[mode].shape == jax_mels[mode].shape == (1, N, 100)
    assert rel_err(mels[mode], jax_mels[mode]) < bound, mode
    assert entry["launches"][mode] == {}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_fast_mode_error_against_fp32_is_the_jax_samplers(sampled, mode):
    """The deviation a fast mode reports is the JAX sampler's: the port's
    MAE against its fp32 mel within 1.25x of JAX's against JAX's fp32."""
    _, mels, jax_mels = sampled
    ours = float(np.mean(np.abs(mels[mode] - mels["fp32"])))
    theirs = float(np.mean(np.abs(jax_mels[mode] - jax_mels["fp32"])))
    assert 0.0 < ours < 1.25 * theirs, (mode, ours, theirs)


@pytest.mark.parametrize("pair", ["bf16_vs_fp32", "int8_vs_fp32", "int8_vs_bf16"])
def test_reported_deviations_match_the_jax_ones(sampled, pair):
    entry, mels, jax_mels = sampled
    got, want = pair.split("_vs_")
    scale = float(np.mean(np.abs(jax_mels["fp32"])))
    mae = float(np.mean(np.abs(jax_mels[got] - jax_mels[want])))  # the script's arithmetic
    ours = fp.deviation(jax_mels[got], jax_mels[want], scale)
    np.testing.assert_allclose([ours["mel_mae"], ours["rel"]], [mae, mae / scale], rtol=1e-6)
    np.testing.assert_allclose(entry["mean_abs_mel_fp32"], scale, rtol=1e-5)
    assert abs(entry[pair]["rel"] - mae / scale) < 5e-2
    assert 0.0 < entry[pair]["rel"] < 5e-2 and 0.0 < entry[pair]["rel_l2"] < 5e-2


@pytest.mark.parametrize("run,key,modes", [
    (fp.run_card, "flagship_card_fast_modes", fp.CARD_MODES),
    (fp.run_card_int8attn, "flagship_card_int8_attn", fp.INT8ATTN_MODES)])
def test_seeded_modes_report_every_pair(run, key, modes):
    entry = run("cpu", cfg=fp.flagship_cfg(**TINY), n=N, cond_len=COND, n_text=N_TEXT,
                duration_bucket=BUCKET, log=lambda msg: None)[key]
    assert entry["device"] == "cpu" and entry["arch"]["dim"] == 64
    assert (entry["n"], entry["cond_len"], entry["nfe"]) == (N, COND, fp.NFE)
    assert entry["launches"] == {m: {} for m in ("fp32", *modes)}
    for mode in modes:
        r = entry[f"{mode}_vs_fp32"]
        assert 0.0 < r["rel"] < 5e-2 and 0.0 < r["rel_l2"] < 5e-2, mode
        np.testing.assert_allclose(r["rel"], r["mel_mae"] / entry["mean_abs_mel_fp32"])


# --- training: train_flagship against the JAX train_step ------------------------


def test_three_training_steps_match_jax_train_step(jax_flat):
    flags = dict(TINY, dropout=0.0, checkpoint_activations=True, remat_policy="dots")
    jcfg, flat = JaxDiTConfig(**flags), jax_flat
    corpus = fp.make_corpus(B, FRAMES, PAD, TEXT)
    jopt = jstep.make_optimizer(learning_rate=1e-4, warmup_updates=50, total_updates=800)
    jstate = jstep.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_tree(flat)), jopt, use_ema=False)
    jbatch = {k: jnp.asarray(corpus[k]) for k in ("mel", "text", "lens")}
    jlosses = []
    for i in range(3):
        jstate, loss = jstep.train_step(jstate, jbatch, jax.random.PRNGKey(i), jcfg, jopt,
                                        JaxCFMConfig())
        jlosses.append(float(loss))
    p0 = {k: np.asarray(v) for k, v in flat.items()}
    state, losses, _ = fp.train_flagship(
        pckpt.params_from_jax(flat, device="cpu"), fp.flagship_cfg(**flags), corpus, 3,
        compute_dtype=None, log=lambda msg: None,
        draws_of=lambda i: jax_draws(jax.random.PRNGKey(i), (B, PAD, 100), corpus["lens"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 3 and state.ema_params is None
    flat_j = {k: np.asarray(v) for k, v in jckpt.flatten_tree(jstate.params).items()}
    flat_p = pckpt.params_to_jax(state.params)
    assert flat_j.keys() == flat_p.keys()
    delta_p = np.concatenate([(flat_p[k] - p0[k]).ravel() for k in flat_j])
    delta_j = np.concatenate([(flat_j[k] - p0[k]).ravel() for k in flat_j])
    assert rel_err(delta_p, delta_j) < 1e-4
    leaves_j = jax.tree_util.tree_leaves(jstate.opt_state)
    leaves_p = pckpt.opt_state_to_leaves(state.opt_state)
    n = (len(leaves_j) - 2) // 2
    for sl in (slice(1, n + 1), slice(n + 1, 2 * n + 1)):  # mu, nu
        got = np.concatenate([x.ravel() for x in leaves_p[sl]])
        want = np.concatenate([np.asarray(x).ravel() for x in leaves_j[sl]])
        assert rel_err(got, want) < 1e-4


def test_trained_flagship_writes_and_reads_its_checkpoint(tmp_path):
    kw = dict(cfg=fp.flagship_cfg(**TINY), corpus=fp.make_corpus(B, FRAMES, PAD, TEXT), n=N,
              cond_len=COND, n_text=N_TEXT, duration_bucket=BUCKET, steps=4, log=lambda m: None,
              ckpt=tmp_path / "ckpts" / "trained.npz")
    steps_seen = []
    first = fp.run_trained_flagship("cpu", steps_trained=3,
                                    hold=lambda i, loss, n: steps_seen.append((i, n)), **kw)
    assert steps_seen == [(0, {}), (1, {}), (2, {})]
    trained = first["flagship_trained_fast_modes_vs_fp32"]
    assert trained["steps_trained"] == 3 and len(trained["loss_every_100"]) == 1
    assert trained["adaln_attn_mod_w_mean_abs"] > 0.0  # the gates left zero
    assert {f"{m}_vs_fp32" for m in fp.MODES} <= trained.keys()
    headline = first["flagship_trained_headline_mode"]
    assert headline["stack"] == {"weights": "int8 (quantize_params, all block linears)",
                                 "attn_path": "default", "attn_int8": None}
    assert headline["rel"] == trained["int8_vs_fp32"]["rel"]
    assert pckpt.load_checkpoint(str(kw["ckpt"]), device="cpu")["update"] == 3
    # the same step count reads the weights back: no training, the same mels
    again = fp.run_trained_flagship("cpu", steps_trained=3, **kw)
    read = again["flagship_trained_fast_modes_vs_fp32"]
    assert "loss_first" not in read and read["int8_vs_fp32"] == trained["int8_vs_fp32"]
    # another step count trains anew and replaces the file
    fp.run_trained_flagship("cpu", steps_trained=1, **kw)
    assert pckpt.load_checkpoint(str(kw["ckpt"]), device="cpu")["update"] == 1


# --- trained_int8 through main, and what main writes ----------------------------


@pytest.fixture(scope="module")
def trained_int8(tmp_path_factory):
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("flagship") / "parity.json"
    before = PARITY.read_bytes()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        merged = fp.main(["--mode", "trained_int8", "--device", "cpu", "--out", str(out)])
    return merged, stdout.getvalue(), out, before


def test_trained_int8_loss_falls_and_fast_modes_meet_the_north_star(trained_int8):
    entry = trained_int8[0]["trained_weights_fast_modes_vs_fp32"]
    assert entry["steps_trained"] == 400 and entry["device"] == "cpu"
    assert entry["loss_last"] < 0.1 * entry["loss_first"]
    for mode in ("bf16", "int8"):
        assert entry[f"{mode}_vs_fp32"]["rel"] < 1e-2, mode
    assert entry["launches"] == {"fp32": {}, "bf16": {}, "int8": {}}


def test_main_writes_only_to_out(trained_int8, tmp_path, monkeypatch):
    merged, stdout, out, parity_before = trained_int8
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    assert lines == [merged] and json.loads(out.read_text()) == merged
    assert PARITY.read_bytes() == parity_before

    def ckpts():
        return sorted((ROOT / "ckpts").rglob("*")) if (ROOT / "ckpts").exists() else []

    parity = hashlib.sha256(PARITY.read_bytes()).hexdigest()
    ckpts_before = ckpts()
    monkeypatch.chdir(tmp_path)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        fp.main(["--mode", "trained_int8", "--device", "cpu", "--steps_trained", "2"])
    assert len(stdout.getvalue().splitlines()) == 4  # fp32, bf16, int8 done; the JSON
    assert list(tmp_path.iterdir()) == []
    assert ckpts() == ckpts_before
    assert hashlib.sha256(PARITY.read_bytes()).hexdigest() == parity


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (fp.run_card, fp.run_card_int8attn, fp.run_trained_flagship, fp.run_trained_int8):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp.main(["--mode", "card"])

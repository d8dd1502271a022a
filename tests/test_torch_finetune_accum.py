"""Gradient accumulation in the port (train/step.py:MultiSteps) against the
JAX package's optax.MultiSteps, on the CPU.

A tiny DiT (dim 64, depth 2, AdaLN-zero layers re-drawn, dropout off) takes
4 mini-steps at k = 2 on four batches, the loss's draws made by the JAX
package (tests/test_torch_train.py:_jax_draws) and handed to the port. The
weights must stay exactly as they were after mini-steps 1 and 3 and move
after 2 and 4 in both packages; the counts follow MultiStepsState
(mini_step, gradient_step, the inner adam and schedule counts). Tolerance:
params, EMA and every optimizer leaf (mu, nu, acc_grads, by group) relative
L2 1e-5 against JAX (fp32). A checkpoint written after mini-step 3, mid-
accumulation, by either package resumes in the other and ends within the
same bound of the uninterrupted run; resumed in the package that wrote it,
it ends equal to the bit.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from _torch_port_util import TINY, redraw_zero_layers, rel_err, t
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.data import dataset as jds
from korean_f5_tts_tpu.models import dit as jdit
from korean_f5_tts_tpu.train import checkpoint as jckpt
from korean_f5_tts_tpu.train import step as jstep
from korean_f5_tts_tpu.train.trainer import Trainer as JaxTrainer
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.data import dataset as pds
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train import checkpoint as pckpt
from korean_f5_tts_tpu_torch.train import step as pstep
from korean_f5_tts_tpu_torch.train.trainer import Trainer
from test_torch_train import TINY_T, _jax_draws, _mel_rows, _tiny_t_params, _trainer_kw

REL = 1e-5
K = 2
B, N = 2, 128
LENS = np.asarray([128, 90], np.int32)
KW = dict(learning_rate=1e-3, warmup_updates=2, total_updates=10)


@pytest.fixture(autouse=True)
def _no_launches():
    reset_launch_counts()
    yield
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _params():
    jcfg = JaxDiTConfig(**TINY, dropout=0.0)
    flat = jckpt.flatten_tree(jdit.init_dit(jax.random.PRNGKey(0), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, 100)
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_tree(flat))
    return jcfg, DiTConfig(**TINY, dropout=0.0), jparams, pckpt.params_from_jax(flat, device="cpu")


def _batch(i: int) -> dict:
    rng = np.random.default_rng(10 + i)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    mel[1, LENS[1]:] = 0.0
    text = np.full((B, 32), -1, np.int32)
    text[0, :21] = rng.integers(0, 49, 21)
    text[1, :14] = rng.integers(0, 49, 14)
    return {"mel": mel, "text": text, "lens": LENS}


JOPT = optax.MultiSteps(jstep.make_optimizer(**KW), K)  # one object: one compile


def _jax_step(state, i: int):
    return jstep.train_step(state, {k: jnp.asarray(v) for k, v in _batch(i).items()},
                            jax.random.PRNGKey(30 + i), _params()[0], JOPT)[0]


def _port_step(state, i: int, opt):
    batch = {k: t(v) for k, v in _batch(i).items()}
    draws = _jax_draws(jax.random.PRNGKey(30 + i), (B, N, 100), LENS)
    return pstep.train_step(state, batch, 0, _params()[1], opt, draws=draws)[0]


def _flat_jax(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def _assert_close(pstate, jstate, bound=REL):
    """Params, EMA and the optimizer leaves, group by group."""
    for name, got, want in (("params", pckpt.params_to_jax(pstate.params),
                             _flat_jax(jstate.params)),
                            ("ema", pckpt.params_to_jax(pstate.ema_params),
                             _flat_jax(jstate.ema_params))):
        assert got.keys() == want.keys()
        assert rel_err(np.concatenate([got[k].ravel() for k in want]),
                       np.concatenate([want[k].ravel() for k in want])) < bound, name
    leaves_p = pckpt.opt_state_to_leaves(pstate.opt_state)
    leaves_j = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.opt_state)]
    assert len(leaves_p) == len(leaves_j)
    n = (len(leaves_j) - 4) // 3
    for i in (0, 1, 2, 2 * n + 3):  # mini_step, gradient_step, adam count, schedule count
        assert int(leaves_p[i]) == int(leaves_j[i]), i
    for name, sl in (("mu", slice(3, n + 3)), ("nu", slice(n + 3, 2 * n + 3)),
                     ("acc_grads", slice(2 * n + 4, None))):
        got = np.concatenate([x.ravel() for x in leaves_p[sl]])
        want = np.concatenate([x.ravel() for x in leaves_j[sl]])
        if not want.any():
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert rel_err(got, want) < bound, name


def test_multisteps_matches_optax_over_four_mini_steps():
    _, _, jparams, pparams = _params()
    popt = pstep.MultiSteps(pstep.make_optimizer(**KW), K)
    jstate = jstep.init_train_state(jparams, JOPT)
    pstate = pstep.init_train_state(pparams, popt)
    for i in range(4):
        before_j, before_p = _flat_jax(jstate.params), pckpt.params_to_jax(pstate.params)
        before_p = {k: v.copy() for k, v in before_p.items()}
        jstate, pstate = _jax_step(jstate, i), _port_step(pstate, i, popt)
        after_j, after_p = _flat_jax(jstate.params), pckpt.params_to_jax(pstate.params)
        emit = (i + 1) % K == 0
        for before, after in ((before_j, after_j), (before_p, after_p)):
            moved = [not np.array_equal(before[k], after[k]) for k in before]
            assert (any(moved) if emit else not any(moved)), i  # only the k-th moves them
        assert pstate.opt_state["mini_step"] == (i + 1) % K
        assert pstate.opt_state["gradient_step"] == (i + 1) // K
        assert pstate.opt_state["inner"]["sched_count"] == (i + 1) // K
        assert pstate.step == i + 1
        _assert_close(pstate, jstate)
    # the EMA moved on every mini-step, the weights on two of them
    assert not np.array_equal(pckpt.params_to_jax(pstate.ema_params)["proj_out/w"],
                              pckpt.params_to_jax(pparams)["proj_out/w"])


def test_the_accumulator_is_a_running_mean():
    """acc + (g - acc) / (mini_step + 1): after k mini-steps the inner
    optimizer saw the mean of the k gradients (not their sum)."""
    params = {"w": t(np.zeros(3, np.float32))}
    opt = pstep.MultiSteps(pstep.PlainAdamW(learning_rate=1.0, weight_decay=0.0), 3)
    state = opt.init(params)
    grads = [np.asarray(g, np.float32) for g in ([3.0, -3.0, 1.0], [6.0, 0.0, 1.0],
                                                 [0.0, 3.0, 1.0])]
    w = [params["w"]]
    for i, g in enumerate(grads[:2]):
        opt.update_(w, [t(g)], state, ["w"])
        np.testing.assert_allclose(state["acc_grads"]["w"].numpy(),
                                   np.mean(grads[:i + 1], axis=0), rtol=1e-6)
        assert not w[0].any() and state["inner"]["count"] == 0
    opt.update_(w, [t(grads[2])], state, ["w"])
    # Adam's first update is -lr * g / (|g| + eps), the sign of the mean gradient (up to
    # the fp32 rounding of the bias correction 1 - 0.999, which optax shares)
    np.testing.assert_allclose(w[0].numpy(), -np.sign(np.mean(grads, axis=0)), rtol=1e-4)
    assert not state["acc_grads"]["w"].any() and state["inner"]["count"] == 1
    assert state["mini_step"] == 0 and state["gradient_step"] == 1


def _save_jax(path, state):
    jckpt.save_checkpoint(path, jax.tree_util.tree_map(np.asarray, state.params),
                          opt_state=jax.tree_util.tree_map(np.asarray, state.opt_state),
                          ema_params=jax.tree_util.tree_map(np.asarray, state.ema_params),
                          update=3)


def _load_jax(path):
    data = jckpt.load_checkpoint(path)
    structure = jax.tree_util.tree_structure(JOPT.init(_params()[2]))
    opt = jax.tree_util.tree_unflatten(structure, [jnp.asarray(x) for x in data["opt_leaves"]])
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    return jstep.TrainState(as_jax(data["params"]), opt, as_jax(data["ema_params"]),
                            jnp.asarray(3, jnp.int32))


def _load_port(path):
    data = pckpt.load_checkpoint(path, device="cpu")
    opt = pckpt.opt_state_from_leaves(data["opt_leaves"], data["params"], device="cpu")
    return pstep.TrainState(data["params"], opt, data["ema_params"], 3)


def test_a_mid_accumulation_checkpoint_resumes_in_either_package(tmp_path):
    _, _, jparams, pparams = _params()
    popt = pstep.MultiSteps(pstep.make_optimizer(**KW), K)
    jstate = jstep.init_train_state(jparams, JOPT)
    pstate = pstep.init_train_state(pparams, popt)
    for i in range(3):
        jstate, pstate = _jax_step(jstate, i), _port_step(pstate, i, popt)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _save_jax(jpath, jstate)
    pckpt.save_checkpoint(ppath, pstate.params, opt_state=pstate.opt_state,
                          ema_params=pstate.ema_params, update=3)
    # the two files hold the same layout: MultiStepsState's leaves, in order
    jfile, pfile = dict(np.load(jpath)), dict(np.load(ppath))
    assert jfile.keys() == pfile.keys()
    assert pstate.opt_state["mini_step"] == 1 and pstate.opt_state["acc_grads"]["proj_out"][
        "w"].any()
    whole_j, whole_p = _jax_step(jstate, 3), _port_step(pstate, 3, popt)
    port_from_jax = _port_step(_load_port(jpath), 3, popt)
    jax_from_port = _jax_step(_load_jax(ppath), 3)
    _assert_close(port_from_jax, whole_j)
    _assert_close(whole_p, jax_from_port)
    # resumed in the package that wrote it: the uninterrupted run, to the bit
    own = _port_step(_load_port(ppath), 3, popt)
    for a, b in ((own.params, whole_p.params), (own.ema_params, whole_p.ema_params)):
        got, want = pckpt.params_to_jax(a), pckpt.params_to_jax(b)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(pckpt.opt_state_to_leaves(own.opt_state),
                    pckpt.opt_state_to_leaves(whole_p.opt_state), strict=True):
        np.testing.assert_array_equal(a, b)


def _acc_kw(ckpt_dir):
    return dict(_trainer_kw(ckpt_dir), grad_accumulation_steps=K, last_per_updates=3)


def test_trainer_accumulates_and_resumes_across_packages(tmp_path):
    """Trainer(grad_accumulation_steps=2): `update` counts mini-steps, 4 of
    them are 2 optimizer updates; a resume after mini-step 3 repeats the
    uninterrupted run; each package's Trainer resumes the other's file."""
    jparams, pparams = _tiny_t_params()
    arch = DiTConfig(**TINY_T)
    ds = pds.CustomDataset(_mel_rows(), preprocessed_mel=True)
    whole = Trainer(pparams, arch, **_acc_kw(str(tmp_path / "a")))
    res = whole.train(ds, resumable_with_seed=666, max_updates=4)
    state = whole.state.opt_state
    assert res["updates"] == 4 and whole.state.step == 4
    assert (state["mini_step"], state["gradient_step"], state["inner"]["count"],
            state["inner"]["sched_count"]) == (0, 2, 2, 2)
    first = Trainer(pparams, arch, **_acc_kw(str(tmp_path / "b")))
    first.train(ds, resumable_with_seed=666, max_updates=3)
    assert first.state.opt_state["mini_step"] == 1
    os.makedirs(tmp_path / "d")
    shutil.copy(tmp_path / "b" / "model_last.npz", tmp_path / "d" / "model_last.npz")
    second = Trainer(pparams, arch, **_acc_kw(str(tmp_path / "b")))
    again = second.train(ds, resumable_with_seed=666, max_updates=1)
    assert again["updates"] == 4 and again["losses"] == res["losses"][3:]
    for a, b in ((second.state.params, whole.state.params),
                 (second.state.ema_params, whole.state.ema_params)):
        got, want = pckpt.params_to_jax(a), pckpt.params_to_jax(b)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # the JAX Trainer resumes the port's mid-accumulation file, and the other way
    jres = JaxTrainer(jparams, JaxDiTConfig(**TINY_T), **_acc_kw(str(tmp_path / "d"))).train(
        jds.CustomDataset(_mel_rows(), preprocessed_mel=True), resumable_with_seed=666,
        max_updates=1)
    assert jres["updates"] == 4 and np.isfinite(jres["losses"]).all()
    JaxTrainer(jparams, JaxDiTConfig(**TINY_T), **_acc_kw(str(tmp_path / "c"))).train(
        jds.CustomDataset(_mel_rows(), preprocessed_mel=True), resumable_with_seed=666,
        max_updates=3)
    resumed = Trainer(pparams, arch, **_acc_kw(str(tmp_path / "c")))
    assert resumed.load_checkpoint() == 3
    assert (resumed.state.opt_state["mini_step"], resumed.state.opt_state["gradient_step"]) \
        == (1, 1)
    out = resumed.train(ds, resumable_with_seed=666, max_updates=1)
    assert out["updates"] == 4 and np.isfinite(out["losses"]).all()
    assert resumed.state.opt_state["gradient_step"] == 2


def test_trainer_refuses_the_optimizer_state_of_another_setting(tmp_path):
    _, pparams = _tiny_t_params()
    arch = DiTConfig(**TINY_T)
    ds = pds.CustomDataset(_mel_rows(), preprocessed_mel=True)
    Trainer(pparams, arch, **_trainer_kw(str(tmp_path))).train(ds, resumable_with_seed=666,
                                                               max_updates=2)
    with pytest.raises(ValueError, match="grad_accumulation_steps"):
        Trainer(pparams, arch, **_acc_kw(str(tmp_path))).load_checkpoint()

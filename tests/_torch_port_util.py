"""Shared fixtures of the torch-port parity tests: one tiny model, built once
in the JAX package and handed to the port through the weight converter.

The AdaLN-zero layers are re-drawn (numpy, seeded) before anything is
compared: freshly initialised they gate every block off and make the mel
exactly zero, so a wrong port would still match.
"""

from __future__ import annotations

import functools
import math
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import torch

from korean_f5_tts_tpu import config as jconfig
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.mmdit import init_mmdit
from korean_f5_tts_tpu.models.unett import init_unett
from korean_f5_tts_tpu.models.vocos import VocosConfig as JaxVocosConfig
from korean_f5_tts_tpu.models.vocos import init_vocos as jax_init_vocos
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.models.vocos import VocosConfig
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32,
            conv_layers=2, text_num_embeds=50)
TINY_VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
ZERO_INIT = ("attn_norm/linear/", "norm_out/linear/", "proj_out/")


def tiny_configs():
    return JaxDiTConfig(**TINY), DiTConfig(**TINY)


def redraw_zero_layers(flat: dict, seed: int) -> dict:
    """Uniform +-1/sqrt(d_in) for every AdaLN-zero leaf (JAX [d_in, d_out])."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    weights = {k: v for k, v in flat.items() if k.endswith("/w")}
    for k, v in flat.items():
        if any(z in k for z in ZERO_INIT):
            d_in = weights[k[:-1] + "w"].shape[0]
            bound = 1.0 / math.sqrt(d_in)
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
    return out


@functools.lru_cache(maxsize=4)
def tiny_dit(seed: int = 0):
    """(jax params, port params, flat numpy params) of one tiny DiT; cached, so
    callers must not modify them."""
    jcfg, _ = tiny_configs()
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), jcfg))
    flat = redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    return jparams, params_from_jax(flat, device="cpu"), flat


@functools.lru_cache(maxsize=2)
def tiny_vocos(seed: int = 1):
    """(jax config, jax params, port config, port params) of one tiny Vocos."""
    jcfg = JaxVocosConfig(**TINY_VOCOS)
    flat = {k: np.asarray(v) for k, v in
            flatten_tree(jax_init_vocos(jax.random.PRNGKey(seed), jcfg)).items()}
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    return jcfg, jparams, VocosConfig(**TINY_VOCOS), params_from_jax(flat, device="cpu")


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def t(x) -> torch.Tensor:
    """numpy -> torch (copy)."""
    return torch.from_numpy(np.array(x))


def _f32(x) -> torch.Tensor:
    return t(np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32)))


def jax_draws(key, shape, lens, dtype=jax.numpy.float32, cfm=None):
    """cfm_loss's draws with its own jax.random calls (cfm.py:96-117,
    misc.py:61), as the port's draw dict (models/cfm.py:draw_cfm's keys)."""
    from korean_f5_tts_tpu.config import CFMConfig as JaxCFMConfig
    from korean_f5_tts_tpu_torch.utils.misc import span_start_end

    cfm = cfm or JaxCFMConfig()
    b = shape[0]
    k_frac, k_span, k_x0, k_time, k_drop1, k_drop2, _ = jax.random.split(key, 7)
    frac = jax.random.uniform(k_frac, (b,), minval=cfm.frac_lengths_mask[0],
                              maxval=cfm.frac_lengths_mask[1])
    rand = jax.random.uniform(k_span, frac.shape, dtype=frac.dtype)
    x0 = jax.random.normal(k_x0, shape, dtype)
    time = jax.random.uniform(k_time, (b,), dtype=dtype)
    drop_audio = jax.random.bernoulli(k_drop1, cfm.audio_drop_prob).astype(dtype)
    drop_both = jax.random.bernoulli(k_drop2, cfm.cond_drop_prob)
    tdt = torch.float32 if dtype == jax.numpy.float32 else torch.bfloat16
    start, end = span_start_end(t(lens), _f32(frac), _f32(rand))
    return {"frac_lengths": _f32(frac), "span_start": start, "span_end": end,
            "x0": _f32(x0).to(tdt), "time": _f32(time).to(tdt),
            "drop_audio": _f32(jax.numpy.where(drop_both, 1.0, drop_audio)).to(tdt),
            "drop_text": _f32(drop_both).to(tdt)}


# the three backbones at tiny widths (tests/test_torch_backbones_*.py)
BACKBONE_ARCH = {
    "DiT": dict(TINY),
    "UNetT": dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_num_embeds=50,
                  text_mask_padding=False),
    "MMDiT": dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_num_embeds=50),
}
BACKBONE_ZERO_INIT = ("attn_norm/linear/", "attn_norm_x/linear/", "attn_norm_c/linear/",
                      "norm_out/linear/", "proj_out/")


def backbone_pair(backbone: str, seed: int = 0, **flags):
    """(jax arch, port arch, jax params, port params, flat numpy params)."""
    kw = dict(BACKBONE_ARCH[backbone], **flags)
    jcfg = jconfig.BACKBONE_CONFIGS[backbone](**kw)
    pcfg = pconfig.BACKBONE_CONFIGS[backbone](**kw)
    init = {"DiT": jax_init_dit, "UNetT": init_unett, "MMDiT": init_mmdit}[backbone]
    flat = {k: np.asarray(v) for k, v in flatten_tree(init(jax.random.PRNGKey(seed), jcfg)).items()}
    rng = np.random.default_rng(seed + 100)
    for k, v in flat.items():
        if any(z in k for z in BACKBONE_ZERO_INIT):
            d_in = flat[k[:-1] + "w"].shape[0]
            flat[k] = rng.uniform(-1, 1, v.shape).astype(np.float32) / math.sqrt(d_in)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, unflatten_tree(flat))
    return jcfg, pcfg, jparams, params_from_jax(flat, device="cpu"), flat


# --- two processes on the CPU (tests/test_torch_parallel_*.py) -------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")


def start_two_processes(tmp_dir, cases: list, timeout: float = 300.0):
    """Start tests/_torch_parallel_worker.py in two gloo processes on `cases`
    ([(name, case function, kwargs)], kwargs numpy and plain values, with an
    optional "mesh_shape" (n_data, n_model), default (1, 2)) and return a
    function that waits for both and returns each rank's {name: result}, so
    the caller can work while they run. The processes find the port through
    PYTHONPATH (no install needed); both are killed past `timeout` seconds of
    waiting. Their output goes to files beside the job, never to a pipe that
    could fill while the caller works."""
    os.makedirs(tmp_dir, exist_ok=True)
    job = os.path.join(tmp_dir, "job.pkl")
    out = os.path.join(tmp_dir, "result")
    with open(job, "wb") as f:
        pickle.dump({"cases": cases, "out": out}, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2",
           "F5_TTS_DIST_COORDINATOR": f"localhost:{port}", "F5_TTS_DIST_NUM_PROCESSES": "2"}
    logs = [os.path.join(tmp_dir, f"log.{r}") for r in (0, 1)]
    procs = []
    for r in (0, 1):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, job], cwd=ROOT, text=True,
                                          env={**env, "F5_TTS_DIST_PROCESS_ID": str(r)},
                                          stdout=log, stderr=subprocess.STDOUT))

    def wait() -> list[dict]:
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            with open(log) as f:
                assert p.returncode == 0, f.read()[-4000:]
        results = []
        for r in (0, 1):
            with open(f"{out}.{r}", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def run_two_processes(tmp_dir, cases: list, timeout: float = 300.0) -> list[dict]:
    """start_two_processes and wait for the results."""
    return start_two_processes(tmp_dir, cases, timeout)()


# --- the eval and measuring entry points on the CPU (tests/test_torch_eval*.py) ---

EVAL_ARCH = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1,
                 text_num_embeds=256)


@functools.lru_cache(maxsize=1)
def eval_main_files() -> dict[str, str]:
    """Small inputs of the eval mains, written once per process into a fresh
    temporary directory: a tiny DiT's model config yaml and .npz (AdaLN-zero
    layers re-drawn), a tiny ECAPA-TDNN .npz, a reference wav, and empty
    metadata files (a main given those loads its model and scores nothing)."""
    import tempfile

    import yaml

    from korean_f5_tts_tpu_torch.eval.ecapa_tdnn import EcapaConfig, init_ecapa
    from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax

    d = tempfile.mkdtemp(prefix="eval_mains_")
    files = {"dir": d}
    files["yaml"] = os.path.join(d, "tiny.yaml")
    with open(files["yaml"], "w") as f:
        yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": EVAL_ARCH,
                                  "tokenizer": "custom"}}, f)
    params = redraw_zero_init(init_dit(DiTConfig(**EVAL_ARCH), seed=0, device="cpu"), seed=1)
    files["npz"] = os.path.join(d, "tiny.npz")
    np.savez(files["npz"], **{f"params/{k}": v for k, v in params_to_jax(params).items()})
    ecapa = init_ecapa(torch.Generator().manual_seed(0),
                       EcapaConfig(feat_dim=80, channels=16, emb_dim=12, res2_scale=4,
                                   se_bottleneck=8, attn_bottleneck=8), device="cpu")
    files["ecapa"] = os.path.join(d, "ecapa.npz")
    np.savez(files["ecapa"], **params_to_jax(ecapa))
    files["empty"] = os.path.join(d, "empty.txt")
    open(files["empty"], "w").close()
    return files

"""The flagship parity protocol on the card: each fast sampling mode (bf16
weights, int8 weights, int8 attention) against fp32 sampling at the
F5TTS_Base architecture, on seeded weights and on weights trained on the
card. Counterpart of the repository's scripts/flagship_parity.py, whose
protocol and mode names it keeps ("tpu" becomes "card"):

    python -m korean_f5_tts_tpu_torch.scripts.flagship_parity --mode card card_int8attn
    python -m korean_f5_tts_tpu_torch.scripts.flagship_parity --mode trained_flagship \\
        --steps_trained 1000 --out chiprun_out/flagship_parity.json
    python -m korean_f5_tts_tpu_torch.scripts.flagship_parity --mode trained_int8 --device cpu

  card              fp32, bf16 and int8 weights (quantize_params over the
                    bf16 ones) sampled by models/cfm.py:cfm_sample from one
                    noise draw at the headline shapes: n 1536, cond 432,
                    180 text tokens, 16 NFE, CFG 2, sway -1, EPSS, duration
                    bucket 512. For bf16 and int8 against fp32, and int8
                    against bf16: the mel MAE, rel = MAE / mean|fp32 mel|
                    (the north star is rel 1e-2) and the relative L2.
  card_int8attn     int8 weights under int8 attention against fp32:
                    attn_int8 "qkpv" (both dots, the JAX package's
                    F5_TTS_INT8_ATTN=1) and "qk".
  trained_flagship  trains the architecture (bf16 compute, remat "dots",
                    AdamW at 1e-4, no EMA) on a synthetic corpus of slow
                    sinusoids (8 x 1200 frames padded to 1280, 128 text
                    tokens) until the AdaLN-zero gates open, then runs the
                    modes of card and card_int8attn on the trained weights
                    with cond taken from the corpus. The weights go to
                    --ckpt (default ckpts/flagship_parity_trained.npz) and
                    a later run asked for the same step count reads them
                    back instead of training.
  trained_int8      the overfit run: a DiT of dim 64 and depth 2 trained
                    400 steps at lr 2e-3, then bf16 and int8 (over the fp32
                    weights) against fp32 at 8 NFE.

The weights of card and card_int8attn are models/dit.py:init_dit(seed 0)
with the AdaLN-zero layers re-drawn (redraw_zero_init), where the
repository's script converts a reference torch DiT that needs the reference
source tree; its fp32 mode (the sampler against that reference) is not
ported for the same reason. One JSON line per mode goes to stdout; --out
merges them into a JSON file, and nothing else is written but --ckpt. Needs
a CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from korean_f5_tts_tpu_torch.config import CFMConfig, DiTConfig
from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.quant import quantize_params
from korean_f5_tts_tpu_torch.ops import launch_counts
from korean_f5_tts_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from korean_f5_tts_tpu_torch.train.step import init_train_state, make_optimizer, train_step
from korean_f5_tts_tpu_torch.utils.misc import require_device

ROOT = Path(__file__).resolve().parents[2]
CKPT = ROOT / "ckpts" / "flagship_parity_trained.npz"
ARCH = "F5TTS_Base dim1024/depth22/conv4/pe_attn_head1"
NORTH_STAR = 1e-2

# F5TTS_Base (scripts/flagship_parity.py:33-35)
FLAGSHIP = dict(dim=1024, depth=22, heads=16, dim_head=64, ff_mult=2,
                mel_dim=100, text_num_embeds=256, text_dim=512,
                text_mask_padding=False, conv_layers=4, pe_attn_head=1)
# the headline protocol (scripts/flagship_parity.py:156-166)
N, COND_LEN, N_TEXT, NFE, NOISE_SEED, BUCKET = 1536, 432, 180, 16, 11, 512
SAMPLER = dict(cfg_strength=2.0, sway_sampling_coef=-1.0, use_epss=True)

# mode -> (weights, attn_int8); "int8" is quantize_params over the bf16
# weights (over the fp32 ones in trained_int8)
MODES = {"bf16": ("bf16", None), "int8": ("int8", None),
         "int8+qkpv": ("int8", "qkpv"), "int8+qk": ("int8", "qk")}
CARD_MODES = ("bf16", "int8")
INT8ATTN_MODES = ("int8+qkpv", "int8+qk")


def flagship_cfg(**overrides) -> DiTConfig:
    return DiTConfig(**{**FLAGSHIP, **overrides})


def draw_y0(n: int, seed: int = NOISE_SEED, mel_dim: int = 100) -> np.ndarray:
    """The noise [1, n, mel_dim]: torch.manual_seed(seed); torch.randn(n,
    mel_dim) on the CPU, drawn from a generator of its own."""
    return torch.randn(n, mel_dim, generator=torch.Generator().manual_seed(seed)).numpy()[None]


def card_text(n_text: int = N_TEXT) -> np.ndarray:
    return np.array([np.arange(2, 2 + n_text) % 250], dtype=np.int32)


def card_inputs(n: int = N, cond_len: int = COND_LEN, n_text: int = N_TEXT,
                mel_dim: int = 100) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cond [1, cond_len, mel_dim], text [1, n_text], y0 [1, n, mel_dim]) of
    the seeded-weight modes (scripts/flagship_parity.py:157-161)."""
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((1, cond_len, mel_dim)).astype(np.float32)
    return cond, card_text(n_text), draw_y0(n, mel_dim=mel_dim)


def make_corpus(b: int = 8, n_frames: int = 1200, n_pad: int = 1280, n_text: int = 128,
                mel_dim: int = 100, seed: int = 7) -> dict[str, np.ndarray]:
    """The training corpus of trained_flagship (scripts/flagship_parity.py:
    277-287): per item, two slow sinusoids per mel channel at the mel
    magnitude of the card protocol; {"mel" [b, n_pad, mel_dim] zero past
    n_frames, "text" [b, n_text], "lens" [b], "frames" [b, n_frames, mel_dim]}."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames, dtype=np.float32)[None, :, None] / 100.0
    freqs = rng.uniform(0.2, 3.0, (b, 1, mel_dim)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (b, 1, mel_dim)).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (b, 1, mel_dim)).astype(np.float32)
    frames = (amp * np.sin(freqs * t + phase)
              + 0.7 * amp * np.sin(2.3 * freqs * t + 1.7 * phase)).astype(np.float32)
    mel = np.zeros((b, n_pad, mel_dim), np.float32)
    mel[:, :n_frames] = frames
    text = rng.integers(2, 250, (b, n_text)).astype(np.int32)
    return {"mel": mel, "text": text, "lens": np.full((b,), n_frames, np.int32), "frames": frames}


def _say(msg: str) -> None:
    print(msg, flush=True)


def _device_of(params) -> torch.device:
    return params["proj_out"]["w"].device


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _arch(cfg: DiTConfig):
    return ARCH if cfg == flagship_cfg() else dataclasses.asdict(cfg)


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    now = launch_counts()
    return {k: n - before[k] for k, n in now.items() if n != before[k]}


def deviation(got: np.ndarray, want: np.ndarray, scale: float) -> dict[str, float]:
    """MAE, rel = MAE / scale, and the relative L2 of got against want."""
    diff = got.astype(np.float64) - want
    mae = float(np.abs(diff).mean())
    rel_l2 = float(np.linalg.norm(diff) / max(np.linalg.norm(want.astype(np.float64)), 1e-30))
    return {"mel_mae": mae, "rel": mae / scale, "rel_l2": rel_l2}


def fast_mode_deviation(params: dict, cfg: DiTConfig, cond: np.ndarray, text: np.ndarray,
                        y0: np.ndarray, modes=CARD_MODES, *, steps: int = NFE,
                        duration_bucket: int = BUCKET, int8_over: str = "bf16",
                        log=_say) -> tuple[dict, dict[str, np.ndarray]]:
    """Sample the fp32 `params` and each of `modes` (keys of MODES) from the
    same cond [1, c, mel], text and noise y0 [1, n, mel] (n: the duration, a
    multiple of duration_bucket) on the params' device. Returns (entry,
    mels): entry holds "<mode>_vs_fp32" (and "int8_vs_bf16" when both ran)
    as deviation() dicts over the whole [1, n, mel], mean|fp32 mel| and
    each sampling's kernel launches; mels the fp32 [1, n, mel] of each.

    cond is fp32, so every mode samples fp32 activations, as the JAX
    sampler keeps cond's dtype: the bf16 and int8 modes differ from fp32 by
    their weights' rounding alone (models/cfm.py:weights_at). Rows [0, c)
    are cond spliced back, fp32 in every mode."""
    n, c = y0.shape[1], cond.shape[1]
    y0_t = torch.as_tensor(y0, device=_device_of(params))
    bf16 = cast_params(params, torch.bfloat16)
    trees = {"fp32": params, "bf16": bf16}
    if any(MODES[m][0] == "int8" for m in modes):
        trees["int8"] = quantize_params(bf16 if int8_over == "bf16" else params)
    launches = {}

    def sample(tag: str, weights: str, attn_int8: str | None) -> np.ndarray:
        before = launch_counts()
        out, _ = cfm_sample(trees[weights], cfg, cond, text, n, steps=steps, seed=NOISE_SEED,
                            y0=y0_t, duration_bucket=duration_bucket, attn_int8=attn_int8,
                            **SAMPLER)
        mel = out[:, :n].float().cpu().numpy()
        launches[tag] = _launches_since(before)
        mel[:, :c] = cond
        log(f"{tag} done")
        return mel

    mels = {"fp32": sample("fp32", "fp32", None)}
    scale = float(np.abs(mels["fp32"]).mean()) or 1.0
    entry = {"n": n, "nfe": steps, "cond_len": c, "mean_abs_mel_fp32": scale}
    for mode in modes:
        mels[mode] = sample(mode, *MODES[mode])
        entry[f"{mode}_vs_fp32"] = deviation(mels[mode], mels["fp32"], scale)
    if "bf16" in mels and "int8" in mels:
        entry["int8_vs_bf16"] = deviation(mels["int8"], mels["bf16"], scale)
    entry["launches"] = launches
    return entry, mels


def train_flagship(params: dict, cfg: DiTConfig, corpus: dict, steps: int, *,
                   lr: float = 1e-4, warmup: int = 50, total: int | None = None,
                   cfm: CFMConfig = CFMConfig(), compute_dtype: torch.dtype | None = torch.bfloat16,
                   draws_of=None, log=_say, hold=None):
    """`steps` updates of a copy of `params` on the whole corpus as one batch
    (scripts/flagship_parity.py:304-326): make_optimizer(lr, warmup, total,
    max(steps, 200) x 4 by default), no EMA, train_step with seed i (or the
    draws draws_of(i)) at compute_dtype. hold(i, loss, launches), when
    given, sees each step's loss (a tensor) and kernel launches. Returns
    (state, losses, seconds a step after the first, None for one step)."""
    dev = _device_of(params)
    opt = make_optimizer(learning_rate=lr, warmup_updates=warmup,
                         total_updates=total or max(steps, 200) * 4)
    state = init_train_state(params, opt, use_ema=False)
    batch = {k: torch.as_tensor(corpus[k], device=dev) for k in ("mel", "text", "lens")}
    losses, t1 = [], None
    for i in range(steps):
        before = launch_counts()
        state, loss = train_step(state, batch, i, cfg, opt, cfm, compute_dtype=compute_dtype,
                                 draws=None if draws_of is None else draws_of(i))
        if hold is not None:
            hold(i, loss, _launches_since(before))
        losses.append(loss)
        if i == 0:
            t1 = time.perf_counter()  # the float() fences the first step
            log(f"step 0 loss {float(loss):.4f}")
        elif i % 100 == 0 or i == steps - 1:
            log(f"step {i} loss {float(loss):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    s_per_step = (time.perf_counter() - t1) / (steps - 1) if steps > 1 else None
    return state, [float(x) for x in losses], s_per_step


def gate_mean(params: dict) -> float:
    """Mean |w| of every block's AdaLN-zero modulation projection
    (attn_norm.linear): zero at init, so above zero once training opened
    the gates (scripts/flagship_parity.py:337-339)."""
    return float(np.mean([blk["attn_norm"]["linear"]["w"].abs().mean().item()
                          for blk in params["blocks"]]))


def _seeded_modes(key: str, modes, device, cfg, n, cond_len, n_text, duration_bucket,
                  log) -> dict:
    dev = require_device(device)
    cfg = cfg or flagship_cfg()
    params = redraw_zero_init(init_dit(cfg, seed=0, device=dev), seed=1)
    cond, text, y0 = card_inputs(n, cond_len, n_text, cfg.mel_dim)
    entry, _ = fast_mode_deviation(params, cfg, cond, text, y0, modes,
                                   duration_bucket=duration_bucket, log=log)
    return {key: {"arch": _arch(cfg), "device": _device_name(dev),
                  "weights": "init_dit(seed 0), AdaLN-zero layers re-drawn (seed 1)",
                  "north_star": NORTH_STAR, **entry}}


def run_card(device="cuda", cfg: DiTConfig | None = None, n: int = N, cond_len: int = COND_LEN,
             n_text: int = N_TEXT, duration_bucket: int = BUCKET, log=_say) -> dict:
    """Mode card (scripts/flagship_parity.py:137-189) on seeded weights."""
    return _seeded_modes("flagship_card_fast_modes", CARD_MODES, device, cfg, n, cond_len,
                         n_text, duration_bucket, log)


def run_card_int8attn(device="cuda", cfg: DiTConfig | None = None, n: int = N,
                      cond_len: int = COND_LEN, n_text: int = N_TEXT,
                      duration_bucket: int = BUCKET, log=_say) -> dict:
    """Mode card_int8attn (scripts/flagship_parity.py:192-241) on seeded weights."""
    return _seeded_modes("flagship_card_int8_attn", INT8ATTN_MODES, device, cfg, n, cond_len,
                         n_text, duration_bucket, log)


def run_trained_flagship(device="cuda", steps_trained: int = 1000, ckpt: Path | str | None = CKPT,
                         cfg: DiTConfig | None = None, corpus: dict | None = None, n: int = N,
                         cond_len: int = COND_LEN, n_text: int = N_TEXT, steps: int = NFE,
                         duration_bucket: int = BUCKET, log=_say, hold=None) -> dict:
    """Mode trained_flagship (scripts/flagship_parity.py:244-409): train,
    then every fast mode against fp32 on the trained weights; hold as in
    train_flagship. ckpt None neither reads nor writes a checkpoint."""
    dev = require_device(device)
    cfg = cfg or flagship_cfg()
    corpus = make_corpus() if corpus is None else corpus
    params, losses, s_per_step = None, [], None
    if ckpt is not None and Path(ckpt).exists():
        saved = load_checkpoint(str(ckpt), device=dev)
        if saved["update"] == steps_trained:
            params = saved["params"]
            log(f"loaded trained flagship params from {ckpt}")
    if params is None:
        train_cfg = dataclasses.replace(cfg, checkpoint_activations=True, remat_policy="dots")
        state, losses, s_per_step = train_flagship(
            init_dit(train_cfg, seed=0, device=dev), train_cfg, corpus, steps_trained,
            log=log, hold=hold)
        params = state.params
        del state
        if ckpt is not None:
            Path(ckpt).parent.mkdir(parents=True, exist_ok=True)
            save_checkpoint(str(ckpt), params, update=steps_trained)
            log(f"saved {ckpt}")
    cond = corpus["frames"][0:1, :cond_len]
    entry, _ = fast_mode_deviation(params, cfg, cond, card_text(n_text),
                                   draw_y0(n, mel_dim=cfg.mel_dim), CARD_MODES + INT8ATTN_MODES,
                                   steps=steps, duration_bucket=duration_bucket, log=log)
    arch = _arch(cfg)
    trained = {"arch": arch, "device": _device_name(dev), "steps_trained": steps_trained,
               "adaln_attn_mod_w_mean_abs": gate_mean(params), "north_star": NORTH_STAR, **entry}
    if losses:
        trained.update(loss_first=losses[0], loss_last=losses[-1], s_per_step=s_per_step,
                       loss_every_100=losses[::100])
    int8 = entry["int8_vs_fp32"]
    headline = {"arch": arch, "n": entry["n"], "nfe": steps, "cond_len": cond_len,
                "stack": {"weights": "int8 (quantize_params, all block linears)",
                          "attn_path": "default", "attn_int8": None},
                "mean_abs_mel_fp32": entry["mean_abs_mel_fp32"],
                "mel_mae_vs_fp32": int8["mel_mae"], "rel": int8["rel"],
                "north_star": NORTH_STAR, "pass": int8["mel_mae"] < NORTH_STAR}
    return {"flagship_trained_fast_modes_vs_fp32": trained,
            "flagship_trained_headline_mode": headline}


def run_trained_int8(device="cuda", steps_trained: int = 400, log=_say) -> dict:
    """Mode trained_int8 (scripts/flagship_parity.py:412-468): the overfit
    recipe of tests/test_learning.py, then bf16 and int8 against fp32."""
    dev = require_device(device)
    cfg = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=8,
                    text_num_embeds=12, text_dim=32, conv_layers=1, dropout=0.0)
    t = np.linspace(0, 4 * np.pi, 64)
    target = np.stack([np.sin(t + k) for k in range(8)], axis=-1).astype(np.float32)
    text = np.arange(1, 9, dtype=np.int32)[None]
    corpus = {"mel": np.tile(target[None], (8, 1, 1)), "text": np.tile(text, (8, 1)),
              "lens": np.full((8,), 64, np.int32)}
    state, losses, _ = train_flagship(
        init_dit(cfg, seed=0, device=dev), cfg, corpus, steps_trained, lr=2e-3, warmup=20,
        total=2000, cfm=CFMConfig(audio_drop_prob=0.0, cond_drop_prob=0.0), compute_dtype=None,
        log=lambda msg: None)
    y0 = np.random.default_rng(0).standard_normal((1, 64, 8)).astype(np.float32)
    entry, _ = fast_mode_deviation(state.params, cfg, target[None, :32], text, y0, CARD_MODES,
                                   steps=8, duration_bucket=1, int8_over="fp32", log=log)
    return {"trained_weights_fast_modes_vs_fp32": {
        "device": _device_name(dev), "loss_first": losses[0], "loss_last": losses[-1],
        "steps_trained": steps_trained, "north_star": NORTH_STAR, **entry}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", nargs="+", required=True,
                   choices=["card", "card_int8attn", "trained_flagship", "trained_int8"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--steps_trained", type=int, default=None,
                   help="training steps (default: 1000 for trained_flagship, 400 for "
                        "trained_int8)")
    p.add_argument("--ckpt", default=str(CKPT),
                   help="trained_flagship's weights (.npz), read when it holds as many steps "
                        "as asked for, else written; '' for neither")
    p.add_argument("--out", type=Path, default=None,
                   help="merge the modes' JSON into this file (nothing is written without it)")
    args = p.parse_args(argv)
    runs = {
        "card": lambda: run_card(args.device),
        "card_int8attn": lambda: run_card_int8attn(args.device),
        "trained_flagship": lambda: run_trained_flagship(
            args.device, args.steps_trained or 1000, args.ckpt or None),
        "trained_int8": lambda: run_trained_int8(args.device, args.steps_trained or 400),
    }
    merged = {}
    for mode in args.mode:
        entry = runs[mode]()
        print(json.dumps(entry), flush=True)
        merged.update(entry)
    if args.out is not None:
        data = json.loads(args.out.read_text()) if args.out.exists() else {}
        data.update(merged)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return merged


if __name__ == "__main__":
    main()

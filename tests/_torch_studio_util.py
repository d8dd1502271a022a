"""Shared pieces of the fine-tuning studio and inference UI parity tests
(tests/test_torch_studio.py, tests/test_torch_gradio.py): a seeded recording
with pauses, Korean transcripts, one tiny DiT (dim 64, depth 2) with its
kor_grapheme vocab in both packages and as a JAX-layout .npz, tiny Vocos
decoders in both, and the fixture that gives both samplers one numpy noise
(as tests/test_torch_eval.py)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import redraw_zero_layers, tiny_vocos
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.infer.model import TTSModel as JaxTTSModel
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops import mel as jmel
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.infer.model import TTSModel
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.vocos import Vocos
from korean_f5_tts_tpu_torch.ops import mel as pmel
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax
from korean_f5_tts_tpu_torch.train.datasets.prepare import build_vocab, tokenize_rows

SR = 24_000
REL = 1e-4  # tests/test_torch_infer.py's REL
TINY_ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=2)
SENTENCES = ["안녕하세요, 오늘은 제 목소리를 녹음합니다.", "국물이 정말 맛있어서 같이 먹었어요!",
             "신라의 역사는 아주 길어요.", "값이 얼마인지 물어봐도 될까요?",
             "내일은 날씨가 맑겠습니다."]
GEN_TEXTS = ["짧은 문장을 말해 볼게요.", "두 번째 목소리로 말합니다!"]
MODE = "kor_grapheme"


def speech_like(seconds: float, seed: int, f0: float = 150.0) -> np.ndarray:
    """A chirp over a noise floor (a clean chirp leaves mel bins at the log
    clamp, where fp32 rounding alone moves them)."""
    t = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * (np.sin(2 * np.pi * (f0 + 300.0 * t) * t) + 0.1 * noise)).astype(np.float32)


def recording(seed: int = 0, segments=(5.2, 5.0, 4.8, 5.1, 4.9), pause: float = 1.1):
    """Speech-like segments separated by pauses of `pause` s at -80 dB."""
    rng = np.random.default_rng(seed + 1000)
    parts = []
    for i, secs in enumerate(segments):
        if i:
            parts.append((1e-4 * rng.standard_normal(int(pause * SR))).astype(np.float32))
        parts.append(speech_like(secs, seed + i, 140.0 + 25 * i))
    return np.concatenate(parts)


def write_wav(path, wav, sr: int = SR) -> str:
    wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return str(path)


def vocab_tokens(texts=tuple(SENTENCES + GEN_TEXTS), mode: str = MODE) -> list[str]:
    """The vocab prepare() builds for these texts (space first)."""
    return build_vocab(tokenize_rows([{"text": t} for t in texts], mode))


def tiny_flat(vocab_size: int, seed: int = 0) -> dict:
    """A tiny DiT's flat JAX params (AdaLN-zero layers re-drawn) for a vocab."""
    cfg = JaxDiTConfig(**TINY_ARCH, text_num_embeds=vocab_size + 1)
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), cfg))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)


def model_pair(flat: dict, vocab: list[str], mode: str = MODE):
    """(JAX TTSModel, port TTSModel on the CPU) of one flat tree."""
    n = len(vocab) + 1
    vmap = {c: i for i, c in enumerate(vocab)}
    jcfg = JaxDiTConfig(**TINY_ARCH, text_num_embeds=n)
    pcfg = DiTConfig(**TINY_ARCH, text_num_embeds=n)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    jmodel = JaxTTSModel(jparams, jcfg, jmel.MelConfig(), vmap, tokenizer_type=mode)
    pmodel = TTSModel(params_from_jax(flat, device="cpu"), pcfg, pmel.MelConfig(), vmap,
                      torch.device("cpu"), tokenizer_type=mode)
    return jmodel, pmodel


def vocoder_pair():
    """(JAX decode callable, port Vocos) of one tiny Vocos."""
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    return (lambda mel: jax_vocos_decode(jvparams, mel, jvcfg)), Vocos(pvparams, pvcfg)


def write_model(d, seed: int = 0):
    """A kor_grapheme vocab.txt and a JAX-layout .npz of the tiny DiT at its
    size under directory d; returns (npz path, vocab path, vocab, flat)."""
    vocab = vocab_tokens()
    flat = tiny_flat(len(vocab), seed)
    npz, vocab_path = d / "model_tiny.npz", d / "vocab.txt"
    np.savez(npz, **{f"params/{k}": v for k, v in flat.items()})
    vocab_path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return str(npz), str(vocab_path), vocab, flat


@pytest.fixture
def same_noise(monkeypatch):
    """Both samplers draw one numpy noise, whatever the seed."""
    def noise(shape):
        return np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(jcfm.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape), dtype))
    monkeypatch.setattr(pcfm, "draw_noise", lambda seeds, canon, d, device, dtype: torch.stack(
        [torch.from_numpy(noise((canon, d))) for _ in seeds]).to(device=device, dtype=dtype))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """At these tiny shapes more torch threads only contend with the other
    test workers of the run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

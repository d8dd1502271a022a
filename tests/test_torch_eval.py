"""The port's evaluation harness (korean_f5_tts_tpu_torch/eval/) against the
JAX package's, on the CPU.

- The host functions (mappings, filters, parsers, prompt buckets, shard
  split, metrics) get the same inputs and must give equal outputs.
- ECAPA-TDNN: the JAX init's parameters go through the converter; the
  embedding agrees to 1e-5 relative L2 in fp32 at tests/test_ecapa.py's TINY
  config and at a wider one, from features and from a 24 kHz wav (the 16 kHz
  log-mel front end with win_length 400 < n_fft 512 held to the JAX
  package's STFT on the way).
- With one tiny DiT (dim 32, depth 2, as tests/test_e2e_flows.py) in both
  packages and the same numpy noise in both samplers (their draws are
  patched, as tests/test_torch_edit_batch.py does): evaluate_one_model,
  evaluate_kub, run_grid and synthesize_bucket write the same details.csv
  rows and summaries, and wavs within 2e-3 relative L2 of the int16 samples
  (the mel agrees to 1e-4, as tests/test_torch_infer.py holds cfm_sample;
  the ISTFT sums in another order). Launch counters stay 0 on the CPU.
"""

import csv
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import redraw_zero_layers, rel_err, tiny_vocos
from korean_f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from korean_f5_tts_tpu.config import ModelConfig as JaxModelConfig
from korean_f5_tts_tpu.eval import ecapa_tdnn as jecapa
from korean_f5_tts_tpu.eval import eval_infer_batch as jbatch
from korean_f5_tts_tpu.eval import evaluate_coreaspeech as jcorea
from korean_f5_tts_tpu.eval import evaluate_korean as jkor
from korean_f5_tts_tpu.eval import evaluate_kub as jkub
from korean_f5_tts_tpu.eval import metrics as jmetrics
from korean_f5_tts_tpu.eval import utils_eval as jutils
from korean_f5_tts_tpu.eval import validate_models as jval
from korean_f5_tts_tpu.infer.model import TTSModel as JaxTTSModel
from korean_f5_tts_tpu.infer.model import load_model as jax_load_model
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.dit import init_dit as jax_init_dit
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops import mel as jmel
from korean_f5_tts_tpu.train.checkpoint import flatten_tree, unflatten_tree
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.eval import ecapa_tdnn as pecapa
from korean_f5_tts_tpu_torch.eval import eval_infer_batch as pbatch
from korean_f5_tts_tpu_torch.eval import evaluate_coreaspeech as pcorea
from korean_f5_tts_tpu_torch.eval import evaluate_korean as pkor
from korean_f5_tts_tpu_torch.eval import evaluate_kub as pkub
from korean_f5_tts_tpu_torch.eval import metrics as pmetrics
from korean_f5_tts_tpu_torch.eval import utils_eval as putils
from korean_f5_tts_tpu_torch.eval import validate_models as pval
from korean_f5_tts_tpu_torch.infer.model import TTSModel
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.vocos import Vocos
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops import mel as pmel
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax
from korean_f5_tts_tpu_torch.train.datasets.prepare import build_vocab, tokenize_rows

SR, HOP = 24_000, 256
MEL_REL = 1e-4    # the sampler's mel (tests/test_torch_infer.py's REL)
WAV_REL = 2e-3    # int16 wavs after the ISTFT (tests/test_torch_edit_batch.py)
ECAPA_REL = 1e-5  # the fp32 embedding
ALONE_REL = 5e-2  # a batched item against the same item run alone (chip_smoke.py's bound)
TINY_ARCH = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=100, text_dim=16,
                 conv_layers=1)
ECAPA_TINY = dict(feat_dim=8, channels=16, emb_dim=12, res2_scale=4, se_bottleneck=8,
                  attn_bottleneck=8)  # tests/test_ecapa.py's TINY
ECAPA_WIDE = dict(feat_dim=80, channels=128, emb_dim=192, res2_scale=8, se_bottleneck=32,
                  attn_bottleneck=32)
TEXTS = ["안녕하세요. 만나서 반갑습니다.", "오늘은 날씨가 정말 좋네요!",
         "국물이 정말 맛있어요.", "같이 가면 좋겠어요?"]
MODES = ("kor_grapheme", "kor_allophone")


def speech_like(seconds: float, f0: float = 150.0, seed: int = 5) -> np.ndarray:
    """A chirp over a noise floor (a clean chirp leaves mel bins at the log
    clamp, where fp32 rounding alone moves them)."""
    tt = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(seed).standard_normal(tt.size)
    return (0.3 * (np.sin(2 * np.pi * (f0 + 400 * tt) * tt) + 0.1 * noise)).astype(np.float32)


def write_wav(path, wav, sr=SR) -> str:
    wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return str(path)


def mode_vocab(mode: str) -> dict[str, int]:
    rows = tokenize_rows([{"text": t} for t in TEXTS], mode, use_n2gk_plus=True)
    return {c: i for i, c in enumerate(build_vocab(rows))}


def tiny_flat(vocab_size: int, seed: int = 0) -> dict:
    """A tiny DiT's flat JAX params (AdaLN-zero layers re-drawn) for a vocab."""
    cfg = JaxDiTConfig(**TINY_ARCH, text_num_embeds=vocab_size + 1)
    flat = flatten_tree(jax_init_dit(jax.random.PRNGKey(seed), cfg))
    return redraw_zero_layers({k: np.asarray(v) for k, v in flat.items()}, seed + 100)


def model_pair(flat: dict, vocab: dict, mode: str):
    n = len(vocab) + 1
    jcfg, pcfg = JaxDiTConfig(**TINY_ARCH, text_num_embeds=n), DiTConfig(**TINY_ARCH,
                                                                         text_num_embeds=n)
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    jmodel = JaxTTSModel(jparams, jcfg, jmel.MelConfig(), vocab, tokenizer_type=mode)
    pmodel = TTSModel(params_from_jax(flat, device="cpu"), pcfg, pmel.MelConfig(), vocab,
                      torch.device("cpu"), tokenizer_type=mode)
    return jmodel, pmodel


def ecapa_pair(cfg: dict, seed: int = 0):
    jcfg, pcfg = jecapa.EcapaConfig(**cfg), pecapa.EcapaConfig(**cfg)
    jp = jecapa.init_ecapa(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jp).items()}
    return jcfg, jp, pcfg, params_from_jax(flat, device="cpu"), flat


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """At these tiny shapes more torch threads only contend with the other
    test workers of the run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Wavs, test/train rows, one tiny DiT per tokenizer mode in both packages
    (and its .npz), a tiny Vocos and a tiny ECAPA in both."""
    d = tmp_path_factory.mktemp("eval")
    refs = [write_wav(d / f"ref{i}.wav", speech_like(1.0 + 0.25 * i, 150 + 40 * i, seed=i))
            for i in range(3)]
    train = [{"audio_path": refs[i], "text": t, "duration": 3.5 + i, "speaker": f"s{i % 2}"}
             for i, t in enumerate(["첫 번째 참조 문장입니다.", "두 번째 참조예요!",
                                    "세 번째 참조 음성이에요?"])]
    test = [{"utt": f"t{i:04d}", "text": t, "speaker": f"s{i % 2}"}
            for i, t in enumerate(TEXTS[:2])]
    models = {}
    for mode in MODES:
        vocab = mode_vocab(mode)
        flat = tiny_flat(len(vocab))
        (d / mode).mkdir()
        np.savez(d / mode / "model_1.npz", **{f"params/{k}": v for k, v in flat.items()})
        with open(d / mode / "vocab.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")
        models[mode] = model_pair(flat, vocab, mode)
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    jcfg, jp, pcfg, pp, _ = ecapa_pair(ECAPA_TINY)
    return {"dir": d, "refs": refs, "train": train, "test": test, "models": models,
            "jvoc": lambda mel: jax_vocos_decode(jvparams, mel, jvcfg),
            "pvoc": Vocos(pvparams, pvcfg),
            "jembed": jecapa.make_embed_fn(jp, jcfg), "pembed": pecapa.make_embed_fn(pp, pcfg)}


@pytest.fixture
def same_noise(monkeypatch):
    def noise(shape):
        return np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(jcfm.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape), dtype))
    monkeypatch.setattr(pcfm, "draw_noise", lambda seeds, canon, d, device, dtype: torch.stack(
        [torch.from_numpy(noise((canon, d))) for _ in seeds]).to(device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# host functions: equal outputs
# ---------------------------------------------------------------------------


def _metainfo_files(tmp_path):
    base = tmp_path / "seed"
    (base / "prompts").mkdir(parents=True)
    lst = base / "meta.lst"
    lst.write_text("u1|prompt one|prompts/p1.wav|target one|/abs/gt1.wav\n"
                   "u2|prompt two|prompts/p2.wav|target two\n"
                   "broken|line\n"
                   "u3|prompt three|/abs/p3.wav|target three\n", encoding="utf-8")
    ls = tmp_path / "ls.tsv"
    ls.write_text("1089-134686-0000\t3.5\tref words\t1089-134686-0001\t4.25\tgen words\n"
                  "2300-131720-0002\t5.0\tmore ref\t2300-131720-0003\t6.5\tmore gen\n",
                  encoding="utf-8")
    return str(lst), str(ls)


def _prompt_rows(tmp_path):
    rows = []
    for i, secs in enumerate((1.0, 2.5, 1.2, 4.0, 0.6)):
        sr = 16_000 if i == 3 else SR
        path = write_wav(tmp_path / f"p{i}.wav", speech_like(secs, seed=i)[: int(secs * sr)], sr)
        rows.append((f"u{i}", "참조 문장" * (i + 1), path, "생성할 문장입니다" * (2 + i)))
    return rows


TRAIN_ROWS = [
    {"audio_path": f"a{i}.wav", "text": t, "duration": dur, "speaker": spk}
    for i, (t, dur, spk) in enumerate([
        ("좋은 아침입니다.", 4.0, "a"), ("정말요?", 3.2, "a"), ("쉼표, 있는 문장.", 5.0, "b"),
        ("마침표 없는 문장", 6.0, "b"), ("너무 짧아요.", 2.0, "a"), ("너무 길어요!", 12.0, "b"),
        ("세 번째 화자입니다.", 7.5, "c"), ("두 번째도 있어요!", 9.9, "b")])]
TEST_ROWS = [{"utt": f"t{i:04d}", "text": f"시험 {i}", "speaker": spk}
             for i, spk in enumerate("abcabd")]
VAL_ROWS = [{"utt": f"v{i:04d}", "text": t, "duration": dur} for i, (t, dur) in enumerate([
    ("안녕하세요.", 3.0), ("쉼표, 있어요.", 4.0), ("중간. 마침표.", 4.0),
    ("아주 긴 문장인데 시간이 짧아요.", 2.9), ("짧은 문장", 0.0), ("충분히 긴 시간의 문장", 9.0)])]
KUB_LINES = ["clean|a/ref.wav|참조 텍스트|3.5|a/gt.wav|목표 텍스트\n",
             "noisy| /abs/r.wav | 공백 | 4 | g.wav | 목표 |\n",
             "numeric|r.wav|숫자 123|not-a-float|g.wav|목표\n",
             "short|r.wav|three|cols\n", "x|y|z|1e1|w|v"]


def _cases(tmp_path):
    lst, ls = _metainfo_files(tmp_path)
    prompts = _prompt_rows(tmp_path)
    return {
        "build_reference_mapping": lambda m: m.build_reference_mapping(TEST_ROWS, TRAIN_ROWS),
        "build_reference_mapping_narrow": lambda m: m.build_reference_mapping(
            TEST_ROWS, TRAIN_ROWS, min_dur=4.0, max_dur=8.0, seed=3),
        "build_reference_mapping_empty": lambda m: m.build_reference_mapping(TEST_ROWS, []),
        "build_same_speaker_mapping": lambda m: m.build_same_speaker_mapping(
            TEST_ROWS, TRAIN_ROWS),
        "build_same_speaker_mapping_wide": lambda m: m.build_same_speaker_mapping(
            TEST_ROWS, TRAIN_ROWS, min_dur=0.0, max_dur=20.0, seed=1),
        "build_reversed_mapping": lambda m: m.build_reversed_mapping(VAL_ROWS),
        "filter_validation_rows": lambda m: m.filter_validation_rows(VAL_ROWS),
        "resolve_mode": lambda m: [m.resolve_mode(k) for k in (*m.MODE_MAP, "kor_nf", "x")],
        "min_duration_for": lambda m: [m.min_duration_for(r["text"]) for r in VAL_ROWS],
        "get_inference_prompt": lambda m: m.get_inference_prompt(prompts),
        "get_inference_prompt_few_buckets": lambda m: m.get_inference_prompt(
            prompts, speed=1.3, num_buckets=3, min_secs=1.0, max_secs=12.0, seed=7),
        "split_jobs": lambda m: [m.split_jobs(list(range(11)), n, i)
                                 for n in (1, 2, 3, 4, 11, 12) for i in range(n)],
        "parse_kub_line": lambda m: [m.parse_kub_line(x) for x in KUB_LINES],
        "load_test_items": lambda m: m.load_test_items(_kub_file(tmp_path)),
        "summarize_by_subset": lambda m: m.summarize_by_subset(KUB_RECORDS, "kor_nf", 5),
        "seedtts_metainfo": lambda m: m.get_seedtts_testset_metainfo(lst),
        "librispeech_metainfo": lambda m: m.get_librispeech_test_clean_metainfo(ls, "/data/ls"),
        "normalize_for_scoring": lambda m: [m.normalize_for_scoring(t) for t in
                                            (*TEXTS, "3월 15일에 2명이 왔다, 정말!")],
        "metrics": lambda m: [(m.word_error_rate(a, b), m.char_error_rate(a, b),
                               m.strip_punctuation(b)) for a, b in METRIC_PAIRS],
    }


KUB_RECORDS = [{"subset": s, "cer": c, "wer": w, "utmos": u, "sim": ""}
               for s, c, w, u in [("clean", "0.1", "0.2", "3.5"), ("noisy", "0.3", "", "2.0"),
                                  ("clean", "0.0", "0.4", "")]]
METRIC_PAIRS = [("a b c", "a x c"), ("안녕 하세요", "안녕하세요!"), ("", ""), ("", "x"),
                ("가 나 다", "가, 나… 다?")]


def _kub_file(tmp_path):
    path = tmp_path / "kub.txt"
    path.write_text("# header\n\n" + "".join(KUB_LINES), encoding="utf-8")
    return str(path)


# which module of each package holds the case's function
_OWNER = {"build_reference_mapping": "kor", "build_reference_mapping_narrow": "kor",
          "build_reference_mapping_empty": "kor", "normalize_for_scoring": "kor",
          "build_same_speaker_mapping": "corea", "build_same_speaker_mapping_wide": "corea",
          "build_reversed_mapping": "val", "filter_validation_rows": "val",
          "resolve_mode": "val", "min_duration_for": "val", "parse_kub_line": "kub",
          "load_test_items": "kub", "summarize_by_subset": "kub", "metrics": "metrics"}
_MODULES = {"kor": (jkor, pkor), "corea": (jcorea, pcorea), "val": (jval, pval),
            "kub": (jkub, pkub), "metrics": (jmetrics, pmetrics), "utils": (jutils, putils)}
HOST_CASES = sorted(_OWNER) + ["get_inference_prompt", "get_inference_prompt_few_buckets",
                               "split_jobs", "seedtts_metainfo", "librispeech_metainfo"]


def _plain(x):
    """Nested results with numpy arrays made comparable exactly."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("name", HOST_CASES)
def test_host_function_equals_jax(name, tmp_path):
    jm, pm = _MODULES[_OWNER.get(name, "utils")]
    case = _cases(tmp_path)[name]
    want, got = case(jm), case(pm)
    assert _plain(got) == _plain(want)
    if name == "get_inference_prompt_few_buckets":  # several buckets, several items in one
        assert len(got) > 1 and max(len(b) for b in got) > 1


# ---------------------------------------------------------------------------
# ECAPA-TDNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", ["tiny", "wide"])
def test_ecapa_embed_matches_jax(width):
    jcfg, jp, pcfg, pp, flat = ecapa_pair(ECAPA_TINY if width == "tiny" else ECAPA_WIDE)
    feats = np.random.default_rng(0).standard_normal((3, 77, jcfg.feat_dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda f: jecapa.ecapa_embed(jp, f, jcfg))(jnp.asarray(feats)))
    got = pecapa.ecapa_embed(pp, torch.from_numpy(feats), pcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, jcfg.emb_dim)
    assert rel_err(got.numpy(), want) < ECAPA_REL
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
    assert pecapa.ecapa_config_of(pp) == pcfg
    # the port's own init: the JAX tree's keys and shapes, from an explicit generator
    mine = pecapa.init_ecapa(torch.Generator().manual_seed(0), pcfg, device="cpu")
    again = pecapa.init_ecapa(torch.Generator().manual_seed(0), pcfg, device="cpu")
    from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax

    shapes = {k: v.shape for k, v in params_to_jax(mine).items()}
    assert shapes == {k: v.shape for k, v in flat.items()}
    assert all(np.array_equal(a, b) for a, b in zip(params_to_jax(mine).values(),
                                                     params_to_jax(again).values()))


@pytest.mark.parametrize("width", ["tiny", "wide"])
def test_make_embed_fn_from_a_24khz_wav_matches_jax(width, tmp_path):
    jcfg, jp, pcfg, pp, _ = ecapa_pair(ECAPA_TINY if width == "tiny" else ECAPA_WIDE, seed=1)
    wav = speech_like(1.5)
    want = jecapa.make_embed_fn(jp, jcfg)(wav, SR)
    reset_launch_counts()
    got = pecapa.make_embed_fn(pp, pcfg)(wav, SR)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert got.dtype == np.float32 and got.shape == (jcfg.emb_dim,)
    assert rel_err(got, want) < ECAPA_REL
    # through run_sim: a wav against itself scores 1, against another voice less
    from korean_f5_tts_tpu_torch.eval.utils_eval import run_sim

    gen = tmp_path / "gen"
    gen.mkdir()
    prompt = write_wav(tmp_path / "p.wav", wav)
    write_wav(gen / "same.wav", wav)
    write_wav(gen / "other.wav", speech_like(1.5, f0=400.0, seed=9)[::-1].copy())
    meta = [("same", "", prompt, ""), ("other", "", prompt, ""), ("absent", "", prompt, "")]
    sims = {r["wav"].split("/")[-1]: r["sim"] for r in run_sim(str(gen), meta,
                                                                pecapa.make_embed_fn(pp, pcfg))}
    assert set(sims) == {"same.wav", "other.wav"} and sims["same.wav"] > 0.9999
    assert sims["other.wav"] < sims["same.wav"]


def test_ecapa_front_end_matches_the_jax_stft_at_16khz():
    """n_fft 512, win_length 400 (zero-padded window), hop 160 at 16 kHz."""
    cfg = pecapa.ecapa_mel_config(pecapa.EcapaConfig())
    jcfg = jmel.MelConfig(n_mel_channels=80, target_sample_rate=16_000, n_fft=512,
                          win_length=400, hop_length=160)
    wav = speech_like(1.0)[:16_000]
    x = np.pad(wav, (256, 256), mode="reflect")[None]
    want = np.asarray(jmel.stft_spectrogram(jnp.asarray(wav[None]), 512, 160, 400, center=True))
    got = pmel.stft_spectrogram(torch.from_numpy(x), 512, 160, 400).numpy()
    assert got.shape == want.shape == (1, 257, 101) and rel_err(got, want) < 1e-5
    want_mel = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav[None]), jcfg))
    got_mel = pmel.log_mel_spectrogram(torch.from_numpy(wav[None]), cfg).numpy()
    assert got_mel.shape == want_mel.shape == (1, 80, 101)
    assert np.abs(got_mel - want_mel).max() < 1e-3


def test_ecapa_turns_cudnn_tf32_off_for_its_call_only(monkeypatch):
    _, _, pcfg, pp, _ = ecapa_pair(ECAPA_TINY)
    seen = []
    real = pecapa.conv1d
    monkeypatch.setattr(pecapa, "conv1d", lambda *a, **k: (
        seen.append(torch.backends.cudnn.allow_tf32), real(*a, **k))[1])
    before = torch.backends.cudnn.allow_tf32
    feats = torch.zeros((1, 20, pcfg.feat_dim))
    for flag in (True, False):
        torch.backends.cudnn.allow_tf32 = flag
        try:
            pecapa.ecapa_embed(pp, feats, pcfg)
            assert torch.backends.cudnn.allow_tf32 is flag  # restored
            assert seen and not any(seen)
            seen.clear()
            pecapa.ecapa_embed(pp, feats, pcfg, tf32=True)  # the control
            assert all(seen)
            seen.clear()
        finally:
            torch.backends.cudnn.allow_tf32 = before


# ---------------------------------------------------------------------------
# the eval paths on a tiny DiT
# ---------------------------------------------------------------------------


def _echo(test_rows):
    """A transcriber that returns each utterance's ground truth."""
    texts = {r["utt"]: r["text"] for r in test_rows}
    return lambda path: texts[os.path.basename(path)[:-4]]


def _csv(path):
    with open(path, encoding="utf-8", newline="") as f:
        return list(csv.DictReader(f))


def _wavs_agree(dir_j, dir_p, names):
    for name in names:
        (sr_j, wj), (sr_p, wp) = wavfile.read(dir_j / name), wavfile.read(dir_p / name)
        assert sr_j == sr_p == SR and wp.shape == wj.shape and wp.size > 10 * HOP
        assert np.abs(wp).max() > 0
        assert rel_err(wp.astype(np.float64), wj.astype(np.float64)) < WAV_REL


def test_evaluate_one_model_matches_jax(world, same_noise, tmp_path):
    jmodel, pmodel = world["models"]["kor_grapheme"]
    test, train = world["test"], world["train"]
    mapping = pkor.build_reference_mapping(test, train)
    assert mapping == jkor.build_reference_mapping(test, train)
    kw = dict(nfe_step=4, transcribe_fn=_echo(test), seed=3)
    want = jkor.evaluate_one_model(jmodel, world["jvoc"], test, mapping, str(tmp_path / "j"),
                                   embed_fn=world["jembed"], **kw)
    reset_launch_counts()
    got = pkor.evaluate_one_model(pmodel, world["pvoc"], test, mapping, str(tmp_path / "p"),
                                  embed_fn=world["pembed"], **kw)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert set(got) == set(want) == {"out_dir", "n", "cer", "wer", "sim"}
    assert got["n"] == want["n"] == 2 and got["cer"] == want["cer"] == 0.0
    assert got["wer"] == want["wer"] == 0.0 and abs(got["sim"] - want["sim"]) < 1e-3
    rows_j, rows_p = _csv(tmp_path / "j" / "details.csv"), _csv(tmp_path / "p" / "details.csv")
    assert rows_p == rows_j and [r["utt"] for r in rows_p] == ["t0000", "t0001"]
    _wavs_agree(tmp_path / "j", tmp_path / "p", ["t0000.wav", "t0001.wav"])
    # resumable: a second call synthesizes nothing and adds no row
    again = pkor.evaluate_one_model(pmodel, None, test, mapping, str(tmp_path / "p"), **kw)
    assert _csv(tmp_path / "p" / "details.csv") == rows_p
    assert again["cer"] == got["cer"] and again["wer"] == got["wer"]


def test_evaluate_kub_matches_jax(world, same_noise, tmp_path):
    jmodel, pmodel = world["models"]["kor_allophone"]
    root = world["dir"]
    items = [{"subset": s, "ref_wav": os.path.basename(world["refs"][i]),
              "ref_text": world["train"][i]["text"], "ref_duration": 3.5,
              "gt_wav": world["refs"][2 - i], "target_text": TEXTS[i + 1]}
             for i, s in enumerate(("clean", "noisy"))]
    texts = {f"kub{i:05d}": it["target_text"] for i, it in enumerate(items)}

    def mos(path):
        return 3.0 + len(os.path.basename(path)) / 100

    def embed_fn(fn):
        from korean_f5_tts_tpu_torch.utils.audio import load_wav, to_mono

        return lambda path: fn(to_mono(load_wav(path)[0]), load_wav(path)[1])

    kw = dict(nfe_step=4, seed=5, transcribe_fn=lambda p: texts[os.path.basename(p)[:-4]],
              mos_fn=mos)
    want = jkub.evaluate_kub(jmodel, world["jvoc"], items, str(root), str(tmp_path / "j"),
                             embed_fn=embed_fn(world["jembed"]), **kw)
    got = pkub.evaluate_kub(pmodel, world["pvoc"], items, str(root), str(tmp_path / "p"),
                            embed_fn=embed_fn(world["pembed"]), **kw)
    strip = [{k: v for k, v in r.items() if k != "sim"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "sim"} for r in want]
    assert [r["cer"] for r in got] == ["0.0", "0.0"]
    assert all(abs(float(a["sim"]) - float(b["sim"])) < 1e-3 for a, b in zip(got, want))
    _wavs_agree(tmp_path / "j", tmp_path / "p", ["kub00000.wav", "kub00001.wav"])
    summary = pkub.summarize_by_subset(got, "kor_allophone", 1)
    assert [r["subset"] for r in summary] == ["clean", "noisy"] and summary[0]["n"] == 1
    assert pkub.evaluate_kub(pmodel, None, items, str(root), str(tmp_path / "p"), **kw) == got


def test_run_grid_matches_jax(world, same_noise, tmp_path):
    """Two tokenizer modes, one step each, each with its own vocabulary size;
    the port's grid_model_loader against the JAX package's load_model."""
    root = world["dir"]
    test, train = world["test"][:1], world["train"]
    mapping = pkor.build_reference_mapping(test, train)
    yaml_path = tmp_path / "tiny.yaml"
    import yaml

    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": TINY_ARCH,
                              "tokenizer": "custom"}}, open(yaml_path, "w"))

    def ckpt_fn(mode, step):
        path = root / mode / f"model_{step}.npz"
        return str(path) if path.exists() else None

    def jax_loader(mode, ckpt):
        cfg = JaxModelConfig(name="tiny", backbone="DiT", arch=JaxDiTConfig(**TINY_ARCH),
                             tokenizer="custom")
        return jax_load_model(cfg, ckpt_path=ckpt, vocab_file=str(root / mode / "vocab.txt"),
                              tokenizer=mode), world["jvoc"]

    port_loader = pkor.grid_model_loader(str(yaml_path), str(root), "cpu")

    def port_vocoder_loader(mode, ckpt):
        model, _ = port_loader(mode, ckpt)
        return model, world["pvoc"]

    kw = dict(nfe_step=4, seed=2, transcribe_fn=_echo(test))
    want = jkor.run_grid(list(MODES), [1, 2], ckpt_fn, jax_loader, test, mapping,
                         results_dir=str(tmp_path / "j"), **kw)
    got = pkor.run_grid(list(MODES), [1, 2], ckpt_fn, port_vocoder_loader, test, mapping,
                        results_dir=str(tmp_path / "p"), **kw)
    sizes = {m: world["models"][m][1].arch.text_num_embeds for m in MODES}
    assert len(set(sizes.values())) == 2  # each mode its own vocabulary size
    for mode in MODES:
        model, voc = port_loader(mode, ckpt_fn(mode, 1))
        assert model.arch.text_num_embeds == sizes[mode] and model.tokenizer_type == mode
        assert model.device.type == "cpu" and voc.params["head"]["w"].device.type == "cpu"
    strip = [{k: v for k, v in r.items() if k != "out_dir"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "out_dir"} for r in want]
    assert [(r["mode"], r["step"], r["cer"]) for r in got] == [(m, 1, 0.0) for m in MODES]
    for mode in MODES:
        _wavs_agree(tmp_path / "j" / f"{mode}_1", tmp_path / "p" / f"{mode}_1", ["t0000.wav"])


def test_synthesize_bucket_matches_jax_and_each_item_run_alone(world, same_noise, tmp_path):
    jmodel, pmodel = world["models"]["kor_grapheme"]
    meta = [(f"u{i}", world["train"][i]["text"], world["refs"][i], TEXTS[i]) for i in range(3)]
    jprompts = jbatch.get_inference_prompt(meta, num_buckets=1, min_secs=0.5, max_secs=30.0)
    prompts = pbatch.get_inference_prompt(meta, num_buckets=1, min_secs=0.5, max_secs=30.0)
    assert len(prompts) == 1 and len(prompts[0]) == 3
    frames = sorted(it["total_frames"] for it in prompts[0])
    assert len({-(-f // 128) for f in frames}) >= 2  # the batch spans duration buckets
    kw = dict(nfe_step=4, seed=7)
    jbatch.synthesize_bucket(jprompts[0], jmodel, world["jvoc"], str(tmp_path / "j"), **kw)
    reset_launch_counts()
    mels = pbatch.synthesize_bucket(prompts[0], pmodel, world["pvoc"], str(tmp_path / "p"), **kw)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    _wavs_agree(tmp_path / "j", tmp_path / "p", ["u0.wav", "u1.wav", "u2.wav"])
    for it in prompts[0]:
        alone = pbatch.synthesize_bucket([it], pmodel, None, str(tmp_path / "alone"), **kw)
        mel = mels[it["utt"]]
        assert mel.shape[1] == 100 and mel.shape[0] > 10
        # an item that shares its duration bucket with a longer one runs under
        # the group's duration mask, alone under the bucket-tail pad mask:
        # both packages give ~1e-2 here, so the bound is the card's bf16 one
        assert rel_err(mel, alone[it["utt"]]) < ALONE_REL
        # no vocoder: silence of the right length
        assert wavfile.read(tmp_path / "alone" / f"{it['utt']}.wav")[1].size == \
            mel.shape[0] * HOP

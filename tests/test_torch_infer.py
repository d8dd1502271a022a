"""The port's offline inference entry point against the JAX package, on the
CPU at a tiny size (dim 64, depth 2, 4 heads x 16, n 128-256), in fp32.

cfm_sample gets the JAX package's inputs and its noise (handed over as y0;
the two packages draw other numbers from the same seed); composites agree to
1e-4 relative L2 (fp32 sums in another order over the Euler steps). Only
rows inside each item's duration are compared: bucket-tail rows are never
zeroed per block, in either package. The host-side functions (chunk_text,
preprocess_ref_audio_text, _vocode_bucketed, the mel front end) are held to
the JAX package's outputs; the buckets that the JAX package reads from
environment variables are arguments in the port.
"""

import numpy as np
import pytest
import yaml

import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import rel_err, t, tiny_configs, tiny_dit, tiny_vocos
from korean_f5_tts_tpu.infer import utils_infer as jinfer
from korean_f5_tts_tpu.infer.model import TTSModel as JaxTTSModel
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops.mel import MelConfig as JaxMelConfig
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch.config import DiTConfig, ModelConfig
from korean_f5_tts_tpu_torch.infer import cli as pcli
from korean_f5_tts_tpu_torch.infer import utils_infer as pinfer
from korean_f5_tts_tpu_torch.infer.model import TTSModel, load_model
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.vocos import Vocos, init_vocos
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.mel import MelConfig
from korean_f5_tts_tpu_torch.train.checkpoint import (
    load_checkpoint,
    opt_state_from_leaves,
    params_from_jax,
    params_to_jax,
)

REL = 1e-4
SR, HOP = 24_000, 256


def _inputs(b, n_cond, seed=0):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((b, n_cond, 100)).astype(np.float32)
    text = np.full((b, 40), -1, np.int32)
    for i in range(b):
        text[i, :20 + 5 * i] = rng.integers(0, 49, 20 + 5 * i)
    return rng, cond, text


def _valid(x, durs):
    return np.concatenate([np.asarray(x)[i, :d] for i, d in enumerate(durs)])


CASES = {
    # name: (durations, extra keyword arguments of both cfm_sample functions)
    "cfg": ([100, 120], dict(cfg_strength=2.0, sway_sampling_coef=-1.0)),
    "no_cfg": ([100, 120], dict(cfg_strength=0.0, sway_sampling_coef=None)),
    "single_item": ([90], dict(cfg_strength=2.0, sway_sampling_coef=-1.0)),
    "split_by_bucket": ([100, 200, 120], dict(cfg_strength=2.0, sway_sampling_coef=-1.0)),
    "no_split": ([100, 200, 120], dict(cfg_strength=2.0, split_by_bucket=False)),
    "no_ref_audio": ([100, 120], dict(cfg_strength=2.0, no_ref_audio=True)),
    "duplicate_test": ([100, 120], dict(cfg_strength=2.0, duplicate_test=True, t_inter=0.25)),
    "linspace_schedule": ([100, 120], dict(cfg_strength=2.0, use_epss=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cfm_sample_matches_jax(name, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    durs, kwargs = CASES[name]
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    b = len(durs)
    rng, cond, text = _inputs(b, 30)
    lens = np.asarray([30, 24, 28][:b])
    n_bucket = -(-max(durs) // 128) * 128  # the noise is handed over at the bucketed length
    y0 = rng.standard_normal((b, n_bucket, 100)).astype(np.float32)
    want, _ = jcfm.cfm_sample(jparams, jcfg, cond, text, np.asarray(durs), lens=lens, steps=8,
                              y0=jnp.asarray(y0), **kwargs)
    reset_launch_counts()
    got, wav = pcfm.cfm_sample(pparams, pcfg, cond, text, np.asarray(durs), lens=lens, steps=8,
                               y0=t(y0), duration_bucket=128, **kwargs)
    assert wav is None and launch_counts() == dict.fromkeys(KERNELS, 0)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(_valid(got, durs)[:, :]).max() > 0.1
    assert rel_err(_valid(got.numpy(), durs), _valid(want, durs)) < REL
    if name == "split_by_bucket":  # the group of two ran at its own 128-frame bucket
        assert got.shape[1] == 256 and got[[0, 2], 128:].abs().max() == 0


def test_cfm_sample_with_an_edit_mask_matches_jax(monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    rng, cond, text = _inputs(2, 110)
    durs = np.asarray([110, 110])
    edit = np.ones((2, 110), bool)
    edit[0, 40:70] = False   # the span to re-synthesize
    edit[1, 20:50] = False
    y0 = rng.standard_normal((2, 128, 100)).astype(np.float32)
    kwargs = dict(steps=8, cfg_strength=2.0, sway_sampling_coef=-1.0, edit_mask=edit)
    want, _ = jcfm.cfm_sample(jparams, jcfg, cond, text, durs, y0=jnp.asarray(y0), **kwargs)
    got, _ = pcfm.cfm_sample(pparams, pcfg, cond, text, durs, y0=t(y0), duration_bucket=128,
                             **kwargs)
    assert rel_err(_valid(got.numpy(), durs), _valid(want, durs)) < REL
    np.testing.assert_array_equal(got.numpy()[0, :40], cond[0, :40])  # kept as it was


@pytest.mark.parametrize("cfg_strength", [2.0, 0.0])
def test_cfm_sample_fused_vocoder_matches_jax(cfg_strength, monkeypatch):
    monkeypatch.setenv("F5_TTS_DURATION_BUCKET", "128")
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    rng, cond, text = _inputs(1, 30)
    y0 = rng.standard_normal((1, 128, 100)).astype(np.float32)
    kwargs = dict(steps=8, cfg_strength=cfg_strength, sway_sampling_coef=-1.0)
    want_mel, want_wav = jcfm.cfm_sample(jparams, jcfg, cond, text, 100, y0=jnp.asarray(y0),
                                         vocoder_fused=(jvparams, jvcfg), **kwargs)
    got_mel, got_wav = pcfm.cfm_sample(pparams, pcfg, cond, text, 100, y0=t(y0),
                                       duration_bucket=128, vocoder_fused=(pvparams, pvcfg),
                                       **kwargs)
    assert rel_err(got_mel.numpy()[:, :100], np.asarray(want_mel)[:, :100]) < REL
    assert got_wav.shape == (1, 128 * HOP)
    assert rel_err(got_wav.numpy()[:, :90 * HOP], np.asarray(want_wav)[:, :90 * HOP]) < 1e-3
    # the callable vocoder gives the non-fused form of the same decode
    voc = Vocos(pvparams, pvcfg)
    out, none = pcfm.cfm_sample(pparams, pcfg, cond, text, 100, y0=t(y0), duration_bucket=128,
                                vocoder=voc, **kwargs)
    want = jax_vocos_decode(jvparams, jnp.swapaxes(jnp.asarray(want_mel), 1, 2), jvcfg)
    assert none is None and rel_err(out.numpy()[:, :90 * HOP], np.asarray(want)[:, :90 * HOP]) < 1e-3


def test_seeded_noise_is_shared_and_bucket_independent():
    """With a seed every item gets the same noise, drawn at the canonical
    length: a batched item equals the same item alone, at any bucket."""
    _, pcfg = tiny_configs()
    _, pparams, _ = tiny_dit()
    _, cond, text = _inputs(2, 30)
    durs = np.asarray([100, 100])
    kwargs = dict(steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, seed=11, max_duration=512)
    both, _ = pcfm.cfm_sample(pparams, pcfg, cond, text, durs, duration_bucket=128, **kwargs)
    for i in range(2):
        for bucket in (128, 256):
            alone, _ = pcfm.cfm_sample(pparams, pcfg, cond[i:i + 1], text[i:i + 1], 100,
                                       duration_bucket=bucket, **kwargs)
            assert rel_err(alone.numpy()[0, :100], both.numpy()[i, :100]) < REL
    other, _ = pcfm.cfm_sample(pparams, pcfg, cond, text, durs, duration_bucket=128,
                               **{**kwargs, "seed": 12})
    assert rel_err(other.numpy()[:, :100], both.numpy()[:, :100]) > 1e-2
    fresh = [pcfm.cfm_sample(pparams, pcfg, cond, text, durs, duration_bucket=128,
                             **{**kwargs, "seed": None})[0].numpy() for _ in range(2)]
    assert rel_err(fresh[0][:, :100], fresh[1][:, :100]) > 1e-2


@pytest.mark.parametrize("text_bucket", [0, 16, 64])
def test_text_bucket_is_an_argument_and_exact(text_bucket):
    _, pcfg = tiny_configs()
    _, pparams, _ = tiny_dit()
    _, cond, text = _inputs(1, 30)
    kwargs = dict(steps=2, cfg_strength=2.0, seed=3, duration_bucket=128)
    want, _ = pcfm.cfm_sample(pparams, pcfg, cond, text, 100, **kwargs)
    got, _ = pcfm.cfm_sample(pparams, pcfg, cond, text, 100, text_bucket=text_bucket, **kwargs)
    assert rel_err(got.numpy()[:, :100], want.numpy()[:, :100]) < 1e-6
    padded = pcfm.bucket_text(text, text_bucket)
    assert padded.shape[1] == (40 if text_bucket == 0 else 48 if text_bucket == 16 else 64)
    assert (padded[:, 40:] == -1).all()


# --- host-side functions -----------------------------------------------------------

TEXTS = [
    "Hello there. This is a test, with several clauses; and more! Does it split? Yes: it does.",
    "안녕하세요. 오늘은 날씨가 좋습니다, 그래서 산책을 갑니다! 정말요? 네.",
    "今天天气很好。我们去公园吧，好不好？好！那就走吧；带上水。",
    "One sentence without any break at all that simply goes on and on for a good while longer",
    "",
]


@pytest.mark.parametrize("max_chars", [20, 60, 135])
@pytest.mark.parametrize("text", TEXTS)
def test_chunk_text_matches_jax(text, max_chars):
    assert pinfer.chunk_text(text, max_chars) == jinfer.chunk_text(text, max_chars)


@pytest.mark.parametrize("bucket,frames", [(256, 100), (256, 256), (64, 100), (0, 100)])
def test_vocode_bucketed_matches_jax(bucket, frames, monkeypatch):
    monkeypatch.setenv("F5_TTS_VOCODER_BUCKET", str(bucket))
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    mel = np.random.default_rng(2).standard_normal((1, 100, frames)).astype(np.float32)
    want = jinfer._vocode_bucketed(lambda m: jax_vocos_decode(jvparams, m, jvcfg), mel)
    got = pinfer._vocode_bucketed(Vocos(pvparams, pvcfg), mel, bucket)
    assert got.shape == want.shape == (1, (frames - 1) * HOP)
    assert rel_err(got, want) < 1e-4


def _chirp(path, seconds, sr=SR, lead_silence=0.0):
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    wav = 0.3 * np.sin(2 * np.pi * (150.0 + 400.0 * tt) * tt)
    wav = np.concatenate([np.zeros(int(lead_silence * sr)), wav])
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))
    return str(path)


@pytest.mark.parametrize("seconds,lead", [(2.0, 0.0), (1.5, 0.3), (13.0, 0.0)])
def test_preprocess_ref_audio_text_matches_jax(tmp_path, seconds, lead):
    path = _chirp(tmp_path / "ref.wav", seconds, lead_silence=lead)
    (want_wav, want_sr), want_text = jinfer.preprocess_ref_audio_text(
        path, "A reference", show_info=lambda m: None)
    (got_wav, got_sr), got_text = pinfer.preprocess_ref_audio_text(
        path, "A reference", show_info=lambda m: None)
    assert got_sr == want_sr and got_text == want_text == "A reference. "
    np.testing.assert_array_equal(got_wav, want_wav)
    assert len(got_wav) <= 12.1 * SR
    with pytest.raises(ValueError, match="ref_text is empty"):
        pinfer.preprocess_ref_audio_text(_chirp(tmp_path / "other.wav", 1.0), " ",
                                         show_info=lambda m: None)


def test_asr_backend_is_installed_by_the_caller(tmp_path):
    with pytest.raises(RuntimeError, match="no ASR backend"):
        pinfer.transcribe("x.wav")
    pinfer.set_asr_backend(lambda path, language=None: "heard this")
    try:
        path = _chirp(tmp_path / "asr.wav", 1.0)
        _, text = pinfer.preprocess_ref_audio_text(path, "", show_info=lambda m: None)
        assert text == "heard this. "
    finally:
        pinfer.set_asr_backend(None)


def test_mel_of_wav_matches_jax():
    wav = np.random.default_rng(5).standard_normal(9000).astype(np.float32) * 0.1
    want = JaxTTSModel(None, None, JaxMelConfig(), None).mel_of_wav(wav)
    got = TTSModel(None, None, MelConfig(), None, torch.device("cpu")).mel_of_wav(wav)
    assert got.shape == want.shape == (9000 // HOP + 1, 100) and got.dtype == np.float32
    assert rel_err(got, want) < 1e-4


# --- the entry points ----------------------------------------------------------------

TINY_ARCH = dict(dim=64, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
                 text_num_embeds=256)
GEN_TEXT = ("Hello there, this is a test. And a second sentence follows, which is longer than "
            "the first one! Then a third one. A fourth sentence closes the paragraph.")


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """A model config yaml, a JAX-layout .npz checkpoint and a reference wav."""
    d = tmp_path_factory.mktemp("infer")
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": TINY_ARCH,
                              "tokenizer": "byte"}}, open(d / "tiny.yaml", "w"))
    params = redraw_zero_init(init_dit(DiTConfig(**TINY_ARCH), seed=0, device="cpu"), seed=1)
    np.savez(d / "tiny.npz", **{f"params/{k}": v for k, v in params_to_jax(params).items()})
    return d, _chirp(d / "ref.wav", 4.0)


@pytest.mark.parametrize("attn_path", ["default", "qkv_kernel"])
def test_cli_main_end_to_end_on_the_cpu(tiny_files, attn_path, capsys):
    d, ref = tiny_files
    reset_launch_counts()
    pcli.main(["--model_cfg", str(d / "tiny.yaml"), "-p", str(d / "tiny.npz"), "-r", ref,
               "-s", "A reference.", "-t", GEN_TEXT, "-o", str(d), "-w", f"{attn_path}.wav",
               "--device", "cpu", "--nfe_step", "4", "--seed", "3", "--attn_path", attn_path,
               "--save_chunk"])
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    sr, wav = wavfile.read(d / f"{attn_path}.wav")
    # what the pipeline does with this reference and text
    (ref_wav, _), ref_text = pinfer.preprocess_ref_audio_text(ref, "A reference.",
                                                              show_info=lambda m: None)
    secs = len(ref_wav) / SR
    chunks = pinfer.chunk_text(GEN_TEXT, int(len(ref_text.encode()) / secs * (22 - secs)))
    assert len(chunks) >= 3
    ref_frames, ref_bytes = len(ref_wav) // HOP + 1, len(ref_text.encode()) + 1
    gen = [int(ref_frames / ref_bytes * len(c.encode())) for c in chunks]
    want = sum((g - 1) * HOP for g in gen) - int(0.15 * SR) * (len(chunks) - 1)
    assert sr == SR and wav.dtype == np.int16 and wav.shape == (want,)
    assert np.sqrt(np.mean((wav / 32768.0) ** 2)) > 1e-3
    assert f"Generating audio in {len(chunks)} batches" in capsys.readouterr().out
    assert len(list((d / f"{attn_path}_chunks").iterdir())) == 1


def test_f5tts_infer_on_the_cpu(tiny_files):
    d, ref = tiny_files
    tts = papi.F5TTS(str(d / "tiny.yaml"), ckpt_file=str(d / "tiny.npz"), device="cpu",
                     attn_path="rope_in_kernel")
    assert tts.ema_model.device.type == "cpu" and tts.attn_path == "rope_in_kernel"
    out = d / "api.wav"
    wav, sr, spec = tts.infer(ref, "A reference.", "A short sentence to say.", nfe_step=2,
                              seed=1, file_wave=str(out), show_info=lambda m: None)
    again, _, _ = tts.infer(ref, "A reference.", "A short sentence to say.", nfe_step=2, seed=1,
                            show_info=lambda m: None)
    np.testing.assert_array_equal(wav, again)  # the seed fixes the noise
    assert sr == SR and tts.seed == 1 and np.isfinite(wav).all() and np.abs(wav).max() > 0
    assert spec.shape[0] == 100 and wav.shape == ((spec.shape[1] - 1) * HOP,)
    assert wavfile.read(out)[1].shape == wav.shape
    with pytest.raises(ValueError, match="attn_path"):
        papi.F5TTS(str(d / "tiny.yaml"), device="cpu", attn_path="nope")
    with pytest.raises(ValueError, match="unknown model"):
        papi.F5TTS("no_such_model", device="cpu")


ON_THE_CARD_BY_DEFAULT = {
    "init_dit": lambda **kw: init_dit(DiTConfig(**TINY_ARCH), **kw),
    "init_vocos": lambda **kw: init_vocos(**kw),
    "load_model": lambda **kw: load_model(ModelConfig(arch=DiTConfig(**TINY_ARCH)), **kw),
    "params_from_jax": lambda **kw: params_from_jax({"a/w": np.zeros((2, 3), np.float32)}, **kw),
    "opt_state_from_leaves": lambda **kw: opt_state_from_leaves(
        [np.int32(0), np.zeros(2, np.float32), np.zeros(2, np.float32), np.int32(0)],
        {"b": torch.zeros(2)}, **kw),
    "load_vocoder": lambda **kw: papi.load_vocoder(**kw),
}


@pytest.mark.parametrize("name", sorted(ON_THE_CARD_BY_DEFAULT))
def test_entry_points_default_to_the_card_and_raise_without_one(name):
    call = ON_THE_CARD_BY_DEFAULT[name]
    assert call(device="cpu") is not None  # the CPU runs when the caller names it
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()


def test_checkpoint_f5tts_and_cli_default_to_the_card(tiny_files, tmp_path):
    d, ref = tiny_files
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_checkpoint(str(d / "tiny.npz"))
    assert load_checkpoint(str(d / "tiny.npz"), device="cpu")["params"]["proj_out"]["w"].device \
        .type == "cpu"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        papi.F5TTS(str(d / "tiny.yaml"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pcli.main(["--model_cfg", str(d / "tiny.yaml"), "-r", ref, "-s", "A reference.",
                   "-t", "Say this.", "-o", str(tmp_path)])

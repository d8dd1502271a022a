"""Speech editing and batch generation of the port against the JAX package, on
the CPU with one tiny model in both packages (the converter carries the
weights), in fp32.

build_edit_mask is host arithmetic and must be equal. edit_speech and
batch_generate sample: both packages get the same numpy noise (their draws
are patched), and agree to 1e-4 relative L2 on the mel and 1e-3 on a
waveform (the ISTFT sums in another order); the frames an edit keeps are the
input mel exactly.
"""

import numpy as np
import pytest
import yaml

import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import rel_err, tiny_configs, tiny_dit, tiny_vocos
from korean_f5_tts_tpu.infer import batch_infer as jbatch
from korean_f5_tts_tpu.infer import speech_edit as jedit
from korean_f5_tts_tpu.infer.model import TTSModel as JaxTTSModel
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops.mel import MelConfig as JaxMelConfig
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.infer import batch_infer as pbatch
from korean_f5_tts_tpu_torch.infer import speech_edit as pedit
from korean_f5_tts_tpu_torch.infer.model import TTSModel
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.vocos import Vocos
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.mel import MelConfig
from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax

SR, HOP = 24_000, 256
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'")}


def _speech_like(seconds: float) -> np.ndarray:
    """A chirp over a noise floor (a clean chirp leaves mel bins at the log
    clamp, where fp32 rounding alone moves them)."""
    tt = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(5).standard_normal(tt.size)
    return (0.3 * (np.sin(2 * np.pi * (150 + 400 * tt) * tt) + 0.1 * noise)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    jmodel = JaxTTSModel(jparams, jcfg, JaxMelConfig(), VOCAB, tokenizer_type="pinyin")
    pmodel = TTSModel(pparams, pcfg, MelConfig(), VOCAB, torch.device("cpu"),
                      tokenizer_type="pinyin")
    return jmodel, pmodel, (lambda mel: jax_vocos_decode(jvparams, mel, jvcfg)), \
        Vocos(pvparams, pvcfg)


@pytest.fixture
def same_noise(monkeypatch):
    def noise(shape):
        return np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(jcfm.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape), dtype))
    monkeypatch.setattr(pcfm, "draw_noise", lambda seeds, canon, d, device, dtype: torch.stack(
        [torch.from_numpy(noise((canon, d))) for _ in seeds]).to(device=device, dtype=dtype))


@pytest.mark.parametrize("spans,fixes", [
    ([(0.5, 1.2)], None),
    ([(0.5, 1.2), (2.0, 2.4)], None),
    ([(0.5, 1.2), (2.0, 2.4)], [0.3, 1.0]),
    ([(0.0, 0.4)], [0.8]),
    ([], None),
])
def test_build_edit_mask_equals_jax(spans, fixes):
    want_keep, want_off = jedit.build_edit_mask(300, spans, SR, HOP, fixes)
    keep, off = pedit.build_edit_mask(300, spans, SR, HOP, fixes)
    assert keep.dtype == bool and off == want_off
    np.testing.assert_array_equal(keep, want_keep)


@pytest.mark.parametrize("fixes", [None, [0.5]])
def test_edit_speech_matches_jax(models, same_noise, fixes):
    jmodel, pmodel, jvoc, pvoc = models
    wav = _speech_like(1.6)
    args = (wav, "the original words here.", "the replaced words here.", [(0.5, 0.9)])
    kw = dict(fix_durations_s=fixes, nfe_step=4, seed=3)
    want = jedit.edit_speech(jmodel, *args, **kw)
    reset_launch_counts()
    got = pedit.edit_speech(pmodel, *args, **kw)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    keep, _ = pedit.build_edit_mask(wav.size // HOP + 1, [(0.5, 0.9)], SR, HOP, fixes)
    assert got.shape == np.asarray(want).shape == (len(keep), 100) and got.dtype == np.float32
    assert rel_err(got, want) < 1e-4
    # outside the edited span the output is the input's mel, re-timed
    mel = pmodel.mel_of_wav(wav)
    lo, hi = int(0.5 * SR / HOP), int(0.9 * SR / HOP)
    np.testing.assert_array_equal(got[:lo], mel[:lo])
    np.testing.assert_array_equal(got[len(keep) - (mel.shape[0] - hi):], mel[hi:])
    assert np.abs(got[lo:lo + 5] - mel[lo:lo + 5]).max() > 0.1  # the span was regenerated
    # with a vocoder: the waveform of that mel
    want_wav = jedit.edit_speech(jmodel, *args, vocoder=jvoc, **kw)
    got_wav = pedit.edit_speech(pmodel, *args, vocoder=pvoc, **kw)
    assert got_wav.shape == np.asarray(want_wav).shape == ((len(keep) - 1) * HOP,)
    assert rel_err(got_wav, want_wav) < 1e-3


def test_batch_generate_matches_jax(models, same_noise, tmp_path):
    jmodel, pmodel, jvoc, pvoc = models
    ref = tmp_path / "ref.wav"
    wavfile.write(ref, SR, (_speech_like(1.5) * 32767).astype(np.int16))
    other = tmp_path / "other.wav"
    wavfile.write(other, SR, (_speech_like(1.2)[::-1] * 32767).astype(np.int16))
    rows = [{"utt": "a", "text": "the first row of the list."},
            {"utt": "b", "text": "and the second row, which is a little longer!"}]
    kw = dict(ref_audio=str(ref), ref_text="this is the reference.", nfe_step=4, seed=1)
    want = jbatch.batch_generate(jmodel, jvoc, rows, str(tmp_path / "jax"), **kw)
    got = pbatch.batch_generate(pmodel, pvoc, rows, str(tmp_path / "port"), **kw)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["a.wav", "b.wav"]
    for pj, pp in zip(want, got):
        (sr_j, wj), (sr_p, wp) = wavfile.read(pj), wavfile.read(pp)
        assert sr_j == sr_p == SR and wp.shape == wj.shape and wp.size > 10 * HOP
        assert rel_err(wp.astype(np.float64), wj.astype(np.float64)) < 2e-3
    # a second call finds the files and writes nothing
    assert pbatch.batch_generate(pmodel, pvoc, rows, str(tmp_path / "port"), **kw) == []
    # per-row references
    per_row = [{"utt": "c", "text": "a row with its own reference.", "ref_audio": str(other),
                "ref_text": "another reference."}]
    want = jbatch.batch_generate(jmodel, jvoc, per_row, str(tmp_path / "jax"), nfe_step=4, seed=1)
    got = pbatch.batch_generate(pmodel, pvoc, per_row, str(tmp_path / "port"), nfe_step=4, seed=1)
    wj, wp = wavfile.read(want[0])[1], wavfile.read(got[0])[1]
    assert wp.shape == wj.shape and rel_err(wp.astype(np.float64), wj.astype(np.float64)) < 2e-3


TINY_ARCH = dict(dim=64, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
                 text_num_embeds=256)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("edit")
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": TINY_ARCH,
                              "tokenizer": "byte"}}, open(d / "tiny.yaml", "w"))
    params = redraw_zero_init(init_dit(DiTConfig(**TINY_ARCH), seed=0, device="cpu"), seed=1)
    np.savez(d / "tiny.npz", **{f"params/{k}": v for k, v in params_to_jax(params).items()})
    wavfile.write(d / "ref.wav", SR, (_speech_like(2.0) * 32767).astype(np.int16))
    (d / "rows.jsonl").write_text('{"utt": "x", "text": "One row to say."}\n\n'
                                  '{"utt": "y", "text": "And another."}\n')
    return d


def test_speech_edit_main_on_the_cpu(tiny_files, capsys):
    out = tiny_files / "edited.wav"
    pedit.main(["--model_cfg", str(tiny_files / "tiny.yaml"), "--ckpt_file",
                str(tiny_files / "tiny.npz"), "--device", "cpu", "--wav",
                str(tiny_files / "ref.wav"), "--orig_text", "Some words.", "--target_text",
                "Other words.", "--edit_spans", "0.5:0.9,1.2:1.5", "--fix_durations", "0.3,0.4",
                "--nfe_step", "2", "--seed", "1", "--output", str(out), "--attn_int8", "qk"])
    assert capsys.readouterr().out.strip().endswith(str(out))
    sr, wav = wavfile.read(out)
    frames = 2 * SR // HOP + 1 - (int(0.9 * SR / HOP) - int(0.5 * SR / HOP)) \
        - (int(1.5 * SR / HOP) - int(1.2 * SR / HOP)) + int(0.3 * SR / HOP) + int(0.4 * SR / HOP)
    assert sr == SR and wav.shape == ((frames - 1) * HOP,) and np.abs(wav).max() > 0


def test_batch_infer_main_on_the_cpu(tiny_files, capsys):
    out_dir = tiny_files / "batch"
    pbatch.main(["--model_cfg", str(tiny_files / "tiny.yaml"), "--device", "cpu", "--metadata",
                 str(tiny_files / "rows.jsonl"), "--ref_audio", str(tiny_files / "ref.wav"),
                 "--ref_text", "A reference.", "--out_dir", str(out_dir), "--nfe_step", "2",
                 "--seed", "1"])
    assert f"wrote 2 wavs to {out_dir}" in capsys.readouterr().out
    assert sorted(p.name for p in out_dir.iterdir()) == ["x.wav", "y.wav"]


@pytest.mark.parametrize("name", ["speech_edit", "batch_infer"])
def test_edit_and_batch_entry_points_default_to_the_card(name, tiny_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    argv = {"speech_edit": ["--wav", str(tiny_files / "ref.wav"), "--orig_text", "a",
                            "--target_text", "b", "--edit_spans", "0.1:0.2"],
            "batch_infer": ["--metadata", str(tiny_files / "rows.jsonl"), "--out_dir",
                            str(tiny_files / "never")]}[name]
    main = {"speech_edit": pedit.main, "batch_infer": pbatch.main}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--model_cfg", str(tiny_files / "tiny.yaml"), *argv])

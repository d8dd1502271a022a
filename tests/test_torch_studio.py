"""The port's fine-tuning studio (train/finetune_gradio.py) and the copied
studio pieces (utils/slicer.py, socket_client.py, the four framework-free
scripts, the host functions of infer/infer_gradio.py) against the JAX
package's, on the CPU.

- Host functions get the same inputs and must give equal outputs (one
  parametrised test, a case each).
- A project driven through both packages' FinetuneProject (slice, transcribe,
  prepare, vocab check, browsing) writes the same files and resolves the same
  paths, including the places where the tabs do not meet (ROADMAP.md queue 3).
- calculate_train: the port sizes the frame batch from the card's memory
  with the reference's formula; at gpu_memory_gb=80 it equals the JAX
  package's at hbm_gb_per_chip=64 (38,400 frames both).
- start_training builds a command that names the port's finetune_cli and the
  project's device (Popen captured: nothing trains here), and stop_training
  ends a real child's whole session.
- With one tiny DiT (dim 64, depth 2) in both packages and one numpy noise in
  both samplers: synthesize_segments and test_model_infer agree within
  tests/test_torch_infer.py's REL; the launch counters stay 0 on the CPU.
- Every new entry point takes the card by default and raises without one.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

from _torch_port_util import rel_err
from _torch_studio_util import (  # noqa: F401 - fixtures
    GEN_TEXTS,
    MODE,
    REL,
    SENTENCES,
    SR,
    TINY_ARCH,
    few_threads,
    model_pair,
    recording,
    same_noise,
    speech_like,
    vocoder_pair,
    write_model,
    write_wav,
)
from korean_f5_tts_tpu import api as japi
from korean_f5_tts_tpu import config as jconfig
from korean_f5_tts_tpu.infer import infer_gradio as jig
from korean_f5_tts_tpu.scripts import analyze_dataset_stats as jstats
from korean_f5_tts_tpu.scripts import analyze_ngram_dist as jngram
from korean_f5_tts_tpu.scripts import count_max_epoch as jepoch
from korean_f5_tts_tpu.scripts import generate_korean_vocab as jgen
from korean_f5_tts_tpu.train import finetune_gradio as jfg
from korean_f5_tts_tpu.utils import slicer as jslicer
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch import config as pconfig
from korean_f5_tts_tpu_torch import socket_client
from korean_f5_tts_tpu_torch.infer import infer_gradio as pig
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.scripts import analyze_dataset_stats as pstats
from korean_f5_tts_tpu_torch.scripts import analyze_ngram_dist as pngram
from korean_f5_tts_tpu_torch.scripts import count_max_epoch as pepoch
from korean_f5_tts_tpu_torch.scripts import generate_korean_vocab as pgen
from korean_f5_tts_tpu_torch.train import finetune_gradio as pfg
from korean_f5_tts_tpu_torch.utils import slicer as pslicer

JAX = {"fg": jfg, "ig": jig, "slicer": jslicer, "epoch": jepoch, "gen": jgen, "ngram": jngram,
       "stats": jstats, "kw": {}}
PORT = {"fg": pfg, "ig": pig, "slicer": pslicer, "epoch": pepoch, "gen": pgen, "ngram": pngram,
        "stats": pstats, "kw": {"device": "cpu"}}
CARD_MSG = "torch.cuda.is_available"


# ---------------------------------------------------------------------------
# host functions: equal outputs
# ---------------------------------------------------------------------------

SCRIPTS = [
    "Plain text with no tag.",
    "{Regular} Hello there. {Shouting} HEY! {Whisper} psst",
    'Lead. {"name": "Happy", "seed": 7, "speed": 1.3} 좋아요! {Sad} 슬퍼요.',
    '{"name": "Fast", "speed": 1.5} speed only {"seed": 3} seed only {} empty',
    "{Broken {nested} tag} text {Regular}",
    "",
]


def _silences():
    """Speech with a 2 s and a 0.4 s pause at -90 dB, and silent edges."""
    rng = np.random.default_rng(3)
    quiet = lambda s: (3e-5 * rng.standard_normal(int(s * SR))).astype(np.float32)  # noqa: E731
    return np.concatenate([quiet(1.5), speech_like(1.2, 1), quiet(2.0), speech_like(0.8, 2),
                           quiet(0.4), speech_like(1.0, 3), quiet(1.2)])


def _stereo(wav):
    return np.stack([wav, 0.5 * wav])


def _slicer_cases(m):
    rec = recording()
    out = [m["slicer"].Slicer(SR).slice_spans(rec),
           m["slicer"].Slicer(SR, threshold=-30.0, min_length=2000, min_interval=200,
                              hop_size=10, max_sil_kept=300).slice_spans(rec),
           m["slicer"].Slicer(16_000).slice_spans(rec[: 3 * 16_000]),  # shorter than min_length
           m["slicer"].Slicer(SR, min_length=3000).slice_spans(_silences())]
    for bad in (dict(min_length=100, min_interval=300), dict(max_sil_kept=5, hop_size=20)):
        with pytest.raises(ValueError) as e:
            m["slicer"].Slicer(SR, **bad)
        out.append(str(e.value))
    return out


def _vocab_cases(m, tmp):
    d = tmp / "proj"
    d.mkdir(exist_ok=True)
    (d / "metadata.csv").write_text(
        "a.wav|안녕하세요, 반가워요!\nb.wav|신라 국물\nbad line\nc.wav|값이 같이 x\n",
        encoding="utf-8")
    full = tmp / "full.txt"
    full.write_text("\n".join([" ", ",", "!", "x"] + sorted(set(
        "ㅇㅏㄴㄴㅕㅇㅎㅏㅅㅔㅇㅛㅂㅏㄴㄱㅏㅇㅝㅅㅣㄴㄹㅏㄱㅜㄱㅁㅜㄹㄱㅏㅄㅇㅣㄱㅏㅌㅇㅣ"))), encoding="utf-8")
    part = tmp / "part.txt"
    part.write_text(" \nㅇ\nㅏ\n", encoding="utf-8")
    fg = m["fg"]
    return [fg.vocab_check(str(d), str(full), "kor_grapheme"),
            fg.vocab_check(str(d), str(part), "kor_grapheme"),
            fg.vocab_check(str(d), str(part), "kor_allophone"),
            fg.vocab_check(str(d), str(part), "char"),
            fg.vocab_check(str(d), str(tmp / "missing.txt"))[0].replace(str(tmp), "T"),
            fg.vocab_check(str(tmp / "nowhere"), str(full))[0].replace(str(tmp), "T"),
            fg.vocab_count("a,b,,c")]


def _settings_cases(m, tmp):
    fg = m["fg"]
    root = str(tmp / "ckpts")
    saved = fg.save_settings("proj_pinyin", {"learning_rate": 3e-5, "epochs": 7}, root)
    with open(os.path.join(root, "proj", "setting.json"), encoding="utf-8") as f:
        raw = f.read()
    return [saved, raw, fg.load_settings("proj", root), fg.load_settings("proj_char", root),
            fg.load_settings("other", root), fg.DEFAULT_SETTINGS,
            [fg.format_seconds_to_hms(s) for s in (0, 59.9, 3600, 3725.5, 90061)]]


def _browse_cases(m, tmp):
    fg = m["fg"]
    data, ck = tmp / "data", tmp / "ckpts"
    for name in ("a_pinyin", "b_char", "c_other", "d_meta"):
        (data / name).mkdir(parents=True, exist_ok=True)
    (data / "d_meta" / "metadata.csv").write_text("x.wav|t", encoding="utf-8")
    (data / "file_pinyin").write_text("not a dir")
    (ck / "a").mkdir(parents=True, exist_ok=True)
    for f in ("model_100.npz", "model_last.npz", "model_20.pt", "pretrained_x.safetensors",
              "setting.json", "model_5.npz"):
        (ck / "a" / f).write_bytes(b"")
    wavs = data / "a_pinyin" / "wavs"
    wavs.mkdir(exist_ok=True)
    for f in ("z.wav", "a.wav", "n.txt"):
        (wavs / f).write_bytes(b"")
    rel = lambda paths: [os.path.relpath(p, tmp) for p in paths]  # noqa: E731
    return [fg.get_list_projects(str(data)), fg.get_list_projects(str(tmp / "none")),
            rel(fg.get_checkpoints_project("a_pinyin", str(ck))),
            fg.get_checkpoints_project("zzz", str(ck)),
            rel(fg.get_audio_project(str(data / "a_pinyin"))),
            fg.get_audio_project(str(tmp / "none"))]


def _calc_project(tmp, name, durations):
    d = tmp / name
    d.mkdir(exist_ok=True)
    (d / "duration.json").write_text(json.dumps({"duration": durations}))
    return str(d)


def _calculate_cases(m, tmp):
    fg = m["fg"]
    return [fg.calculate_train(_calc_project(tmp, "s", [4.0] * 20), batch_size_type="sample",
                               num_warmup_updates=0),
            fg.calculate_train(_calc_project(tmp, "s2", [3.0, 9.5] * 60), batch_size_type="sample",
                               finetune=False, n_chips=4, max_samples=32),
            fg.calculate_train(_calc_project(tmp, "long", [900.0, 5.0]), batch_size_type="frame"),
            fg.calculate_train(str(tmp / "nope"))]


def _epoch_cases(m, capsys):
    e = m["epoch"]
    out = [e.updates_per_epoch(95_000.0, 307_200), e.max_epochs(1_200_000, 100.0, 38_400),
           e.HOP_S]
    e.main([])
    e.main(["--total_updates", "5000", "--dataset_hours", "12.5", "--frames_per_update", "9600"])
    return out + [capsys.readouterr().out]


def _gen_cases(m, tmp, capsys):
    g = m["gen"]
    modes = ["kor_grapheme", "kor_phoneme", "kor_allophone", "kor_i_only", "kor_c_only",
             "kor_i_and_c", "kor_n_only", "kor_i_and_n", "kor_inf", "kor_nf",
             "kor_efficient_allophone", "kor_no_ieung_g2p", "kor_no_ieung_raw"]
    out = [g.base_jamo()] + [g.vocab_for_mode(mo, skip_tc=s) for mo in modes for s in (False, True)]
    with pytest.raises(ValueError):
        g.vocab_for_mode("nope")
    g.main(["--out_dir", str(tmp / "vocabs"), "--skip_tc"])
    files = {f: (tmp / "vocabs" / f).read_text(encoding="utf-8")
             for f in sorted(os.listdir(tmp / "vocabs"))}
    return out + [files, capsys.readouterr().out.replace(str(tmp), "T")]


TOKEN_ROWS = [list("가나다라 마바사"), ["ㄱ", "ㅏ", " ", "ㄴ", "ㅏ", "!", "ㄱ", "ㅏ"], [], ["a"],
              ["waiting...", "x", "x", "y", "x", "y", "z"]]


def _ngram_cases(m, prepared, capsys):
    n = m["ngram"]
    stats = n.ngram_stats(TOKEN_ROWS)
    data_root, name = prepared[0], f"{prepared[1]}_{MODE}"
    out = [stats, n.ngram_stats(TOKEN_ROWS, orders=(2,), alpha=2.0), n.ngrams("abcd", 3),
           n.ngrams("ab", 3), n.gini(n.Counter({"a": 5, "b": 1})), n.gini(n.Counter()),
           n.renyi_entropy(n.Counter({"a": 2, "b": 2}), alpha=2.5),
           n.shannon_entropy(n.Counter({"a": 1, "b": 3})),
           n.analyze_dataset(name, data_root=data_root),
           n.analyze_dataset("missing", data_root=data_root),
           n.analyze_all([name, "missing"], data_root=data_root)]
    n.main([name, "--data_root", data_root, "--json"])
    return out + [capsys.readouterr().out.replace(data_root, "D")]


def _stats_cases(m, prepared, capsys):
    s = m["stats"]
    data_root, name = prepared
    out = [s.duration_stats([1.0, 2.5, 7.0, 3.25]), s.ngram_distribution(TOKEN_ROWS, 2),
           s.ngram_distribution(TOKEN_ROWS, 3), s.gini(s.Counter({"a": 3, "b": 1, "c": 1})),
           s.entropy(s.Counter({"a": 3, "b": 1})), s.entropy(s.Counter()),
           s.analyze_dataset(data_root, name, MODE, ngram_n=3)]
    s.main(["--data_dir", data_root, "--dataset", name, "--tokenizers", MODE])
    return out + [capsys.readouterr().out]


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A prepared kor_grapheme dataset (the port's prepare: both packages'
    readers take the same arrow stream)."""
    from korean_f5_tts_tpu_torch.train.datasets.prepare import prepare

    d = tmp_path_factory.mktemp("prepared")
    corpus = d / "corpus"
    (corpus / "wavs").mkdir(parents=True)
    lines = []
    for i, text in enumerate(SENTENCES):
        write_wav(corpus / "wavs" / f"u{i}.wav", speech_like(1.0 + 0.3 * i, i))
        lines.append(f"u{i}.wav|{text}")
    (corpus / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    prepare(str(corpus), "tiny", MODE, corpus_format="csv", data_dir=str(d / "data"))
    return str(d / "data"), "tiny"


CASES = {
    "parse_speechtypes_text": lambda m, t, c, p: [m["ig"].parse_speechtypes_text(s)
                                                  for s in SCRIPTS],
    "strip_long_silences": lambda m, t, c, p: [
        m["ig"].strip_long_silences(w, SR).tolist()
        for w in (_silences(), _stereo(_silences()), speech_like(0.5, 9))] + [
        m["ig"].strip_long_silences(None, SR)],
    "load_text_from_file": lambda m, t, c, p: [
        m["ig"].load_text_from_file(write_text(t / "s.txt", "  {Regular} 안녕.\n\n")),
        m["ig"].load_text_from_file(None), m["ig"].load_text_from_file("")],
    "slicer": lambda m, t, c, p: _slicer_cases(m),
    "vocab_check": lambda m, t, c, p: _vocab_cases(m, t),
    "settings": lambda m, t, c, p: _settings_cases(m, t),
    "project_browsing": lambda m, t, c, p: _browse_cases(m, t),
    "calculate_train_sample_type_and_floors": lambda m, t, c, p: _calculate_cases(m, t),
    "count_max_epoch": lambda m, t, c, p: _epoch_cases(m, c),
    "generate_korean_vocab": lambda m, t, c, p: _gen_cases(m, t, c),
    "analyze_ngram_dist": lambda m, t, c, p: _ngram_cases(m, p, c),
    "analyze_dataset_stats": lambda m, t, c, p: _stats_cases(m, p, c),
}


def write_text(path, text: str) -> str:
    path.write_text(text, encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_functions_match_jax(name, tmp_path, capsys, prepared):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = CASES[name](JAX, tmp_path / "j", capsys, prepared)
    got = CASES[name](PORT, tmp_path / "p", capsys, prepared)
    assert got == want


def test_calculate_train_sizes_the_batch_from_the_cards_memory(tmp_path):
    """The reference's formula at gpu_memory_gb=80 and the JAX package's
    scaling at hbm_gb_per_chip=64 both give 38,400 frames, so every
    suggestion agrees; other sizes follow 38400 * (mem - 5) / 75."""
    proj = _calc_project(tmp_path, "p", [5.0, 7.5, 3.2] * 30)
    for kind in ("frame", "sample"):
        for n_chips in (1, 4):
            got = pfg.calculate_train(proj, batch_size_type=kind, gpu_memory_gb=80.0,
                                      n_chips=n_chips)
            want = jfg.calculate_train(proj, batch_size_type=kind, hbm_gb_per_chip=64.0,
                                       n_chips=n_chips)
            assert got == want
    assert pfg.calculate_train(proj, gpu_memory_gb=80.0)["batch_size_per_gpu"] == 38_400
    assert pfg.calculate_train(proj, gpu_memory_gb=24.0)["batch_size_per_gpu"] == 9_728
    assert not hasattr(pfg, "FRAMES_PER_16GB_CHIP")
    assert pfg.device_memory_gb("cpu") > 0  # the system memory available


# ---------------------------------------------------------------------------
# one project through both packages
# ---------------------------------------------------------------------------


def _drive_project(m, work, rec: str):
    """Slice, transcribe, prepare, check, browse: every result with paths
    relative to the working directory, plus the files written."""
    os.chdir(work)
    fg = m["fg"]
    proj = fg.FinetuneProject("voice", **m["kw"])
    created = proj.create()
    clips = proj.slice_audio(rec)
    texts = dict(zip((os.path.basename(c) for c in clips), SENTENCES))
    meta = proj.transcribe_all(lambda p: texts[os.path.basename(p)])
    with pytest.raises(RuntimeError, match="ASR backend"):
        proj.transcribe_all()
    out = proj.prepare_arrow(tokenizer=MODE)
    files = {}
    for root, _, names in os.walk(work):
        for f in names:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, work)] = fh.read()
    return {
        "paths": (proj.dir, proj.wavs_dir, proj.ckpt_dir, created, meta, out),
        "clips": clips,
        "vocab_check": fg.vocab_check(proj.dir, os.path.join(out, "vocab.txt"), MODE),
        "calculate_train_on_the_project_dir": fg.calculate_train(proj.dir),
        "calculate_train_on_prepare_s_dir": fg.calculate_train(out, batch_size_type="sample"),
        "random_transcribe": [fg.get_random_sample_transcribe(proj.dir, seed=s) for s in (0, 1)],
        "random_prepare": [fg.get_random_sample_prepare(out, seed=s) for s in (0, 3)],
        "random_prepare_of_the_project_dir": fg.get_random_sample_prepare(proj.dir),
        "checkpoints": fg.get_checkpoints_project("voice_pinyin"),
        "settings_path": fg._settings_path("voice_pinyin"),
        "files": files,
    }


def test_a_project_through_both_packages_writes_the_same_files(tmp_path, monkeypatch):
    rec = write_wav(tmp_path / "rec.wav", recording())
    results = []
    for m, sub in ((JAX, "j"), (PORT, "p")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        results.append(_drive_project(m, str(tmp_path / sub), rec))
    want, got = results
    assert got == want
    assert len(got["clips"]) == 5 and got["vocab_check"][0] == "You can train using your language !"
    assert got["paths"][-1] == os.path.join("data", f"voice_{MODE}")


def test_the_studio_s_directories_resolve_alike_and_do_not_meet(tmp_path, monkeypatch):
    """The tabs' paths, as both packages resolve them (ROADMAP.md queue 3):
    the training child writes ckpts/{exp}_{tokenizer}_{name} (finetune_cli),
    while Prune and Test look in ckpts/{name}; calculate_train reads
    duration.json from the project's _pinyin directory, while prepare writes
    under data/{name}_{tokenizer}."""
    from korean_f5_tts_tpu_torch.train import finetune_cli as pcli

    monkeypatch.chdir(tmp_path)
    for m in (JAX, PORT):
        proj = m["fg"].FinetuneProject("voice", **m["kw"])
        assert (proj.dir, proj.wavs_dir, proj.ckpt_dir) == (
            os.path.join("data", "voice_pinyin"), os.path.join("data", "voice_pinyin", "wavs"),
            os.path.join("ckpts", "voice"))
        assert m["fg"]._settings_path("voice_pinyin") == os.path.join("ckpts", "voice",
                                                                        "setting.json")
    child_dir = os.path.join("ckpts", "F5TTS_v1_Base_char_voice")  # finetune_cli.py:64
    source = open(pcli.__file__, encoding="utf-8").read()
    assert 'os.path.join("ckpts", f"{args.exp_name}_{args.tokenizer}_{args.dataset_name}")' \
        in source
    assert child_dir != pfg.FinetuneProject("voice", device="cpu").ckpt_dir


# ---------------------------------------------------------------------------
# the training child
# ---------------------------------------------------------------------------


class _Captured:
    """subprocess.Popen that records the command and starts an empty child."""

    def __init__(self):
        self.calls = []
        self.popen = subprocess.Popen

    def __call__(self, cmd, **kw):
        self.calls.append((cmd, kw))
        return self.popen([sys.executable, "-c", "pass"], **kw)


def test_start_training_names_the_port_s_cli_and_the_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cap = _Captured()
    monkeypatch.setattr(pfg.subprocess, "Popen", cap)
    proj = pfg.FinetuneProject("voice", device="cpu")
    pid = proj.start_training(exp_name="F5TTS_Base", tokenizer=MODE,
                              extra_args="--max_updates 2 --logger none")
    (cmd, kw), = cap.calls
    assert pid > 0 and cmd[0] == sys.executable
    assert cmd[1:] == ["-m", "korean_f5_tts_tpu_torch.train.finetune_cli", "--exp_name",
                       "F5TTS_Base", "--dataset_name", "voice", "--tokenizer", MODE,
                       "--device", "cpu", "--max_updates", "2", "--logger", "none"]
    assert kw["start_new_session"] and kw["stdout"] == subprocess.PIPE
    root = os.path.dirname(os.path.dirname(os.path.abspath(pfg.__file__)))
    assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == os.path.dirname(root)
    proj._proc.communicate(timeout=30)
    # JAX's command differs only in the module and the device
    jcap = _Captured()
    monkeypatch.setattr(jfg.subprocess, "Popen", jcap)
    jproj = jfg.FinetuneProject("voice")
    jproj.start_training(exp_name="F5TTS_Base", tokenizer=MODE,
                         extra_args="--max_updates 2 --logger none")
    jproj._proc.communicate(timeout=30)
    jcmd = jcap.calls[0][0]
    assert jcmd[2] == "korean_f5_tts_tpu.train.finetune_cli"
    assert [a for a in cmd if a not in ("--device", "cpu")][3:] == jcmd[3:]


def test_stop_training_ends_the_child_s_session(tmp_path, monkeypatch):
    """A real child (a sleeping Python with a grandchild) in its own session:
    stop_training's killpg ends both."""
    monkeypatch.chdir(tmp_path)
    sleeper = ("import subprocess, sys, time; "
               "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)']); "
               "print('up', flush=True); time.sleep(60)")
    real = subprocess.Popen
    monkeypatch.setattr(pfg.subprocess, "Popen",
                        lambda cmd, **kw: real([sys.executable, "-c", sleeper], **kw))
    proj = pfg.FinetuneProject("voice", device="cpu")
    proj.start_training()
    proc = proj._proc
    assert proc.stdout.readline().strip() == b"up" and proj.is_training()
    with pytest.raises(RuntimeError, match="already running"):
        proj.start_training()
    pgid = os.getpgid(proc.pid)
    proj.stop_training()
    assert proc.wait(timeout=30) == -signal.SIGTERM and not proj.is_training()
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    with pytest.raises(ProcessLookupError):
        os.killpg(pgid, 0)
    proj.stop_training()  # nothing running: a no-op


# ---------------------------------------------------------------------------
# synthesis: synthesize_segments and test_model_infer against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    npz, vocab_path, vocab, flat = write_model(d)
    refs = [write_wav(d / f"ref{i}.wav", speech_like(1.5 + 0.5 * i, 20 + i, 130.0 + 40 * i))
            for i in range(2)]
    return {"dir": d, "npz": npz, "vocab_path": vocab_path, "vocab": vocab, "flat": flat,
            "refs": refs, "models": model_pair(flat, vocab), "vocoders": vocoder_pair()}


def test_synthesize_segments_matches_jax(tiny, same_noise):
    (jmodel, pmodel), (jvoc, pvoc) = tiny["models"], tiny["vocoders"]
    from korean_f5_tts_tpu_torch.utils.audio import load_wav, to_mono

    voices = {}
    for name, path, text in zip(("Regular", "Calm"), tiny["refs"], SENTENCES):
        wav, sr = load_wav(path)
        voices[name] = {"ref_wav": to_mono(wav), "sr": sr, "ref_text": text}
    script = (f'{{"name": "Regular", "seed": 11, "speed": 1.0}} {GEN_TEXTS[0]} '
              f'{{"name": "Calm", "seed": 5, "speed": 1.2}} {GEN_TEXTS[1]} {{Missing}} 없어요.')
    segments = pig.parse_speechtypes_text(script)
    assert segments == jig.parse_speechtypes_text(script)
    np.random.seed(0)  # seed -1 draws a seed from numpy's global generator, in both
    want = jig.synthesize_segments(segments, voices, jmodel, jvoc, nfe_step=3)
    np.random.seed(0)
    reset_launch_counts()
    got = pig.synthesize_segments(segments, voices, pmodel, pvoc, nfe_step=3)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert got[1] == want[1] == SR and got[2] == want[2]
    # Missing falls back to the Regular voice, as in JAX
    assert [u["name"] for u in got[2]] == ["Regular", "Calm", "Missing"]
    assert got[0].shape == want[0].shape and np.abs(got[0]).max() > 0
    assert rel_err(got[0], want[0]) < REL


def test_test_model_infer_matches_jax(tiny, same_noise, monkeypatch):
    """The Test Model tab's core on one .npz in both packages (each package's
    preset cut to the tiny widths, the tiny Vocos in both)."""
    jvoc, pvoc = tiny["vocoders"]
    monkeypatch.setattr(jconfig, "preset_model_config", lambda name: jconfig.ModelConfig(
        arch=jconfig.DiTConfig(**TINY_ARCH)))
    monkeypatch.setattr(pconfig, "preset_model_config", lambda name: pconfig.ModelConfig(
        arch=pconfig.DiTConfig(**TINY_ARCH)))
    monkeypatch.setattr(japi, "load_vocoder", lambda *a, **k: jvoc)
    monkeypatch.setattr(papi, "load_vocoder", lambda *a, **k: pvoc)
    kw = dict(tokenizer=MODE, vocab_file=tiny["vocab_path"], nfe_step=4, speed=1.1, seed=3)
    sr_j, want = jfg.test_model_infer(tiny["npz"], tiny["refs"][0], SENTENCES[0], GEN_TEXTS[0],
                                      **kw)
    reset_launch_counts()
    sr_p, got = pfg.test_model_infer(tiny["npz"], tiny["refs"][0], SENTENCES[0], GEN_TEXTS[0],
                                     device="cpu", **kw)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert sr_p == sr_j == SR and got.shape == want.shape and np.abs(got).max() > 0
    assert rel_err(got, want) < REL
    # kernels=False is the same function on the CPU
    again = pfg.test_model_infer(tiny["npz"], tiny["refs"][0], SENTENCES[0], GEN_TEXTS[0],
                                 device="cpu", kernels=False, **kw)[1]
    np.testing.assert_array_equal(again, got)


# ---------------------------------------------------------------------------
# entry points: the card by default
# ---------------------------------------------------------------------------


def _stubbed(call):
    def run(**kw):
        from korean_f5_tts_tpu_torch.utils import gradio_stub

        gradio_stub.install(force=True)
        try:
            return call(**kw)
        finally:
            gradio_stub.uninstall()
    return run


ON_THE_CARD_BY_DEFAULT = {
    "FinetuneProject": lambda **kw: pfg.FinetuneProject("voice", **kw),
    "device_memory_gb": lambda **kw: pfg.device_memory_gb(**kw),
    "finetune_gradio.build_app": _stubbed(lambda **kw: pfg.build_app(**kw)),
    "finetune_gradio.main": _stubbed(lambda **kw: pfg.main(
        ["--device", kw["device"]] if kw else []) or "launched"),
    "test_model_infer": None,  # filled by the test (needs the tiny files)
    "infer_gradio.build_app": None,
    "infer_gradio.main": None,
    "infer_gradio._load_model_cached": None,
}


@pytest.mark.parametrize("name", sorted(ON_THE_CARD_BY_DEFAULT))
def test_entry_points_default_to_the_card_and_raise_without_one(name, tiny, tmp_path,
                                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pconfig, "preset_model_config", lambda name: pconfig.ModelConfig(
        arch=pconfig.DiTConfig(**TINY_ARCH)))
    monkeypatch.setattr(papi, "load_vocoder", lambda *a, **k: tiny["vocoders"][1])
    pig._load_model_cached.cache_clear()
    files = dict(ckpt_file=tiny["npz"], vocab_file=tiny["vocab_path"])
    extra = {
        "test_model_infer": lambda **kw: pfg.test_model_infer(
            tiny["npz"], tiny["refs"][0], SENTENCES[0], GEN_TEXTS[0], tokenizer=MODE,
            vocab_file=tiny["vocab_path"], nfe_step=2, **kw),
        "infer_gradio.build_app": _stubbed(lambda **kw: pig.build_app("tiny", **files, **kw)),
        "infer_gradio.main": _stubbed(lambda **kw: pig.main(
            ["--ckpt_file", files["ckpt_file"], "--vocab_file", files["vocab_file"]]
            + (["--device", kw["device"]] if kw else [])) or "launched"),
        "infer_gradio._load_model_cached": lambda **kw: pig._load_model_cached(
            "tiny", files["ckpt_file"], files["vocab_file"], MODE, **kw),
    }
    call = ON_THE_CARD_BY_DEFAULT[name] or extra[name]
    assert call(device="cpu") is not None  # the CPU runs when the caller names it
    pig._load_model_cached.cache_clear()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match=CARD_MSG):
        call()


def test_socket_client_reads_until_the_sentinel(tmp_path):
    """request_tts against a local socket that streams float32 PCM in pieces
    and then b"END"; main writes the samples as a 24 kHz wav."""
    import socket
    import threading

    pcm = np.linspace(-0.5, 0.5, 5000, dtype=np.float32)
    srv = socket.socket()
    srv.bind(("localhost", 0))
    srv.listen(2)
    port = srv.getsockname()[1]
    texts = []

    def serve():
        for _ in range(2):
            conn, _ = srv.accept()
            with conn:
                texts.append(conn.recv(1024).decode("utf-8"))
                data = pcm.tobytes()
                for i in range(0, len(data), 3000):
                    conn.sendall(data[i:i + 3000])
                conn.sendall(b"END")

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    got = socket_client.request_tts("localhost", port, "안녕하세요")
    np.testing.assert_array_equal(got, pcm)
    out = tmp_path / "out.wav"
    socket_client.main(["--port", str(port), "--text", "두 번째", "--output", str(out)])
    t.join(timeout=30)
    srv.close()
    from scipy.io import wavfile

    sr, wav = wavfile.read(out)
    assert texts == ["안녕하세요", "두 번째"] and sr == SR and wav.shape == (5000,)

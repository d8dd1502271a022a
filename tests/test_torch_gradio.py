"""The port's two gradio apps (infer/infer_gradio.py, train/finetune_gradio.py)
against the JAX package's, each under its own package's gradio stand-in
(utils/gradio_stub.py), on the CPU.

- Both build_apps record the same component tree: kinds, labels, every
  constructor keyword (Markdown text aside: the titles name each package's
  hardware), nesting, order, and the same event wiring (trigger, source,
  inputs, outputs by position in the tree).
- The two stubs expose the same gradio surface and behave alike.
- Fired through the stub with one tiny DiT (dim 64, depth 2) in both packages
  and one numpy noise in both samplers: the Basic TTS button, the
  multi-speech-type button (two voices, each with its own seed and speed)
  and a voice-chat turn (an injected chat backend) give audio within
  tests/test_torch_infer.py's REL and equal cherry-pick lines; the studio's
  callbacks (create, slice, random samples, vocab check, prepare, prune)
  give the same results.
"""

import os

import numpy as np
import pytest

from _torch_port_util import rel_err
from _torch_studio_util import (  # noqa: F401 - fixtures
    GEN_TEXTS,
    MODE,
    REL,
    SENTENCES,
    SR,
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
from korean_f5_tts_tpu.infer import infer_gradio as jig
from korean_f5_tts_tpu.train import finetune_gradio as jfg
from korean_f5_tts_tpu.utils import gradio_stub as jstub
from korean_f5_tts_tpu_torch import api as papi
from korean_f5_tts_tpu_torch.infer import infer_gradio as pig
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.train import finetune_gradio as pfg
from korean_f5_tts_tpu_torch.utils import gradio_stub as pstub


def layout(container, out=None, parent=-1):
    """[(kind, label, parent index, keywords)] of the tree in walk order."""
    out = [] if out is None else out
    for c in container.children:
        kind = type(c).__name__
        kwargs = {k: (v if not callable(v) else f"<{v.__name__}>") for k, v in c.kwargs.items()}
        value = None if kind in ("Markdown", "HTML") else c.value
        out.append((kind, c.label, parent, value, c.choices, kwargs))
        if hasattr(c, "children"):
            layout(c, out, len(out) - 1)
    return out


def wiring(app):
    """[(trigger, source, inputs, outputs)] by position in the walk."""
    index = {id(c): i for i, c in enumerate(app.walk())}
    return [(e.trigger, index[id(e.source)], [index[id(c)] for c in e.inputs],
             [index[id(c)] for c in e.outputs]) for e in app.all_events]


def build(stub, fn, **kw):
    stub.install(force=True)
    try:
        return fn(**kw)
    finally:
        stub.uninstall()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    npz, vocab_path, vocab, flat = write_model(d)
    refs = [write_wav(d / f"ref{i}.wav", speech_like(1.5 + 0.5 * i, 20 + i, 130.0 + 40 * i))
            for i in range(2)]
    return {"dir": d, "npz": npz, "vocab_path": vocab_path, "refs": refs,
            "models": model_pair(flat, vocab), "vocoders": vocoder_pair()}


@pytest.fixture
def apps(tiny, monkeypatch):
    """Both infer apps on the tiny model pair (the cached loader and the
    vocoder patched in each package)."""
    (jmodel, pmodel), (jvoc, pvoc) = tiny["models"], tiny["vocoders"]
    monkeypatch.setattr(jig, "_load_model_cached", lambda *a, **k: jmodel)
    monkeypatch.setattr(pig, "_load_model_cached", lambda *a, **k: pmodel)
    monkeypatch.setattr(japi, "load_vocoder", lambda *a, **k: jvoc)
    monkeypatch.setattr(papi, "load_vocoder", lambda *a, **k: pvoc)
    return (build(jstub, jig.build_app, model_name="tiny"),
            build(pstub, pig.build_app, model_name="tiny", device="cpu"))


def test_the_stubs_offer_the_same_gradio_surface():
    jmod, pmod = jstub.make_module(), pstub.make_module()
    names = sorted(n for n in vars(jmod) if not n.startswith("_"))
    assert names == sorted(n for n in vars(pmod) if not n.startswith("_"))
    assert jstub._COMPONENTS == pstub._COMPONENTS and jstub._CONTAINERS == pstub._CONTAINERS
    for mod, stub in ((jmod, jstub), (pmod, pstub)):
        with mod.Blocks(title="t") as app:
            with mod.Tab("tab"):
                a = mod.Textbox(label="a", value="x")
                b = mod.Slider(0, 10, 5, label="b")
                ev = mod.Button("go").click(lambda v, n: (v + "!", n + 1), [a, b], [a, b])
        assert ev.fire() == ("x!", 6) and (a.value, b.value) == ("x!", 6)
        assert mod.update(visible=False) == {"__type__": "update", "visible": False}
        assert app.find("Slider", "b") is b and app.find(label="nope") is None
        stub._WARNINGS.clear()
        mod.Warning("w")
        assert stub._WARNINGS == ["w"]
    assert layout(app) == layout(app)


def test_infer_apps_record_the_same_tree(apps):
    japp, papp = apps
    assert layout(papp) == layout(japp)
    assert wiring(papp) == wiring(japp)
    assert len(layout(papp)) > 1000 and len(wiring(papp)) > 300
    tabs = [c.label for c in papp.walk() if type(c).__name__ == "Tab"]
    assert tabs == ["Basic TTS", "Multi-Speech-Type", "Voice Chat"]
    assert papp.title == "Korean F5-TTS (PyTorch/CUDA)" and "TPU" not in papp.title


def test_finetune_apps_record_the_same_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    japp = build(jstub, jfg.build_app)
    papp = build(pstub, pfg.build_app, device="cpu")
    assert layout(papp) == layout(japp)
    assert wiring(papp) == wiring(japp)
    items = [c.label for c in papp.walk() if type(c).__name__ == "TabItem"]
    assert items == ["Transcribe Data", "Vocab Check", "Prepare Data", "Train Model",
                     "Test Model", "Prune Checkpoint", "System Info"]
    assert "TPU" not in papp.title


def _fire(app, cls, label, *args):
    """The first event of the component: its outputs, a tuple."""
    return app.find(cls, label).events[0].fire(*args)


def _one(app, cls, label, *args):
    """The one output of the component's first event."""
    out, = _fire(app, cls, label, *args)
    return out


def test_basic_tts_through_the_stub_matches_jax(apps, tiny, same_noise):
    japp, papp = apps
    args = (tiny["refs"][0], SENTENCES[0], GEN_TEXTS[0], False, 0.15, 4, 1.0)
    (sr_j, want), = _fire(japp, "Button", "Synthesize", *args)
    reset_launch_counts()
    (sr_p, got), = _fire(papp, "Button", "Synthesize", *args)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert sr_p == sr_j == SR and got.shape == want.shape and np.abs(got).max() > 0
    assert rel_err(got, want) < REL
    # "Remove silences": the same trimming of the same audio
    (_, trimmed), = _fire(papp, "Button", "Synthesize", *args[:3], True, *args[4:])
    np.testing.assert_array_equal(trimmed, pig.strip_long_silences(got, SR))


def test_multi_speech_types_through_the_stub_match_jax(apps, tiny, same_noise):
    """Two speech types, each with its own reference, seed and speed; every
    segment's seed comes back in the cherry-pick lines."""
    japp, papp = apps
    n = pig.MAX_SPEECH_TYPES
    names, audios, texts = [None] * n, [None] * n, [None] * n
    names[:2], audios[:2], texts[:2] = ["Regular", "Calm"], tiny["refs"], SENTENCES[:2]
    script = (f'{{"name": "Regular", "seed": 11, "speed": 1.0}} {GEN_TEXTS[0]} '
              f'{{"name": "Calm", "seed": 5, "speed": 1.3}} {GEN_TEXTS[1]}')
    args = (script, 4, False, *names, *audios, *texts)
    (sr_j, want), lines_j = _fire(japp, "Button", "Generate Multi-Style Speech", *args)
    reset_launch_counts()
    (sr_p, got), lines_p = _fire(papp, "Button", "Generate Multi-Style Speech", *args)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert lines_p == lines_j
    assert lines_p.splitlines() == [
        f'{{"name": "Regular", "seed": 11, "speed": 1.0}} {GEN_TEXTS[0]}',
        f'{{"name": "Calm", "seed": 5, "speed": 1.3}} {GEN_TEXTS[1]}']
    assert sr_p == sr_j == SR and got.shape == want.shape and rel_err(got, want) < REL
    # the insert button bakes the row's settings into a tag, as in JAX
    ins = [e for e in papp.all_events if e.source.label == "Insert Label"][1]
    jins = [e for e in japp.all_events if e.source.label == "Insert Label"][1]
    assert ins.fn("x ", "Calm", 5, 1.3) == jins.fn("x ", "Calm", 5, 1.3)


def test_a_voice_chat_turn_through_the_stub_matches_jax(apps, tiny, same_noise, monkeypatch):
    japp, papp = apps
    replies = iter(["네, 안녕하세요!", "네, 안녕하세요!"])
    seen = []

    def backend(name):
        def chat(messages):
            seen.append([m["role"] for m in messages])
            return next(replies)
        return chat

    monkeypatch.setattr(jig, "make_hf_chat_backend", backend)
    monkeypatch.setattr(pig, "make_hf_chat_backend", backend)
    outs = []
    for app in (japp, papp):
        session, status = _fire(app, "Button", "Load chat model", "local-llm", "Be brief.")
        submit = next(e for e in app.all_events if e.trigger == "submit")
        reset_launch_counts()
        outs.append(submit.fire(session, None, "안녕?", tiny["refs"][0], SENTENCES[0]))
        assert launch_counts() == dict.fromkeys(KERNELS, 0)
        assert status == "chat model `local-llm` loaded"
    (_, conv_j, (sr_j, want)), (session, conv_p, (sr_p, got)) = outs
    assert conv_p == conv_j == [{"role": "user", "content": "안녕?"},
                                {"role": "assistant", "content": "네, 안녕하세요!"}]
    assert seen == [["system", "user"]] * 2 and session.system_prompt == "Be brief."
    assert sr_p == sr_j == SR and got.shape == want.shape and rel_err(got, want) < REL
    cleared = _fire(papp, "Button", "Clear conversation", session)
    assert cleared[1:] == ([], None) and session.conversation == []


def _studio(app, tmp, rec):
    """Create, slice, sample, check, prepare and prune through the studio's
    callbacks; every path relative to the working directory."""
    out = {"create": _fire(app, "Button", "Create / refresh", "voice_pinyin")}
    out["slice"] = _one(app, "Button", "Slice", "voice_pinyin", [rec])
    clips = out["slice"].splitlines()
    with open(os.path.join("data", "voice_pinyin", "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(f"{os.path.basename(c)}|{t}" for c, t in zip(clips, SENTENCES)))
    samples = [e for e in app.all_events if e.source.label == "Random sample"]
    text, audio = samples[0].fire("voice_pinyin")  # a draw of its own: the pair must agree
    out["random_transcribed"] = dict(zip(map(os.path.basename, clips), SENTENCES))[
        os.path.basename(audio)] == text and os.path.isfile(audio)
    out["prepare"] = _one(app, "Button", "Prepare", "voice_pinyin", MODE)
    out["check"] = _fire(app, "Button", "Check", "voice_pinyin",
                         os.path.join(out["prepare"], "vocab.txt"), MODE)
    out["random_prepared_of_the_project"] = samples[1].fire("voice_pinyin")
    out["load_settings"] = _one(app, "Button", "Load settings", "voice_pinyin")
    out["save_settings"] = _one(app, "Button", "Save settings", "voice_pinyin", {"epochs": 3})
    out["prune"] = _one(app, "Button", "Prune", "voice_pinyin", str(tmp / "model_tiny.npz"))
    out["pruned"] = {k: v.tolist() for k, v in np.load(out["prune"]).items()}
    out["list_checkpoints"] = _one(app, "Button", "List checkpoints", "voice_pinyin")
    return out


def test_studio_callbacks_through_the_stub_match_jax(tiny, tmp_path, monkeypatch):
    rec = write_wav(tmp_path / "rec.wav", recording())
    results = []
    for sub, stub, fg, kw in (("j", jstub, jfg, {}), ("p", pstub, pfg, {"device": "cpu"})):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        d = tmp_path / sub / "m"
        d.mkdir()
        write_model(d)
        app = build(stub, fg.build_app, **kw)
        results.append(_studio(app, d, rec))
        if sub == "p":  # the port's own: the card's memory, here the system's
            configured = _one(app, "Button", "Auto-configure", "voice_pinyin")
            stats = _one(app, "Button", "Update Stats")
    want, got = results
    got["prune"] = os.path.relpath(got["prune"], tmp_path / "p")
    want["prune"] = os.path.relpath(want["prune"], tmp_path / "j")
    assert got == want
    assert got["check"] == ("You can train using your language !", "")
    assert got["random_transcribed"] is True
    assert len(got["slice"].splitlines()) == 5
    assert len(got["pruned"]) > 10
    # calculate_train reads duration.json from the _pinyin dir, prepare writes
    # under the tokenizer's name: "project not found !" in both packages
    assert configured == jfg.calculate_train(os.path.join("data", "voice_pinyin")) == {
        "error": "project not found !"}
    assert "### Accelerator Stats\nNo CUDA device" in stats and "System Memory:" in stats

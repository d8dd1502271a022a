"""The port's own copies of the framework-free modules against the originals.

korean_f5_tts_tpu_torch/text/ is a copy of korean_f5_tts_tpu/text/ with the
imports renamed, and korean_f5_tts_tpu_torch/serving/native.py a copy of the
batcher bindings that builds its library from the port's own source: the
same strings must give the same tokens for every tokenizer type, and the
same submissions the same batches, through the C++ batcher and the Python
one alike.
"""

import contextlib
import importlib.util
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

from korean_f5_tts_tpu.serving import native as jnative
from korean_f5_tts_tpu.text import vocab as jvocab
from korean_f5_tts_tpu.text.g2p_ko import g2p as jax_g2p
from korean_f5_tts_tpu.text.vocab import KOREAN_TOKENIZER_NAMES
from korean_f5_tts_tpu_torch.scripts import g2p_corpus_audit, pinyin_coverage
from korean_f5_tts_tpu_torch.serving import native as pnative
from korean_f5_tts_tpu_torch.text import vocab as pvocab
from korean_f5_tts_tpu_torch.text.g2p_ko import g2p as port_g2p

STRINGS = [
    "안녕하세요, 오늘 날씨가 참 좋네요.",
    "값이 같이 국물 신라 3개월 동안 12,000원을 모았다!",
    "今天天气很好，我们一起去公园散步吧。",
    "The quick brown fox jumps over the lazy dog; isn't it?",
    "Mixed 한국어 and 中文 and English, all in 1 line.",
]
# a vocab whose contents name no Korean mode, so "custom" detects pinyin
PLAIN_VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz,.!?")}
KOREAN_MODES = sorted(KOREAN_TOKENIZER_NAMES)


@pytest.mark.parametrize("mode", ["custom", "pinyin", "byte"] + KOREAN_MODES)
@pytest.mark.parametrize("skip_tc,legacy", [(False, False), (True, False), (True, True)])
def test_tokenize_text_matches_the_original(mode, skip_tc, legacy):
    kwargs = dict(tokenizer_type=mode, vocab=PLAIN_VOCAB, use_skip_tc=skip_tc, legacy=legacy)
    got = pvocab.tokenize_text(list(STRINGS), **kwargs)
    want = jvocab.tokenize_text(list(STRINGS), **kwargs)
    assert [list(x) for x in got] == [list(x) for x in want]
    assert any(len(x) > 0 for x in got)


@pytest.mark.parametrize("n2gk", [True, False])
def test_tokenize_without_vocab_and_without_normalisation(n2gk):
    for vocab, mode in ((None, "custom"), (PLAIN_VOCAB, "kor_grapheme")):
        got = pvocab.tokenize_text(list(STRINGS), tokenizer_type=mode, vocab=vocab,
                                   use_n2gk_plus=n2gk)
        want = jvocab.tokenize_text(list(STRINGS), tokenizer_type=mode, vocab=vocab,
                                    use_n2gk_plus=n2gk)
        assert [list(x) for x in got] == [list(x) for x in want]


def test_ids_and_byte_tensor_match_the_original():
    tokens = pvocab.tokenize_text(list(STRINGS), vocab=None)
    vocab = {c: i for i, c in enumerate(sorted({c for row in tokens for c in row}))}
    np.testing.assert_array_equal(pvocab.list_str_to_idx(tokens, vocab),
                                  jvocab.list_str_to_idx(tokens, vocab))
    np.testing.assert_array_equal(pvocab.list_str_to_tensor(STRINGS),
                                  jvocab.list_str_to_tensor(STRINGS))
    assert pvocab.detect_tokenizer_type(vocab) == jvocab.detect_tokenizer_type(vocab)


@pytest.mark.parametrize("word,spoken", [("값이", "갑씨"), ("같이", "가치"), ("국물", "궁물"),
                                         ("신라", "실라")])
def test_g2p_outcomes(word, spoken):
    assert port_g2p(word) == jax_g2p(word) == spoken


def test_vocab_file_loads_the_same(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text(" \na\nb\n가\n你\n", encoding="utf-8")
    assert pvocab.load_vocab_file(str(path)) == jvocab.load_vocab_file(str(path))


def _drain(batcher, n):
    """Batches until n request ids have come out: [(bucket, [ids])]."""
    out, seen, deadline = [], 0, time.monotonic() + 10
    while seen < n and time.monotonic() < deadline:
        bucket, ids = batcher.next_batch(timeout_us=50_000)
        if ids:
            out.append((bucket, list(ids)))
            seen += len(ids)
    return out


SUBMISSIONS = [(1, 256), (2, 512), (3, 256), (4, 256), (5, 512), (6, 256), (7, 256)]


@pytest.mark.parametrize("native", [True, False])
def test_batcher_groups_as_the_original(native):
    """Full buckets come out at once, in submission order, cut at max_batch;
    the rest after max_wait; the port's batcher (C++ built from its own
    source, or Python) against the original's."""
    def run(batcher):
        for rid, bucket in SUBMISSIONS:
            batcher.submit(rid, bucket)
        got = _drain(batcher, len(SUBMISSIONS))
        batcher.close()
        return sorted(got)

    port = pnative.NativeBatcher(max_batch=3, max_wait_us=20_000, native=native)
    assert port.is_native is native
    got = run(port)
    want = run(jnative.NativeBatcher(max_batch=3, max_wait_us=20_000))
    assert got == want
    assert sorted(i for _, ids in got for i in ids) == [r for r, _ in SUBMISSIONS]
    assert all(len(ids) <= 3 for _, ids in got)
    assert (256, [1, 3, 4]) in got  # the first full bucket, in submission order


@pytest.mark.parametrize("native", [True, False])
def test_int16_and_crossfade_match_the_original(native):
    rng = np.random.default_rng(0)
    wav = rng.uniform(-1.2, 1.2, 4001).astype(np.float32)
    np.testing.assert_array_equal(pnative.f32_to_i16(wav, native=native), jnative.f32_to_i16(wav))
    a, b = rng.standard_normal(3000).astype(np.float32), rng.standard_normal(2000).astype(np.float32)
    for n_fade in (0, 500, 5000):
        np.testing.assert_allclose(pnative.crossfade(a, b, n_fade, native=native),
                                   jnative.crossfade(a, b, n_fade), rtol=1e-6, atol=1e-6)


def test_the_library_is_built_from_the_ports_own_source():
    from korean_f5_tts_tpu_torch.ops import cuda_build

    path = cuda_build.build_host_library("f5_runtime.cpp", "libf5runtime")
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert (cuda_build.CSRC / "f5_runtime.cpp").exists()


def _jax_script(name: str):
    """The repository's scripts/<name>.py, loaded by path (scripts/ is no package)."""
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main()
    return result, out.getvalue()


def test_g2p_corpus_audit_prints_the_originals_counts():
    want, want_out = _printed(_jax_script("g2p_corpus_audit").main)
    got, got_out = _printed(g2p_corpus_audit.main)
    assert got == want and got[1] >= 150
    assert got_out == want_out  # the per-class table and every mismatch


def test_pinyin_coverage_prints_the_originals_json():
    jax_script = _jax_script("pinyin_coverage")
    assert pinyin_coverage.SAMPLE == jax_script.SAMPLE
    _, want_out = _printed(jax_script.main)
    got, got_out = _printed(pinyin_coverage.main)
    assert json.loads(got_out.splitlines()[-1]) == json.loads(want_out.splitlines()[-1]) == got
    assert got["sample_hanzi_tokens"] > 800

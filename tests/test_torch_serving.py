"""The port's TTSService and HTTP server on the CPU with a tiny model.

Two requests, each answered with int16 audio of (duration - ref_frames) * hop
samples under the server's byte-ratio duration rule; on the CPU no kernel
launches (the wrappers take their plain versions). A bf16 model with int8
weights (models/quant.py) goes through the same service unchanged.
"""

import base64
import io
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from korean_f5_tts_tpu.text.vocab import load_vocab_file
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.infer.model import TTSModel
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.quant import quantize_params
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.mel import MelConfig
from korean_f5_tts_tpu_torch.serving.server import TTSService, serve

SR, HOP = 24_000, 256
REF_TEXT = "This is the reference."
VOCAB = Path(__file__).resolve().parent.parent / "data/Emilia_ZH_EN_pinyin/vocab.txt"


@pytest.fixture(scope="module")
def tiny_model():
    vocab = load_vocab_file(str(VOCAB))
    arch = DiTConfig(dim=64, depth=2, heads=4, dim_head=16, text_dim=32, conv_layers=1,
                     text_num_embeds=len(vocab) + 1)
    params = redraw_zero_init(init_dit(arch, seed=0, device="cpu"), seed=1)
    model = TTSModel(params, arch, MelConfig(), vocab, torch.device("cpu"),
                     tokenizer_type="pinyin")
    vcfg = VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
    return model, Vocos(init_vocos(vcfg, seed=2, device="cpu"), vcfg)


def _chirp(seconds: float) -> np.ndarray:
    tt = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (150 + 400 * tt) * tt)).astype(np.float32)


def _expected_samples(n_ref: int, target: str) -> int:
    ref_frames = n_ref // HOP + 1
    dur = ref_frames + int(ref_frames * len(target.encode()) / (len(REF_TEXT.encode()) + 1))
    return (dur - ref_frames) * HOP


def test_service_answers_two_requests(tiny_model):
    model, vocoder = tiny_model
    service = TTSService(model, vocoder, max_batch=4, max_wait_us=200_000)
    try:
        reset_launch_counts()
        wav = _chirp(2.0)
        targets = ["The first generated sentence.", "And the second one!"]
        items = [service.submit({"ref_wav": wav, "sr": SR, "ref_text": REF_TEXT,
                                 "target_text": tx, "seed": 3, "_duration_frames": 300})
                 for tx in targets]
        for item, tx in zip(items, targets):
            assert item.event.wait(timeout=120)
            assert item.error is None, item.error
            audio, sr = item.result
            assert sr == SR and audio.dtype == np.int16
            assert audio.size == _expected_samples(wav.size, tx)
            assert np.sqrt(np.mean(audio.astype(np.float64) ** 2)) > 0
        assert service.stats["requests"] == 2
        assert launch_counts() == dict.fromkeys(KERNELS, 0)
    finally:
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()


def test_http_roundtrip(tiny_model):
    model, vocoder = tiny_model
    httpd, service = serve(model, vocoder, host="127.0.0.1", port=0, max_wait_us=1000)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        buf = io.BytesIO()
        wav = _chirp(1.5)
        wavfile.write(buf, SR, (wav * 32767).astype(np.int16))
        target = "Served over HTTP by the port."
        body = json.dumps({"reference_audio": base64.b64encode(buf.getvalue()).decode(),
                           "reference_text": REF_TEXT, "target_text": target,
                           "seed": 1}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=body)
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            sr, audio = wavfile.read(io.BytesIO(resp.read()))
        assert sr == SR and audio.dtype == np.int16
        assert audio.size == _expected_samples(wav.size, target)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
            assert json.loads(resp.read())["requests"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_service_requires_a_fused_vocoder(tiny_model):
    """Only a vocoder that exposes .params and .vcfg takes the fused path; a
    plain callable or None is accepted and served by the two-call paths
    (tests/test_torch_serving_paths.py), and the latency benchmark, which
    times the fused call, refuses them."""
    from korean_f5_tts_tpu_torch.serving.benchmark import run_latency_benchmark

    model, vocoder = tiny_model
    for voc, fused in ((vocoder, True), (lambda mel: vocoder(mel), False), (None, False)):
        service = TTSService(model, voc, native_batcher=False)
        try:
            assert (service.vocoder_fused is not None) == fused
        finally:
            service.shutdown(drain=False, timeout=5.0)
            service.batcher.close()
    with pytest.raises(ValueError, match="params"):
        run_latency_benchmark(model, None, n_items=1)


def test_service_serves_an_int8_model_in_bf16(tiny_model, monkeypatch):
    """One request alone (the fused int8 attention path), then two as one
    batch (duration mask: int8 projections one by one); the compute-dtype
    probe of _serve_core_vocos still picks bf16 for a tree that holds int8
    weights and fp32 scales beside its bf16 leaves."""
    model, vocoder = tiny_model
    params = quantize_params(cast_params(model.params, torch.bfloat16))
    assert params["blocks"][0]["attn"]["to_q"]["w_scale"].dtype == torch.float32
    qmodel = TTSModel(params, model.arch, model.mel, model.vocab_char_map, model.device,
                      tokenizer_type="pinyin")
    qvocoder = Vocos(cast_params(vocoder.params, torch.bfloat16), vocoder.vcfg)
    seen = []
    core = pcfm._sample_core

    def spy(params, arch, step_cond, text, mask, *args, **kwargs):
        seen.append((step_cond.dtype, step_cond.shape[0], mask is None))
        return core(params, arch, step_cond, text, mask, *args, **kwargs)

    monkeypatch.setattr(pcfm, "_sample_core", spy)
    service = TTSService(qmodel, qvocoder, max_batch=4, max_wait_us=200_000)
    try:
        reset_launch_counts()
        wav = _chirp(2.0)
        targets = ["Alone first.", "Then a pair, the first.", "And the second of the pair!"]

        def submit(tx):
            return service.submit({"ref_wav": wav, "sr": SR, "ref_text": REF_TEXT,
                                   "target_text": tx, "seed": 5})

        first = submit(targets[0])
        assert first.event.wait(timeout=120)
        pair = [submit(tx) for tx in targets[1:]]
        for item, tx in zip([first, *pair], targets):
            assert item.event.wait(timeout=120)
            assert item.error is None, item.error
            audio, sr = item.result
            assert sr == SR and audio.dtype == np.int16
            assert audio.size == _expected_samples(wav.size, tx)
            assert np.sqrt(np.mean(audio.astype(np.float64) ** 2)) > 0
        assert seen == [(torch.bfloat16, 1, True), (torch.bfloat16, 2, False)]
        assert launch_counts() == dict.fromkeys(KERNELS, 0)
    finally:
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()

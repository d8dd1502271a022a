"""The port's TTSService and HTTP server on the CPU with a tiny model.

Two requests, each answered with int16 audio of (duration - ref_frames) * hop
samples under the server's byte-ratio duration rule; on the CPU no kernel
launches (the wrappers take their plain versions).
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
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
from korean_f5_tts_tpu_torch.ops import launch_counts, reset_launch_counts
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
    params = redraw_zero_init(init_dit(arch, seed=0), seed=1)
    model = TTSModel(params, arch, MelConfig(), vocab, torch.device("cpu"),
                     tokenizer_type="pinyin")
    vcfg = VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
    return model, Vocos(init_vocos(vcfg, seed=2), vcfg)


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
        assert launch_counts() == {"flash_prefix": 0, "ff_block": 0, "grouped_conv": 0}
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
    with pytest.raises(ValueError):
        TTSService(tiny_model[0], None)

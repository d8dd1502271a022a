"""The rest of the port's serving surface on the CPU with tiny models: the
two-call synthesis paths against the JAX service's, the dispatch by vocoder
kind, warm_start, the command lines, the protobuf codec, the gRPC handler
bodies, the socket server and the serving benchmarks.

The two packages draw other numbers from one seed, so the comparisons hand
both the same numpy noise (the noise draws are patched on both sides). fp32
composites agree to 1e-4 relative L2 on the mel and 1e-3 on the waveform
(the ISTFT sums in another order). Every network test binds port 0 on
127.0.0.1 and every wait has a timeout.
"""

import base64
import io
import json
import socket
import threading

import numpy as np
import pytest
import yaml

import jax.numpy as jnp
import torch
from scipy.io import wavfile

from _torch_port_util import rel_err, tiny_configs, tiny_dit, tiny_vocos
from korean_f5_tts_tpu.infer.model import TTSModel as JaxTTSModel
from korean_f5_tts_tpu.models import cfm as jcfm
from korean_f5_tts_tpu.models.vocos import vocos_decode as jax_vocos_decode
from korean_f5_tts_tpu.ops.mel import MelConfig as JaxMelConfig
from korean_f5_tts_tpu.serving import benchmark as jbench
from korean_f5_tts_tpu.serving import proto as jproto
from korean_f5_tts_tpu.serving import server as jserver
from korean_f5_tts_tpu_torch import socket_server as psocket
from korean_f5_tts_tpu_torch.config import DiTConfig
from korean_f5_tts_tpu_torch.infer.model import TTSModel
from korean_f5_tts_tpu_torch.models import cfm as pcfm
from korean_f5_tts_tpu_torch.models.dit import init_dit, redraw_zero_init
from korean_f5_tts_tpu_torch.models.vocos import Vocos, vocos_decode
from korean_f5_tts_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from korean_f5_tts_tpu_torch.ops.mel import MelConfig
from korean_f5_tts_tpu_torch.serving import benchmark as pbench
from korean_f5_tts_tpu_torch.serving import grpc_server as pgrpc
from korean_f5_tts_tpu_torch.serving import proto as pproto
from korean_f5_tts_tpu_torch.serving import server as pserver
from korean_f5_tts_tpu_torch.train.checkpoint import params_to_jax

SR, HOP = 24_000, 256
REF_TEXT = "this is the reference."
VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?'")}
TARGETS = ["the first sentence to say.", "and a second one, a little longer than that!"]


def _chirp(seconds: float, amp: float = 0.3) -> np.ndarray:
    """A chirp over a noise floor: in the bins a clean chirp leaves empty the
    log-mel sits at its 1e-5 clamp, where fp32 rounding alone moves it by 1."""
    tt = np.arange(int(seconds * SR)) / SR
    noise = np.random.default_rng(5).standard_normal(tt.size)
    return (amp * (np.sin(2 * np.pi * (150 + 400 * tt) * tt) + 0.1 * noise)).astype(np.float32)


def _wav_b64(wav: np.ndarray) -> str:
    buf = io.BytesIO()
    wavfile.write(buf, SR, (wav * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def models():
    """One tiny DiT and Vocos in both packages, the same weights."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams, _ = tiny_dit()
    jvcfg, jvparams, pvcfg, pvparams = tiny_vocos()
    jmodel = JaxTTSModel(jparams, jcfg, JaxMelConfig(), VOCAB, tokenizer_type="pinyin")
    pmodel = TTSModel(pparams, pcfg, MelConfig(), VOCAB, torch.device("cpu"),
                      tokenizer_type="pinyin")
    return dict(jmodel=jmodel, pmodel=pmodel,
                jvoc=lambda mel: jax_vocos_decode(jvparams, mel, jvcfg),
                pvoc=lambda mel: vocos_decode(pvparams, mel, pvcfg),
                pvoc_fused=Vocos(pvparams, pvcfg))


@pytest.fixture
def same_noise(monkeypatch):
    """Both packages' samplers draw this numpy noise whatever the seed."""
    def noise(shape):
        return np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(jcfm.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise(shape), dtype))
    monkeypatch.setattr(pcfm, "draw_noise", lambda seeds, canon, d, device, dtype: torch.stack(
        [torch.from_numpy(noise((canon, d))) for _ in seeds]).to(device=device, dtype=dtype))


def _payload(target, wav, nfe=4):
    return {"ref_wav": wav, "sr": SR, "ref_text": REF_TEXT, "target_text": target,
            "nfe_step": nfe, "seed": 7}


def _service(cls, model, vocoder, **kw):
    return cls(model, vocoder, max_batch=4, max_wait_us=1000, **kw)


def _close(service):
    service.shutdown(drain=False, timeout=5.0)
    close = getattr(service.batcher, "close", None)
    if close is not None:
        close()


# --- the two-call synthesis paths against the JAX service ------------------------


def test_synthesize_matches_the_jax_service(models, same_noise):
    """One request through infer_batch_process with a callable vocoder."""
    wav = _chirp(1.5, amp=0.05)  # below the target RMS: boosted, then restored
    js = _service(jserver.TTSService, models["jmodel"], models["jvoc"])
    ps = _service(pserver.TTSService, models["pmodel"], models["pvoc"], native_batcher=False)
    try:
        assert js.vocoder_fused is None and ps.vocoder_fused is None
        want, sr_j = js._synthesize(_payload(TARGETS[0], wav))
        reset_launch_counts()
        got, sr_p = ps._synthesize(_payload(TARGETS[0], wav))
        assert launch_counts() == dict.fromkeys(KERNELS, 0)
    finally:
        _close(js)
        _close(ps)
    assert sr_j == sr_p == SR and got.dtype == np.float32
    assert got.shape == np.asarray(want).shape and got.size > 10 * HOP
    assert np.sqrt(np.mean(got ** 2)) > 0
    assert rel_err(got, want) < 1e-3


def test_synthesize_batch_matches_the_jax_service(models, same_noise):
    """Two requests as one batch: one cfm_sample, one vocoder call on the
    generated mels padded to a 256-frame multiple, per-item slices."""
    wavs = [_chirp(1.5), _chirp(1.1, amp=0.04)]
    js = _service(jserver.TTSService, models["jmodel"], models["jvoc"])
    ps = _service(pserver.TTSService, models["pmodel"], models["pvoc"], native_batcher=False)
    try:
        items_j = [jserver._Pending(_payload(tx, w)) for tx, w in zip(TARGETS, wavs)]
        items_p = [pserver._Pending(_payload(tx, w)) for tx, w in zip(TARGETS, wavs)]
        js._synthesize_batch(items_j, 0)
        ps._synthesize_batch(items_p, 0)
        assert ps.stats["requests"] == 2
    finally:
        _close(js)
        _close(ps)
    for ij, ip, w, tx in zip(items_j, items_p, wavs, TARGETS):
        (want, _), (got, sr) = ij.result, ip.result
        ref_frames = w.size // HOP + 1
        ref_bytes = len(REF_TEXT.encode()) + 1
        gen = int(ref_frames * len(tx.encode()) / ref_bytes)
        assert sr == SR and got.shape == np.asarray(want).shape == (gen * HOP,)
        assert rel_err(got, want) < 1e-3


def test_synthesize_batch_with_the_fused_vocoder_and_without_any(models, same_noise):
    """_synthesize_batch also serves a fused-capable vocoder (the wav comes
    back with the mel) and no vocoder at all (silence of the right length)."""
    wavs = [_chirp(1.5), _chirp(1.1)]
    fused = _service(pserver.TTSService, models["pmodel"], models["pvoc_fused"],
                     native_batcher=False)
    plain = _service(pserver.TTSService, models["pmodel"], models["pvoc"], native_batcher=False)
    none = _service(pserver.TTSService, models["pmodel"], None, native_batcher=False)
    try:
        results = []
        for service in (fused, plain, none):
            items = [pserver._Pending(_payload(tx, w)) for tx, w in zip(TARGETS, wavs)]
            service._synthesize_batch(items, 0)
            results.append([it.result[0] for it in items])
    finally:
        for service in (fused, plain, none):
            _close(service)
    for f, p, z in zip(*results):
        assert f.shape == p.shape == z.shape and np.abs(z).max() == 0
        # the fused decode sees the whole utterance, the second call only the
        # generated frames: equal away from the vocoder's receptive field at the cut
        mid = slice(f.size // 3, 2 * f.size // 3)
        assert rel_err(f[mid], p[mid]) < 0.2 and np.abs(p).max() > 0


def test_run_dispatches_by_vocoder_kind(models, monkeypatch):
    """Fused-capable vocoder: _synthesize_fast for one request and for a
    batch; a plain callable: _synthesize for one, _synthesize_batch for two."""
    calls = []

    def spy(name):
        def fake(self, arg, *rest):
            calls.append((name, 1 if isinstance(arg, dict) else len(arg)))
            if isinstance(arg, dict):
                return np.zeros(HOP, np.float32), SR
            for it in arg:
                it.result = (np.zeros(HOP, np.float32), SR)
        return fake

    for name in ("_synthesize_fast", "_synthesize_batch", "_synthesize"):
        monkeypatch.setattr(pserver.TTSService, name, spy(name))
    wav = _chirp(1.0)
    for vocoder, expect in ((models["pvoc_fused"], [("_synthesize_fast", 1),
                                                    ("_synthesize_fast", 2)]),
                            (models["pvoc"], [("_synthesize", 1), ("_synthesize_batch", 2)])):
        calls.clear()
        service = pserver.TTSService(models["pmodel"], vocoder, max_batch=4, max_wait_us=300_000,
                                     native_batcher=False)
        try:
            first = service.submit(_payload(TARGETS[0], wav))
            assert first.event.wait(timeout=30)
            pair = [service.submit(_payload(tx, wav)) for tx in TARGETS]
            assert all(it.event.wait(timeout=30) and it.error is None for it in pair)
        finally:
            _close(service)
        assert calls == expect


# --- warm_start ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fused", "callable", "none"])
def test_warm_start_prints_and_leaves_the_service_answering(models, kind, capsys):
    vocoder = {"fused": models["pvoc_fused"], "callable": models["pvoc"], "none": None}[kind]
    pserver.warm_start(models["pmodel"], vocoder, [128], 2, batch_sizes=(1, 2), text_tokens=8)
    out = capsys.readouterr().out
    if kind == "fused":
        assert "warmed mel front-end buckets (384, 768, 1152)" in out
        assert "warmed serve bucket 128 batch 1" in out and "batch 2" in out
    else:
        assert "warmed bucket 128 batch 1" in out and "warmed bucket 128 batch 2" in out
        assert ("warmed vocoder lengths 256..128" in out) == (kind == "callable")
    service = _service(pserver.TTSService, models["pmodel"], vocoder, native_batcher=False)
    try:
        item = service.submit(_payload(TARGETS[0], _chirp(1.0), nfe=2))
        assert item.event.wait(timeout=120) and item.error is None, item.error
        assert item.result[0].size > 0
    finally:
        _close(service)


def test_warm_start_prints_the_jax_lines(models, capsys):
    """The printed lines of the two-call branch are the JAX function's."""
    jserver.warm_start(models["jmodel"], models["jvoc"], [256], 2, text_tokens=8)
    want = capsys.readouterr().out
    pserver.warm_start(models["pmodel"], models["pvoc"], [256], 2, text_tokens=8)
    assert capsys.readouterr().out == want


# --- the command lines -------------------------------------------------------------

TINY_ARCH = dict(dim=64, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1,
                 text_num_embeds=256)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    yaml.safe_dump({"model": {"name": "tiny", "backbone": "DiT", "arch": TINY_ARCH,
                              "tokenizer": "byte"}}, open(d / "tiny.yaml", "w"))
    params = redraw_zero_init(init_dit(DiTConfig(**TINY_ARCH), seed=0, device="cpu"), seed=1)
    np.savez(d / "tiny.npz", **{f"params/{k}": v for k, v in params_to_jax(params).items()})
    wavfile.write(d / "ref.wav", SR, (_chirp(2.0) * 32767).astype(np.int16))
    return d


def test_server_main_arguments():
    args = pserver.build_parser().parse_args([])
    assert args.device == "cuda" and args.attn_path == "default" and args.attn_int8 is None
    assert args.warm_buckets == [1024] and args.warm_batch_sizes == [1] and not args.quantize
    args = pserver.build_parser().parse_args(
        ["--device", "cpu", "--attn_int8", "qkpv", "--quantize", "--attn_path", "linear_fused",
         "--warm_buckets", "512", "1024", "--warm_batch_sizes", "1", "2"])
    assert (args.device, args.attn_int8, args.quantize) == ("cpu", "qkpv", True)
    assert args.warm_buckets == [512, 1024] and args.warm_batch_sizes == [1, 2]
    with pytest.raises(SystemExit):
        pserver.build_parser().parse_args(["--attn_int8", "1"])
    # the gRPC front end takes the batch sizes to warm as the HTTP one does
    g = pgrpc.build_parser().parse_args(["--warm_buckets", "256", "--warm_batch_sizes", "1", "4"])
    assert g.device == "cuda" and g.warm_batch_sizes == [1, 4] and g.port == 8001


def test_server_main_on_the_cpu(tiny_files, monkeypatch, capsys):
    """main loads the model on the named device, warms, serves and drains; the
    accept loop and the signal handlers are stubbed."""
    import signal

    handlers = {}
    monkeypatch.setattr(signal, "signal", lambda sig, fn: handlers.setdefault(sig, fn))
    monkeypatch.setattr(pserver.ThreadingHTTPServer, "serve_forever", lambda self: None)
    pserver.main(["--model_cfg", str(tiny_files / "tiny.yaml"), "--ckpt_file",
                  str(tiny_files / "tiny.npz"), "--device", "cpu", "--port", "0", "--nfe_step",
                  "2", "--warm_buckets", "128", "--warm_batch_sizes", "1", "--attn_int8", "qk"])
    out = capsys.readouterr().out
    assert "warmed serve bucket 128 batch 1" in out and "server stopped" in out
    assert set(handlers) == {signal.SIGTERM, signal.SIGINT}
    with pytest.raises(ValueError, match="attn_path"):
        pserver.main(["--model_cfg", str(tiny_files / "tiny.yaml"), "--device", "cpu",
                      "--attn_int8", "qk", "--attn_path", "qkv_kernel"])


ENTRY_POINTS = {
    "server": lambda d: pserver.main(["--model_cfg", str(d / "tiny.yaml")]),
    "grpc_server": lambda d: pgrpc.main(["--model_cfg", str(d / "tiny.yaml")]),
    "benchmark": lambda d: pbench.main(["--model_cfg", str(d / "tiny.yaml"), "--n_items", "1"]),
    "socket_server": lambda d: psocket.main(["--model_cfg", str(d / "tiny.yaml"), "--ref_audio",
                                             str(d / "ref.wav"), "--ref_text", "A reference."]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_serving_entry_points_default_to_the_card(name, tiny_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name](tiny_files)


# --- the protobuf codec ------------------------------------------------------------


def _infer_tensors(pb, wav):
    samples = wav.reshape(1, -1)
    return [pb.InferTensor("reference_wav", "FP32", samples.shape, samples),
            pb.InferTensor("reference_wav_len", "INT32", (1, 1),
                           np.array([[samples.shape[1]]], np.int32)),
            pb.InferTensor("reference_text", "BYTES", (1, 1), [REF_TEXT]),
            pb.InferTensor("target_text", "BYTES", (1, 1), ["안녕하세요, target."])]


def test_proto_bytes_equal_the_jax_modules():
    wav = _chirp(0.1)
    req_j = jproto.encode_model_infer_request("f5_tts", _infer_tensors(jproto, wav),
                                              outputs=["waveform"], request_id="42")
    req_p = pproto.encode_model_infer_request("f5_tts", _infer_tensors(pproto, wav),
                                              outputs=["waveform"], request_id="42")
    assert req_p == req_j
    dec = pproto.decode_model_infer_request(req_j)
    assert dec["model_name"] == "f5_tts" and dec["id"] == "42" and dec["outputs"] == ["waveform"]
    np.testing.assert_array_equal(np.asarray(dec["inputs"]["reference_wav"]).reshape(-1), wav)
    assert dec["inputs"]["target_text"][0].decode() == "안녕하세요, target."
    out = np.linspace(-1, 1, 77, dtype=np.float32)
    resp_j = jproto.encode_model_infer_response(
        "f5_tts", [jproto.InferTensor("waveform", "FP32", (1, 77), out)], request_id="42")
    resp_p = pproto.encode_model_infer_response(
        "f5_tts", [pproto.InferTensor("waveform", "FP32", (1, 77), out)], request_id="42")
    assert resp_p == resp_j
    got = pproto.decode_model_infer_response(resp_j)["outputs"]["waveform"]
    np.testing.assert_array_equal(np.asarray(got).reshape(-1), out)
    assert pproto.encode_ready_response(True) == jproto.encode_ready_response(True)
    assert pproto.decode_ready_response(jproto.encode_ready_response(True)) is True
    assert pgrpc.encode_infer_request("f5_tts", wav, REF_TEXT, "안녕하세요, target.", "42") == req_j


# --- the gRPC handler bodies, the real round trip, the socket server ---------------


@pytest.fixture
def service(models):
    svc = _service(pserver.TTSService, models["pmodel"], models["pvoc_fused"],
                   native_batcher=False)
    svc.nfe_step = 2
    yield svc
    _close(svc)


def _expected_samples(n_ref, target):
    ref_frames = n_ref // HOP + 1
    return int(ref_frames * len(target.encode()) / (len(REF_TEXT.encode()) + 1)) * HOP


def test_grpc_handler_bodies_without_grpc(service):
    wav = _chirp(1.2)
    assert json.loads(pgrpc.health(service, b"{}")) == {"status": "ok"}
    assert pproto.decode_ready_response(pgrpc.server_ready(service, b"")) is True
    body = json.dumps({"reference_audio": _wav_b64(wav), "reference_text": REF_TEXT,
                       "target_text": TARGETS[0], "nfe_step": 2, "seed": 1}).encode()
    resp = json.loads(pgrpc.synthesize(service, body, timeout=120))
    sr, audio = wavfile.read(io.BytesIO(base64.b64decode(resp["audio"])))
    assert sr == resp["sample_rate"] == SR and audio.dtype == np.int16
    assert audio.size == _expected_samples(wav.size, TARGETS[0])
    # the int16 audio of the fused path goes into the file as it is: not clipped
    assert 0 < np.abs(audio).max() < 32767
    req = pgrpc.encode_infer_request("f5_tts", wav, REF_TEXT, TARGETS[1], request_id="9")
    out = pproto.decode_model_infer_response(pgrpc.model_infer(service, req, timeout=120))
    wave = np.asarray(out["outputs"]["waveform"], np.float32).reshape(-1)
    assert out["id"] == "9" and wave.size == _expected_samples(wav.size, TARGETS[1])
    assert 0 < np.abs(wave).max() <= 1.0  # FP32 in [-1, 1], not int16 counts
    bad = pproto.encode_model_infer_request(
        "f5_tts", [pproto.InferTensor("reference_text", "BYTES", (1, 1), ["x"])])
    with pytest.raises(pgrpc.RpcAbort) as err:
        pgrpc.model_infer(service, bad)
    assert err.value.code == "INVALID_ARGUMENT"
    service.max_queue = 0
    with pytest.raises(pgrpc.RpcAbort) as err:
        pgrpc.model_infer(service, req)
    assert err.value.code == "RESOURCE_EXHAUSTED"


def test_grpc_round_trip(service, tmp_path):
    grpc = pytest.importorskip("grpc")
    server = pgrpc.make_grpc_server(service, host="127.0.0.1", port=0)
    server.start()
    wav = _chirp(1.2)
    ref = tmp_path / "ref.wav"
    wavfile.write(ref, SR, (wav * 32767).astype(np.int16))
    target = f"127.0.0.1:{server.bound_port}"
    triton, plain = pgrpc.TritonGrpcClient(target), pgrpc.GrpcTTSClient(target)
    try:
        assert triton.ready() and plain.health() == {"status": "ok"}
        wave, sr = triton.synthesize(wav, REF_TEXT, TARGETS[0])
        assert sr == SR and wave.size == _expected_samples(wav.size, TARGETS[0])
        audio, sr = plain.synthesize(str(ref), REF_TEXT, TARGETS[0], nfe_step=2, seed=3)
        assert sr == SR and wavfile.read(io.BytesIO(audio))[1].size == wave.size
        with pytest.raises(grpc.RpcError) as err:
            triton._infer(pproto.encode_model_infer_request("f5_tts", []), timeout=30)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        stats = pgrpc.load_test(target, [dict(ref_wav_path=str(ref), ref_text=REF_TEXT,
                                              target_text=tx, nfe_step=2) for tx in TARGETS],
                                concurrency=2)
        assert stats["n"] == 2 and stats["latency_ms_p95"] >= stats["latency_ms_p50"] > 0
    finally:
        triton.close()
        plain.close()
        server.stop(grace=None).wait(timeout=10)


def test_socket_server_round_trip(models, tmp_path):
    ref = tmp_path / "ref.wav"
    wavfile.write(ref, SR, (_chirp(1.2) * 32767).astype(np.int16))
    processor = psocket.TTSStreamingProcessor(models["pmodel"], models["pvoc_fused"], str(ref),
                                              REF_TEXT, nfe_step=2)
    ready, stop, port = threading.Event(), threading.Event(), []
    thread = threading.Thread(target=psocket.start_server, daemon=True, kwargs=dict(
        processor=processor, host="127.0.0.1", port=0, stop=stop,
        ready=lambda p: (port.append(p), ready.set())))
    thread.start()
    try:
        assert ready.wait(timeout=30)
        with socket.create_connection(("127.0.0.1", port[0]), timeout=60) as conn:
            conn.sendall(TARGETS[0].encode())
            data = b""
            while not data.endswith(b"END"):
                chunk = conn.recv(65536)
                assert chunk, "the server closed before the END sentinel"
                data += chunk
        pcm = np.frombuffer(data[:-3], np.float32)
        want = b"".join(processor.generate_stream(TARGETS[0]))
        assert pcm.size > 10 * HOP and np.isfinite(pcm).all() and np.abs(pcm).max() > 0
        assert pcm.size == len(want) // 4  # the stream is the processor's own
        writer = psocket.AudioFileWriterThread(str(tmp_path / "out.wav"), SR)
        writer.start()
        for i in range(0, pcm.size, 2048):
            writer.add_chunk(pcm[i:i + 2048])
        writer.stop()
        writer.join(timeout=10)
        assert not writer.is_alive()
        assert wavfile.read(tmp_path / "out.wav")[1].size == pcm.size
    finally:
        stop.set()
        thread.join(timeout=10)
        assert not thread.is_alive()


# --- the serving benchmarks --------------------------------------------------------


def test_benchmark_json_keys_equal_the_jax_ones(models):
    kw = dict(n_items=1, nfe_step=2, gen_seconds=0.6, ref_seconds=0.4, warmup=0)
    jvcfg, jvparams, _, _ = tiny_vocos()

    class JaxVocoder:  # the latency mode needs a fused-capable vocoder
        params, vcfg = jvparams, jvcfg

        def __call__(self, mel):
            return jax_vocos_decode(jvparams, mel, jvcfg)

    want = jbench.run_offline_benchmark(models["jmodel"], JaxVocoder(), **kw)
    got = pbench.run_offline_benchmark(models["pmodel"], models["pvoc_fused"], **kw)
    assert list(got) == list(want)
    assert got["n_items"] == 1 and got["audio_s"] == want["audio_s"] and got["rtf"] > 0
    assert got["dit_time_avg_ms"] > 0 and got["vocoder_time_avg_ms"] > 0
    want = jbench.run_latency_benchmark(models["jmodel"], JaxVocoder(), **kw)
    got = pbench.run_latency_benchmark(models["pmodel"], models["pvoc_fused"], **kw)
    # the JAX result also carries another card's published average, a constant:
    # the port's result holds only what the run measured
    assert list(got) == [k for k in want if k != "reference_l20_avg_ms"]
    assert got["protocol"] == want["protocol"] and got["latency_p95_ms"] >= got["latency_p50_ms"]
    assert json.loads(json.dumps(got)) == got
    # a plain callable serves the offline benchmark's second stage as well
    plain = pbench.run_offline_benchmark(models["pmodel"], models["pvoc"], **kw)
    assert plain["vocoder_time_avg_ms"] > 0


def test_benchmark_main_on_the_cpu(tiny_files, capsys):
    result = pbench.main(["--model_cfg", str(tiny_files / "tiny.yaml"), "--device", "cpu",
                          "--n_items", "1", "--nfe_step", "2", "--latency"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert result["n_items"] == 1 and result["latency_avg_ms"] > 0

"""Batching TTS HTTP server (counterpart of korean_f5_tts_tpu/serving/server.py).

Requests flow submit() -> the C++ dynamic batcher (reused from
korean_f5_tts_tpu.serving.native) -> one worker thread -> serve_sample, which
runs a whole batch (sampler + Vocos, fused) on the device and returns int16
audio. Batches share a duration bucket and one sampling-parameter signature.

Protocol: POST /tts JSON {reference_audio: b64 wav, reference_text,
target_text, nfe_step?, cfg_strength?, sway_sampling_coef?, seed?} ->
audio/wav; GET /health -> {"status": "ok"}; GET /stats -> counters.

Ported here: the fused serving path (_synthesize_fast). The non-fused paths
(_synthesize, _synthesize_batch), warm_start and the CLI wait for later
slices.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from korean_f5_tts_tpu.serving.native import NativeBatcher, f32_to_i16
from korean_f5_tts_tpu.text.vocab import list_str_to_idx, tokenize_text
from korean_f5_tts_tpu_torch.models.cfm import serve_sample
from korean_f5_tts_tpu_torch.utils import audio as au

TARGET_SAMPLE_RATE = 24_000
HOP_LENGTH = 256
TARGET_RMS = 0.1


class ServiceOverloaded(RuntimeError):
    """The queue is at max_queue: reject with 429 instead of queueing."""


class RequestTooLong(ValueError):
    """Estimated duration exceeds max_duration in strict mode."""


class ServiceShuttingDown(RuntimeError):
    """submit() after shutdown() started: new work is refused (503)."""


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "t_enqueue")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.perf_counter()


def _param_signature(payload: dict, nfe_default: int) -> tuple:
    return (int(payload.get("nfe_step", nfe_default)),
            float(payload.get("cfg_strength", 2.0)),
            float(payload.get("sway_sampling_coef", -1.0)),
            payload.get("seed"))


class TTSService:
    """Model + vocoder + batch worker.

    vocoder: an object with .params and .vcfg (models.vocos.Vocos); its
    decode runs inside the sampling call.
    """

    def __init__(self, model_obj, vocoder, max_batch: int = 8, max_wait_us: int = 5_000,
                 nfe_step: int = 16, max_duration: int = 4096, max_queue: int = 64,
                 strict_max_duration: bool = False):
        if vocoder is None or not hasattr(vocoder, "params") or not hasattr(vocoder, "vcfg"):
            raise ValueError("TTSService needs a vocoder with .params and .vcfg (models.vocos.Vocos)")
        self.model = model_obj
        self.vocoder = vocoder
        self.vocoder_fused = (vocoder.params, vocoder.vcfg)
        self.nfe_step = nfe_step
        self.max_duration = max_duration
        self.max_queue = max_queue
        self.strict_max_duration = strict_max_duration
        self.accepting = True
        self.batcher = NativeBatcher(max_batch=max_batch, max_wait_us=max_wait_us)
        # device-resident reference-mel cache, keyed by content hash (LRU)
        self._mel_cache: dict[tuple, tuple] = {}
        self._mel_cache_cap = 64
        self.pending: dict[int, _Pending] = {}
        self.lock = threading.Lock()
        self.counter = 0
        self.param_groups: dict[tuple, int] = {}
        self.stats = {"requests": 0, "batches": 0, "batch_sizes": [], "latency_ms": []}
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.running = True
        self.worker.start()

    def _batch_key(self, payload: dict, bucket: int) -> int:
        """Duration bucket + sampling-parameter group: requests share a batch
        only when (nfe, cfg, sway, seed) all match."""
        sig = _param_signature(payload, self.nfe_step)
        with self.lock:
            gid = self.param_groups.setdefault(sig, len(self.param_groups))
        # batcher keys are int32: the bucket (<= 4096) needs 13 bits
        return (bucket << 18) | (gid & 0x3FFFF)

    def submit(self, payload: dict) -> _Pending:
        # cap the reference at 12 s, as the reference preprocessing clips
        if payload.get("ref_wav") is not None and payload.get("sr"):
            cap = 12 * int(payload["sr"])
            if np.asarray(payload["ref_wav"]).shape[-1] > cap:
                payload["ref_wav"] = np.asarray(payload["ref_wav"])[..., :cap]
        est = max(1, int(payload.get("_duration_frames", 1024)))
        if self.strict_max_duration and est > self.max_duration:
            raise RequestTooLong(f"estimated {est} mel frames exceeds max_duration="
                                 f"{self.max_duration}")
        with self.lock:
            if not self.accepting:
                raise ServiceShuttingDown("server is shutting down")
            if len(self.pending) >= self.max_queue:
                raise ServiceOverloaded(f"queue full ({self.max_queue} requests in flight)")
            self.counter += 1
            rid = self.counter
            item = _Pending(payload)
            self.pending[rid] = item
        # clamp to the frame cap before bucketing, so the key keeps its bits
        bucket = int(np.ceil(min(est, self.max_duration) / 128) * 128)
        self.batcher.submit(rid, self._batch_key(payload, bucket))
        return item

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting, optionally drain queued work, stop the worker and
        fail whatever is still queued."""
        with self.lock:
            self.accepting = False
        deadline = time.monotonic() + timeout
        if drain:
            while time.monotonic() < deadline:
                with self.lock:
                    if not self.pending:
                        break
                time.sleep(0.01)
        self.running = False
        self.worker.join(timeout=max(0.0, deadline - time.monotonic()) + 1.0)
        with self.lock:
            leftovers = list(self.pending.values())
            self.pending.clear()
        for item in leftovers:
            if item.result is None and item.error is None:
                item.error = "ServiceShuttingDown: server stopped before the request was scheduled"
            item.event.set()

    def _run(self):
        while self.running:
            _, ids = self.batcher.next_batch(timeout_us=200_000)
            if not ids:
                continue
            with self.lock:
                items = [self.pending.pop(i) for i in ids if i in self.pending]
            if not items:
                continue
            t0 = time.perf_counter()
            try:
                # partition by exact parameter signature (the int key hashes it)
                groups: dict[tuple, list[_Pending]] = {}
                for it in items:
                    groups.setdefault(_param_signature(it.payload, self.nfe_step), []).append(it)
                for group in groups.values():
                    self._synthesize_fast(group)
            except Exception as e:  # a batch-level failure is reported to all its requests
                for item in items:
                    if item.result is None and item.error is None:
                        item.error = repr(e)
            for item in items:
                item.event.set()
            dt = (time.perf_counter() - t0) * 1e3
            self.stats["batches"] += 1
            self.stats["batch_sizes"].append(len(items))
            self.stats["latency_ms"].append(dt / max(len(items), 1))

    def _ref_mel(self, p: dict) -> tuple:
        """Preprocess + mel one reference, cached on the device by content
        hash. Returns ([1, Bc, d] mel, n_frames, rms). Order as the reference:
        mono, RMS boost below the target, resample, 12 s clip."""
        wav = np.asarray(p["ref_wav"], np.float32)
        key = (hashlib.sha1(wav.tobytes()).hexdigest(), int(p["sr"]))
        with self.lock:
            hit = self._mel_cache.pop(key, None)
            if hit is not None:
                self._mel_cache[key] = hit  # LRU bump
        if hit is not None:
            return hit
        wav = au.to_mono(wav)
        r = au.rms(wav)
        if 0 < r < TARGET_RMS:
            wav = wav * (TARGET_RMS / r)
        if int(p["sr"]) != TARGET_SAMPLE_RATE:
            wav = au.resample(wav, int(p["sr"]), TARGET_SAMPLE_RATE)
        wav = wav[: 12 * TARGET_SAMPLE_RATE]
        mel_dev, n_frames = self.model.mel_of_wav_device(wav)
        entry = (mel_dev, n_frames, float(r))
        with self.lock:
            if len(self._mel_cache) >= self._mel_cache_cap:
                self._mel_cache.pop(next(iter(self._mel_cache)))
            self._mel_cache[key] = entry
        return entry

    def _synthesize_fast(self, items: list[_Pending]) -> None:
        """Cached device ref mels -> one serve_sample call for the whole batch
        (sampler + Vocos + int16 on the device), one int16 readback."""
        mels, texts, durations, lens, scales = [], [], [], [], []
        for it in items:
            p = it.payload
            mel_dev, n_frames, r = self._ref_mel(p)
            mels.append(mel_dev)
            lens.append(n_frames)
            ref_text = p["ref_text"]
            if ref_text and len(ref_text[-1].encode()) == 1:
                ref_text += " "
            gen_text = p["target_text"]
            texts.append(ref_text + gen_text)
            # byte-ratio duration with the reference's short-text slowdown
            speed = 0.3 if len(gen_text.encode()) < 10 else 1.0
            ratio = len(gen_text.encode()) / max(len(ref_text.encode()), 1)
            durations.append(n_frames + int(n_frames * ratio / speed))
            scales.append(r / TARGET_RMS if 0 < r < TARGET_RMS else 1.0)
        token_lists = tokenize_text(
            texts, tokenizer_type=self.model.tokenizer_type, vocab=self.model.vocab_char_map,
            use_n2gk_plus=self.model.use_n2gk_plus, use_skip_tc=self.model.use_skip_tc,
            legacy=self.model.tokenizer_legacy)
        text_ids = np.asarray(list_str_to_idx(token_lists, self.model.vocab_char_map or {" ": 0}))
        cond_b = torch.cat(mels, dim=0)
        p0 = items[0].payload
        wav_i16, durs = serve_sample(
            self.model.params, self.model.arch, cond_b, text_ids,
            np.asarray(durations), np.asarray(lens), vocoder_fused=self.vocoder_fused,
            steps=int(p0.get("nfe_step", self.nfe_step)),
            cfg_strength=float(p0.get("cfg_strength", 2.0)),
            sway_sampling_coef=float(p0.get("sway_sampling_coef", -1.0)),
            seed=p0.get("seed"), wav_scale=np.asarray(scales, np.float32),
            max_duration=self.max_duration)
        wav_np = wav_i16.cpu().numpy()
        for i, it in enumerate(items):
            w = wav_np[i, int(lens[i]) * HOP_LENGTH: int(durs[i]) * HOP_LENGTH]
            if w.size == 0:
                w = np.zeros(HOP_LENGTH, np.int16)
            it.result = (w, TARGET_SAMPLE_RATE)
            self.stats["requests"] += 1


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    from scipy.io import wavfile

    wav = np.asarray(wav)
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav if wav.dtype == np.int16 else f32_to_i16(wav))
    return buf.getvalue()


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, status: int, body: bytes, ctype: str, extra: dict | None = None):
            self.send_response(status)
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                body = {"status": "ok"}
            elif self.path == "/stats":
                lat = service.stats["latency_ms"]
                sizes = service.stats["batch_sizes"]
                body = {
                    "requests": service.stats["requests"],
                    "batches": service.stats["batches"],
                    "avg_batch_size": float(np.mean(sizes)) if sizes else 0.0,
                    "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None,
                    "latency_ms_p95": float(np.percentile(lat, 95)) if lat else None,
                    "native_batcher": service.batcher.is_native,
                }
            else:
                self.send_error(404)
                return
            self._send(200, json.dumps(body).encode(), "application/json")

        def do_POST(self):
            if self.path != "/tts":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                from scipy.io import wavfile

                sr, data = wavfile.read(io.BytesIO(base64.b64decode(req["reference_audio"])))
                if data.dtype == np.int16:
                    data = data.astype(np.float32) / 32768.0
                ref_wav = au.to_mono(data.T if data.ndim == 2 else data)
                payload = {
                    "ref_wav": np.asarray(ref_wav, np.float32),
                    "sr": int(sr),
                    "ref_text": req["reference_text"],
                    "target_text": req["target_text"],
                    "nfe_step": req.get("nfe_step", service.nfe_step),
                    "cfg_strength": req.get("cfg_strength", 2.0),
                    "sway_sampling_coef": req.get("sway_sampling_coef", -1.0),
                    "seed": req.get("seed"),
                }
                # duration estimate for bucketing (byte-length ratio)
                ref_frames = len(ref_wav) / sr * TARGET_SAMPLE_RATE / HOP_LENGTH
                ratio = len(req["target_text"].encode()) / max(
                    len(req["reference_text"].encode()), 1)
                payload["_duration_frames"] = int(ref_frames * (1 + ratio))
                item = service.submit(payload)
                if not item.event.wait(timeout=600):
                    raise TimeoutError("synthesis timed out")
                if item.error:
                    if "ServiceShuttingDown" in item.error:
                        raise ServiceShuttingDown(item.error)
                    raise RuntimeError(item.error)
                wav, sr_out = item.result
                self._send(200, _wav_bytes(wav, sr_out), "audio/wav")
            except Exception as e:  # the HTTP boundary reports every failure
                status = (429 if isinstance(e, ServiceOverloaded) else
                          400 if isinstance(e, RequestTooLong) else
                          503 if isinstance(e, ServiceShuttingDown) else
                          504 if isinstance(e, TimeoutError) else 500)
                extra = {"Retry-After": "1"} if status == 429 else None
                self._send(status, json.dumps({"error": repr(e)}).encode(),
                           "application/json", extra)

    return Handler


def serve(model_obj, vocoder, host: str = "0.0.0.0", port: int = 8000, max_batch: int = 8,
          max_wait_us: int = 5_000, nfe_step: int = 16, max_queue: int = 64,
          strict_max_duration: bool = False):
    """Build the service and its HTTP server; the caller runs
    httpd.serve_forever() (in a thread or the main loop) and shuts both down."""
    service = TTSService(model_obj, vocoder, max_batch=max_batch, max_wait_us=max_wait_us,
                         nfe_step=nfe_step, max_queue=max_queue,
                         strict_max_duration=strict_max_duration)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"serving on {host}:{port} (native batcher: {service.batcher.is_native})")
    return httpd, service

"""Batching TTS HTTP server (counterpart of korean_f5_tts_tpu/serving/server.py).

Requests flow submit() -> the C++ dynamic batcher (serving/native.py, built
from csrc/f5_runtime.cpp at first use) -> one worker thread -> serve_sample, which
runs a whole batch (sampler + Vocos, fused) on the device and returns int16
audio. Batches share a duration bucket and one sampling-parameter signature.

Protocol: POST /tts JSON {reference_audio: b64 wav, reference_text,
target_text, nfe_step?, cfg_strength?, sway_sampling_coef?, seed?} ->
audio/wav; GET /health -> {"status": "ok"}; GET /stats -> counters.

A vocoder that exposes .params and .vcfg (models.vocos.Vocos) takes the fused
path (_synthesize_fast: sampler, Vocos and int16 in one call); any other
callable, or None, takes the two-call paths (_synthesize_batch for a batch,
_synthesize through infer_batch_process for one request). warm_start runs
every (bucket, batch) shape once before traffic: on a GPU that builds the
kernels, fills cuBLAS and allocator state and warms the mel front-end; there
is no compile to wait for. main is the command line: python -m
korean_f5_tts_tpu_torch.serving.server, on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from korean_f5_tts_tpu_torch.infer.utils_infer import infer_batch_process, vocoder_input
from korean_f5_tts_tpu_torch.models.cfm import cfm_sample, serve_sample
from korean_f5_tts_tpu_torch.ops.attention import ATTN_PATHS, check_attn_int8, check_attn_path
from korean_f5_tts_tpu_torch.serving.native import NativeBatcher, f32_to_i16
from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, tokenize_text
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


def _fused_of(vocoder) -> tuple | None:
    """(params, config) of a vocoder that exposes them, for the fused
    sampler + vocoder call; None for a plain callable or no vocoder."""
    if vocoder is not None and hasattr(vocoder, "params") and hasattr(vocoder, "vcfg"):
        return vocoder.params, vocoder.vcfg
    return None


class TTSService:
    """Model + vocoder + batch worker.

    vocoder: an object with .params and .vcfg (models.vocos.Vocos), whose
    decode then runs inside the sampling call (vocoder_fused); or any
    callable mel [b, d, n] tensor -> waveform tensor (fp32 on the model's
    device in, see infer/utils_infer.py:vocoder_input), decoded in a second
    call; or None (silence of the right length). attn_path picks the
    attention half's kernels (ops/attention.py:ATTN_PATHS), attn_int8 the
    int8 attention kernel in kernel A's place (ATTN_INT8). native_batcher=True
    queues requests in the C++ batcher (built at first use, or raises); False
    in the Python batcher of the same semantics.
    """

    def __init__(self, model_obj, vocoder, max_batch: int = 8, max_wait_us: int = 5_000,
                 nfe_step: int = 16, max_duration: int = 4096, max_queue: int = 64,
                 strict_max_duration: bool = False, attn_path: str = "default",
                 native_batcher: bool = True, attn_int8: str | None = None):
        self.model = model_obj
        self.vocoder = vocoder
        self.vocoder_fused = _fused_of(vocoder)
        self.nfe_step = nfe_step
        self.max_duration = max_duration
        self.max_queue = max_queue
        self.strict_max_duration = strict_max_duration
        self.accepting = True
        self.attn_path = check_attn_path(attn_path)
        self.attn_int8 = check_attn_int8(attn_int8, attn_path)
        self.batcher = NativeBatcher(max_batch=max_batch, max_wait_us=max_wait_us,
                                     native=native_batcher)
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
            bucket, ids = self.batcher.next_batch(timeout_us=200_000)
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
                    if self.vocoder_fused is not None:
                        self._synthesize_fast(group)  # single requests and batches
                    elif len(group) > 1:
                        self._synthesize_batch(group, bucket)
                    else:
                        group[0].result = self._synthesize(group[0].payload)
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
            max_duration=self.max_duration, attn_path=self.attn_path,
            attn_int8=self.attn_int8)
        wav_np = wav_i16.cpu().numpy()
        for i, it in enumerate(items):
            w = wav_np[i, int(lens[i]) * HOP_LENGTH: int(durs[i]) * HOP_LENGTH]
            if w.size == 0:
                w = np.zeros(HOP_LENGTH, np.int16)
            it.result = (w, TARGET_SAMPLE_RATE)
            self.stats["requests"] += 1

    def _synthesize_batch(self, items: list[_Pending], bucket: int) -> None:
        """Batched synthesis with a callable vocoder (_run sends a fused one to
        _synthesize_fast): one cfm_sample over the whole batch with per-item
        lens and durations, then one vocoder call on the generated mels padded
        to a 256-frame multiple. Single-chunk texts only."""
        mels, texts, durations, rms_vals = [], [], [], []
        for it in items:
            p = it.payload
            wav = au.to_mono(np.asarray(p["ref_wav"], np.float32))
            r = au.rms(wav)
            rms_vals.append(r)
            if 0 < r < TARGET_RMS:
                wav = wav * (TARGET_RMS / r)
            if p["sr"] != TARGET_SAMPLE_RATE:
                wav = au.resample(wav, p["sr"], TARGET_SAMPLE_RATE)
            wav = wav[: 12 * TARGET_SAMPLE_RATE]  # the reference preprocessing's clip
            mel = self.model.mel_of_wav(wav)
            mels.append(mel)
            ref_text = p["ref_text"]
            if ref_text and len(ref_text[-1].encode()) == 1:
                ref_text += " "
            texts.append(ref_text + p["target_text"])
            ref_len = mel.shape[0]
            ratio = len(p["target_text"].encode()) / max(len(ref_text.encode()), 1)
            durations.append(ref_len + int(ref_len * ratio))

        d = self.model.mel.n_mel_channels
        cond = np.zeros((len(items), max(m.shape[0] for m in mels), d), np.float32)
        for i, m in enumerate(mels):
            cond[i, : m.shape[0]] = m
        lens = np.array([m.shape[0] for m in mels])
        token_lists = tokenize_text(
            texts, tokenizer_type=self.model.tokenizer_type, vocab=self.model.vocab_char_map,
            use_n2gk_plus=self.model.use_n2gk_plus, use_skip_tc=self.model.use_skip_tc)
        text_ids = list_str_to_idx(token_lists, self.model.vocab_char_map or {" ": 0})
        # cfm_sample's own duration floor and clamp, mirrored so that the
        # slices below agree with what was generated
        text_lens = np.asarray((np.asarray(text_ids) != -1).sum(axis=-1))
        durations = np.maximum(np.maximum(text_lens, lens) + 1, np.asarray(durations))
        durations = np.clip(durations, None, self.max_duration)
        p0 = items[0].payload  # the batch key guarantees uniform sampling parameters
        out, _ = cfm_sample(
            self.model.params, self.model.arch, cond, text_ids, np.array(durations), lens=lens,
            steps=int(p0.get("nfe_step", self.nfe_step)),
            cfg_strength=float(p0.get("cfg_strength", 2.0)),
            sway_sampling_coef=float(p0.get("sway_sampling_coef", -1.0)),
            seed=p0.get("seed"), max_duration=self.max_duration,
            attn_path=self.attn_path, attn_int8=self.attn_int8)
        out = out.float().cpu().numpy()
        gen_lens = np.array([durations[i] - lens[i] for i in range(len(items))])
        wavs: list[np.ndarray | None] = [None] * len(items)
        if self.vocoder is not None and gen_lens.max(initial=0) > 1:
            # a second call: every item's generated mel padded to one 256-frame
            # multiple; pad frames replicate the final frame (zeros are loud in
            # log-mel space and would bleed into the sliced tail)
            voc_len = max(256, int(-(-int(gen_lens.max()) // 256)) * 256)
            genb = np.zeros((len(items), out.shape[-1], voc_len), np.float32)
            for i in range(len(items)):
                if gen_lens[i] > 0:
                    g = out[i, lens[i]: durations[i], :].T
                    genb[i, :, : gen_lens[i]] = g
                    genb[i, :, gen_lens[i]:] = g[:, -1:]
            wavb = self.vocoder(vocoder_input(self.vocoder, genb, self.model.device))
            wavb = wavb.float().cpu().numpy().reshape(len(items), -1)
            for i in range(len(items)):
                wavs[i] = wavb[i, : int(gen_lens[i]) * HOP_LENGTH]
        for i, it in enumerate(items):
            wav = wavs[i]
            if wav is None or wav.size == 0:
                wav = np.zeros(max(int(gen_lens[i]), 1) * HOP_LENGTH, np.float32)
            if 0 < rms_vals[i] < TARGET_RMS:
                wav = wav * (rms_vals[i] / TARGET_RMS)
            it.result = (wav, TARGET_SAMPLE_RATE)
            self.stats["requests"] += 1

    def _synthesize(self, p: dict) -> tuple[np.ndarray, int]:
        """One request through infer_batch_process (the offline path's
        per-chunk synthesis) with the service's vocoder."""
        gen = next(infer_batch_process(
            (p["ref_wav"], p["sr"]), p["ref_text"], [p["target_text"]], self.model,
            self.vocoder,
            nfe_step=int(p.get("nfe_step", self.nfe_step)),
            cfg_strength=float(p.get("cfg_strength", 2.0)),
            sway_sampling_coef=float(p.get("sway_sampling_coef", -1.0)),
            seed=p.get("seed"), attn_path=self.attn_path, attn_int8=self.attn_int8))
        self.stats["requests"] += 1
        return gen[0], TARGET_SAMPLE_RATE


def _wav_bytes(wav: np.ndarray, sr: int, native: bool = True) -> bytes:
    from scipy.io import wavfile

    wav = np.asarray(wav)
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav if wav.dtype == np.int16 else f32_to_i16(wav, native=native))
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
                self._send(200, _wav_bytes(wav, sr_out, native=service.batcher.is_native),
                           "audio/wav")
            except Exception as e:  # the HTTP boundary reports every failure
                status = (429 if isinstance(e, ServiceOverloaded) else
                          400 if isinstance(e, RequestTooLong) else
                          503 if isinstance(e, ServiceShuttingDown) else
                          504 if isinstance(e, TimeoutError) else 500)
                extra = {"Retry-After": "1"} if status == 429 else None
                self._send(status, json.dumps({"error": repr(e)}).encode(),
                           "application/json", extra)

    return Handler


def warm_start(model_obj, vocoder, buckets: list[int] = (512, 1024, 1536),
               nfe_step: int = 16, batch_sizes: tuple = (1,), text_tokens: int = 16,
               attn_path: str = "default", attn_int8: str | None = None) -> None:
    """Run the sampler and the vocoder once per serving (duration bucket,
    batch size) before traffic, through the same calls the service makes.

    Nothing compiles per shape here: the first call builds and loads the
    kernels, and each shape's run fills cuBLAS's workspaces and the
    allocator's pools and warms the mel front-end's buckets, so the first
    real request pays none of it. batch_sizes: the batcher forms batches of
    1..max_batch; text_tokens: the request token count to warm with.
    """
    fused = _fused_of(vocoder)
    d = model_obj.mel.n_mel_channels
    dev = model_obj.device

    def fence(t: torch.Tensor) -> None:
        float(t.float().abs().sum())  # a readback: the work has finished

    if fused is not None:
        hop = model_obj.mel.hop_length
        for f_b in model_obj.REF_FRAME_BUCKETS:
            mel_dev, _ = model_obj.mel_of_wav_device(np.zeros((f_b - 1) * hop, np.float32))
        fence(mel_dev)
        print(f"warmed mel front-end buckets {model_obj.REF_FRAME_BUCKETS}")
        bc = model_obj.REF_FRAME_BUCKETS[-1]
        for n in buckets:
            for b in batch_sizes:
                cond = torch.zeros((b, bc, d), dtype=torch.float32, device=dev)
                text = np.zeros((b, max(1, text_tokens)), np.int32)
                lens = np.full((b,), min(256, n // 2), np.int64)
                dur = np.full((b,), max(n - 64, int(lens[0]) + 2, text_tokens + 2), np.int64)
                wav, _ = serve_sample(
                    model_obj.params, model_obj.arch, cond, text, dur, lens,
                    vocoder_fused=fused, steps=nfe_step, cfg_strength=2.0,
                    sway_sampling_coef=-1.0, seed=0, duration_bucket=n, attn_path=attn_path,
                    attn_int8=attn_int8)
                fence(wav)
                print(f"warmed serve bucket {n} batch {b}")
        return
    for n in buckets:
        for b in batch_sizes:
            cond = np.zeros((b, min(256, n // 2), d), np.float32)
            text = np.zeros((b, max(1, text_tokens)), np.int32)
            lens = np.full((b,), cond.shape[1], np.int64)
            # a duration below the bucket, as real requests have: that is what
            # makes the bucket-tail pad mask
            dur = max(n - 64, cond.shape[1] + 2, text_tokens + 2)
            out, _ = cfm_sample(
                model_obj.params, model_obj.arch, cond, text,
                duration=np.full((b,), dur, np.int64), lens=lens, steps=nfe_step,
                cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0, duration_bucket=n,
                attn_path=attn_path, attn_int8=attn_int8)
            if vocoder is not None:
                mel = out.float().cpu().numpy().swapaxes(1, 2)
                fence(vocoder(vocoder_input(vocoder, mel, dev)))
            else:
                fence(out)
            print(f"warmed bucket {n} batch {b}")
    if vocoder is not None:
        # the batch path decodes generated mels at 256-frame multiples
        for vn in range(256, max(buckets) + 1, 256):
            fence(vocoder(vocoder_input(vocoder, np.zeros((1, d, vn), np.float32), dev)))
        print(f"warmed vocoder lengths 256..{max(buckets)}")


def serve(model_obj, vocoder, host: str = "0.0.0.0", port: int = 8000, max_batch: int = 8,
          max_wait_us: int = 5_000, nfe_step: int = 16, max_queue: int = 64,
          strict_max_duration: bool = False, attn_path: str = "default",
          native_batcher: bool = True, attn_int8: str | None = None):
    """Build the service and its HTTP server; the caller runs
    httpd.serve_forever() (in a thread or the main loop) and shuts both down."""
    service = TTSService(model_obj, vocoder, max_batch=max_batch, max_wait_us=max_wait_us,
                         nfe_step=nfe_step, max_queue=max_queue,
                         strict_max_duration=strict_max_duration, attn_path=attn_path,
                         native_batcher=native_batcher, attn_int8=attn_int8)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"serving on {host}:{port} (native batcher: {service.batcher.is_native})")
    return httpd, service


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    """The model, device and kernel-path arguments the serving entry points
    share (HTTP, gRPC, benchmark, socket server)."""
    parser.add_argument("--model", default="F5TTS_v1_Base")
    parser.add_argument("--model_cfg", default=None)
    parser.add_argument("--ckpt_file", default=None)
    parser.add_argument("--vocab_file", default=None)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"],
                        help="cast the weights to this dtype (every kernel takes either: "
                             "float32 runs their fp32 forms; default: bfloat16 on cuda, float32 "
                             "on cpu)")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 block linears (load_model(..., quantize=True)): kernels 4, 5, "
                             "6, 9 on rows of the compute dtype")
    parser.add_argument("--attn_path", default="default", choices=list(ATTN_PATHS),
                        help="kernels of the attention half (ops/attention.py)")
    parser.add_argument("--attn_int8", default=None, choices=["qk", "qkpv"],
                        help="int8 attention (kernel 14) in kernel A's place")


def load_from_arguments(args):
    """(model, vocoder) for add_model_arguments' arguments, on args.device
    (utils/misc.py:require_device: a missing card raises)."""
    from korean_f5_tts_tpu_torch.api import load_vocoder
    from korean_f5_tts_tpu_torch.config import load_model_config, preset_model_config
    from korean_f5_tts_tpu_torch.infer.model import load_model
    from korean_f5_tts_tpu_torch.utils.misc import require_device

    device = require_device(args.device)
    check_attn_int8(args.attn_int8, args.attn_path)
    name = args.compute_dtype or ("bfloat16" if device.type == "cuda" else "float32")
    dtype = getattr(torch, name)
    model_cfg = (load_model_config(args.model_cfg) if args.model_cfg
                 else preset_model_config(args.model))
    model_obj = load_model(model_cfg, ckpt_path=args.ckpt_file, vocab_file=args.vocab_file,
                           tokenizer=args.tokenizer, dtype=dtype, device=device,
                           quantize=args.quantize)
    return model_obj, load_vocoder("vocos", device=device, dtype=dtype)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="f5-tts_server")
    add_model_arguments(parser)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_wait_us", type=int, default=5000)
    parser.add_argument("--nfe_step", type=int, default=16)
    parser.add_argument("--warm_buckets", type=int, nargs="*", default=[1024],
                        help="run these duration buckets once before serving")
    parser.add_argument("--warm_batch_sizes", type=int, nargs="*", default=[1],
                        help="run these batch sizes per bucket before serving")
    parser.add_argument("--warm_text_tokens", type=int, default=16,
                        help="token count of the warm-up requests")
    parser.add_argument("--max_queue", type=int, default=64,
                        help="in-flight request cap; beyond it /tts returns 429")
    parser.add_argument("--strict_max_duration", action="store_true",
                        help="reject (400) requests whose duration estimate exceeds "
                             "max_duration instead of clamping")
    return parser


def main(argv=None):
    import signal

    args = build_parser().parse_args(argv)
    model_obj, vocoder = load_from_arguments(args)
    if args.warm_buckets:
        warm_start(model_obj, vocoder, args.warm_buckets, args.nfe_step,
                   batch_sizes=tuple(args.warm_batch_sizes), text_tokens=args.warm_text_tokens,
                   attn_path=args.attn_path, attn_int8=args.attn_int8)
    httpd, service = serve(model_obj, vocoder, port=args.port,
                           max_batch=args.max_batch, max_wait_us=args.max_wait_us,
                           nfe_step=args.nfe_step, max_queue=args.max_queue,
                           strict_max_duration=args.strict_max_duration,
                           attn_path=args.attn_path, attn_int8=args.attn_int8)

    # SIGTERM/SIGINT: stop accepting, drain in-flight requests, then exit
    def _graceful(signum, frame):
        print(f"signal {signum}: draining in-flight requests ...")
        threading.Thread(target=httpd.shutdown, daemon=True).start()
        service.shutdown(drain=True, timeout=60.0)

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    httpd.serve_forever()
    httpd.server_close()
    service.shutdown(drain=True, timeout=60.0)
    print("server stopped")


if __name__ == "__main__":
    main()

"""gRPC TTS service and load-generating client (counterpart of
korean_f5_tts_tpu/serving/grpc_server.py).

Two protocols are served over one TTSService (shared with the HTTP front end):

1. `inference.GRPCInferenceService`: the Triton predict-v2 protobuf contract
   (named tensors reference_wav FP32, reference_wav_len INT32,
   reference_text / target_text BYTES -> waveform FP32). Messages are proto3
   wire bytes, encoded and decoded by serving/proto.py.
2. `f5tts.TTS`: a JSON-bodied convenience service.

The handler bodies (synthesize, health, model_infer, server_ready) are plain
functions of the service and the request's bytes: they raise RpcAbort with
the name of a gRPC status code, and only make_grpc_server, the clients and
main import `grpc`, so the bodies can be driven where that package is missing.
The fused serving path returns int16 audio: it goes into the wav file as it
is and into the FP32 waveform tensor divided by 32768.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import io
import json
import time

import numpy as np

from korean_f5_tts_tpu_torch.serving import proto as pb
from korean_f5_tts_tpu_torch.serving.server import (
    RequestTooLong,
    ServiceOverloaded,
    ServiceShuttingDown,
    _wav_bytes,
)
from korean_f5_tts_tpu_torch.utils.audio import to_mono

_SERVICE = "f5tts.TTS"
_TRITON_SERVICE = "inference.GRPCInferenceService"


class RpcAbort(Exception):
    """A handler body ends the call with this gRPC status (`code` is the
    name of a grpc.StatusCode member)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


def _submit_mapped(service, payload):
    """submit() with the overload conditions mapped to gRPC status codes."""
    try:
        return service.submit(payload)
    except ServiceOverloaded as e:
        raise RpcAbort("RESOURCE_EXHAUSTED", str(e)) from e
    except RequestTooLong as e:
        raise RpcAbort("INVALID_ARGUMENT", str(e)) from e
    except ServiceShuttingDown as e:
        raise RpcAbort("UNAVAILABLE", str(e)) from e


def _await_result(item, timeout: float):
    if not item.event.wait(timeout=timeout):
        raise RpcAbort("DEADLINE_EXCEEDED", "synthesis timeout")
    if item.error:
        raise RpcAbort("INTERNAL", item.error)
    return item.result


def _estimate_frames(ref_wav, sr: int, ref_text: str, target_text: str) -> int:
    """Byte-ratio duration estimate for bucketing and overload gating, the
    heuristic of the HTTP front end."""
    ref_frames = len(ref_wav) / sr * 24000 / 256
    ratio = len(target_text.encode()) / max(len(ref_text.encode()), 1)
    return int(ref_frames * (1 + ratio))


def _json_ser(obj) -> bytes:
    return json.dumps(obj).encode()


def _json_de(data: bytes):
    return json.loads(data)


def synthesize(service, request_bytes: bytes, timeout: float = 600.0) -> bytes:
    """f5tts.TTS/Synthesize: JSON {reference_audio: b64 wav, reference_text,
    target_text, nfe_step?, ...} -> JSON {audio: b64 wav, sample_rate}."""
    from scipy.io import wavfile

    request = _json_de(request_bytes)
    sr, data = wavfile.read(io.BytesIO(base64.b64decode(request["reference_audio"])))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    ref_wav = to_mono(data.T if data.ndim == 2 else data)
    payload = {
        "ref_wav": np.asarray(ref_wav, np.float32),
        "sr": int(sr),
        "ref_text": request["reference_text"],
        "target_text": request["target_text"],
        "nfe_step": request.get("nfe_step", 16),
        "cfg_strength": request.get("cfg_strength", 2.0),
        "sway_sampling_coef": request.get("sway_sampling_coef", -1.0),
        "seed": request.get("seed"),
        "_duration_frames": _estimate_frames(ref_wav, int(sr), request["reference_text"],
                                             request["target_text"]),
    }
    wav, out_sr = _await_result(_submit_mapped(service, payload), timeout)
    audio = _wav_bytes(wav, out_sr, native=service.batcher.is_native)
    return _json_ser({"audio": base64.b64encode(audio).decode(), "sample_rate": out_sr})


def health(service, request_bytes: bytes) -> bytes:
    """f5tts.TTS/Health."""
    return _json_ser({"status": "ok"})


def model_infer(service, request_bytes: bytes, timeout: float = 600.0) -> bytes:
    """inference.GRPCInferenceService/ModelInfer on proto3 wire bytes."""
    req = pb.decode_model_infer_request(request_bytes)
    ins = req["inputs"]
    try:
        ref_wav = np.asarray(ins["reference_wav"], np.float32).reshape(-1)
        if "reference_wav_len" in ins:
            ref_wav = ref_wav[: int(np.asarray(ins["reference_wav_len"]).reshape(-1)[0])]
        ref_text = ins["reference_text"][0].decode()
        target_text = ins["target_text"][0].decode()
    except (KeyError, IndexError) as e:
        raise RpcAbort("INVALID_ARGUMENT", f"missing tensor: {e}") from e
    payload = {
        "ref_wav": ref_wav,
        "sr": 24000,  # protocol contract: the client resamples to 24 kHz
        "ref_text": ref_text,
        "target_text": target_text,
        "_duration_frames": _estimate_frames(ref_wav, 24000, ref_text, target_text),
    }
    wav, _ = _await_result(_submit_mapped(service, payload), timeout)
    wav = np.asarray(wav)
    wav = wav.astype(np.float32) / 32768.0 if wav.dtype == np.int16 else wav.astype(np.float32)
    out = pb.InferTensor("waveform", "FP32", (1, len(wav)), wav)
    return pb.encode_model_infer_response(req["model_name"] or "f5_tts", [out],
                                          request_id=req["id"])


def server_ready(service, request_bytes: bytes) -> bytes:
    """inference.GRPCInferenceService/ServerReady and ServerLive."""
    return pb.encode_ready_response(True)


def make_grpc_server(service, host: str = "0.0.0.0", port: int = 8001, max_workers: int = 8):
    """service: serving.server.TTSService (shared with the HTTP front end).
    The returned server carries the port it bound as `bound_port` (port 0
    asks the system for a free one)."""
    import grpc

    def handler(body):
        def call(request_bytes: bytes, context):
            try:
                return body(service, request_bytes)
            except RpcAbort as e:
                context.abort(getattr(grpc.StatusCode, e.code), e.message)

        # raw bytes in and out: the bodies do the (de)framing
        return grpc.unary_unary_rpc_method_handler(call)

    handlers = grpc.method_handlers_generic_handler(
        _SERVICE, {"Synthesize": handler(synthesize), "Health": handler(health)})
    triton_handlers = grpc.method_handlers_generic_handler(
        _TRITON_SERVICE, {"ModelInfer": handler(model_infer),
                          "ServerReady": handler(server_ready),
                          "ServerLive": handler(server_ready)})
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((handlers, triton_handlers))
    server.bound_port = server.add_insecure_port(f"{host}:{port}")
    return server


class TritonGrpcClient:
    """Client of the Triton protobuf protocol, through serving/proto.py."""

    def __init__(self, target: str = "localhost:8001", model_name: str = "f5_tts"):
        import grpc

        self.model_name = model_name
        self.channel = grpc.insecure_channel(target)
        self._infer = self.channel.unary_unary(f"/{_TRITON_SERVICE}/ModelInfer")
        self._ready = self.channel.unary_unary(f"/{_TRITON_SERVICE}/ServerReady")

    def ready(self) -> bool:
        return pb.decode_ready_response(self._ready(b""))

    def synthesize(self, ref_wav: np.ndarray, ref_text: str, target_text: str,
                   request_id: str = "1"):
        """ref_wav: float32 mono at 24 kHz (the client resamples). Returns
        (waveform float32, 24000)."""
        req = encode_infer_request(self.model_name, ref_wav, ref_text, target_text, request_id)
        resp = pb.decode_model_infer_response(self._infer(req))
        return np.asarray(resp["outputs"]["waveform"], np.float32).reshape(-1), 24000

    def close(self) -> None:
        self.channel.close()


def encode_infer_request(model_name: str, ref_wav: np.ndarray, ref_text: str, target_text: str,
                         request_id: str = "1") -> bytes:
    """The ModelInferRequest bytes of one synthesis request."""
    samples = np.asarray(ref_wav, np.float32).reshape(1, -1)
    lengths = np.array([[samples.shape[1]]], dtype=np.int32)
    inputs = [
        pb.InferTensor("reference_wav", "FP32", samples.shape, samples),
        pb.InferTensor("reference_wav_len", "INT32", (1, 1), lengths),
        pb.InferTensor("reference_text", "BYTES", (1, 1), [ref_text]),
        pb.InferTensor("target_text", "BYTES", (1, 1), [target_text]),
    ]
    return pb.encode_model_infer_request(model_name, inputs, outputs=["waveform"],
                                         request_id=request_id)


class GrpcTTSClient:
    def __init__(self, target: str = "localhost:8001"):
        import grpc

        self.channel = grpc.insecure_channel(target)
        self._synth = self.channel.unary_unary(
            f"/{_SERVICE}/Synthesize", request_serializer=_json_ser,
            response_deserializer=_json_de)
        self._health = self.channel.unary_unary(
            f"/{_SERVICE}/Health", request_serializer=_json_ser, response_deserializer=_json_de)

    def health(self) -> dict:
        return self._health({})

    def synthesize(self, ref_wav_path: str, ref_text: str, target_text: str,
                   nfe_step: int = 16, **kw) -> tuple[bytes, int]:
        with open(ref_wav_path, "rb") as f:
            audio_b64 = base64.b64encode(f.read()).decode()
        resp = self._synth({"reference_audio": audio_b64, "reference_text": ref_text,
                            "target_text": target_text, "nfe_step": nfe_step, **kw})
        return base64.b64decode(resp["audio"]), resp["sample_rate"]

    def close(self) -> None:
        self.channel.close()


def load_test(target: str, requests: list[dict], concurrency: int = 2) -> dict:
    """Concurrent latency benchmark over the JSON service."""
    client = GrpcTTSClient(target)
    latencies, audio_s = [], []

    def one(r):
        t0 = time.perf_counter()
        audio, sr = client.synthesize(**r)
        dt = time.perf_counter() - t0
        return dt, (len(audio) - 44) / 2 / sr

    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=concurrency) as ex:
            for dt, secs in ex.map(one, requests):
                latencies.append(dt)
                audio_s.append(secs)
    finally:
        client.close()
    lat = np.asarray(latencies)
    return {
        "n": len(requests),
        "concurrency": concurrency,
        "latency_ms_avg": float(lat.mean() * 1e3),
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p95": float(np.percentile(lat, 95) * 1e3),
        "rtf": float(lat.sum() / concurrency / max(sum(audio_s), 1e-9)),
    }


def build_parser() -> argparse.ArgumentParser:
    from korean_f5_tts_tpu_torch.serving.server import add_model_arguments

    p = argparse.ArgumentParser(prog="f5-tts_grpc-server")
    add_model_arguments(p)
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--nfe_step", type=int, default=16)
    p.add_argument("--warm_buckets", type=int, nargs="*", default=[],
                   help="run these duration buckets once before serving (as the HTTP "
                        "front end's flag)")
    p.add_argument("--warm_batch_sizes", type=int, nargs="*", default=[1],
                   help="run these batch sizes per bucket before serving")
    p.add_argument("--warm_text_tokens", type=int, default=16)
    return p


def main(argv=None):
    from korean_f5_tts_tpu_torch.serving.server import (
        TTSService,
        load_from_arguments,
        warm_start,
    )

    args = build_parser().parse_args(argv)
    model_obj, vocoder = load_from_arguments(args)
    if args.warm_buckets:
        warm_start(model_obj, vocoder, args.warm_buckets, args.nfe_step,
                   batch_sizes=tuple(args.warm_batch_sizes), text_tokens=args.warm_text_tokens,
                   attn_path=args.attn_path, attn_int8=args.attn_int8)
    service = TTSService(model_obj, vocoder, nfe_step=args.nfe_step, attn_path=args.attn_path,
                         attn_int8=args.attn_int8)
    server = make_grpc_server(service, port=args.port)
    server.start()
    print(f"gRPC serving on :{args.port}")
    try:
        server.wait_for_termination()
    finally:
        service.shutdown(drain=False, timeout=5.0)
        service.batcher.close()


if __name__ == "__main__":
    main()

"""Request latency through the Triton predict-v2 protobuf contract
(counterpart of scripts/bench_grpc_live.py).

The timed loop (`run`) takes any client with `ready()` and
`synthesize(ref_wav, ref_text, target_text, request_id=...) -> (wav, sr)`:

  - `main` drives a live gRPC server through serving/grpc_server.py's
    TritonGrpcClient (the named-tensor contract of the reference's
    `runtime/triton_trtllm/client_grpc.py:227-307`; needs the grpc package);
  - `InProcessClient` calls the handler bodies (grpc_server.model_infer and
    server_ready) on a TTSService in this process with the same proto3 bytes,
    for a machine without grpc: the wire and its framing are not in the time.

The wire null (ServerReady round trips) is measured in the same run, so a
latency can be read against the transport's own cost.

    python -m korean_f5_tts_tpu_torch.serving.grpc_server --port 8801 --warm_buckets 1024 &
    python -m korean_f5_tts_tpu_torch.scripts.bench_grpc_live --target localhost:8801 --n 12
    python -m korean_f5_tts_tpu_torch.scripts.bench_grpc_live --in_process --n 12

Against `--target` the client holds no model and the server picks its device.
`--in_process` builds F5TTS_v1_Base + Vocos with seeded random weights
(AdaLN-zero layers re-drawn; bf16, `--int8` for int8 block linears) behind a
TTSService on `--device` (the card unless `--device cpu` is given; no card
raises) and drives it through InProcessClient; `--tiny` cuts the model to dim
64, depth 2 and the Vocos to dim 32 for a CPU smoke run.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

REF_TEXT = "이것은 참조 음성의 전사 텍스트입니다."
TARGET_TEXT = "안녕하세요, 프로토버프 지연 시간 측정을 위한 문장입니다."


class InProcessClient:
    """The Triton protocol's handler bodies on `service` in this process:
    ModelInfer request bytes in, response bytes out, no grpc import."""

    def __init__(self, service, model_name: str = "f5_tts"):
        self.service = service
        self.model_name = model_name

    def ready(self) -> bool:
        from korean_f5_tts_tpu_torch.serving import grpc_server
        from korean_f5_tts_tpu_torch.serving import proto as pb

        return pb.decode_ready_response(grpc_server.server_ready(self.service, b""))

    def synthesize(self, ref_wav: np.ndarray, ref_text: str, target_text: str,
                   request_id: str = "1"):
        from korean_f5_tts_tpu_torch.serving import grpc_server
        from korean_f5_tts_tpu_torch.serving import proto as pb

        req = grpc_server.encode_infer_request(self.model_name, ref_wav, ref_text, target_text,
                                               request_id)
        resp = pb.decode_model_infer_response(grpc_server.model_infer(self.service, req))
        return np.asarray(resp["outputs"]["waveform"], np.float32).reshape(-1), 24000


def synthetic_reference(seconds: float) -> np.ndarray:
    """A seeded 220 Hz tone over noise, mono at the protocol's 24 kHz (the
    reference client resamples before building the FP32 tensor)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 24000), dtype=np.float32) / 24000.0
    return (0.2 * np.sin(2 * np.pi * 220.0 * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def run(client, n: int = 12, warm: int = 2, ref_seconds: float = 4.8,
        ref_text: str = REF_TEXT, target_text: str = TARGET_TEXT,
        protocol: str = "TritonGrpcClient") -> dict:
    """`warm` unrecorded requests, then `n` sequential ones (concurrency 1),
    each timed on the host clock from the request's bytes to the decoded
    waveform."""
    ref_wav = synthetic_reference(ref_seconds)
    if not client.ready():
        raise RuntimeError("server not ready")
    nulls = []
    for _ in range(20):
        t0 = time.perf_counter()
        client.ready()
        nulls.append(time.perf_counter() - t0)
    null_ms = float(np.percentile(np.asarray(nulls) * 1e3, 50))

    for i in range(warm):
        wav, _ = client.synthesize(ref_wav, ref_text, target_text, request_id=f"warm{i}")
        print(f"warm {i}: {len(wav) / 24000:.2f} s audio", flush=True)

    lats, secs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        wav, sr = client.synthesize(ref_wav, ref_text, target_text, request_id=str(i))
        dt = time.perf_counter() - t0
        lats.append(dt)
        secs.append(len(wav) / sr)
        print(f"req {i}: {dt * 1e3:.1f} ms for {secs[-1]:.2f} s audio", flush=True)

    lat = np.asarray(lats) * 1e3
    gen_s = float(np.median(secs))
    return {
        "protocol": f"{protocol}.synthesize -> inference.GRPCInferenceService/ModelInfer "
                    "(proto3 bytes, serving/proto.py codec), sequential c1",
        "n_items": n,
        "gen_seconds": gen_s,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p95_ms": float(np.percentile(lat, 95)),
        "latency_avg_ms": float(lat.mean()),
        "wire_null_ms": null_ms,
        "rtf_p50": float(np.percentile(lat, 50) / 1e3 / max(gen_s, 1e-9)),
        "reference_l20_avg_ms": 253.0,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--target", default="localhost:8801")
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--warm", type=int, default=2,
                   help="unrecorded warm requests first")
    p.add_argument("--ref_seconds", type=float, default=4.8)
    p.add_argument("--ref_text", default=REF_TEXT)
    p.add_argument("--target_text", default=TARGET_TEXT)
    p.add_argument("--out", default=None, help="write/merge into this JSON")
    p.add_argument("--key", default="grpc_proto_live")
    p.add_argument("--in_process", action="store_true",
                   help="a model and TTSService in this process, driven through the handler "
                        "bodies (no grpc import)")
    p.add_argument("--device", default="cuda",
                   help="with --in_process: cuda (default; raises without a card) or cpu")
    p.add_argument("--nfe_step", type=int, default=16, help="with --in_process")
    p.add_argument("--int8", action="store_true", help="with --in_process: int8 block linears")
    p.add_argument("--tiny", action="store_true",
                   help="with --in_process: dim-64 model for CPU smoke runs")
    args = p.parse_args(argv)

    if args.in_process:
        from korean_f5_tts_tpu_torch.scripts.profile_serving_request import load_random_model
        from korean_f5_tts_tpu_torch.serving.server import TTSService

        model, vocoder = load_random_model("F5TTS_v1_Base", args.device, args.tiny,
                                           quantize=args.int8)
        service = TTSService(model, vocoder, nfe_step=args.nfe_step)
        try:
            rec = run(InProcessClient(service), args.n, args.warm, args.ref_seconds,
                      args.ref_text, args.target_text, protocol="InProcessClient")
        finally:
            service.shutdown(drain=False, timeout=5.0)
            service.batcher.close()
    else:
        from korean_f5_tts_tpu_torch.serving.grpc_server import TritonGrpcClient

        client = TritonGrpcClient(args.target)
        try:
            rec = run(client, args.n, args.warm, args.ref_seconds, args.ref_text,
                      args.target_text)
        finally:
            client.close()
    print(json.dumps(rec, sort_keys=True), flush=True)
    if args.out:
        try:
            with open(args.out) as f:
                doc = json.load(f)
        except FileNotFoundError:
            doc = {}
        doc[args.key] = rec
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}[{args.key}]")
    return rec


if __name__ == "__main__":
    main()

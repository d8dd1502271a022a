"""HTTP client + load generator for the batching server.

Parity with reference `runtime/triton_trtllm/client_http.py` (single request)
and `client_grpc.py` (concurrent load-gen with latency percentiles + server
stats scrape).
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import json
import time
import urllib.request

import numpy as np


def synthesize(server_url: str, ref_wav_path: str, ref_text: str, target_text: str,
               nfe_step: int = 16, **kw) -> bytes:
    with open(ref_wav_path, "rb") as f:
        audio_b64 = base64.b64encode(f.read()).decode()
    payload = {
        "reference_audio": audio_b64,
        "reference_text": ref_text,
        "target_text": target_text,
        "nfe_step": nfe_step,
        **kw,
    }
    req = urllib.request.Request(
        f"{server_url}/tts", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.read()


def get_stats(server_url: str) -> dict:
    with urllib.request.urlopen(f"{server_url}/stats", timeout=10) as resp:
        return json.loads(resp.read())


def load_test(server_url: str, requests: list[dict], concurrency: int = 2) -> dict:
    """Run requests at fixed concurrency; report latency percentiles + RTF."""
    latencies, audio_seconds = [], []

    def one(r):
        t0 = time.perf_counter()
        wav_bytes = synthesize(server_url, **r)
        dt = time.perf_counter() - t0
        # wav payload: 44-byte header + int16 samples @ 24 kHz
        n_samples = (len(wav_bytes) - 44) // 2
        return dt, n_samples / 24_000

    with concurrent.futures.ThreadPoolExecutor(max_workers=concurrency) as ex:
        for dt, secs in ex.map(one, requests):
            latencies.append(dt)
            audio_seconds.append(secs)

    lat = np.asarray(latencies)
    total_audio = float(np.sum(audio_seconds))
    wall = float(np.sum(latencies)) / concurrency
    return {
        "n": len(requests),
        "concurrency": concurrency,
        "latency_ms_avg": float(lat.mean() * 1e3),
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p95": float(np.percentile(lat, 95) * 1e3),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1e3),
        "total_audio_s": total_audio,
        "rtf": wall / max(total_audio, 1e-9),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--server", default="http://localhost:8000")
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", required=True)
    p.add_argument("--target_text", required=True)
    p.add_argument("--output", default="client_out.wav")
    p.add_argument("--nfe_step", type=int, default=16)
    args = p.parse_args(argv)
    wav = synthesize(args.server, args.ref_audio, args.ref_text, args.target_text,
                     nfe_step=args.nfe_step)
    with open(args.output, "wb") as f:
        f.write(wav)
    print(args.output)


if __name__ == "__main__":
    main()

"""Concurrent-serving throughput: the model behind the port's HTTP server and
dynamic batcher, driven by the port's load generator (counterpart of
scripts/bench_serving_throughput.py).

Role of the reference's `runtime/triton_trtllm/client_grpc.py` benchmark (a
concurrency sweep against Triton). Here the whole stack is local: load_model
(seeded random weights, AdaLN-zero layers re-drawn; throughput does not
depend on the weights' values) -> warm_start -> serve() on localhost ->
client.load_test at each concurrency. Every request carries the same ~4.6 s
reference and ~`--gen_seconds` of target text, so all of them fall into one
duration bucket and the batcher can group concurrent ones. bf16 weights on
the card (fp32 on the CPU); `--int8` takes int8 block linears
(load_model(..., quantize=True)).

    python -m korean_f5_tts_tpu_torch.scripts.bench_serving_throughput [--int8]

Runs on the card unless `--device cpu` is given (no card raises); `--tiny`
cuts the model to dim 64, depth 2 and the Vocos to dim 32 for a CPU smoke
run. Prints one JSON line per concurrency level.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading

import numpy as np
import torch


def run(model_name: str = "F5TTS_v1_Base", device="cuda", nfe_step: int = 16,
        n_requests: int = 16, concurrency=(1, 2, 4), gen_seconds: float = 10.0,
        int8: bool = False, tiny: bool = False) -> list[dict]:
    from korean_f5_tts_tpu_torch.scripts.profile_serving_request import load_random_model
    from korean_f5_tts_tpu_torch.serving.client import load_test
    from korean_f5_tts_tpu_torch.serving.server import serve, warm_start
    from korean_f5_tts_tpu_torch.utils.audio import save_wav

    model, vocoder = load_random_model(model_name, device, tiny, quantize=int8)
    sr = 24_000
    rng = np.random.default_rng(0)
    ref = (0.05 * np.sin(2 * np.pi * 220 * np.arange(int(4.6 * sr)) / sr)
           + 0.01 * rng.standard_normal(int(4.6 * sr))).astype(np.float32)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.wav")
        save_wav(ref_path, ref, sr)
        ref_text = "the quick brown fox jumps over the lazy dog. "
        # the duration estimate scales with the target/ref text length ratio
        target_text = ref_text * max(1, int(gen_seconds / 4.6))
        # every (bucket, batch) shape the batcher can form at these concurrencies
        warm_start(model, vocoder, buckets=(1536,), nfe_step=nfe_step,
                   batch_sizes=tuple(range(1, max(concurrency) + 1)),
                   text_tokens=len(ref_text + target_text))
        httpd, service = serve(model, vocoder, host="127.0.0.1", port=0, max_batch=8,
                               nfe_step=nfe_step)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        reqs = [dict(ref_wav_path=ref_path, ref_text=ref_text, target_text=target_text,
                     nfe_step=nfe_step, seed=0) for _ in range(n_requests)]
        mode = "int8" if int8 else ("bf16" if model.device.type == "cuda" else "fp32")
        try:
            load_test(url, reqs[:1], concurrency=1)  # one untimed request first
            for c in concurrency:
                before = len(service.stats["batch_sizes"])
                r = load_test(url, reqs, concurrency=c)
                r["protocol"] = ("http server + dynamic batcher, "
                                 + ("tiny (smoke)" if tiny else f"{model_name} {mode}"))
                r["nfe_step"] = nfe_step
                r["batch_sizes"] = list(service.stats["batch_sizes"][before:])
                r["device"] = (torch.cuda.get_device_name(model.device)
                               if model.device.type == "cuda" else "cpu")
                print(json.dumps(r), flush=True)
                results.append(r)
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.shutdown(drain=False, timeout=5.0)
            service.batcher.close()
            thread.join(timeout=10)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--nfe_step", type=int, default=16)
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--concurrency", type=int, nargs="*", default=[1, 2, 4])
    p.add_argument("--gen_seconds", type=float, default=10.0)
    p.add_argument("--int8", action="store_true", help="int8 block linears")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tiny", action="store_true", help="dim-64 model for CPU smoke runs")
    args = p.parse_args(argv)
    return run(args.model, args.device, args.nfe_step, args.n_requests,
               tuple(args.concurrency), args.gen_seconds, args.int8, args.tiny)


if __name__ == "__main__":
    main()

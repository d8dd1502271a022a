"""Raw-TCP streaming TTS server + wav-writing worker (counterpart of
korean_f5_tts_tpu/socket_server.py): python -m
korean_f5_tts_tpu_torch.socket_server, on the card unless --device cpu.

Parity with reference `src/f5_tts/socket_server.py`: warm-up pass at startup
(`:122-136`), first-chunk shrinking for low first-byte latency (`:138-143`),
float32 PCM streamed over the socket with a b"END" sentinel (`:163-174`),
and a thread-safe queue worker that persists generated audio (`:32-69`).
start_server takes a `ready` callback (called with the bound port, so port 0
works) and a `stop` event checked between accepts.
"""

from __future__ import annotations

import argparse
import logging
import queue
import socket
import threading

import numpy as np

from korean_f5_tts_tpu_torch.infer.utils_infer import infer_batch_process, preprocess_ref_audio_text
from korean_f5_tts_tpu_torch.utils.audio import save_wav

logger = logging.getLogger(__name__)


class AudioFileWriterThread(threading.Thread):
    """Background thread draining audio chunks into a wav file (`:32-69`)."""

    def __init__(self, output_file: str, sample_rate: int):
        super().__init__(daemon=True)
        self.output_file = output_file
        self.sample_rate = sample_rate
        self.queue: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self.chunks: list[np.ndarray] = []

    def add_chunk(self, chunk: np.ndarray) -> None:
        self.queue.put(chunk)

    def run(self):
        while not self.stop_event.is_set() or not self.queue.empty():
            try:
                self.chunks.append(self.queue.get(timeout=0.1))
            except queue.Empty:
                continue
        if self.chunks:
            save_wav(self.output_file, np.concatenate(self.chunks), self.sample_rate)

    def stop(self):
        self.stop_event.set()


class TTSStreamingProcessor:
    def __init__(self, model_obj, vocoder, ref_audio: str, ref_text: str,
                 nfe_step: int = 16, sample_rate: int = 24_000,
                 attn_path: str = "default", attn_int8: str | None = None):
        self.model = model_obj
        self.vocoder = vocoder
        self.nfe_step = nfe_step
        self.sample_rate = sample_rate
        self.attn_path = attn_path
        self.attn_int8 = attn_int8
        (self.ref_wav, self.ref_sr), self.ref_text = preprocess_ref_audio_text(
            ref_audio, ref_text
        )
        self._warm_up()

    def _warm_up(self):
        """Build the kernels and prime caches so the first request is fast
        (`:122-136`)."""
        logger.info("warming up...")
        for _ in self.generate_stream("warm up text for the model."):
            pass
        logger.info("warm-up done")

    def generate_stream(self, text: str):
        """Yield (float32 pcm bytes) chunks; first chunks shrunk (`:138-143`)."""
        stream = infer_batch_process(
            (self.ref_wav, self.ref_sr), self.ref_text, [text], self.model,
            self.vocoder, nfe_step=self.nfe_step, streaming=True, chunk_size=2048,
            attn_path=self.attn_path, attn_int8=self.attn_int8,
        )
        first = True
        for chunk, _sr in stream:
            if first and len(chunk) > 512:
                # shrink the first package for faster playback start
                for j in range(0, len(chunk), 512):
                    yield np.asarray(chunk[j:j + 512], np.float32).tobytes()
                first = False
            else:
                yield np.asarray(chunk, np.float32).tobytes()


def handle_client(conn: socket.socket, processor: TTSStreamingProcessor):
    try:
        with conn:
            while True:
                data = conn.recv(1024)
                if not data:
                    break
                text = data.decode("utf-8").strip()
                if not text:
                    continue
                for pcm in processor.generate_stream(text):
                    conn.sendall(pcm)
                conn.sendall(b"END")
    except Exception:
        logger.exception("client handler failed")


def start_server(processor: TTSStreamingProcessor, host: str = "0.0.0.0",
                 port: int = 9998, ready=None, stop: threading.Event | None = None):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(5)
    srv.settimeout(0.2)
    bound = srv.getsockname()[1]
    logger.info("socket server on %s:%d", host, bound)
    if ready is not None:
        ready(bound)
    try:
        while stop is None or not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            threading.Thread(target=handle_client, args=(conn, processor),
                             daemon=True).start()
    finally:
        srv.close()


def main(argv=None):
    from korean_f5_tts_tpu_torch.serving.server import add_model_arguments, load_from_arguments

    p = argparse.ArgumentParser(prog="f5-tts_socket-server")
    add_model_arguments(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", required=True)
    p.add_argument("--nfe_step", type=int, default=16)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model_obj, vocoder = load_from_arguments(args)
    processor = TTSStreamingProcessor(model_obj, vocoder, args.ref_audio, args.ref_text,
                                      nfe_step=args.nfe_step, attn_path=args.attn_path,
                                      attn_int8=args.attn_int8)
    start_server(processor, args.host, args.port)


if __name__ == "__main__":
    main()

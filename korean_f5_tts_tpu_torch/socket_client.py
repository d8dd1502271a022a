"""TCP streaming client: send text, receive float32 PCM until b"END" (a copy
of korean_f5_tts_tpu/socket_client.py over the port's utils/audio.save_wav):
python -m korean_f5_tts_tpu_torch.socket_client --text "..." against
korean_f5_tts_tpu_torch.socket_server.

Parity with reference `src/f5_tts/socket_client.py` (async pyaudio playback
is replaced with file capture; no audio device in this environment).
"""

from __future__ import annotations

import argparse
import socket

import numpy as np

from korean_f5_tts_tpu_torch.utils.audio import save_wav


def request_tts(host: str, port: int, text: str, timeout: float = 600.0) -> np.ndarray:
    buf = bytearray()
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(text.encode("utf-8"))
        while True:
            data = sock.recv(8192)
            if not data:
                break
            buf.extend(data)
            if buf.endswith(b"END"):
                del buf[-3:]
                break
    return np.frombuffer(bytes(buf), dtype=np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--text", required=True)
    p.add_argument("--output", default="socket_out.wav")
    args = p.parse_args(argv)
    wav = request_tts(args.host, args.port, args.text)
    save_wav(args.output, wav, 24_000)
    print(f"{args.output}: {len(wav) / 24_000:.2f}s")


if __name__ == "__main__":
    main()

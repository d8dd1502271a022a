"""ctypes bindings for the C++ serving runtime (csrc/f5_runtime.cpp): the
dynamic batcher, int16 conversion and cross-fade.

The port's own copy of korean_f5_tts_tpu/serving/native.py. The library is
built with the host compiler from the package's source into
``korean_f5_tts_tpu_torch/_build/`` at first use (ops/cuda_build.py:
build_host_library). Whether the C++ runtime or the pure-Python code of the
same semantics runs is the caller's choice: ``native=True`` builds and loads
the library or raises, ``native=False`` never touches it. Nothing gives way
quietly when a build fails.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque

import numpy as np

from korean_f5_tts_tpu_torch.ops import cuda_build

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The loaded runtime library, building it first if needed; raises when
    the host compiler is missing or the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(cuda_build.build_host_library("f5_runtime.cpp", "libf5runtime")))
        lib.f5rt_batcher_create.restype = ctypes.c_void_p
        lib.f5rt_batcher_create.argtypes = [ctypes.c_int, ctypes.c_int64]
        lib.f5rt_batcher_destroy.argtypes = [ctypes.c_void_p]
        lib.f5rt_batcher_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.f5rt_batcher_next.restype = ctypes.c_int
        lib.f5rt_batcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int64,
        ]
        lib.f5rt_batcher_close.argtypes = [ctypes.c_void_p]
        lib.f5rt_f32_to_i16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ]
        lib.f5rt_rms.restype = ctypes.c_double
        lib.f5rt_rms.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.f5rt_crossfade.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return lib


class NativeBatcher:
    """Dynamic batching queue: groups request ids by duration bucket under
    (max_batch, max_wait_us) — Triton dynamic_batching parity. native=True
    is the C++ queue (built at first use, or raises), native=False the
    Python one."""

    def __init__(self, max_batch: int = 8, max_wait_us: int = 5_000, native: bool = True):
        self._lib = _load_lib() if native else None
        self.max_batch = max_batch
        if native:
            self._h = self._lib.f5rt_batcher_create(max_batch, max_wait_us)
        else:  # the pure-Python batcher
            self._h = None
            self._max_wait = max_wait_us / 1e6
            self._queues: dict[int, deque] = {}
            self._lock = threading.Condition()

    @property
    def is_native(self) -> bool:
        return self._h is not None

    def submit(self, request_id: int, bucket: int) -> None:
        if self._h is not None:
            self._lib.f5rt_batcher_submit(self._h, request_id, bucket)
            return
        with self._lock:
            self._queues.setdefault(bucket, deque()).append((request_id, time.monotonic()))
            self._lock.notify_all()

    def next_batch(self, timeout_us: int = 100_000):
        """-> (bucket, [request_ids]) or (None, []) on timeout / close."""
        if self._h is not None:
            ids = (ctypes.c_int64 * self.max_batch)()
            bucket = ctypes.c_int(0)
            n = self._lib.f5rt_batcher_next(self._h, ids, ctypes.byref(bucket),
                                            timeout_us)
            if n <= 0:
                return None, []
            return bucket.value, [ids[i] for i in range(n)]
        deadline = time.monotonic() + timeout_us / 1e6
        with self._lock:
            while True:
                best, oldest = None, None
                for b, q in self._queues.items():
                    if q and (oldest is None or q[0][1] < oldest):
                        best, oldest = b, q[0][1]
                if best is not None:
                    q = self._queues[best]
                    waited = time.monotonic() - q[0][1]
                    if len(q) >= self.max_batch or waited >= self._max_wait:
                        n = min(self.max_batch, len(q))
                        return best, [q.popleft()[0] for _ in range(n)]
                    self._lock.wait(min(deadline, q[0][1] + self._max_wait)
                                    - time.monotonic())
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, []
                self._lock.wait(remaining)

    def close(self):
        if self._h is not None:
            self._lib.f5rt_batcher_close(self._h)

    def __del__(self):
        try:
            if self._h is not None and self._lib is not None:
                self._lib.f5rt_batcher_destroy(self._h)
        except Exception:
            pass


def f32_to_i16(wav: np.ndarray, native: bool = True) -> np.ndarray:
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    lib = _load_lib() if native else None
    if lib is None:
        return (np.clip(wav, -1, 1) * 32767.0).round().astype(np.int16)
    out = np.empty(wav.shape, np.int16)
    lib.f5rt_f32_to_i16(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        wav.size,
    )
    return out


def crossfade(a: np.ndarray, b: np.ndarray, n_fade: int, native: bool = True) -> np.ndarray:
    lib = _load_lib() if native else None
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    n_fade = min(n_fade, len(a), len(b))
    if lib is None:
        if n_fade <= 0:
            return np.concatenate([a, b])
        t = np.linspace(0.0, 1.0, n_fade, dtype=np.float32)
        mid = a[-n_fade:] * (1 - t) + b[:n_fade] * t
        return np.concatenate([a[:-n_fade], mid, b[n_fade:]])
    out = np.empty(len(a) + len(b) - n_fade, np.float32)
    lib.f5rt_crossfade(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(b),
        n_fade, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out

"""Build and load the hand-written Hopper kernels (csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: a build takes seconds, where a PyTorch C++
extension takes minutes. The build runs on first use, from the package's own
sources, into ``korean_f5_tts_tpu_torch/_build/`` (listed in .gitignore); the
library name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a stale one is never loaded.

Nothing here runs at import time, and nothing falls back: a missing nvcc, a
compile error or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the build this process ran
build_log: str = ""                 # nvcc/ptxas output (registers, smem, spills)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, kv_lens, out, H, n, d, scale_log2, device, stream
    "f5_flash_prefix_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # h, sc, sh, gate, w1, b1, w2, b2, z, out, M, d, dff, eps, device, stream
    "f5_ff_block_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, w, b, out, B, N, C, groups, taps, fuse_mish, device, stream
    "f5_grouped_conv_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the Hopper kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # .cu and .cuh
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the build directory (once per source hash)."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libf5kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.f5_error_string.argtypes = (ctypes.c_int,)
            lib.f5_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().f5_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors, dtype=None) -> None:
    """Device, dtype, contiguity and alignment checks for a kernel launch."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")

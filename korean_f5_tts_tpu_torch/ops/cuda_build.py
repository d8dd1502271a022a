"""Build and load the hand-written Hopper kernels (csrc/*.cu) and the host
C++ serving runtime (csrc/f5_runtime.cpp, build_host_library).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: a build takes seconds, where a PyTorch C++
extension takes minutes. Each source compiles in its own nvcc process, all
started together, and one more nvcc links the objects. The build runs on
first use, from the package's own sources, into
``korean_f5_tts_tpu_torch/_build/`` (listed in .gitignore); the library name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
a stale one is never loaded.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the build this process ran
build_log: str = ""                 # nvcc/ptxas output (registers, smem, spills)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, kv_lens, out, H, n, d, scale_log2, device, stream
    "f5_flash_prefix_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "f5_flash_prefix_f32_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # d = 64 on the mma.sync loop: q, k, v, kv_lens, out, H, n, scale_log2, device, stream
    "f5_flash_prefix_fwd_mma": (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, kv_lens, out, lse, H, n, d, scale_log2, device, stream
    "f5_flash_prefix_fwd_lse": (_P,) * 6 + (_I, _I, _I, _F, _I, _P),
    "f5_flash_prefix_f32_fwd_lse": (_P,) * 6 + (_I, _I, _I, _F, _I, _P),
    # q, k, v, dO, dvec, lse, kv_lens, dq, H, n, d, scale_log2, sm_scale, device, stream
    "f5_flash_prefix_dq_lsein": (_P,) * 8 + (_I, _I, _I, _F, _F, _I, _P),
    "f5_flash_prefix_f32_dq_lsein": (_P,) * 8 + (_I, _I, _I, _F, _F, _I, _P),
    # q, k, v, dO, dvec, kv_lens, dq, lse_out, H, n, d, scale_log2, sm_scale, device,
    # stream
    "f5_flash_prefix_dq": (_P,) * 8 + (_I, _I, _I, _F, _F, _I, _P),
    "f5_flash_prefix_f32_dq": (_P,) * 8 + (_I, _I, _I, _F, _F, _I, _P),
    # q, k, v, dO, dvec, lse, kv_lens, dk, dv, H, n, d, scale_log2, sm_scale, device,
    # stream
    "f5_flash_prefix_dkv": (_P,) * 9 + (_I, _I, _I, _F, _F, _I, _P),
    "f5_flash_prefix_f32_dkv": (_P,) * 9 + (_I, _I, _I, _F, _F, _I, _P),
    # q8, k8, v, c, sv, kv_lens, out, H, n, n_pad, pv_i8, out_f32, device, stream
    "f5_flash_prefix_i8_fwd": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _P),
    # q8, k8, v, c, kv_lens, out, H, n, device, stream
    "f5_flash_prefix_i8_qk_f32_fwd": (_P,) * 6 + (_I, _I, _I, _P),
    # d = 128, every form: q8, k8, v, c, sv, kv_lens, out, H, n, n_pad, pv_i8, out_f32,
    # device, stream
    "f5_flash_prefix_i8_d128_fwd": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _P),
    # q, k, v, their item/head/row strides (q, k, v), q8, k8, v8, c, sv, b, h, n,
    # n_pad, d, pv_i8, f32, c_mul, sv_mul, device, stream
    "f5_quant_heads": (_P,) * 3 + (_L,) * 9 + (_P,) * 5 + (_I,) * 7 + (_F, _F, _I, _P),
    # h, sc, sh, gate, w1, b1, w2, b2, z, stats, out, M, d, dff, eps, device, stream
    "f5_ff_block_fwd": (_P,) * 11 + (_I, _I, _I, _F, _I, _P),
    "f5_ff_block_f32_fwd": (_P,) * 11 + (_I, _I, _I, _F, _I, _P),
    # x, w, b, out, B, N, C, groups, taps, fuse_mish, device, stream
    "f5_grouped_conv_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "f5_grouped_conv_f32_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # kernels 4, 5, 6, 9: f32 says the rows, vectors and output are fp32 (else bf16)
    # x, w, w_scale, b, xq, xs, out, M, K, N, gelu, f32, device, stream
    "f5_qmatmul_fwd": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _P),
    # the same, then the product's tile width bn (0: gemm_tile_n's pick), device, stream
    "f5_qmatmul_width": (_P,) * 7 + (_I, _I, _I, _I, _I, _I, _I, _P),
    # h, sc, sh, w0..w2, ws0..ws2, b0..b2, yq, ys, out, M, d, seg_n, nseg, eps,
    # f32, device, stream
    "f5_ln_mod_matmul_int8_fwd": (_P,) * 15 + (_I, _I, _I, _I, _F, _I, _I, _P),
    # the same, then the product's tile width bn (0: gemm_tile_n's pick), device, stream
    "f5_ln_mod_matmul_int8_width": (_P,) * 15 + (_I, _I, _I, _I, _F, _I, _I, _I, _P),
    # a, h, gate, w, ws, b, aq, as, out, M, din, d, f32, device, stream
    "f5_proj_gated_int8_fwd": (_P,) * 9 + (_I, _I, _I, _I, _I, _P),
    # the same, then the product's tile width bn (0: gemm_tile_n's pick), device, stream
    "f5_proj_gated_int8_width": (_P,) * 9 + (_I, _I, _I, _I, _I, _I, _P),
    # h, sc, sh, gate, w1, w1s, b1, w2, w2s, b2, yq, ys, z, zq, zs, out, M, d,
    # dff, eps, f32, device, stream
    "f5_ff_block_int8_fwd": (_P,) * 16 + (_I, _I, _I, _F, _I, _I, _P),
    # the same, then the two products' tile widths bn1, bn2, device, stream
    "f5_ff_block_int8_widths": (_P,) * 16 + (_I, _I, _I, _F, _I, _I, _I, _I, _P),
    # h, sc, sh, w0..w2, b0..b2, stats, out, M, d, seg_n, nseg, eps, device, stream
    "f5_ln_mod_matmul_fwd": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _P),
    "f5_ln_mod_matmul_f32_fwd": (_P,) * 11 + (_I, _I, _I, _I, _F, _I, _P),
    # a, h, gate, w, b, out, M, din, d, device, stream
    "f5_proj_gated_fwd": (_P,) * 6 + (_I, _I, _I, _I, _P),
    "f5_proj_gated_f32_fwd": (_P,) * 6 + (_I, _I, _I, _I, _P),
    # q, k, v, kv_lens, cos, sin, out, B, heads, n, n_rope, scale_log2, device, stream
    "f5_flash_prefix_rope_fwd": (_P,) * 7 + (_I, _I, _I, _I, _F, _I, _P),
    "f5_flash_prefix_rope_f32_fwd": (_P,) * 7 + (_I, _I, _I, _I, _F, _I, _P),
    # d = 128: the same, then f32, device, stream
    "f5_flash_prefix_rope_d128_fwd": (_P,) * 7 + (_I, _I, _I, _I, _F, _I, _I, _P),
    # A (cos, sin, lse null; heads 1), 10 (cos, sin null) or 18 (lse null) at d = 128
    # in bf16 on the mma.sync loop the attention core replaced: q, k, v, kv_lens, cos,
    # sin, out, lse, B, heads, n, n_rope, scale_log2, device, stream
    "f5_flash_prefix_d128_fwd_mma": (_P,) * 8 + (_I, _I, _I, _I, _F, _I, _P),
    # A (cos, sin, lse null; heads 1), 10 (cos, sin null) or 18 (lse null) at d = 128 in
    # fp32 on the FFMA kernel the split 3xTF32 kernel replaced: arguments as above
    "f5_flash_prefix_f32_d128_fwd_ffma": (_P,) * 8 + (_I, _I, _I, _I, _F, _I, _P),
    # 11 (form 11), 12 (form 12) or 13 (form 13) at d = 128 in fp32 on the FFMA kernels
    # the split 3xTF32 kernels replaced: q, k, v, dO, dvec, lse, kv_lens, out0 (dq or
    # dk), out1 (12's lse or dv), H, n, form, scale_log2, sm_scale, device, stream
    "f5_flash_prefix_f32_d128_bwd_ffma": (_P,) * 9 + (_I, _I, _I, _F, _F, _I, _P),
    # the same forms in bf16 on the mma.sync kernels (13's replaced by the backward core)
    "f5_flash_prefix_d128_bwd_mma": (_P,) * 9 + (_I, _I, _I, _F, _F, _I, _P),
    # qkv, kv_lens, cos, sin, out, B, heads, n, n_rope, scale_log2, device, stream
    "f5_flash_prefix_qkv_fwd": (_P,) * 5 + (_I, _I, _I, _I, _F, _I, _P),
    "f5_flash_prefix_qkv_f32_fwd": (_P,) * 5 + (_I, _I, _I, _I, _F, _I, _P),
    # scripts/probe_hopper.py: x, y, out, ld, cx, cy, device, stream
    "f5_probe_slice_mma": (_P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, out, device, stream
    "f5_probe_pair_store": (_P, _P, _P, _I, _P),
    # x, cos, sin, out, ld, device, stream
    "f5_probe_half_swap": (_P, _P, _P, _P, _I, _I, _P),
    # x, raw, rows, cols, row, col, type (0 bf16, 1 int8, 2 fp32), device, stream
    "f5_probe_tma": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, y, out, mode, device, stream
    "f5_probe_wgmma_tf32": (_P, _P, _P, _I, _I, _P),
    # out, device, stream
    "f5_probe_tf32_accumulate": (_P, _I, _P),
    # x, y, out, register_a, device, stream
    "f5_probe_wgmma": (_P, _P, _P, _I, _I, _P),
    # x, y, out, n, device, stream
    "f5_probe_wgmma_i8": (_P, _P, _P, _I, _I, _P),
    # x, raw, planes, rows, row, plane, device, stream
    "f5_probe_tma_3d": (_P, _P, _I, _I, _I, _I, _I, _P),
    # p, v, out, device, stream
    "f5_probe_pv": (_P, _P, _P, _I, _P),
    # x, y, z, s, g, device, stream
    "f5_probe_bwd": (_P,) * 5 + (_I, _P),
    # x, raw, items, rows, slots, row, slot, item, split_heads, device, stream
    "f5_probe_tma_4d": (_P, _P) + (_I,) * 8 + (_P,),
    # q8, k8, v8, a8, p, mode, n, q0, s_out, pv_out, device, stream
    "f5_probe_attn_i8": (_P,) * 5 + (_I, _I, _I, _P, _P, _I, _P),
    # qkv, cos, sin, s, raw_k, n, q0, k0, device, stream
    "f5_probe_rope": (_P,) * 5 + (_I,) * 4 + (_P,),
    # M, n, seg_n, int8, device -> 128 or 256
    "f5_tile_width": (_I, _I, _I, _I, _I),
    # a, h, gate, w, b, out, M, din, d, bn, device, stream
    "f5_probe_tile_width": (_P,) * 6 + (_I, _I, _I, _I, _I, _P),
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
    """Compile csrc/*.cu into the build directory (once per source hash):
    one nvcc per source, all at once, then one link."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libf5kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=CSRC)))
    logs, failed = [], []
    for name, _, proc in jobs:  # wait for every compiler before anything else
        logs.append(f"== {name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(name)
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, cwd=CSRC)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(build_log)
    return out


def build_host_library(source: str, stem: str) -> Path:
    """Compile one host C++ source of csrc/ (no CUDA in it) into a shared
    library in the build directory with the host compiler, once per source
    hash; raises when there is no compiler or the build fails."""
    src = CSRC / source
    flags = ("-O3", "-fPIC", "-std=c++17", "-shared")
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}_{digest}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler (g++) to build {source}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(src), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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


def require_no_grad(what: str, *tensors) -> None:
    """Raise when a gradient would be taken through a forward-only kernel:
    14 and its quantization pass, 4, 5, 6 and 9 (the JAX package gives them
    no gradient either)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is forward-only: an input requires a gradient, and the kernel has "
            "no backward (the JAX kernel has no vjp)")


def launch_op(name: str, schema: str, fn):
    """Register `fn`, a kernel launch (or its plain version on CPU tensors),
    as the PyTorch operator ``f5_port::name`` with the given schema.

    The autograd Functions of kernels 7, 8, 10, 18 and 19 launch through
    these operators, so the dispatcher sees the launch: the "dots" remat
    policy (models/dit.py) can keep the kernel's output for the backward,
    which a ctypes call inside a Function hides from it. Registration only:
    nothing is built here."""
    import torch

    return torch.library.custom_op(f"f5_port::{name}", fn, mutates_args=(), schema=schema)

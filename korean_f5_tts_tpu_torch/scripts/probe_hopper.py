"""Probes of the CUDA idioms the qkv-layout attention kernel rests on
(counterpart of scripts/probe_mosaic.py, which probes the Mosaic lowering of
the same idioms for the TPU kernel).

    python -m korean_f5_tts_tpu_torch.scripts.probe_hopper

Three tiny hand-written kernels (csrc/probe_hopper.cu), each held against
two lines of torch and printed OK or FAIL by name:
  slice_mma   a 64-column slice of a wider row-major array fed to an mma
              product (a head read in place from the fused qkv rows);
  pair_store  two heads' results stored side by side into one merged row
              (the [B, n, heads * 64] output written without a merge pass);
  half_swap   the half swap of the rotary embedding inside a 64-wide head
              (the loader that ropes rows as it stages them).
Unlike the Mosaic script it raises on a failure. It needs a CUDA card.
"""

from __future__ import annotations

import torch

from korean_f5_tts_tpu_torch.ops import cuda_build
from korean_f5_tts_tpu_torch.ops.flash_prefix import rope_reference
from korean_f5_tts_tpu_torch.utils.misc import require_device


def _probes(dev: torch.device) -> dict:
    """name -> (got, want, absolute tolerance)."""
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}
    # a head of q (columns 64..127) against a head of k (columns 192..255) of 384-wide rows
    x, y, ld, cx, cy = rnd(64, 384), rnd(64, 384), 384, 64, 192
    s = torch.empty((64, 64), dtype=torch.float32, device=dev)
    cuda_build.check(lib.f5_probe_slice_mma(x.data_ptr(), y.data_ptr(), s.data_ptr(), ld, cx, cy,
                                            dev.index, stream), "probe_slice_mma")
    out["slice_mma"] = (s, x[:, cx:cx + 64].float() @ y[:, cy:cy + 64].float().t(), 1e-3)

    q, k = rnd(2, 64, 64), rnd(2, 64, 64)
    merged = torch.empty((64, 128), dtype=torch.bfloat16, device=dev)
    cuda_build.check(lib.f5_probe_pair_store(q.data_ptr(), k.data_ptr(), merged.data_ptr(),
                                             dev.index, stream), "probe_pair_store")
    want = torch.cat([q[g].float() @ k[g].float().t() for g in range(2)], dim=1)
    out["pair_store"] = (merged, want.to(torch.bfloat16), 0.25)  # <= 1 bf16 ulp at |s| < 64

    x = rnd(64, 192)
    ang = torch.rand((64, 32), generator=gen, device=dev) * 6.28
    cos, sin = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
    roped = torch.empty((64, 64), dtype=torch.bfloat16, device=dev)
    cuda_build.check(lib.f5_probe_half_swap(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                            roped.data_ptr(), 192, dev.index, stream),
                     "probe_half_swap")
    want = rope_reference(x[None, None, :, :64], cos, sin)[0, 0]
    out["half_swap"] = (roped, want, 0.0625)  # <= 1 bf16 ulp at |x| < 8
    torch.cuda.synchronize(dev)
    return out


def run(device="cuda") -> dict[str, float]:
    """Run the three probes; returns name -> max abs error, raises on a FAIL."""
    dev = require_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_hopper runs CUDA kernels: it needs a card")
    dev = torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())
    errs, failed = {}, []
    for name, (got, want, tol) in _probes(dev).items():
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.isfinite(got.float()).all().item() and err <= tol
        print(f"probe {name}: {'OK' if ok else 'FAIL'} (max abs err {err:.3e}, bound {tol:.1e})")
        errs[name] = err
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"probe_hopper: {', '.join(failed)} failed")
    return errs


if __name__ == "__main__":
    run()

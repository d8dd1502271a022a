"""Registers each built kernel really uses, read from its machine code.

    python -m korean_f5_tts_tpu_torch.scripts.sass_registers [SUBSTRING ...]

`nvcc -Xptxas -v` reports a kernel that moves registers between its
warpgroups with `setmaxnreg` at the share it is launched with (168 a thread
for 384 threads), not at what its consumer warpgroups use after the move.
This builds the kernels (ops/cuda_build.py), disassembles the library with
`cuobjdump -sass` and prints, for each kernel whose mangled name holds one
of the given substrings (default: the attention cores and the 3xTF32
attention kernels), the highest register index its code names plus one.
Needs the CUDA toolkit (the machine with the card).
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

from korean_f5_tts_tpu_torch.ops import cuda_build

DEFAULT = ("wgmma_kernel", "tf32_d128_kernel")


def registers(sass: str) -> dict[str, int]:
    """{kernel: highest register index + 1} of a `cuobjdump -sass` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[name] = max(out[name], int(r) + 1)
    return out


def main(argv=None) -> int:
    keys = tuple(argv if argv is not None else sys.argv[1:]) or DEFAULT
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(cuda_build.build())], capture_output=True,
                          text=True, check=True).stdout
    for fn, n in sorted(registers(sass).items()):
        if any(k in fn for k in keys):
            print(f"{n:4d} registers  {fn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

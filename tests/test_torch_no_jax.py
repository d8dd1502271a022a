"""The port imports torch and never jax: the machine with the GPU has no jax.

Every module of korean_f5_tts_tpu_torch is imported in a fresh interpreter
that first drops every jax* entry from sys.modules and then sets
sys.modules["jax"] = None, so any `import jax` on the way raises.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import korean_f5_tts_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

GUARD = r"""
import importlib, pkgutil, sys
for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]
sys.modules["jax"] = None
import korean_f5_tts_tpu_torch as pkg
names = ["korean_f5_tts_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, "korean_f5_tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.startswith(("jax.", "jaxlib"))]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        korean_f5_tts_tpu_torch.__path__, "korean_f5_tts_tpu_torch."))
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == expected >= 20


def test_chip_smoke_imports_without_jax():
    code = GUARD.replace("print(len(names))", "import chip_smoke\nprint(len(names))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_the_sources():
    for path in (ROOT / "korean_f5_tts_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (path, line)

"""The port imports torch and never jax, and nothing of the JAX package: the
machine with the GPU has no jax, and the port keeps its own copy of whatever
it needs from a framework-free module of korean_f5_tts_tpu.

Every module of korean_f5_tts_tpu_torch is imported in a fresh interpreter
that first drops every jax* entry from sys.modules and then sets
sys.modules["jax"] = None, so any `import jax` on the way raises. Afterwards
no key of sys.modules may be korean_f5_tts_tpu or start with
"korean_f5_tts_tpu.": that package's __init__ is lazy, so importing a
jax-free module of it raises nothing and only this check sees it.
"""

import pkgutil
import re
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
# after the imports: nothing of the JAX package was loaded on the way
NO_JAX_PACKAGE = r"""
loaded = [m for m in sys.modules
          if m == "korean_f5_tts_tpu" or m.startswith("korean_f5_tts_tpu.")]
assert not loaded, loaded
"""
IMPORTS_JAX_PACKAGE = re.compile(r"^\s*(from|import)\s+korean_f5_tts_tpu(\.|\s|$)")


def test_port_imports_without_jax():
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        korean_f5_tts_tpu_torch.__path__, "korean_f5_tts_tpu_torch."))
    proc = subprocess.run([sys.executable, "-c", GUARD + NO_JAX_PACKAGE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == expected >= 20


def test_chip_smoke_imports_without_jax():
    code = GUARD.replace("print(len(names))", "import chip_smoke\nprint(len(names))")
    code += NO_JAX_PACKAGE
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_the_sources():
    for path in (ROOT / "korean_f5_tts_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (path, line)


def _sources():
    yield from (ROOT / "korean_f5_tts_tpu_torch").rglob("*.py")
    yield ROOT / "chip_smoke.py"


def test_no_import_of_the_jax_package_in_the_sources():
    for path in _sources():
        for line in path.read_text().splitlines():
            assert not IMPORTS_JAX_PACKAGE.match(line), (path, line)


def test_the_check_sees_an_import_of_a_jax_free_module():
    """The fault this file once missed: a jax-free module of the JAX package
    imports without error, and only the sys.modules check notices."""
    code = GUARD + "import korean_f5_tts_tpu.text.vocab\n" + NO_JAX_PACKAGE
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "korean_f5_tts_tpu.text.vocab" in proc.stderr
    assert IMPORTS_JAX_PACKAGE.match("from korean_f5_tts_tpu.text.vocab import x")
    assert IMPORTS_JAX_PACKAGE.match("    import korean_f5_tts_tpu")
    assert not IMPORTS_JAX_PACKAGE.match("from korean_f5_tts_tpu_torch.text.vocab import x")


SERVING_AND_INFERENCE_MODULES = (
    "serving.proto", "serving.client", "serving.grpc_server", "serving.benchmark",
    "socket_server", "infer.speech_edit", "infer.batch_infer", "scripts.int8_quality",
)
ENTRY_POINTS = ("serving.server", "serving.grpc_server", "serving.benchmark", "socket_server",
                "infer.speech_edit", "infer.batch_infer", "scripts.int8_quality", "train.train",
                "train.finetune_cli", "train.train_lora")
# the fine-tuning path: reference checkpoints, LoRA, the datasets, the training CLIs
FINETUNE_MODULES = (
    "utils.torch_ckpt", "models.lora", "train.train", "train.finetune_cli", "train.train_lora",
    "train.vocab_extend", "train.datasets.prepare", "scripts.convert_vocoder", "data.dataset",
)


def test_the_walk_covers_the_serving_and_inference_modules():
    """test_port_imports_without_jax imports whatever pkgutil finds: the
    modules of the serving and inference entry points are among them, and
    grpc is imported by none of them at import time."""
    found = {m.name for m in pkgutil.walk_packages(korean_f5_tts_tpu_torch.__path__,
                                                   "korean_f5_tts_tpu_torch.")}
    for name in SERVING_AND_INFERENCE_MODULES:
        assert f"korean_f5_tts_tpu_torch.{name}" in found, name
    code = GUARD.replace("import korean_f5_tts_tpu_torch as pkg",
                         'sys.modules["grpc"] = None\nimport korean_f5_tts_tpu_torch as pkg')
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_entry_point_takes_a_device_that_defaults_to_the_card():
    """Each command line has --device with default "cuda" and goes through
    utils/misc.py:require_device (directly or through
    serving/server.py:load_from_arguments), so it raises without a card."""
    for name in ENTRY_POINTS:
        text = (ROOT / "korean_f5_tts_tpu_torch" / (name.replace(".", "/") + ".py")).read_text()
        assert "add_model_arguments(" in text or '"--device", default="cuda"' in text, name
        assert "load_from_arguments(" in text or "require_device(" in text, name
    server = (ROOT / "korean_f5_tts_tpu_torch/serving/server.py").read_text()
    assert '"--device", default="cuda"' in server and "require_device(args.device)" in server


def test_the_walk_covers_the_finetuning_modules():
    """The fine-tuning modules are in the walk of test_port_imports_without_jax,
    and none of them imports an optional package (safetensors, pyarrow, yaml,
    datasets) at import time: the card's machine may lack them."""
    found = {m.name for m in pkgutil.walk_packages(korean_f5_tts_tpu_torch.__path__,
                                                   "korean_f5_tts_tpu_torch.")}
    for name in FINETUNE_MODULES:
        assert f"korean_f5_tts_tpu_torch.{name}" in found, name
    blocked = "".join(f'sys.modules["{m}"] = None\n'
                      for m in ("safetensors", "pyarrow", "yaml", "datasets"))
    code = GUARD.replace("import korean_f5_tts_tpu_torch as pkg",
                         blocked + "import korean_f5_tts_tpu_torch as pkg")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_backbone_modules_are_walked():
    """The modules of the UNetT and MMDiT backbones, BigVGAN and the parameter
    counter are among those the guard above imports."""
    names = {m.name for m in pkgutil.walk_packages(korean_f5_tts_tpu_torch.__path__,
                                                   "korean_f5_tts_tpu_torch.")}
    assert {"korean_f5_tts_tpu_torch.models.unett", "korean_f5_tts_tpu_torch.models.mmdit",
            "korean_f5_tts_tpu_torch.models.bigvgan",
            "korean_f5_tts_tpu_torch.scripts.count_params_gflops"} <= names

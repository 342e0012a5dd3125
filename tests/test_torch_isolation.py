"""styletts2_tpu_torch, chip_smoke.py and the multi-process tests' worker
(tests/torch_parallel_worker.py) import torch, never jax, and nothing of
the styletts2_tpu package.

The import check runs in a fresh interpreter: conftest has already imported
jax (and styletts2_tpu) into this process."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "styletts2_tpu_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import styletts2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "tests")
importlib.import_module("torch_parallel_worker")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "styletts2_tpu" or m.startswith("styletts2_tpu."))
for must in ("train", "train_loop", "losses", "optim", "checkpoint",
             "nn.asr", "nn.jdc", "nn.discriminators", "nn.wavlm", "nn.slm",
             "data.loader",
             "convert", "flac", "ops.launch_count", "tools.serve_http",
             "tools.export_serving", "tools.app", "tools.demo_infer",
             "tools.convert_to_torch", "tools.strip_checkpoint",
             "tools.extend_tokens", "parallel", "parallel.mesh",
             "parallel.seqpar", "onnx", "onnx.proto", "onnx.builder",
             "onnx.export", "onnx.runtime", "tools.export_onnx",
             "tools.bench_train", "tools.profile_inference"):
    assert pkg.__name__ + "." + must in names, must
print(len(names))
print("|".join(bad))
"""


def test_package_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = (out.stdout.split("\n") + [""])[:2]
    # every submodule was imported: the inference, training, deployment,
    # multi-GPU and ONNX modules and the measurement tools
    assert int(n_modules) >= 60, out.stdout
    assert bad == "", f"imported: {bad}"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)")


def test_no_source_line_imports_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PKG.rglob("*.py")) + [
            REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_worker.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = _IMPORT.match(line)
            if not m:
                continue
            root = m.group(1).split(".")[0]
            if root in ("jax", "jaxlib", "styletts2_tpu"):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)

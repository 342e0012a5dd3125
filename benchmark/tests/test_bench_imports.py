"""Nothing the benchmark runs imports jax, jaxlib, flax or styletts2_tpu
(top-level names compared whole: styletts2_tpu_torch passes), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

RUNS = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import json
from pathlib import Path
from benchmark.harness import cells
from benchmark import control, run
for wl in json.loads(Path({str(ROOT)!r}, "BENCHMARK.json").read_text())["workloads"]:
    cells.load(Path({str(ROOT)!r}), wl["name"])
import styletts2_tpu_torch.infer, styletts2_tpu_torch.config
print(json.dumps(run.banned_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_banned_is_loaded():
    out = subprocess.run([sys.executable, "-c", RUNS], capture_output=True,
                         text=True, timeout=300, check=True).stdout.split("\n")
    assert out[0] == "[]"
    assert "styletts2_tpu_torch" in out[1]


def test_banned_names_compare_whole():
    from benchmark import run

    before = set(sys.modules)
    try:
        sys.modules["styletts2_tpu_torch_x"] = sys
        sys.modules["jaxlike.y"] = sys
        assert "styletts2_tpu" not in run.banned_modules()
        assert "jax" not in run.banned_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax" in run.banned_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] in {
                "__future__", "benchmark", "contextlib", "dataclasses",
                "itertools", "math", "numpy", "re", "scipy", "torch",
                "typing"}, (path.name, n)
            if n.startswith("benchmark"):
                assert n.startswith("benchmark.reference"), (path.name, n)


def test_reference_alone_loads_no_program_module():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import benchmark.reference.synth, benchmark.reference.params; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith(('styletts2', 'jax', 'flax'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"

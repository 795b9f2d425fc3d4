"""What the benchmark runs loads neither JAX nor the JAX package: compared by
whole top-level names, since ngmlr_tpu_torch begins with ngmlr_tpu."""

import ast
import os
import subprocess
import sys

import pytest

from .helpers import BENCH, ROOT

sys.path.insert(0, ROOT)
from benchmark.run import forbidden_modules  # noqa: E402


@pytest.mark.parametrize("modules,found", [
    (["ngmlr_tpu_torch", "ngmlr_tpu_torch.pipeline.runner", "numpy"], []),
    (["ngmlr_tpu", "ngmlr_tpu_torch"], ["ngmlr_tpu"]),
    (["ngmlr_tpu.cli"], ["ngmlr_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"],
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_by_whole_name(modules, found):
    assert forbidden_modules(modules) == found


def test_harness_and_program_imports_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.calibrate\n"
            "import benchmark.harness.trace\n"
            "import ngmlr_tpu_torch.cli, ngmlr_tpu_torch.pipeline.runner\n"
            "from benchmark.run import forbidden_modules\n"
            "print(forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"ngmlr_tpu_torch", "ngmlr_tpu", "jax"}, f


def test_harness_names_no_file_outside_the_benchmark():
    """Nothing under benchmark/ reads bench.py, BENCH_*.json, chip_smoke.py
    or scripts/ (the tests compare the copies with those originals)."""
    for d, _, files in os.walk(BENCH):
        if "tests" in d.split(os.sep) or "cache" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(d, f))}
                assert not tops & {"chip_smoke", "bench", "torch_bench",
                                   "scripts"}, f

"""Without a CUDA card a run fails and prints no result; so does a checkout
that holds only BENCHMARK.json and benchmark/."""

import os
import shutil
import subprocess
import sys

from .helpers import BENCH, ROOT

ARGS = ["--workload", "chr1_pacbio.clr", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def test_run_without_a_card_fails_with_no_result():
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py")] + ARGS,
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2
    assert p.stdout == ""
    assert "is_available() is false" in p.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS,
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert p.stdout == ""


def test_unknown_workload_fails():
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "nope", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout == ""

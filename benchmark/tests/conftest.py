"""Tests of the benchmark harness (CPU). Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked `cuda` need a card and skip without one; on the card they run
a cell end to end through benchmark/run.py.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch sees none")

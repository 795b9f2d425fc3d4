"""fuzzq's first 4 reads (scripts/torch_options_vs_jax.py) through the port
on the CPU under the subread, filter and output option sets (sub128, sub512,
strict, nosplit, readgroup), each read held to the JAX package's committed
digests, QUAL included (readgroup through the CLI's -o *.sam.gz).
"""

import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_options as T  # noqa: E402

SETS = ["sub128", "sub512", "strict", "nosplit", "readgroup"]


@pytest.fixture(scope="module")
def fuzzq_files(tmp_path_factory):
    return T.O.make_fuzzq(str(tmp_path_factory.mktemp("fuzzq")))[:2]


@pytest.mark.parametrize("name", SETS)
def test_fuzzq_prefix_equals_the_committed_digests(fuzzq_files, name,
                                                   tmp_path):
    runs, failures, _ = T.map_prefix(name, fuzzq_files, str(tmp_path))
    T.check_prefix(name, runs, failures)

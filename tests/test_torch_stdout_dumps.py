"""The --stdout debug dump modes through the port's CLI on the CPU, byte
for byte against the reference binary's own stdout (tests/golden/dumps/),
the four cases the reference's CI checks (tests/test_stdout_dumps.py:33-38).
The dumps come from the serial Python path: one-problem score and align
waves posted through SerialBinding (pipeline/batcher.py)."""

import gzip
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DUMPS = os.path.join(HERE, "golden", "dumps")
DATASETS = {
    "test_2": ("test_2/ref_chr21_20kb.fa", "test_2/reads_100_2200bp.fa"),
    "test_4": ("test_4/reference.fasta.gz", "test_4/read.fa.gz"),
}


@pytest.mark.parametrize("dataset,mode", [
    ("test_2", 1),    # dot plot: anchors + cLIS + segments + results
    ("test_2", 5),    # mapped segments
    ("test_4", 4),    # inversion-candidate FASTA (real SV reads)
    ("test_4", 3),    # error profile (nm-per-position windows)
])
def test_stdout_dump_matches_reference(dataset, mode):
    ref, qry = (os.path.join(HERE, "data", p) for p in DATASETS[dataset])
    env = dict(os.environ, NGMLR_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               NGMLR_TPU_STRICT="1")
    r = subprocess.run(
        [sys.executable, "-m", "ngmlr_tpu_torch", "-r", ref, "-q", qry,
         "-x", "pacbio", "--stdout", str(mode), "-o", os.devnull],
        capture_output=True, env=env, cwd=REPO, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    golden = os.path.join(DUMPS, f"{dataset}_stdout{mode}.txt.gz")
    with gzip.open(golden, "rb") as f:
        assert r.stdout == f.read()

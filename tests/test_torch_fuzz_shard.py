"""--shard over a read file with empty records, merged with
scripts/merge_sams.py --query: the first 12 reads of the SV-rich fuzz's
seed 501 with two empty FASTA records among them, mapped as two shards
through the port's CLI on the CPU and through ngmlr_tpu's CLI; the two
merged files are equal byte for byte (@PG aside), every read's records
equal its records in the port's single run, and the empty records emit
none.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_fuzz_vs_jax as F  # noqa: E402

N_READS = 12
# the empty records go in before these reads: file records 3 and 8, one in
# each shard of two
EMPTY_BEFORE = {3: b"empty_a", 7: b"empty_b"}


def _with_empties(reads, out):
    """Writes reads' records to out with EMPTY_BEFORE's empty records."""
    with open(reads, "rb") as f:
        recs = [b">" + r for r in f.read().split(b">")[1:]]
    with open(out, "wb") as f:
        for i, rec in enumerate(recs):
            if i in EMPTY_BEFORE:
                f.write(b">" + EMPTY_BEFORE[i] + b"\n")
            f.write(rec)


def _sharded(package, ref, reads, workdir):
    """Maps reads as --shard 0/2 and 1/2 through package's CLI (both
    processes at once, one thread each) and merges them with --query.
    Returns the merged SAM, @PG stripped."""
    env = dict(os.environ, NGMLR_TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    shards = [os.path.join(workdir, "%s_%d.sam" % (package, i))
              for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", package, "-r", ref, "-q", reads, "-o", out,
         "--skip-write", "--no-progress", "--shard", "%d/2" % i],
        cwd=REPO, env=env, stderr=subprocess.PIPE)
        for i, out in enumerate(shards)]
    for p in procs:
        _, err = p.communicate()
        assert p.returncode == 0, err[-2000:]
    merged = os.path.join(workdir, "%s_merged.sam" % package)
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "merge_sams.py"),
                    "--query", reads, merged] + shards,
                   cwd=REPO, check=True)
    with open(merged, "rb") as f:
        return F.strip_pg(f.read())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fuzz_shard"))
    ref, plain = F.dataset(501, N_READS, d)
    reads = os.path.join(d, "with_empties.fa")
    _with_empties(plain, reads)
    return d, ref, reads


def test_shard_merge_over_empty_records_matches_jax_and_single_run(files):
    d, ref, reads = files
    port = _sharded("ngmlr_tpu_torch", ref, reads, d)
    jax = _sharded("ngmlr_tpu", ref, reads, d)
    assert port == jax
    p, _ = F.port_pipeline(ref, "pacbio", device="cpu")
    buf = io.BytesIO()
    p.run(reads, buf)
    single = F.strip_pg(buf.getvalue())
    heads, merged, order = F.groups(port)
    sheads, by_read, sorder = F.groups(single)
    assert heads == sheads
    assert sorted(order) == sorted(sorder) == sorted(F.read_names(N_READS))
    for q in order:
        assert merged[q] == by_read[q], q
    assert not set(EMPTY_BEFORE.values()) & set(order)

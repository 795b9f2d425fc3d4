"""The SV-rich fuzz of scripts/fuzz_vs_reference.py through the PyTorch
port on the CPU (scripts/torch_fuzz_vs_jax.py): its datasets are the
reference generator's bytes; the port's SAM equals ngmlr_tpu's (@PG aside)
with the host search, the device search and wave depth 2 at intake batches
off the 10-read intake group (where both packages move records), and with
-x ont; the committed JAX SAMs and digests of tests/golden/torch_fuzz are
what ngmlr_tpu writes now; and those files keep their SV records.
"""

import gzip
import io
import os
import sys

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import fuzz_vs_reference as R  # noqa: E402
import chip_smoke as cs  # noqa: E402
import torch_fuzz_vs_jax as F  # noqa: E402

FUZZ_DIR = os.path.join(GOLDEN_DIR, "torch_fuzz")
# the prefixes mapped here: sized to one core's test budget
CASES = {"pacbio": (501, 24), "ont": (506, 16)}
# seed 504's first 5 reads (junk, junk, a 211 bp read, a deletion span,
# junk) in 2-read intake batches: the short read leads its intake group
# at 192-read batches and follows fz1 at 2, in either package
REORDER = (504, 5, 2)


@pytest.mark.parametrize("seed,n_reads", [(501, 150), (506, 150), (7, 3)])
def test_datasets_are_the_reference_generators_bytes(tmp_path, seed,
                                                     n_reads):
    paths = []
    for gen, sub in ((F.make_dataset, "port"), (R.make_dataset, "ref")):
        d = tmp_path / sub
        d.mkdir()
        paths.append(gen(np.random.default_rng(seed), str(d), n_reads))
    for a, b in zip(*paths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def _jax_sam(ref, reads, preset, batch_reads=192):
    """ngmlr_tpu's Pipeline in process, @PG stripped."""
    from ngmlr_tpu.cli import build_parser, config_from_args
    from ngmlr_tpu.pipeline.runner import Pipeline
    argv = ["-r", ref, "-q", reads, "-x", preset, "--skip-write",
            "--batch-reads", str(batch_reads)]
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), ref, use_cache=False)
    buf = io.BytesIO()
    p.run(reads, buf)
    return F.strip_pg(buf.getvalue())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """preset -> (ref, reads, ngmlr_tpu's SAM) of CASES' datasets, and
    "reorder" -> (ref, reads, ngmlr_tpu's SAM at 192-read batches, at
    REORDER's batches) of REORDER's."""
    out = {}
    for preset, (seed, n) in CASES.items():
        d = str(tmp_path_factory.mktemp("fuzz_%s" % preset))
        ref, reads = F.dataset(seed, n, d)
        out[preset] = (ref, reads, _jax_sam(ref, reads, preset))
    seed, n, batch = REORDER
    ref, reads = F.dataset(seed, n, str(tmp_path_factory.mktemp("reorder")))
    out["reorder"] = (ref, reads, _jax_sam(ref, reads, "pacbio"),
                      _jax_sam(ref, reads, "pacbio", batch))
    return out


def test_port_matches_jax_three_ways(jax_runs, monkeypatch):
    """Under NGMLR_TPU_WAVE_DEPTH=2: seed 501's first 24 reads with the
    gate's host search and with a device search on the CPU
    (NGMLR_TPU_DEVICE_SEARCH=1's path) on one Pipeline; and map_seed's
    three mappings of REORDER's reads, the third at its 2-read batches
    (three batches, two in flight), which ngmlr_tpu orders as the port
    does."""
    monkeypatch.setenv("NGMLR_TPU_WAVE_DEPTH", "2")
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    ref, reads, want = jax_runs["pacbio"]
    p, _ = F.port_pipeline(ref, "pacbio", device="cpu")
    assert p.ctx.device.type == "cpu" and p.dev_search is None
    assert p._native_pool.qsize() == 2
    host = cs._run_counted("host search", p, reads)
    with cs.other_search(p) as (search, _):
        assert search == "device"
        dev = cs._run_counted("device search", p, reads)
    assert dev[3]["search_v2_launches"] > 0
    for run in (host, dev):
        assert run[3]["engine_waves"] > 0
        assert F.strip_pg(run[0]) == want
    _, by_read, _ = F.groups(want)
    assert len(by_read) == CASES["pacbio"][1]

    seed, n, batch = REORDER
    ref, reads, want, want_small = jax_runs["reorder"]
    p, _ = F.port_pipeline(ref, "pacbio", device="cpu")
    runs = F.map_seed(p, reads, "seed %d" % seed, small_batch=batch)
    assert [(r["search"], r["batch_reads"]) for r in runs.values()] == [
        ("host", 192), ("device", 192), ("host", batch)]
    assert runs["small batches"]["stats"]["engine_waves"] >= 2
    assert runs["gate"]["sam"] == runs["other search"]["sam"] == want
    assert runs["small batches"]["sam"] == want_small


def test_both_packages_move_records_at_batches_off_the_intake_group(
        jax_runs):
    """At REORDER's 2-read batches ngmlr_tpu writes the same records per
    read as at 192, in another order (each batch starts an intake group;
    short reads lead their group); the port's bytes there are
    test_port_matches_jax_three_ways'."""
    _, _, want, want_small = jax_runs["reorder"]
    heads, by_read, order = F.groups(want)
    heads_s, by_read_s, order_s = F.groups(want_small)
    assert heads == heads_s and by_read == by_read_s
    assert order == [b"fz2", b"fz0", b"fz1", b"fz3", b"fz4"]
    assert order_s == F.read_names(REORDER[1])


def test_port_matches_jax_with_ont(jax_runs, monkeypatch):
    monkeypatch.setenv("NGMLR_TPU_STRICT", "1")
    ref, reads, want = jax_runs["ont"]
    p, _ = F.port_pipeline(ref, "ont", device="cpu")
    assert F.strip_pg(cs._run_counted("ont", p, reads)[0]) == want


@pytest.mark.parametrize("preset", sorted(CASES))
def test_committed_sams_are_what_ngmlr_tpu_writes_now(jax_runs, preset):
    seed, n = CASES[preset]
    assert F.committed_sam(seed, preset, n) == jax_runs[preset][2]


def test_committed_digests_are_what_ngmlr_tpu_writes_now(tmp_path):
    """The per-read digests of seed 33 (-x ont), whose first 6 reads
    ngmlr_tpu maps now, and the table's size."""
    table = F.committed_digests()
    assert sorted(table) == sorted((p, s) for s, p in F.DIGEST_SEEDS)
    assert all(len(t) == F.N_READS + 1 for t in table.values())
    ref, reads = F.dataset(33, 6, str(tmp_path))
    _, by_read, _ = F.groups(_jax_sam(ref, reads, "ont"))
    for q, recs in by_read.items():
        assert F.digest(recs) == table[("ont", 33)][q.decode()], q


def test_committed_sams_keep_their_sv_records():
    m = F.load_manifest()
    assert [(e["seed"], e["preset"], e["reads"]) for e in m["files"]] == [
        (s, p, F.N_READS) for s, p in F.SAM_SEEDS]
    total = {"sa_records": 0, "supplementary": 0, "reverse": 0,
             "unmapped": 0}
    chroms, short, size = set(), 0, 0
    for e in m["files"]:
        path = os.path.join(FUZZ_DIR, e["file"])
        size += os.path.getsize(path)
        with gzip.open(path) as f:
            s = F.sam_summary(f.read())
        assert s == e["summary"]
        assert s["reads"] == F.N_READS
        for k in total:
            total[k] += s[k]
        chroms |= set(s["by_chrom"])
        short += s["short_reads"]
    assert all(v >= 1 for v in total.values()), total
    assert chroms == {"fzchr1", "fzchr2"}
    assert short >= 1
    assert size < 2_000_000


def test_script_runs_on_the_cpu(capsys):
    """The script's seed mode on 3 reads of a committed seed (seed 504's:
    two junk reads and a short one, quick on the CPU): the three mappings,
    each identical to the committed file's prefix."""
    assert F.main(["--device", "cpu", "--reads", "3", "504"]) == 0
    out = capsys.readouterr().out
    assert out.count("identical=3 diff=0 file_identical=True") == 3, out


def test_script_without_a_jax_source_exits_2(capsys):
    assert F.main(["--device", "cpu", "--reads", "3", "7"]) == 2
    assert "no committed file covers seed 7" in capsys.readouterr().out

"""The CLI's option sets over FASTQ input (scripts/torch_options_vs_jax.py)
on the CPU: the generators rebuild the committed FASTQ bytes; both
packages' parsers give the same Config for every set's argv; fuzzq's first
4 reads go through the port under the sets of SETS (the others in
tests/test_torch_options_sets.py and tests/test_torch_options_filters.py:
the plain fill takes ~25 s a set), each read held to the JAX package's
committed digests (QUAL included); the port and ngmlr_tpu in process agree on them under the
scoring set; and --bam-fix's SAM writer line for an alignment of 70,000
CIGAR ops is the same in both packages.
"""

import dataclasses
import gzip
import hashlib
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

import torch_fuzz_vs_jax as F  # noqa: E402
import torch_options_vs_jax as O  # noqa: E402

OPTIONS_DIR = os.path.join(GOLDEN_DIR, "torch_options")
N_READS = 4
FUZZQ_SETS = [s for s, (_, dsets) in O.OPTION_SETS.items()
              if "fuzzq" in dsets]
# the sets whose fuzzq prefix maps in this file (scoring among them, for
# test_scoring_agrees_with_ngmlr_tpu_in_process); the rest map in two
# files of their own, so that each file stays within its time
SETS = ["default", "ont", "scoring", "affine"]


@pytest.fixture(scope="module")
def manifest():
    return O.load_manifest(OPTIONS_DIR)


@pytest.fixture(scope="module")
def fuzzq(tmp_path_factory):
    """(ref, reads.fastq.gz, the FASTQ's bytes) of fuzzq."""
    return O.make_fuzzq(str(tmp_path_factory.mktemp("fuzzq")))


def test_generators_rebuild_the_committed_fastq(fuzzq, manifest,
                                                tmp_path):
    ds = manifest["datasets"]
    phase4q = O.make_phase4q(str(tmp_path))
    for name, (ref, reads, fq) in (("fuzzq", fuzzq), ("phase4q", phase4q)):
        assert hashlib.sha256(fq).hexdigest() == ds[name]["reads_sha256"]
        assert O.reads_sha256(reads) == ds[name]["reads_sha256"]
        with open(ref, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() \
                == ds[name]["genome_sha256"]
        recs = fq.split(b"\n")
        assert len(recs) == 4 * ds[name]["reads"] + 1
        quals = np.frombuffer(b"".join(recs[3::4]), np.uint8) - 33
        assert quals.min() >= O.QUAL_RANGE[0]
        assert quals.max() <= O.QUAL_RANGE[1]
        # the sequences are the FASTA generator's bytes
        fa = O.fasta_records(os.path.join(os.path.dirname(ref), "reads.fa"))
        assert [(n, s) for n, s in zip(recs[0::4], recs[1::4])] \
            == [(b"@" + n, s) for n, s in fa]


def test_committed_digests_cover_every_pair(manifest):
    digests = O.load_digests(OPTIONS_DIR)
    assert set(digests) == set(O.pairs())
    for key, want in digests.items():
        n = manifest["datasets"][key[1]]["reads"]
        assert "*" in want and len(want) == n + 1, key
        assert "%s/%s" % key in manifest["mappings"]
    for key, (env, argv, _) in O.JAX_EXTRA.items():
        rec = manifest["mappings"]["%s/%s" % key]
        assert rec["env"] == env and rec["why"]
        assert " ".join(argv) in rec["command"]


def test_committed_default_equals_the_fasta_runs_with_qual_masked(
        manifest):
    """The cross-checks: fuzzq under default is seed 501's committed SAM
    once QUAL is '*' (recomputed here from the committed SAMs), and
    phase4q's, recorded at --write-jax, phase 4's digests."""
    with gzip.open(os.path.join(OPTIONS_DIR,
                                manifest["sams"]["default/fuzzq"])) as f:
        sam = f.read()
    assert hashlib.sha256(sam).hexdigest() \
        == O.load_digests(OPTIONS_DIR)[("default", "fuzzq")]["*"]
    assert O.mask_qual(sam) == F.committed_sam(O.FUZZQ_SEED, "pacbio",
                                               F.N_READS)
    assert sam != O.mask_qual(sam)
    checks = manifest["cross_checks"]
    for name in ("fuzzq_default_vs_seed501", "phase4q_default_vs_phase4"):
        assert checks[name]["diff"] == []
        assert checks[name]["identical"] == checks[name]["reads"] > 0


def _configs(argv):
    """Each package's Config (with rg_fields) from argv through its own
    parser and config_from_args."""
    from ngmlr_tpu import cli as jcli
    from ngmlr_tpu_torch import cli as tcli
    out = []
    for cli in (jcli, tcli):
        args = cli.build_parser().parse_args(argv)
        cfg = cli.config_from_args(args, argv)
        out.append(dict(dataclasses.asdict(cfg), rg_fields=cfg.rg_fields))
    return out


@pytest.mark.parametrize("name", list(O.OPTION_SETS))
def test_config_from_args_agree(name):
    argv = ["-r", "ref.fa", "-q", "reads.fastq.gz"] + O.set_argv(name, "d")
    jax_cfg, port_cfg = _configs(argv)
    assert port_cfg == jax_cfg
    # the set's options reach the Config: it differs from the defaults'
    # (the readgroup set's -o is the output file)
    if name != "default":
        assert port_cfg != _configs(argv[:4])[1]


def map_prefix(name, files, workdir):
    """The port's runs of fuzzq's first N_READS reads under a set (map_set
    on the CPU: the gate's search alone; readgroup through the CLI's -o
    *.sam.gz alone), held to the committed digests."""
    return O.map_set(name, "fuzzq", files,
                     O.load_digests(OPTIONS_DIR)[(name, "fuzzq")],
                     device="cpu", n_reads=N_READS,
                     n_mappings=0 if name == "readgroup" else 1,
                     workdir=workdir)


def check_prefix(name, runs, failures):
    assert not failures, failures
    assert runs
    for m, run in runs.items():
        assert run["identical"] == run["reads"] == N_READS, m
        assert run["search"] == "host"
        assert not any(run["launches"].values())
        # QUAL is the FASTQ's, reversed on reverse-strand records
        assert b"\t*\tAS:i:" not in run["sam"]
    if name == "readgroup":
        assert b"@RG\tID:run1\tSM:NA12878\tLB:lib1\tPL:PACBIO\tPU:u1\n" \
            in runs["cli -o .sam.gz"]["sam"]


@pytest.fixture(scope="module")
def port_runs(fuzzq, tmp_path_factory):
    """name -> map_prefix's (runs, failures, setup) of a set, computed
    once."""
    cache = {}
    work = str(tmp_path_factory.mktemp("runs"))

    def get(name):
        if name not in cache:
            cache[name] = map_prefix(name, fuzzq[:2], work)
        return cache[name]
    return get


@pytest.mark.parametrize("name", SETS)
def test_fuzzq_prefix_equals_the_committed_digests(port_runs, name):
    runs, failures, _ = port_runs(name)
    check_prefix(name, runs, failures)


def test_every_fuzzq_set_maps_in_one_file():
    import test_torch_options_filters as filters
    import test_torch_options_sets as sets
    split = SETS + sets.SETS + filters.SETS
    assert sorted(split) == sorted(FUZZQ_SETS)


def test_scoring_agrees_with_ngmlr_tpu_in_process(fuzzq, port_runs,
                                                  tmp_path):
    """fuzzq's first N_READS reads under scoring through ngmlr_tpu's
    Pipeline in process (its parser, config_from_args), QUAL included,
    equal to the port's run byte for byte."""
    from ngmlr_tpu.cli import build_parser, config_from_args
    from ngmlr_tpu.pipeline.runner import Pipeline
    ref = fuzzq[0]
    reads = O.head_reads(fuzzq[1], N_READS,
                         str(tmp_path / "head.fastq.gz"))
    argv = ["-r", ref, "-q", reads, "--skip-write"] \
        + O.set_argv("scoring", str(tmp_path))
    args = build_parser().parse_args(argv)
    p = Pipeline(config_from_args(args, argv), ref, use_cache=False)
    buf = io.BytesIO()
    p.run(reads, buf)
    jax_sam = F.strip_pg(buf.getvalue())
    runs, failures, _ = port_runs("scoring")
    assert not failures
    assert runs["gate"]["sam"] == jax_sam
    _, by_read, _ = F.groups(jax_sam)
    assert len(by_read) == N_READS
    assert any(int(l.split(b"\t")[1]) & 16 for r in by_read.values()
               for l in r)


def _long_alignment_line(pkg, tmp_path):
    """One read of 70,000 bases aligned as 35,000 x 1M1I (70,000 CIGAR ops)
    forward, with a reverse supplementary record, through pkg's SamWriter
    under --bam-fix."""
    import importlib
    cli = importlib.import_module(pkg + ".cli")
    ref_m = importlib.import_module(pkg + ".io.reference")
    reads_m = importlib.import_module(pkg + ".io.reads")
    cigar_m = importlib.import_module(pkg + ".align.cigar")
    lr = importlib.import_module(pkg + ".pipeline.longread")
    sam_m = importlib.import_module(pkg + ".out.sam")
    rng = np.random.default_rng(70000)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60_000)]
    fa = tmp_path / ("ref_%s.fa" % pkg)
    fa.write_bytes(b">chrL\n" + g.tobytes() + b"\n")
    ref = ref_m.ReferenceGenome.from_fasta(str(fa), use_cache=False)
    argv = ["-r", str(fa), "--bam-fix"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv), argv)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 70_000)]
    qual = (rng.integers(2, 41, 70_000).astype(np.uint8) + 33).tobytes()
    read = reads_m.Read(0, b"long70k", seq.tobytes(), qual)
    big = cigar_m.Align(cigar="1M1I" * 35_000, md="35000", score=1000.0,
                        identity=0.5, nm=35_000, mq=60, qstart=0, qend=0,
                        cigar_op_count=70_000, primary=True, sv_type=-1)
    small = cigar_m.Align(cigar="69000S1000M", md="1000", score=900.0,
                          identity=1.0, nm=0, mq=20, qstart=69_000, qend=0,
                          cigar_op_count=2, primary=False, sv_type=-1)
    recs = [lr.AlignmentRecord(big, 100, False, 1000.0),
            lr.AlignmentRecord(small, 50_000, True, 900.0)]
    buf = io.BytesIO()
    sam_m.SamWriter(ref, cfg, buf).write_read(read, recs, True)
    return buf.getvalue()


def test_bam_fix_writer_agrees(tmp_path):
    jax_out = _long_alignment_line("ngmlr_tpu", tmp_path)
    port_out = _long_alignment_line("ngmlr_tpu_torch", tmp_path)
    assert port_out == jax_out
    big, small = port_out.split(b"\n")[:2]
    f = big.split(b"\t")
    assert f[5] == b"70000S"
    cg = [t for t in f[11:] if t.startswith(b"CG:B:I,")]
    assert len(cg) == 1
    vals = [int(v) for v in cg[0][len(b"CG:B:I,"):].split(b",")]
    assert vals == [(1 << 4) | 0, (1 << 4) | 1] * 35_000
    assert O.bam_fix_facts(port_out) == {
        "records_65536_ops": 1, "cg_tags": 1, "max_ops": 70_000}
    # the short record keeps its CIGAR; its SA:Z names the long one's
    assert small.split(b"\t")[5] == b"69000S1000M"
    assert b"CG:B:I" not in small

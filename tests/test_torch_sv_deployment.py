"""The benchmark's chr1_pacbio_sv deployment on the CPU: its traffic mix
(benchmark/traffic/survivor.json, SURVIVOR's default SV mix over
length-biased PBSIM CLR reads) gives the strata it states, and a dozen of
its reads map through Pipeline alike on the native engine and on the Python
assembly path: the JAX package's SAM bytes, records the benchmark's plain
reference passes, and the same split-path counters."""

import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import gen, generators, genome as genome_mod
from benchmark.reference import check
from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.pipeline.runner import Pipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CHR1 = 248_956_422
GENOME_LEN = 3_000_000
SEED = 2**31 + 22
# block 0's reads of SEED on this genome: the shortest of each kind (3.2-4
# kb), and the two short ones (r22, r81) whose inversion the SV check sends
# to a realign try
READS = (0, 1, 3, 4, 5, 7, 18, 22, 33, 41, 49, 81)
SPLIT_COUNTERS = ("sv_probes", "sv_realign_tries", "sv_align_rows",
                  "cells_sv_useful", "records_supplementary")


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _strip_pg(sam: bytes) -> bytes:
    return b"".join(l for l in sam.splitlines(keepends=True)
                    if not l.startswith(b"@PG"))


def _jax_sam(fasta, query, argv):
    """ngmlr_tpu's Pipeline in process on the same reads, @PG stripped."""
    from ngmlr_tpu.cli import build_parser as jax_parser
    from ngmlr_tpu.cli import config_from_args as jax_config
    from ngmlr_tpu.pipeline.runner import Pipeline as JaxPipeline
    argv = ["-r", fasta, "-q", query] + argv + ["--skip-write"]
    p = JaxPipeline(jax_config(jax_parser().parse_args(argv), argv), fasta,
                    use_cache=False)
    buf = io.BytesIO()
    p.run(query, buf)
    return _strip_pg(buf.getvalue())


def test_survivor_mix_holds_its_strata():
    mix = _load("traffic", "survivor.json")
    block = gen.design(mix)
    kinds = [k for _, _, k in block]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "inv": 55, "dup": 21, "join": 14, "del": 3, "ins": 3}
    lengths = np.array([L for L, _, _ in block])
    assert lengths.min() == 3000 and lengths.max() <= 25000
    assert abs(lengths.mean() - 5109) <= 1


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """The reads mapped with NGMLR_TPU_NATIVE=1 and =0: {path: (SAM bytes,
    stats)}, and by the JAX package ("jax": its SAM bytes, @PG stripped);
    the reads, the genome and the mix."""
    d = tmp_path_factory.mktemp("sv_deployment")
    genome = generators.make_genome(np.random.default_rng(11), GENOME_LEN)
    fasta = str(d / "ref.fa")
    genome_mod._write_fasta(fasta, "chr1", genome)
    mix = _load("traffic", "survivor.json")
    # the joins' least distance scaled from chr1's length to this genome's
    ev = mix["events"]
    ev["join_min"] = round(ev["join_min"] * GENOME_LEN / CHR1)
    block = gen.design(mix)
    reads = {i: gen.read_at(mix, SEED, genome, i, block=block)
             for i in READS}
    query = str(d / "reads.fa")
    with open(query, "wb") as f:
        for i, r in reads.items():
            f.write(gen.fasta(b"r%d" % i, r.seq))
    argv = ["-r", fasta] + _load("configs", "chr1_pacbio_sv.json")["argv"]
    cfg = config_from_args(build_parser().parse_args(argv), argv)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for native in ("1", "0"):
            mp.setenv("NGMLR_TPU_NATIVE", native)
            p = Pipeline(cfg, fasta, use_cache=True, device="cpu")
            assert (p.native is not None) == (native == "1")
            buf = io.BytesIO()
            p.run(query, buf)
            out[native] = (buf.getvalue(), dict(p.ctx.stats))
    finally:
        mp.undo()
    out["jax"] = _jax_sam(fasta, query, _load("configs", "chr1_pacbio_sv.json")
                          ["argv"])
    return out, reads, genome, mix


def test_both_paths_write_the_same_sam(mapped):
    """The native engine's SAM, the Python assembly path's and the JAX
    package's are the same bytes, split records and SA tags among them."""
    out, reads, _, _ = mapped
    assert out["1"][0] == out["0"][0]
    assert _strip_pg(out["1"][0]) == out["jax"]
    assert b"SA:Z:" in out["jax"]
    assert out["1"][1]["native_failed"] == 0
    assert {r.kind for r in reads.values()} == {"inv", "dup", "join", "del",
                                               "ins"}


def test_the_reference_passes_the_records(mapped):
    out, reads, genome, _ = mapped
    lines = {}
    for line in out["1"][0].splitlines(keepends=True):
        if line[:1] != b"@":
            lines.setdefault(line.split(b"\t", 1)[0], []).append(line)
    conf = _load("configs", "chr1_pacbio_sv.json")
    items = [(lines[b"r%d" % i], r.seq, r.parts, r.reverse, r.path, r.cuts,
              r.kind) for i, r in reads.items()]
    nums, _, seen = check.judge(items, genome, {b"chr1": (0, GENOME_LEN)},
                                check.Scoring(**conf["scoring"]))
    assert nums["record_faults"] == nums["misplaced"] == 0, seen
    assert nums["score_gap"] == 0, seen
    limits = _load("limits", "chr1_pacbio_sv.survivor.json")
    for k in ("unsplit_share", "records_off_source"):
        assert nums[k] <= limits[k], (k, nums[k], seen)


def test_both_paths_count_the_split_path_alike(mapped):
    out, _, _, _ = mapped
    native, python = out["1"][1], out["0"][1]
    assert {k: native[k] for k in SPLIT_COUNTERS} == {
        k: python[k] for k in SPLIT_COUNTERS}
    for k in ("sv_realign_tries", "sv_align_rows", "records_supplementary"):
        assert native[k] > 0, k
    assert 0 < native["cells_sv_useful"] < native["cells_align_useful"]

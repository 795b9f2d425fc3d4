"""The real-size datasets of scripts/torch_scale_vs_jax.py on the CPU: the
generators rebuild phase4's, svlong's, ultralong's and bench30's FASTAs to
the sha256 of tests/golden/torch_scale/MANIFEST.json; the committed digests
cover every read of every dataset; the first PREFIX reads of phase4 and of
svlong, through the port (its plain versions) and through `python -m
ngmlr_tpu`, equal their committed per-read digests, so the committed file
is what the JAX package writes now (regenerate it with --write-jax after
any change to ngmlr_tpu/); and ultralong's shortest read (52 kb) through
the port equals its committed digest.
"""

import gzip
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_scale_vs_jax as S  # noqa: E402

PREFIX = 4
MAPPED = ("phase4", "svlong")


@pytest.fixture(scope="module")
def phase4_files(tmp_path_factory):
    """Phase 4's genome, its reads, svlong's and ultralong's, written
    once."""
    return S.genome_files("phase4", str(tmp_path_factory.mktemp("scale")))


@pytest.mark.parametrize("dataset", ["phase4", "svlong", "ultralong",
                                     "bench30"])
def test_generators_rebuild_the_committed_bytes(dataset, phase4_files,
                                                tmp_path, monkeypatch):
    entry = S.load_manifest()["datasets"][dataset]
    if dataset.startswith("bench"):
        # the bench writes under tempfile.gettempdir()
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        files = S.genome_files(dataset, str(tmp_path))
    else:
        files = phase4_files
    reads = files[S.DATASETS[dataset][1]]
    assert S.sha256_file(files["ref"]) == entry["genome_sha256"]
    assert S.sha256_file(reads) == entry["reads_sha256"]
    assert len(S.read_names(reads)) == entry["reads"]


def test_committed_digests_cover_every_read():
    manifest = S.load_manifest()["datasets"]
    digests = S.load_digests()
    # every dataset of the script has its committed digests
    assert set(S.DATASETS) == set(manifest) == set(digests)
    with gzip.open(os.path.join(S.SCALE_DIR, S.DIGESTS), "rt") as f:
        n_lines = sum(1 for _ in f)
    assert n_lines == sum(len(d) for d in digests.values())
    for name, entry in manifest.items():
        assert len(digests[name]) == entry["reads"] + 1, name
        assert entry["summary"]["reads"] == entry["reads"], name
        assert "*" in digests[name], name


def _port_cli(ref, reads, out):
    """The port's CLI on the CPU in a subprocess, on the FASTA's caches,
    under NGMLR_TPU_STRICT=1. Returns its SAM."""
    env = dict(os.environ, NGMLR_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               NGMLR_TPU_STRICT="1")
    subprocess.run([sys.executable, "-m", "ngmlr_tpu_torch", "-r", ref,
                    "-q", reads, "-o", out, "-x", S.PRESET, "--no-progress"],
                   cwd=REPO, env=env, check=True, capture_output=True)
    with open(out, "rb") as f:
        return f.read()


def shortest_read(reads_p):
    """The name of a FASTA file's shortest read."""
    lengths = {}
    with open(reads_p, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                name = line[1:].split()[0]
                lengths[name] = 0
            else:
                lengths[name] += len(line.rstrip())
    return min(lengths, key=lengths.get)


@pytest.fixture(scope="module")
def prefix_sams(phase4_files, tmp_path_factory):
    """{(package, dataset): (SAM, read names)} of the first PREFIX reads of
    MAPPED, and ("port", "ultralong") of ultralong's shortest read. The JAX
    package maps both prefixes in one process. The port builds the
    genome's caches in this process and maps phase4's prefix here, and
    each of svlong's reads and the ultra-long read in a CLI process of its
    own, all at once: the plain convex fill takes most of a minute on one
    long SV read (and 85 s on the ultra-long one alone), and a read's
    records do not depend on the reads beside it."""
    d = str(tmp_path_factory.mktemp("prefix"))
    ref = phase4_files["ref"]
    heads = {n: S.head_reads(phase4_files[S.DATASETS[n][1]], PREFIX,
                             os.path.join(d, n + ".fa")) for n in MAPPED}
    names = {n: S.read_names(heads[n]) for n in MAPPED}
    both = os.path.join(d, "both.fa")
    with open(both, "wb") as f:
        for n in MAPPED:
            with open(heads[n], "rb") as h:
                f.write(h.read())
    out = {}
    ul = S.pick_reads(phase4_files[S.UL_FILE],
                      [shortest_read(phase4_files[S.UL_FILE])],
                      os.path.join(d, "ul.fa"))
    names["ultralong"] = S.read_names(ul)
    with ThreadPoolExecutor(max_workers=2 + PREFIX) as pool:
        jax = pool.submit(S.fuzz.run_jax_cli, ref, both,
                          os.path.join(d, "jax.sam"), S.PRESET, "prefixes")
        p, _ = S.port_pipeline(ref, "cpu")
        singles = [S.pick_reads(heads["svlong"], [q],
                                os.path.join(d, "sv%d.fa" % i))
                   for i, q in enumerate(names["svlong"])]
        sv = [pool.submit(_port_cli, ref, r, r + ".sam")
              for r in singles + [ul]]
        run = S.map_once("phase4 prefix", p, heads["phase4"])
        S.check_native("phase4 prefix", p, run)
        out["port", "phase4"] = run["sam"]
        out["port", "svlong"] = b"".join(S.fuzz.strip_pg(f.result())
                                         for f in sv[:-1])
        out["port", "ultralong"] = S.fuzz.strip_pg(sv[-1].result())
        jax.result()
    with open(os.path.join(d, "jax.sam"), "rb") as f:
        jax_sam = S.fuzz.strip_pg(f.read())
    for n in MAPPED:
        keep = set(names[n])
        out["jax", n] = b"".join(
            l for l in jax_sam.splitlines(keepends=True)
            if l.split(b"\t", 1)[0] in keep)
    return {k: (sam, names[k[1]]) for k, sam in out.items()}


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("dataset", MAPPED)
def test_prefix_equals_the_committed_digests(prefix_sams, dataset, package):
    sam, names = prefix_sams[package, dataset]
    want = S.load_digests()[dataset]
    held = S.hold(want, sam, names, whole=False)
    assert held["identical"] == PREFIX, S.diff_text(dataset, want, sam,
                                                    held["diff"])


def test_shortest_ultralong_read_equals_its_committed_digest(prefix_sams):
    sam, names = prefix_sams["port", "ultralong"]
    want = S.load_digests()["ultralong"]
    held = S.hold(want, sam, names, whole=False)
    assert held["identical"] == 1, S.diff_text("ultralong", want, sam,
                                               held["diff"])

"""The port at human scale, on the CPU at small sizes: the synthetic
human-like genome of scripts/torch_human_scale.py against the JAX package's
scripts/human_scale.py, the port's index on it against ngmlr_tpu's, and
coordinates past 2^31. A genome shifted by a multiple of 2^16 behind an
all-N chromosome maps to the same records through both packages' CLIs;
the plain versions of the four alignment kernels give the same outputs on
rows moved past 2^31 of a genome tensor of 2^31 + 2^22 bytes; the device
search's first batch equals the host search's on an index whose positions
lie past 2^31. chip_smoke.py's phase 9 and scripts/torch_human_scale.py
run the same on the card at full size.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngmlr_tpu.index.kmer_index import KmerIndex as JKmerIndex
from ngmlr_tpu.io.reference import ReferenceGenome as JReferenceGenome
from ngmlr_tpu_torch.index.kmer_index import KmerIndex
from ngmlr_tpu_torch.io.reference import ReferenceGenome
from ngmlr_tpu_torch.ops import kernels as K
from ngmlr_tpu_torch.seed.candidates import search_batch
from ngmlr_tpu_torch.seed.device_search import DeviceSearch

from chip_smoke import high_rows
from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = torch.tensor([2.0, -5.0, -5.0, -5.0, -1.0, 0.15])
# a shift past 2^31 by a multiple of 2^16: bins (pos >> 4) and decode
# parity move uniformly
HIGH = (1 << 31) + (16 << 16)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mini_genome(tmp_path_factory):
    """scripts/torch_human_scale.py's 2 Mbp genome (one chromosome)."""
    path = str(tmp_path_factory.mktemp("hs") / "port.fa")
    _load("torch_human_scale", "torch_human_scale.py").make_genome_fa(
        path, 0.002, seed=3)
    return path


# ---------------------------------------------------------------------------
# (a), (b): the genome and its index
# ---------------------------------------------------------------------------

def test_generator_writes_the_reference_scripts_bytes(mini_genome, tmp_path):
    ref = str(tmp_path / "ref.fa")
    _load("human_scale", "human_scale.py").make_genome_fa(ref, 0.002, seed=3)
    with open(mini_genome, "rb") as a, open(ref, "rb") as b:
        ours, theirs = a.read(), b.read()
    assert len(ours) > 2_000_000 and ours.count(b"N") > 10_000
    assert ours == theirs


def test_index_on_the_human_scale_genome_matches_the_reference(mini_genome):
    """The port's KmerIndex.build on that genome: bucket_start, positions
    (and the sparse representation's prefixes) bit for bit as ngmlr_tpu's,
    its repeat patch held under the frequency cutoff."""
    ours = KmerIndex.build(ReferenceGenome.from_fasta(
        mini_genome, use_cache=False, skip_save=True))
    theirs = JKmerIndex.build(JReferenceGenome.from_fasta(
        mini_genome, use_cache=False, skip_save=True))
    assert ours.positions.dtype == theirs.positions.dtype == np.uint32
    assert len(ours.positions) > 100_000
    np.testing.assert_array_equal(ours.bucket_start, theirs.bucket_start)
    assert ours.bucket_start.dtype == theirs.bucket_start.dtype
    np.testing.assert_array_equal(ours.positions, theirs.positions)
    assert (ours.uniq_prefix is None) == (theirs.uniq_prefix is None)
    if ours.uniq_prefix is not None:
        np.testing.assert_array_equal(ours.uniq_prefix, theirs.uniq_prefix)
    assert np.diff(ours.bucket_start).max() <= 990


def test_a_read_inside_a_repeat_patch_maps_in_neither_package(mini_genome,
                                                              tmp_path):
    """8 kb from inside the genome's alpha-satellite-like patch (one 171-bp
    monomer tiled) is left unmapped by both packages' CLIs, and 8 kb of
    unique sequence before it maps to its source in both; the script's
    distinct_kmers tells the two sources apart (at most 171 against ~5000).
    Such a read is unmapped by the algorithm, not by a genome's size."""
    hs = _load("torch_human_scale", "torch_human_scale.py")
    with open(mini_genome, "rb") as f:
        seq = np.frombuffer(b"".join(l.strip() for l in f
                                     if not l.startswith(b">")), np.uint8)
    # the longest N-free run of period 171: the patch
    rep = np.concatenate([[0], ((seq[171:] == seq[:-171])
                                & (seq[171:] != ord("N"))).astype(np.int8),
                          [0]])
    a, b = np.nonzero(np.diff(rep) == 1)[0], np.nonzero(np.diff(rep) == -1)[0]
    i = int(np.argmax(b - a))
    lo, hi = int(a[i]), int(b[i]) + 171
    assert 40_000 <= hi - lo <= 60_000
    inside, outside = lo + 20_000, lo - 30_000
    reads = str(tmp_path / "reads.fa")
    with open(reads, "wb") as f:
        for name, at in ((b"inside", inside), (b"outside", outside)):
            f.write(b">%s\n%s\n" % (name, seq[at:at + 8000].tobytes()))
    ref = ReferenceGenome.from_fasta(mini_genome, use_cache=False,
                                     skip_save=True)
    start = int(ref.ref_start[0])
    assert hs.distinct_kmers(ref, start + inside) <= 171
    assert hs.distinct_kmers(ref, start + outside) > 4900
    for module, env in (("ngmlr_tpu", {"JAX_PLATFORMS": "cpu"}),
                        ("ngmlr_tpu_torch", {"NGMLR_TORCH_DEVICE": "cpu"})):
        sam = _cli(module, mini_genome, str(tmp_path / (module + ".sam")),
                   env, reads=reads)
        recs = {l.split(b"\t")[0]: l.split(b"\t") for l in _body(sam)
                if l and not l.startswith(b"@")}
        assert int(recs[b"inside"][1]) & 4, module
        assert int(recs[b"outside"][1]) & 4 == 0, module
        assert int(recs[b"outside"][3]) - 1 == outside, module


# ---------------------------------------------------------------------------
# (c): shift invariance through both CLIs
# ---------------------------------------------------------------------------

# an all-N chromosome of GAP bases before test_2's: GAP is even and
# GAP + 1000 a multiple of 2^16, so chr21's 20 kb start at 1000 + GAP + 1000
GAP = (16 << 16) - 1000
T2_REF = os.path.join(DATA_DIR, "test_2", "ref_chr21_20kb.fa")
T2_READS = os.path.join(DATA_DIR, "test_2", "reads_100_2200bp.fa")


def _body(sam):
    """The records and header lines other than @SQ and @PG."""
    return [l for l in sam.split(b"\n")
            if not l.startswith((b"@SQ", b"@PG"))]


def _no_pg(sam):
    return [l for l in sam.split(b"\n") if not l.startswith(b"@PG")]


@pytest.fixture(scope="module")
def shifted_test2(tmp_path_factory):
    """test_2's reference behind the gap chromosome, and the JAX package's
    SAM of test_2's pacbio reads on it (python -m ngmlr_tpu on the CPU)."""
    d = tmp_path_factory.mktemp("shift")
    ref = str(d / "gap_test2.fa")
    with open(ref, "wb") as f, open(T2_REF, "rb") as src:
        f.write(b">gap\n" + b"N" * GAP + b"\n" + src.read())
    return ref, _cli("ngmlr_tpu", ref, str(d / "jax.sam"),
                     {"JAX_PLATFORMS": "cpu"})


def _cli(module, ref, out, env, reads=T2_READS):
    r = subprocess.run(
        [sys.executable, "-m", module, "-r", ref, "-q", reads,
         "-x", "pacbio", "-o", out], capture_output=True, cwd=REPO,
        timeout=600, env=dict(os.environ, NGMLR_TPU_STRICT="1",
                              OMP_NUM_THREADS="1", **env))
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("search", ["host", "device"])
def test_a_genome_shifted_behind_a_gap_maps_as_unshifted(shifted_test2,
                                                         tmp_path, search):
    """The port's SAM behind the gap equals the JAX package's there (@PG
    aside), and its records equal the unshifted golden's: the output does
    not depend on where in the concatenated genome a chromosome lies."""
    ref, jax_sam = shifted_test2
    port = _cli("ngmlr_tpu_torch", ref, str(tmp_path / "port.sam"),
                {"NGMLR_TORCH_DEVICE": "cpu",
                 "NGMLR_TPU_DEVICE_SEARCH": "1" if search == "device"
                 else "0"})
    assert sum(l.startswith(b"@SQ") for l in port.split(b"\n")) == 2
    assert _no_pg(port) == _no_pg(jax_sam)
    with open(os.path.join(GOLDEN_DIR, "test_2.sam"), "rb") as f:
        golden = f.read()
    assert len(_body(golden)) > 10
    assert _body(port) == _body(golden)


# ---------------------------------------------------------------------------
# (d): the plain versions on rows past 2^31
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moved_genome():
    """A seeded small genome of n bases and the same bases at the end of a
    genome tensor of HIGH + n = 2^31 + 2^22 bytes (torch.empty: only the
    written pages are resident), so its last window ends at the big
    genome's last byte."""
    rng = np.random.default_rng(2031)
    n = (1 << 22) - (16 << 16)
    small_np = rng.integers(0, 5, n).astype(np.uint8)
    big = torch.empty(HIGH + n, dtype=torch.uint8)
    big[HIGH:] = torch.from_numpy(small_np)
    return rng, small_np, big


def _moved(pk):
    """The rows with ds and hi moved by HIGH (uint32 bit patterns)."""
    out = pk.copy()
    u = out.view(np.uint32)
    u[:, 0] += np.uint32(HIGH)
    u[:, 1] += np.uint32(HIGH)
    return out


def _same(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == torch.float32:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        else:
            assert torch.equal(x, y)


def test_score_fill_plain_past_2_31_matches_unmoved(moved_genome):
    rng, small_np, big = moved_genome
    readbuf_np = rng.integers(0, 5, 1 << 16).astype(np.uint8)
    pk = high_rows(rng, small_np, 0, readbuf_np, 48, (306, 307), (1, 2),
                   (1,), H_max=256)[:, :7]
    pk = np.ascontiguousarray(pk)
    moved = _moved(pk)
    assert int(moved.view(np.uint32)[:, 0].min()) >= 1 << 31
    assert int(moved.view(np.uint32)[:, 1].max()) >= big.numel()
    readbuf = torch.from_numpy(readbuf_np)
    small = torch.from_numpy(small_np)
    want = K.score_fill_plain(small, readbuf, torch.from_numpy(pk), 320, 256)
    got = K.score_fill(big, readbuf, torch.from_numpy(moved), 320, 256)
    _same([got], [want])
    assert float(want.max()) > 100


def test_convex_plain_past_2_31_matches_unmoved(moved_genome):
    """corridor_windows, convex_fill and convex_backtrack (their plain
    versions, as the CPU wrappers run them) on moved align rows of all four
    corridor modes: windows, directions, best cells and walks equal the
    unmoved rows'."""
    rng, small_np, big = moved_genome
    readbuf_np = rng.integers(0, 5, 1 << 16).astype(np.uint8)
    pk = high_rows(rng, small_np, 0, readbuf_np, 6, (200, 450), (24, 60),
                   (0, 1, 2, 3), H_max=511)
    readbuf = torch.from_numpy(readbuf_np)
    small = torch.from_numpy(small_np)
    out = []
    for genome, rows in ((small, pk), (big, _moved(pk))):
        t = torch.from_numpy(rows)
        ymin, ymax, hmax = K.corridor_windows(t, 1024)
        dirs, best, by, bx = K.convex_fill(genome, readbuf, t, PARAMS, ymin,
                                           ymax, 128)
        walk = K.convex_backtrack(dirs, ymin, t, bx, by)
        out.append((ymin, ymax, hmax, dirs, best, by, bx) + tuple(walk))
    _same(out[1], out[0])
    assert int(out[0][-1].eq(K.DONE).sum()) >= 4


# ---------------------------------------------------------------------------
# (e): the device search on an index past 2^31
# ---------------------------------------------------------------------------

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _subreads(rng, genome, n=160):
    """n subreads of 60-256 bases from the genome's sequence, ~10% of their
    bases redrawn, half reverse-complemented."""
    seqs = []
    for _ in range(n):
        L = int(rng.integers(60, 257))
        pos = int(rng.integers(0, len(genome) - L))
        s = bytearray(genome[pos:pos + L])
        for _ in range(L // 10):
            s[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
        s = bytes(s)
        seqs.append(s.translate(COMP)[::-1] if rng.random() < 0.5 else s)
    return seqs


def test_device_search_past_2_31_matches_the_host_search(mini_genome):
    """The first batch of subreads through the device search (on the CPU)
    and the host search_batch, on the index of the 2 Mbp genome with every
    position moved by HIGH: the same candidates, subread by subread, and
    the host's equal to the unmoved index's moved by HIGH."""
    ref = ReferenceGenome.from_fasta(mini_genome, use_cache=False,
                                     skip_save=True)
    idx = KmerIndex.build(ref)
    moved = KmerIndex(idx.k, idx.bucket_start,
                      (idx.positions.astype(np.uint32) + np.uint32(HIGH)),
                      idx.bin_size, idx.kmer_skip,
                      uniq_prefix=idx.uniq_prefix)
    assert int(moved.positions.min()) >= 1 << 31
    with open(mini_genome, "rb") as f:
        seq = b"".join(l.strip() for l in f if not l.startswith(b">"))
    seqs = _subreads(np.random.default_rng(31), seq)
    want = search_batch(moved, seqs)
    got = DeviceSearch(moved, device="cpu").search_batch(seqs)
    assert got is not None and len(got) == len(want) == len(seqs)
    n_cand = 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.locations, b.locations)
        np.testing.assert_array_equal(a.reverse, b.reverse)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.mq_zero == b.mq_zero
        n_cand += len(a.locations)
    assert n_cand > len(seqs) // 2
    for a, b in zip(want, search_batch(idx, seqs)):
        np.testing.assert_array_equal(a.locations,
                                      b.locations.astype(np.int64) + HIGH)
        np.testing.assert_array_equal(a.reverse, b.reverse)
        np.testing.assert_array_equal(a.counts, b.counts)

"""Index positions past 2^32 (a genome above 4.29 Gbp), on the CPU at small
sizes: a small two-chromosome genome seen through a view whose coordinates
start SHIFT = 2^32 later (its chromosome starts, concatenated length and
code slices all moved by SHIFT), as the genome behind a 4.29 Gbp all-N
chromosome would be. The port's KmerIndex stores that view's positions as
int64, each the unshifted position plus SHIFT; the host search places its
candidates in unit 2; a table of 4.29 Gbp or less stays uint32 and equal
to ngmlr_tpu's, bit for bit; a uint32 cache of a genome past 2^32 is
rebuilt. ngmlr_tpu's own index wraps such positions to pos - 2^32: that
divergence is recorded here as it stands. chip_smoke.py's phase 10 and
scripts/torch_human_scale.py run the same on the card at full size.
"""

import numpy as np
import pytest
import torch

from ngmlr_tpu.index.kmer_index import KmerIndex as JKmerIndex
from ngmlr_tpu.io.reference import ReferenceGenome as JReferenceGenome
from ngmlr_tpu_torch.index import kmer_index
from ngmlr_tpu_torch.index.kmer_index import (INDEX_COOKIE, INDEX_VERSION,
                                              KmerIndex, positions_dtype)
from ngmlr_tpu_torch.io.reference import ReferenceGenome
from ngmlr_tpu_torch.seed.candidates import search_batch
from ngmlr_tpu_torch.seed.device_search import DeviceSearch

torch.set_num_threads(1)

SHIFT = 1 << 32
# below 2^32: a shift past 2^31 by a multiple of 2^16
LOW_SHIFT = (1 << 31) + (16 << 16)
# k = 13 keeps the small genome's table sparse; k = 8 makes it dense
REGIMES = {"sparse": 13, "dense": 8}
COMP = bytes.maketrans(b"ACGT", b"TGCA")


class _Codes:
    """The code array seen from shift on: slices and length moved."""

    def __init__(self, codes, shift):
        self.codes, self.shift = codes, shift

    def __len__(self):
        return len(self.codes) + self.shift

    def __getitem__(self, s):
        assert isinstance(s, slice) and s.start >= self.shift, s
        return self.codes[s.start - self.shift: s.stop - self.shift]


class ShiftedRef:
    """A ReferenceGenome of either package seen through coordinates moved
    by shift (what KmerIndex.build reads of it)."""

    def __init__(self, ref, shift):
        self.ref, self.shift = ref, shift
        self.names = ref.names
        self.ref_start = ref.ref_start + shift
        self.ref_len = ref.ref_len
        self.codes = _Codes(ref.codes, shift)
        self.concat_len = ref.concat_len + shift

    def decode_window(self, position, buffer_length):
        return self.ref.decode_window(position - self.shift, buffer_length)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """(FASTA path, sequence) of two chromosomes of 200 kb, numpy-seeded,
    each with one N run."""
    rng = np.random.default_rng(2032)
    path = str(tmp_path_factory.mktemp("past232") / "two.fa")
    seqs = []
    with open(path, "wb") as f:
        for ci in range(2):
            arr =np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, 200_000)].copy()
            s = int(rng.integers(10_000, 150_000))
            arr[s:s + 5_000] = ord("N")
            seq = arr.tobytes()
            seqs.append(seq)
            f.write(b">chr%d\n" % (ci + 1))
            f.write(b"\n".join(seq[i:i + 80] for i in range(0, len(seq), 80))
                    + b"\n")
    return path, seqs


def _ref(path):
    return ReferenceGenome.from_fasta(path, use_cache=False, skip_save=True)


def _jref(path):
    return JReferenceGenome.from_fasta(path, use_cache=False, skip_save=True)


def _same_buckets(a, b):
    np.testing.assert_array_equal(a.bucket_start, b.bucket_start)
    assert (a.uniq_prefix is None) == (b.uniq_prefix is None)
    if a.uniq_prefix is not None:
        np.testing.assert_array_equal(a.uniq_prefix, b.uniq_prefix)


# ---------------------------------------------------------------------------
# (a) the port's table past 2^32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", list(REGIMES))
def test_positions_past_2_32_are_int64_and_shifted(genome, regime):
    """The port's KmerIndex.build over the view moved by 2^32: int64
    positions, each the unshifted build's plus 2^32, in the same buckets.
    (A uint32 table wraps them to the unshifted positions.)"""
    k = REGIMES[regime]
    ref = _ref(genome[0])
    flat = KmerIndex.build(ref, k=k)
    moved = KmerIndex.build(ShiftedRef(ref, SHIFT), k=k)
    assert (flat.uniq_prefix is None) == (regime == "dense")
    assert flat.positions.dtype == np.uint32
    assert moved.positions.dtype == np.int64
    assert len(moved.positions) > 50_000
    _same_buckets(moved, flat)
    np.testing.assert_array_equal(
        moved.positions, flat.positions.astype(np.int64) + SHIFT)
    assert int(moved.positions.min()) >= SHIFT + 1000


# ---------------------------------------------------------------------------
# (b) the host search on that table
# ---------------------------------------------------------------------------

def _subreads(rng, seqs, n=120):
    """n subreads of 60-256 bases from the chromosomes' N-free sequence,
    ~10% of their bases redrawn, half reverse-complemented."""
    out = []
    while len(out) < n:
        seq = seqs[int(rng.integers(0, len(seqs)))]
        L = int(rng.integers(60, 257))
        pos = int(rng.integers(0, len(seq) - L))
        s = bytearray(seq[pos:pos + L])
        if b"N" in s:
            continue
        for _ in range(L // 10):
            s[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
        s = bytes(s)
        out.append(s.translate(COMP)[::-1] if rng.random() < 0.5 else s)
    return out


def test_host_search_past_2_32_lands_in_unit_2(genome):
    """search_batch on the moved table as on a genome of 3 units of 2^31:
    every candidate the unmoved table's plus 2^32, so in unit 2, with the
    same strands, counts and order. The device search refuses the table
    (its positions upload as 32-bit patterns)."""
    ref = _ref(genome[0])
    flat = KmerIndex.build(ref)
    moved = KmerIndex.build(ShiftedRef(ref, SHIFT))
    seqs = _subreads(np.random.default_rng(232), genome[1])
    want = search_batch(flat, seqs)
    got = search_batch(moved, seqs, n_units=3, unit_bits=31)
    n_cand = 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.locations,
                                      a.locations.astype(np.int64) + SHIFT)
        np.testing.assert_array_equal(b.reverse, a.reverse)
        np.testing.assert_array_equal(b.counts, a.counts)
        assert a.mq_zero == b.mq_zero
        assert (b.locations >> 31 == 2).all()
        n_cand += len(b.locations)
    assert n_cand > len(seqs) // 2
    assert not DeviceSearch(moved, device="cpu").available


# ---------------------------------------------------------------------------
# (c) 4.29 Gbp or less: the table of ngmlr_tpu, unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("shift", [0, LOW_SHIFT], ids=["flat", "past-2^31"])
def test_tables_below_2_32_stay_uint32_and_match_the_reference(genome,
                                                               regime, shift):
    """Below 2^32 (unmoved, and moved past 2^31) the port's table is uint32
    and equal to ngmlr_tpu's, bit for bit."""
    k = REGIMES[regime]
    ours = KmerIndex.build(ShiftedRef(_ref(genome[0]), shift), k=k)
    theirs = JKmerIndex.build(ShiftedRef(_jref(genome[0]), shift), k=k)
    assert ours.positions.dtype == theirs.positions.dtype == np.uint32
    assert ours.bucket_start.dtype == theirs.bucket_start.dtype
    _same_buckets(ours, theirs)
    np.testing.assert_array_equal(ours.positions, theirs.positions)
    assert int(ours.positions.min()) >= shift + 1000


def test_positions_dtype_boundary():
    """uint32 up to a concatenated length of 2^32 - 1, int64 from 2^32; a
    position that the table's type cannot hold raises, never wraps."""
    assert positions_dtype(2 ** 32 - 1) == np.uint32
    assert positions_dtype(2 ** 32) == np.int64
    pos = np.asarray([5, 2 ** 32 - 1], np.int64)
    assert kmer_index._narrow(pos, np.dtype(np.uint32)).dtype == np.uint32
    with pytest.raises(ValueError, match="does not fit"):
        kmer_index._narrow(pos + 1, np.dtype(np.uint32))


# ---------------------------------------------------------------------------
# (d) the cache
# ---------------------------------------------------------------------------

def _write_cache(path, idx, positions):
    extra = ({"uniq_prefix": idx.uniq_prefix}
             if idx.uniq_prefix is not None else {})
    np.savez(path, cookie=np.int64(INDEX_COOKIE),
             version=np.int64(INDEX_VERSION), k=np.int64(idx.k),
             kmer_skip=np.int64(idx.kmer_skip),
             bucket_start=idx.bucket_start, positions=positions, **extra)


def test_wrapped_cache_past_2_32_is_rebuilt(genome, tmp_path, monkeypatch):
    """A *.torch.npz holding uint32 positions for a genome past 2^32 (what
    the wrapping build wrote) is rebuilt, not loaded; an int64 cache of that
    genome and a uint32 cache of a genome below 2^32 load without a
    build."""
    ref = _ref(genome[0])
    flat = KmerIndex.build(ref)
    moved_ref = ShiftedRef(ref, SHIFT)
    fa = str(tmp_path / "g.fa")
    cache = fa + "-ht-13-2.torch.npz"
    want = flat.positions.astype(np.int64) + SHIFT

    _write_cache(cache, flat, flat.positions)       # the wrapped table
    got = KmerIndex.load_or_build(moved_ref, fa)
    assert got.positions.dtype == np.int64
    np.testing.assert_array_equal(got.positions, want)

    def no_build(*a, **kw):
        raise AssertionError("the cache should have loaded")
    monkeypatch.setattr(KmerIndex, "build", no_build)
    # the rebuild above rewrote the cache with its int64 table
    got = KmerIndex.load_or_build(moved_ref, fa)
    np.testing.assert_array_equal(got.positions, want)
    _write_cache(cache, flat, flat.positions)
    got = KmerIndex.load_or_build(ref, fa)
    assert got.positions.dtype == np.uint32
    np.testing.assert_array_equal(got.positions, flat.positions)


# ---------------------------------------------------------------------------
# (e) ngmlr_tpu's wrap, recorded
# ---------------------------------------------------------------------------

def test_reference_index_wraps_positions_past_2_32(genome):
    """ngmlr_tpu's KmerIndex.build over the view moved by 2^32 stores uint32
    positions equal to the unmoved build's: each position past 2^32 wrapped
    to pos - 2^32 (ngmlr_tpu/index/kmer_index.py, the astype(np.uint32)
    casts). The port does not carry this over (tests (a) and (b))."""
    jref = _jref(genome[0])
    flat = JKmerIndex.build(jref)
    moved = JKmerIndex.build(ShiftedRef(jref, SHIFT))
    assert moved.positions.dtype == np.uint32
    np.testing.assert_array_equal(moved.positions, flat.positions)
    ours = KmerIndex.build(ShiftedRef(_ref(genome[0]), SHIFT))
    np.testing.assert_array_equal(
        ours.positions, moved.positions.astype(np.int64) + SHIFT)

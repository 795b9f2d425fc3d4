"""The port's device candidate search (ngmlr_tpu_torch.seed.device_search)
on the CPU, held exactly against ngmlr_tpu's DeviceSearch and the host
search_batch on the inputs of tests/test_device_search.py; its expand_votes
plain version against the Pallas kernel in interpret mode; the k-mer count
stage against JAX's; the runner's gate; and test_2 through the port's
Pipeline with the device search forced on.

Each dense bucket table is 537 MB at k = 13, so every case computes the JAX
results first and frees them before it builds the port's.
"""

import gc
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmlr_tpu.index.kmer_index import KmerIndex as JKmerIndex
from ngmlr_tpu.io.reference import ReferenceGenome as JReferenceGenome
from ngmlr_tpu.seed import device_search as jds
from ngmlr_tpu.seed.candidates import search_batch as jsearch_batch
from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.index.kmer_index import KmerIndex
from ngmlr_tpu_torch.io.reference import ReferenceGenome
from ngmlr_tpu_torch.ops import device_engine as tde
from ngmlr_tpu_torch.ops import kernels as K
from ngmlr_tpu_torch.pipeline import runner
from ngmlr_tpu_torch.seed import device_search as tds
from ngmlr_tpu_torch.seed.candidates import search_batch

from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


# ---------------------------------------------------------------------------
# the six inputs of tests/test_device_search.py, generated the same way
# ---------------------------------------------------------------------------

def _exact_reads(rng, genome, n, lo):
    seqs = []
    for _ in range(n):
        L = int(rng.integers(lo, 257))
        pos = int(rng.integers(0, len(genome) - L))
        seqs.append(genome[pos:pos + L].tobytes())
    return seqs


def _mutated(seed):
    """:30-65: 300 subreads, ~10% mutated, half reverse-complemented, some
    with an N run; plus a no-hit subread and one shorter than k."""
    rng = np.random.default_rng(seed)
    genome = BASES[rng.integers(0, 4, size=400_000)]
    seqs = []
    for _ in range(300):
        L = int(rng.integers(40, 257))
        pos = int(rng.integers(0, len(genome) - L))
        s = bytearray(genome[pos:pos + L].tobytes())
        for _ in range(L // 10):
            s[int(rng.integers(0, L))] = b"ACGT"[int(rng.integers(0, 4))]
        s = bytes(s)
        if rng.random() < 0.5:
            s = s.translate(COMP)[::-1]
        if rng.random() < 0.05:
            s = s[:10] + b"N" * int(rng.integers(1, 5)) + s[10:]
        seqs.append(s)
    seqs.append(b"N" * 60)
    seqs.append(b"ACGT" * 3)
    return genome, seqs


def _v1():
    """:68-85: the v1 global-chunk kernel forced (the reference by
    NGMLR_TPU_SEARCH_V2=0; the port runs every subread through v1 alone,
    as it runs outliers, with L_V2_MAX at 0)."""
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, size=200_000)]
    return genome, _exact_reads(rng, genome, 150, 60)


def _overflow():
    """:88-124: a tandem-repeat patch makes vote-heavy subreads; tiny caps
    force every v2 escape path."""
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, size=200_000)]
    mono = BASES[rng.integers(0, 4, size=171)]
    genome[50_000:50_000 + 171 * 100] = np.tile(mono, 100)
    seqs = _exact_reads(rng, genome, 60, 100)
    for _ in range(6):
        pos = 50_000 + int(rng.integers(0, 171 * 90))
        seqs.append(genome[pos:pos + 256].tobytes())
    return genome, seqs


def _chunked():
    """:204-224: the reference with NV_MAX shrunk to 2^16; the port with
    BL_MAX shrunk to 2^16, so a vote class splits over several launches."""
    rng = np.random.default_rng(3)
    genome = BASES[rng.integers(0, 4, size=300_000)]
    return genome, _exact_reads(rng, genome, 200, 100)


def _fifty():
    """:177-201: 50 subreads (the reference's Pallas-expand end-to-end case;
    here the JAX side runs that kernel in interpret mode)."""
    rng = np.random.default_rng(21)
    genome = BASES[rng.integers(0, 4, size=150_000)]
    return genome, _exact_reads(rng, genome, 50, 80)


TINY_CAPS = {"E_CAP": 4, "NE2": 64, "L_V2_MAX": 2048}
# case -> (input, environment, module constants patched in both packages,
# constants patched in the port alone)
CASES = {
    "seed0": (lambda: _mutated(0), {}, {}, {}),
    "seed7": (lambda: _mutated(7), {}, {}, {}),
    "v1": (_v1, {"NGMLR_TPU_SEARCH_V2": "0"}, {}, {"L_V2_MAX": 0}),
    # the port's v1 runs also return 8 entries at first, so the outliers'
    # ~100 entries rerun with room for all
    "overflow": (_overflow, {}, TINY_CAPS, {"NE_CAP": 8}),
    # the same input with the repeat subreads kept in v2, where their ~100
    # entries a row pass E_CAP: those rows retry through v1 (held against
    # the host twin only: the reference's v1 runs take ~45 s on the CPU)
    "overflow-retry": (_overflow, {}, {"E_CAP": 4, "NE2": 64}, {}),
    "chunked": (_chunked, {}, {}, {"BL_MAX": 1 << 16}),
    "fifty-pallas": (_fifty, {"NGMLR_TPU_SEARCH_EXPAND": "pallas"}, {}, {}),
}
JAX_ONLY = {"chunked": {"NV_MAX": 1 << 16}}


def _write_fa(path, genome):
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        g = genome.tobytes()
        for i in range(0, len(g), 70):
            f.write(g[i:i + 70] + b"\n")


def _assert_same(want, got, what):
    assert got is not None, what
    assert len(got) == len(want), what
    for i, (h, d) in enumerate(zip(want, got)):
        msg = "%s, sub %d" % (what, i)
        np.testing.assert_array_equal(h.locations, d.locations, err_msg=msg)
        np.testing.assert_array_equal(h.reverse, d.reverse, err_msg=msg)
        np.testing.assert_array_equal(h.counts, d.counts, err_msg=msg)
        assert h.mq_zero == d.mq_zero, msg


@pytest.mark.parametrize("case", list(CASES))
def test_device_search_matches_jax_and_host(case, tmp_path, monkeypatch):
    make, env, consts, port_consts = CASES[case]
    genome, seqs = make()
    fa = str(tmp_path / "ref.fa")
    _write_fa(fa, genome)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in {**consts, **JAX_ONLY.get(case, {})}.items():
        monkeypatch.setattr(jds, k, v)
    for k, v in {**consts, **port_consts}.items():
        monkeypatch.setattr(tds, k, v)
    if case == "fifty-pallas":
        from ngmlr_tpu.ops import pallas_kernels as pk
        real = pk.expand_votes
        monkeypatch.setattr(
            pk, "expand_votes",
            lambda *a, **kw: real(*a, **{**kw, "interpret": True}))

    jidx = JKmerIndex.build(JReferenceGenome.from_fasta(fa, use_cache=False))
    host = jsearch_batch(jidx, seqs)
    jgot = None
    if case != "overflow-retry":
        jdev = jds.DeviceSearch(jidx)
        jgot = jdev.search_batch(seqs)
        del jdev
    del jidx
    gc.collect()

    idx = KmerIndex.build(ReferenceGenome.from_fasta(fa, use_cache=False))
    _assert_same(host, search_batch(idx, seqs), "port host search")
    # a fresh context collects the search's counters
    ctx = tde.DeviceContext(np.zeros(64, np.uint8), device="cpu")
    monkeypatch.setattr(tde, "_current", ctx)
    dev = tds.DeviceSearch(idx, device="cpu")
    assert dev.available and dev.bucket_pairs.shape == (4 ** idx.k, 2)
    n0 = K.launches["expand_votes"]
    got = dev.search_batch(seqs)
    _assert_same(host, got, "vs host search_batch")
    if jgot is not None:
        _assert_same(jgot, got, "vs ngmlr_tpu DeviceSearch")

    st = ctx.stats
    assert not [k for k in st if k.startswith("search_fallback_")], st
    assert K.launches["expand_votes"] == n0   # plain version on the CPU
    n_class = sum(v for k, v in st.items()
                  if k.startswith("search_v2_class_"))
    assert n_class == st.get("search_v2_launches", 0)
    if case == "v1":
        assert st["search_v2_launches"] == 0
        assert st["search_v1_outliers"] == st["search_v1_launches"] \
            == len(seqs)
    else:
        assert st["search_v2_launches"] > 0
    if case == "overflow":
        assert st["search_v1_outliers"] > 0 and st["search_v1_rerun"] > 0
    if case == "overflow-retry":
        assert st.get("search_v2_retry", 0) > 0
    if case == "chunked":
        assert st["search_v2_launches"] > 1


def test_device_search_slices_past_max_subs(tmp_path, monkeypatch):
    """A batch of MAX_SUBS - 1 subreads or more runs as consecutive slices
    of MAX_SUBS - 2 (shrunk here), with the same candidates."""
    monkeypatch.setattr(tds, "MAX_SUBS", 40)
    genome, seqs = _fifty()
    fa = str(tmp_path / "ref.fa")
    _write_fa(fa, genome)
    idx = KmerIndex.build(ReferenceGenome.from_fasta(fa, use_cache=False))
    got = tds.DeviceSearch(idx, device="cpu").search_batch(seqs)
    _assert_same(search_batch(idx, seqs), got, "sliced")


def test_device_search_fallbacks_are_counted(tmp_path, monkeypatch):
    """The one batch the search does not take, a subread longer than SL,
    goes back to the host search on the CPU (counted); on a card it raises,
    so no batch leaves the card unseen. The Pipeline's gate keeps such
    subread lengths off the device search."""
    genome, seqs = _fifty()
    fa = str(tmp_path / "ref.fa")
    _write_fa(fa, genome)
    idx = KmerIndex.build(ReferenceGenome.from_fasta(fa, use_cache=False))
    ctx = tde.DeviceContext(np.zeros(64, np.uint8), device="cpu")
    monkeypatch.setattr(tde, "_current", ctx)
    dev = tds.DeviceSearch(idx, device="cpu")
    long_batch = seqs + [b"A" * (tds.SL + 1)]
    assert dev.search_batch(long_batch) is None
    assert ctx.stats["search_fallback_len"] == 1
    dev.device = torch.device("cuda")      # the check runs before any tensor
    with pytest.raises(ValueError, match="longer than"):
        dev.search_batch(long_batch)
    assert ctx.stats["search_fallback_len"] == 1


def _one_big_group_index(mod):
    """k = 4, prefix 0 (AAAA) at 300 positions inside one 4096-wide bin: a
    subread of 256 A's votes 253 x 300 = 75,900 times into one group."""
    bs = np.zeros(4 ** 4 + 1, np.int64)
    bs[1:] = 300
    pos = np.arange(1000, 1300, dtype=np.uint32)
    return mod(4, bs, pos, 12, 2)


def test_device_search_counts_past_16_bits(monkeypatch):
    """A group of more than 2^16 votes: the reference's device search gives
    the batch up (None); the port's v1 counts it in 64-bit keys and equals
    the host search."""
    seqs = [b"A" * 256, b"ACGT" * 40]
    jidx = _one_big_group_index(JKmerIndex)
    host = jsearch_batch(jidx, seqs)
    assert host[0].counts.max() == 253 * 300
    assert jds.DeviceSearch(jidx).search_batch(seqs) is None
    ctx = tde.DeviceContext(np.zeros(64, np.uint8), device="cpu")
    monkeypatch.setattr(tde, "_current", ctx)
    idx = _one_big_group_index(KmerIndex)
    got = tds.DeviceSearch(idx, device="cpu").search_batch(seqs)
    _assert_same(host, got, "one group past 2^16 votes")
    assert ctx.stats["search_v1_outliers"] == 1


def test_device_search_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = KmerIndex(4, np.zeros(4 ** 4 + 1, np.int32), np.zeros(0, np.uint32),
                    4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.DeviceSearch(idx)
    assert tds.DeviceSearch(idx, device="cpu").available


def test_positions_past_uint32_disable_the_search():
    """The 2^32 gate reads the largest position, not the last one."""
    pos = np.array([5, 2 ** 32 + 7, 9], dtype=np.int64)
    bs = np.zeros(4 ** 4 + 1, np.int32)
    bs[1:] = 3
    dev = tds.DeviceSearch(KmerIndex(4, bs, pos, 4, 2), device="cpu")
    assert not dev.available
    assert dev.search_views(torch.zeros(8, dtype=torch.uint8),
                            np.zeros(1, np.int32), np.ones(1, np.int32)) \
        is None


# ---------------------------------------------------------------------------
# expand_votes: plain version vs the Pallas kernel and the repeat oracle
# ---------------------------------------------------------------------------

def _slot_tables(case, B=16, L=512):
    rng = np.random.default_rng(17)
    SL2 = 2 * tds.SL
    c2 = np.zeros((B, SL2), np.int32)
    for b in range(B):
        nv = int(rng.integers(0, L + 1))
        np.add.at(c2[b], rng.integers(0, SL2, size=nv), 1)
    if case == "ragged":
        c2[0] = 0                                 # a row with no vote
        c2[1] = 0
        np.add.at(c2[1], rng.integers(0, SL2, size=L), 1)   # nv == L
        c2[2] = 0
        c2[2, 37] = L - 3                         # one slot holds them all
        c2[3] = 0
        c2[3, SL2 - 1] = L                        # ... the last one, full
        c2[4] = 0
        c2[4, 0] = 1                              # a single vote
        c2[5:8] = 0                               # zero rows in a run
    base2 = rng.integers(0, 1 << 28, (B, SL2)).astype(np.int32)
    ct2 = rng.integers(-300, 300, (B, SL2)).astype(np.int32)
    cum2 = np.cumsum(c2, axis=1, dtype=np.int32)
    d2tp = np.concatenate([base2 - (cum2 - c2), np.zeros((B, 1), np.int32)],
                          axis=1)
    ct2p = np.concatenate([ct2, np.zeros((B, 1), np.int32)], axis=1)
    return c2, cum2, d2tp, ct2p


@pytest.mark.parametrize("case", ["random", "ragged"])
def test_expand_votes_plain_matches_pallas_and_repeat(case):
    from ngmlr_tpu.ops.pallas_kernels import expand_votes as pallas_expand
    B, L = 16, 512
    SL2 = 2 * tds.SL
    c2, cum2, d2tp, ct2p = _slot_tables(case, B, L)

    # the reference's repeat + gather formulation (device_search.py:411-419)
    c2p = np.concatenate([c2, (L - cum2[:, -1])[:, None]], axis=1)
    kmer_f = np.repeat(np.arange(B * (SL2 + 1)), c2p.reshape(-1))
    want = ((kmer_f % (SL2 + 1)).reshape(B, L),
            d2tp.reshape(-1)[kmer_f].reshape(B, L),
            ct2p.reshape(-1)[kmer_f].reshape(B, L))

    # the Pallas kernel, its inputs transformed as device_search.py:394-406
    SLP = ((SL2 + 1 + 127) // 128) * 128
    Bp = 128

    def tab(x, pad):
        return np.pad(x, ((0, Bp - B), (0, SLP - x.shape[1])),
                      constant_values=pad).T
    v0 = np.zeros((8, Bp), np.int32)
    v0[0, :B] = d2tp[:, 0]
    v0[1, :B] = ct2p[:, 0]
    slot_T, d2t_T, ct_T = pallas_expand(
        jnp.asarray(tab(cum2, np.int32(2 ** 30))),
        jnp.asarray(tab(d2tp[:, 1:] - d2tp[:, :-1], 0)),
        jnp.asarray(tab(ct2p[:, 1:] - ct2p[:, :-1], 0)),
        jnp.asarray(v0), L, KT=256, interpret=True)
    pallas = tuple(np.asarray(x).T[:B] for x in (slot_T, d2t_T, ct_T))

    t = [torch.from_numpy(x) for x in (cum2, d2tp, ct2p)]
    plain = K.expand_votes_plain(*t, L)
    wrapped = K.expand_votes(*t, L)           # CPU tensors: the plain version
    for a, b, p, w in zip(want, pallas, plain, wrapped):
        np.testing.assert_array_equal(p.numpy(), a)
        np.testing.assert_array_equal(p.numpy(), b)
        assert p.dtype == torch.int32 and torch.equal(p, w)


def test_expand_votes_rejects_bad_inputs():
    cum2 = torch.zeros((2, 8), dtype=torch.int32)
    tab = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.expand_votes(cum2.long(), tab, tab, 16)
    with pytest.raises(ValueError):
        K.expand_votes(cum2, tab[:, :8].contiguous(), tab, 16)


# ---------------------------------------------------------------------------
# the count stage: _kmer_mat / _rc_dev / _count_kernel against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 11])
def test_count_kernel_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    R = 1 << 14
    codes = rng.integers(0, 4, R).astype(np.uint8)
    for _ in range(40):                        # N runs
        s = int(rng.integers(0, R - 30))
        codes[s:s + int(rng.integers(1, 20))] = 4
    NS = 256
    starts = rng.integers(0, R - 300, NS).astype(np.int32)
    lens = rng.integers(0, tds.SL + 1, NS).astype(np.int32)
    lens[:6] = (0, 1, k - 1, k, k + 1, tds.SL)   # len < k has no k-mer
    starts[-3:] = R - 5                          # windows clipped at the end
    pairs = rng.integers(0, 1000, (4 ** k, 2)).astype(np.int32)

    want = jds._count_kernel(jnp.asarray(pairs), jnp.asarray(codes),
                             jnp.asarray(starts), jnp.asarray(lens), k=k)
    got = tds._count_kernel(torch.from_numpy(pairs), torch.from_numpy(codes),
                            torch.from_numpy(starts), torch.from_numpy(lens),
                            k=k)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][:3].sum()) == 0          # len < k: no zero-hit k-mer

    jp, jv = jds._kmer_mat(jnp.asarray(codes), jnp.asarray(starts),
                           jnp.asarray(lens), k)
    tp, tv = tds._kmer_mat(torch.from_numpy(codes), torch.from_numpy(starts),
                           torch.from_numpy(lens), k)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    p = rng.integers(0, 4 ** k, 4096).astype(np.int32)
    np.testing.assert_array_equal(
        tds._rc_dev(torch.from_numpy(p), k).numpy(),
        np.asarray(jds._rc_dev(jnp.asarray(p), k)))


# ---------------------------------------------------------------------------
# the runner: gate and end to end
# ---------------------------------------------------------------------------

def test_runner_gate(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def want(n_units, device, rpl=256):
        return runner.device_search_wanted(n_units, device, rpl)
    monkeypatch.delenv("NGMLR_TPU_DEVICE_SEARCH", raising=False)
    assert want(1, cuda)
    assert not want(1, cpu)
    assert not want(2, cuda)
    assert want(1, cuda, tds.SL) and not want(1, cuda, tds.SL + 1)
    monkeypatch.setenv("NGMLR_TPU_DEVICE_SEARCH", "1")
    assert want(1, cpu) and want(1, cuda)
    assert not want(3, cuda)
    assert not want(1, cpu, 512)              # --subread-length 512
    monkeypatch.setenv("NGMLR_TPU_DEVICE_SEARCH", "0")
    assert not want(1, cuda)


def test_pipeline_with_device_search_matches_golden(monkeypatch):
    """test_2 pacbio through the port's Pipeline with the device search
    forced on: byte-identical to the golden and to the host-search run
    (the single-device counterpart of tests/test_sharding.py:95)."""
    argv = ["-r", os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa"),
            "-q", os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")]
    args = build_parser().parse_args(argv)

    def run(flag):
        monkeypatch.setenv("NGMLR_TPU_DEVICE_SEARCH", flag)
        p = runner.Pipeline(config_from_args(args, argv), args.reference,
                            use_cache=True, device="cpu")
        buf = io.BytesIO()
        K.reset_launches()
        p.run(args.query, buf)
        return p, [l for l in buf.getvalue().split(b"\n")
                   if not l.startswith(b"@PG")]

    p, dev_out = run("1")
    st = p.ctx.stats
    assert p.dev_search is not None
    assert st["search_v2_launches"] > 0 and st["search_count_s"] > 0
    assert not [k for k in st if k.startswith("search_fallback_")], st
    assert K.launches["expand_votes"] == 0     # the CPU runs the plain version
    del p
    gc.collect()
    p, host_out = run("0")
    assert p.dev_search is None
    assert p.ctx.stats["search_v2_launches"] == 0
    with open(os.path.join(GOLDEN_DIR, "test_2.sam"), "rb") as f:
        golden = [l for l in f.read().split(b"\n") if not l.startswith(b"@PG")]
    assert dev_out == golden
    assert dev_out == host_out

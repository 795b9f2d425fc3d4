"""The benchmark's genome draws as its original, edits come at the rates
asked, the traffic's strata follow the mix's distributions, and every read
is made again alike from the seed."""

import importlib
import json
import os
import sys
from statistics import NormalDist

import numpy as np
import pytest

from benchmark.harness import gen, generators as G

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAFFIC = os.path.join(ROOT, "benchmark", "traffic")


def _original(name):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(name)


def _mix(name="clr"):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


def test_genome_matches_chip_smoke():
    cs = _original("chip_smoke")
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    assert np.array_equal(G.make_genome(a, 50_000), cs.make_genome(b, 50_000))


@pytest.mark.parametrize("rates", [(0.10, 0.04, 0.01),
                                   (0.132, 0.066, 0.022)])
def test_edit_rates(rates):
    """Each source base is inserted before, deleted or substituted at the
    rates asked (a substitution draws the same base a quarter of the
    time), and the same generator gives the same read."""
    src = G.make_genome(np.random.default_rng(1), 1_000_000)
    read, path = G.edit(np.random.default_rng(5), src, *rates)
    again, none = G.edit(np.random.default_rng(5), src, *rates, False)
    assert again == read and none is None
    n = np.bincount(path, minlength=4) / len(src)
    ins, dele, sub = rates
    assert abs(n[G.INS] - ins) < 0.002 and abs(n[G.DEL] - dele) < 0.002
    assert abs(n[G.MISMATCH] - 0.75 * sub) < 0.002
    assert len(read) == len(src) + np.sum(path == G.INS) - np.sum(
        path == G.DEL)


def test_edit_path_spells_the_read():
    """Walking the path over the source gives the read: M columns take a
    source base (equal to the read's unless MISMATCH), I a read base, D a
    source base alone."""
    src = G.make_genome(np.random.default_rng(2), 5_000)
    read, path = G.edit(np.random.default_rng(3), src, 0.13, 0.066, 0.022)
    q = np.frombuffer(read, dtype=np.uint8)
    takes_q = path != G.DEL
    takes_s = path != G.INS
    qi = np.cumsum(takes_q) - 1
    si = np.cumsum(takes_s) - 1
    assert takes_q.sum() == len(q) and takes_s.sum() == len(src)
    m = (path == G.MATCH) | (path == G.MISMATCH)
    same = q[qi[m]] == src[si[m]]
    assert np.array_equal(same, path[m] == G.MATCH)


def test_strata_follow_pbsim_defaults():
    """The design's K lengths and accuracies are the quantiles of the mix's
    distributions: log-normal lengths of PBSIM's mean and sd, normal
    accuracies clipped at PBSIM's least, edits at its ratio."""
    m = _mix()
    d = gen.design(m)
    L = np.array([x for x, _ in d], dtype=float)
    acc = np.array([a for _, a in d])
    assert len(d) == gen.K == len(set(L))
    assert abs(L.mean() / m["length"]["mean"] - 1) < 0.02
    assert abs(L.std() / m["length"]["sd"] - 1) < 0.15
    assert m["length"]["min"] <= L.min() and L.max() <= m["length"]["max"]
    assert acc.min() == m["accuracy"]["min"] and acc.max() < 0.85
    assert abs(np.median(acc) - m["accuracy"]["mean"]) < 0.002
    s2 = np.log1p((m["length"]["sd"] / m["length"]["mean"]) ** 2)
    med = np.exp(np.log(m["length"]["mean"]) - s2 / 2)
    assert abs(np.median(L) / med - 1) < 0.02
    # every quantile (j + 0.5) / K once
    u = np.sort([NormalDist().cdf((np.log(x) - np.log(med)) / np.sqrt(s2))
                 for x in L])
    assert np.allclose(u, (np.arange(gen.K) + 0.5) / gen.K, atol=1e-3)


def test_edit_kinds_follow_the_ratio():
    m = _mix()
    genome = G.make_genome(np.random.default_rng(4), 2_000_000)
    paths = [gen.read_at(m, 9, genome, i).path for i in range(gen.K)]
    n = np.bincount(np.concatenate(paths), minlength=4).astype(float)
    src = n[G.MATCH] + n[G.MISMATCH] + n[G.DEL]
    # a substitution by the same base is a match: 3/4 of them show
    sub, ins, dele = n[G.MISMATCH] * 4 / 3, n[G.INS], n[G.DEL]
    err = (sub + ins + dele) / src
    assert abs(err - 0.22) < 0.01
    r = m["edit_ratio"]
    for x, key in ((sub, "sub"), (ins, "ins"), (dele, "del")):
        assert abs(x / (sub + ins + dele) - r[key] / 100) < 0.02


def test_reads_are_deterministic_from_the_seed():
    m = _mix()
    genome = G.make_genome(np.random.default_rng(2), 2_000_000)
    a = gen.records(m, 2**31 + 77, genome, 0, 12)
    b = gen.records(m, 2**31 + 77, genome, 0, 12)
    c = gen.records(m, 2**31 + 78, genome, 0, 12)
    assert a == b and a != c
    assert a[0].startswith(b">r0\n") and a[11].startswith(b">r11\n")
    w = gen.records(m, 2**31 + 77, genome, 0, 3, warm=True)
    assert w[0].startswith(b">w0\n") and w[0][4:] != a[0][4:]
    # a read made again alone is the one the pool holds
    for i in (0, 5, 11):
        rd = gen.read_at(m, 2**31 + 77, genome, i)
        assert a[i] == b">r%d\n" % i + rd.seq + b"\n"
        pos = rd.parts[0][0]
        src = genome[pos:pos + rd.length].tobytes()
        fwd = G.revcomp(rd.seq) if rd.reverse else rd.seq
        assert len(fwd) == int(np.sum(rd.path != G.DEL))
        assert abs(len(fwd) - len(src)) < 0.3 * len(src)


def test_every_seed_reads_the_same_block():
    """Each seed's first K reads are the design's K strata, in an order of
    its own."""
    m = _mix()
    genome = G.make_genome(np.random.default_rng(2), 3_000_000)
    src, order = [], []
    for seed in (5, 6):
        reads = [gen.read_at(m, seed, genome, i) for i in range(gen.K)]
        src.append(sorted(r.length for r in reads))
        order.append([r.length for r in reads])
    assert src[0] == src[1] == sorted(L for L, _ in gen.design(m))
    assert order[0] != order[1]


def test_records_in_a_child_process_are_the_same(tmp_path):
    m = _mix()
    genome = G.make_genome(np.random.default_rng(2), 1_000_000)
    npy = str(tmp_path / "g.npy")
    np.save(npy, genome)
    assert gen.chunk_in_child([m, 2**31 + 9, npy, 7, 5, False]) == \
        gen.records(m, 2**31 + 9, genome, 7, 5)
    assert gen.chunk_in_child([m, 2**31 + 9, npy, 0, 3, True]) == \
        gen.records(m, 2**31 + 9, genome, 0, 3, warm=True)


def test_longest_reads_are_the_top_stratum():
    m = _mix()
    genome = G.make_genome(np.random.default_rng(2), 1_000_000)
    top = max(L for L, _ in gen.design(m))
    idx = gen.longest(m, 2**31 + 3, 3)
    assert [i // gen.K for i in idx] == [0, 1, 2]
    assert all(gen.read_at(m, 2**31 + 3, genome, i).length == top
               for i in idx)


def test_pool_size_follows_the_window():
    m = _mix()
    assert gen.pool_size(m, 10) == min(m["pool_max_reads"], int(np.ceil(
        m["pool_kbp_per_s"] * 1e4 / gen.mean_length(m))))
    assert gen.pool_size(dict(m, pool_max_reads=5), 10) == 5


@pytest.mark.parametrize("dist", ["uniform", "loguniform"])
def test_other_length_distributions_have_their_quantiles(dist):
    """A mix of another length distribution is data alone: its K lengths
    are the distribution's quantiles at (j + 0.5) / K."""
    m = dict(_mix(), length={"dist": dist, "lo": 1000, "hi": 20000})
    L = np.sort([x for x, _ in gen.design(m)]).astype(float)
    u = (np.arange(gen.K) + 0.5) / gen.K
    want = 1000 + u * 19000 if dist == "uniform" else 1000 * 20 ** u
    assert np.allclose(L, want, atol=0.5)


def _scale_script():
    spec = importlib.util.spec_from_file_location(
        "torch_scale_vs_jax", os.path.join(ROOT, "scripts",
                                           "torch_scale_vs_jax.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sv_mix():
    from .helpers import sv_mix
    return sv_mix()


@pytest.mark.parametrize("kind", ["clean", "del", "ins", "inv", "dup",
                                  "join"])
def test_sv_source_draws_as_its_original(kind):
    """sv_source is scripts/torch_scale_vs_jax.py:sv_read: the same pieces
    and bases from the same generator, and as many draws."""
    sv = _scale_script()
    genome = G.make_genome(np.random.default_rng(11), 3_000_000)
    for seed in (1, 2**31 + 5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        k, parts, seq, starts = G.sv_source(a, genome, kind, 23_457,
                                            sv.SV_SIZES, sv.JOIN_MIN)
        k0, parts0, seq0 = sv.sv_read(b, genome, kind, 23_457, sv.SV_SIZES)
        assert k == kind and k0.startswith(kind)
        assert [(x, y) for x, y, _ in parts] == parts0 and seq == seq0
        assert [r for _, _, r in parts] == [kind == "inv" and j == 1
                                            for j in range(len(parts))]
        assert a.random() == b.random()
    ev = _sv_mix()["events"]
    assert {k: tuple(v) for k, v in ev["sizes"].items()} == sv.SV_SIZES
    assert ev["join_min"] == sv.JOIN_MIN and tuple(ev["kinds"]) == \
        sv.SV_KINDS
    L = _sv_mix()["length"]
    assert (L["lo"], L["hi"]) == sv.SV_LEN


def test_sv_reads_are_made_again_alike():
    """An SV read made again alone is the pool's read."""
    m = _sv_mix()
    genome = G.make_genome(np.random.default_rng(2), 3_000_000)
    a = gen.records(m, 2**31 + 77, genome, 0, 12)
    assert a == gen.records(m, 2**31 + 77, genome, 0, 12)
    for i in (0, 5, 11):
        rd = gen.read_at(m, 2**31 + 77, genome, i)
        assert a[i] == b">r%d\n" % i + rd.seq + b"\n"


def _walk(rd, genome):
    """Every path column's read base and source base (source order), and
    the columns each piece's cuts hold, checked against the genome."""
    S = np.frombuffer(G.revcomp(rd.seq) if rd.reverse else rd.seq,
                      dtype=np.uint8)
    comp = np.frombuffer(b"TGCA", dtype=np.uint8)
    qi = np.cumsum(rd.path != G.DEL) - 1
    si = np.cumsum(rd.path != G.INS) - 1
    assert qi[-1] + 1 == len(S) and si[-1] + 1 == rd.length
    for (a, b, rev), (c0, c1) in zip(rd.parts, rd.cuts):
        cols = np.arange(c0, c1)
        src = si[cols] - int(np.sum(rd.path[:c0] != G.INS))
        assert int(np.sum(rd.path[cols] != G.INS)) == b - a
        m = np.isin(rd.path[cols], (G.MATCH, G.MISMATCH))
        g = np.asarray(genome[a:b])
        if rev:
            g = comp[np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                     g[::-1])]
        same = S[qi[cols[m]]] == g[src[m]]
        assert np.array_equal(same, rd.path[cols[m]] == G.MATCH)


def test_sv_kinds_have_their_pieces():
    """Each block holds 16 strata of each kind; each read's pieces lie and
    face where sv_source puts them, its path cut at their edges spells
    them, and an insertion's random bases lie between its pieces."""
    m = _sv_mix()
    block = gen.design(m)
    kinds = [s[2] for s in block]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        k: 16 for k in m["events"]["kinds"]}
    assert [s[:2] for s in block] == [s[:2] for s in gen.design(
        {k: v for k, v in m.items() if k != "events"})]
    sizes = m["events"]["sizes"]
    genome = G.make_genome(np.random.default_rng(3), 3_000_000)
    seen = set()
    for i in range(gen.K):
        rd = gen.read_at(m, 2**31 + 9, genome, i)
        seen.add(rd.kind)
        p = rd.parts
        n = [b - a for a, b, _ in p]
        assert [r for _, _, r in p] == [rd.kind == "inv" and j == 1
                                        for j in range(len(p))]
        assert len(p) == {"clean": 1, "inv": 3}.get(rd.kind, 2)
        inserted = rd.length - sum(n)
        assert (inserted > 0) == (rd.kind == "ins")
        if rd.kind == "del":
            assert sizes["del"][0] <= p[1][0] - p[0][1] <= sizes["del"][1]
        elif rd.kind == "ins":
            assert p[0][1] == p[1][0]
            assert sizes["ins"][0] <= inserted <= sizes["ins"][1]
            gap = rd.cuts[1][0] - rd.cuts[0][1]
            assert np.sum(rd.path[rd.cuts[0][1]:rd.cuts[1][0]] != G.INS) \
                == inserted and gap >= inserted
        elif rd.kind == "inv":
            assert p[0][1] == p[1][0] and p[1][1] == p[2][0]
            assert sizes["inv"][0] <= n[1] <= sizes["inv"][1]
        elif rd.kind == "dup":
            U = p[0][1] - p[1][0]
            assert sizes["dup"][0] <= U <= min(sizes["dup"][1],
                                               (rd.length - 2000) // 2)
            assert p[1][0] > p[0][0] and p[1][1] > p[0][1]
        elif rd.kind == "join":
            assert abs(p[1][0] - p[0][0]) >= m["events"]["join_min"]
        if rd.kind != "ins":
            assert [c0 for c0, _ in rd.cuts[1:]] == [
                c1 for _, c1 in rd.cuts[:-1]]
        assert rd.cuts[0][0] == 0 and rd.cuts[-1][1] == len(rd.path)
        _walk(rd, genome)
    assert seen == set(m["events"]["kinds"])


# sha256 of the clr pool's first 192 reads (index, position, source
# length, strand, sequence, edit path) at two seeds on one genome, as the
# generator made them before it learned of structural variants
CLR_DIGESTS = {
    2**31 + 77:
        "0626fd7a6dc5093758c46af589f2d627749102394181ddcb83325f4ff7bb7e26",
    3319000011:
        "6b8ca48de2c1fa1b62802991750f48bde939a475c929717cde75d8682ed9cad9",
}


@pytest.mark.parametrize("seed", sorted(CLR_DIGESTS))
def test_clr_pool_is_unchanged(seed):
    import hashlib
    m = _mix()
    genome = G.make_genome(np.random.default_rng(2), 3_000_000)
    h = hashlib.sha256()
    for i in range(192):
        rd = gen.read_at(m, seed, genome, i)
        pos = rd.parts[0][0]
        assert rd.parts == [(pos, pos + rd.length, False)]
        assert rd.cuts == [(0, len(rd.path))] and rd.kind is None
        h.update(b"%d %d %d %d\n" % (i, pos, rd.length, rd.reverse))
        h.update(rd.seq + b"\n")
        h.update(rd.path.tobytes() + b"\n")
    assert h.hexdigest() == CLR_DIGESTS[seed]


def test_chunks_hold_whole_blocks_of_like_bases():
    """A generator's chunk is whole blocks of about as many bases in every
    mix: 40 blocks of the clr mix's 3 kb reads, 5 of the SV mix's 25 kb."""
    assert gen.chunk_reads(_mix()) == 40 * gen.K
    assert gen.chunk_reads(_sv_mix()) == 5 * gen.K

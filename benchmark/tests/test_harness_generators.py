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
        src = genome[rd.pos:rd.pos + rd.length].tobytes()
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

"""The plain reference on records made by hand: a sound record passes, and
each field it checks fails it when altered."""

import numpy as np
import pytest

from benchmark.reference import check as C

rng = np.random.default_rng(4)
GENOME = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 400)]
CHROMS = {b"chr1": (0, len(GENOME))}
SC = C.Scoring()


def g(a, b):
    return GENOME[a:b].tobytes()


def other(base):
    return b"C" if base != b"C"[0] else b"G"


# genome[100:105], a mismatch at 105, two inserted bases, genome[106:111]:
# 5 matches (10), a mismatch (5), a gap opened (0) and extended from a
# score of exactly 0 (0, not -4.85), 5 matches: AS 10
READ = g(100, 105) + other(GENOME[105]) + b"AA" + g(106, 111)
MD = b"5%c5" % GENOME[105]


def line(name=b"r1", flag=0, pos=101, cigar=b"6M2I5M", seq=READ, AS=10,
         NM=3, md=MD, extra=b"", qs=0, qe=None):
    qe = len(READ) if qe is None else qe
    return (b"%s\t%d\tchr1\t%d\t60\t%s\t*\t0\t0\t%s\t*\tAS:i:%d\tNM:i:%d\t"
            b"XI:f:0.9\tXS:i:0\tXE:i:%d\tXR:i:%d\tMD:Z:%s\t%sQS:i:%d\t"
            b"QE:i:%d\tCV:f:100.000000\n"
            % (name, flag, pos, cigar, seq, AS, NM, AS, len(READ), md, extra,
               qs, qe))


def verdict(lines, parts=((100, 111),), reverse=False, read=READ):
    return C.check_read(lines, read, list(parts), reverse, GENOME, CHROMS,
                        SC, "bfloat16")


def test_sound_record_passes():
    v = verdict([line()])
    assert v.faults == [] and v.placed and v.mapped and v.score_gap == 0


def test_reverse_record_and_deletion():
    read = g(200, 210) + g(213, 220)           # 10M3D7M
    rc = C.revcomp(read)
    md = b"10^%s7" % g(210, 213)
    # 17 matches (34), a 3-base deletion: -5, -4.85, -4.7 = 19.45
    ln = line(flag=16, pos=201, cigar=b"10M3D7M", seq=C.revcomp(rc),
              AS=19, NM=3, md=md, qe=17)
    v = C.check_read([ln], rc, [(200, 220)], True, GENOME, CHROMS, SC)
    assert v.faults == [] and v.placed and v.score_gap == 0


@pytest.mark.parametrize("kw,fault", [
    (dict(NM=4), "NM"),
    (dict(md=b"11"), "MD"),
    (dict(cigar=b"6M1I5M"), "CIGAR spends"),
    (dict(seq=C.revcomp(READ)), "SEQ"),
    (dict(qe=5), "QS/QE"),
    (dict(flag=0x800), "0 primary"),
    (dict(extra=b"SA:Z:chr1,5,+,3M,60,0;\t"), "SA"),
    (dict(cigar=b"6M2X5M"), "ops other"),
])
def test_altered_field_is_a_fault(kw, fault):
    v = verdict([line(**kw)])
    assert any(fault in f for f in v.faults), v.faults


def test_altered_score_and_position():
    assert verdict([line(AS=14)]).score_gap == 4
    v = verdict([line(pos=102)])
    assert v.faults                      # NM and MD no longer hold
    assert not verdict([line()], parts=((300, 311),)).placed
    assert not verdict([line()], reverse=True).placed


def test_supplementary_records_name_each_other():
    a = line(extra=b"SA:Z:chr1,101,+,6M2I5M,60,3;\t")
    b = line(flag=0x800, extra=b"SA:Z:chr1,101,+,6M2I5M,60,3;\t")
    assert verdict([a, b]).faults == []
    assert verdict([a, line(flag=0x800)]).faults


def test_unmapped_read():
    ln = b"r1\t4\t*\t0\t0\t*\t*\t0\t0\t%s\t*\n" % READ
    v = verdict([ln])
    assert not v.mapped and v.faults == []


def test_path_score_rules():
    f = np.float32
    t = np.array([2, 3, -5, -4.85, 2], dtype=f)
    e = np.array([0, 0, 0, 1, 0], dtype=bool)
    assert C.path_score(t, e) == 2.0           # the extension from 0 adds 0
    assert C.path_score(t, np.zeros(5, bool)) == pytest.approx(-2.85)
    long = np.full(5000, 2.0, dtype=f)
    none = np.zeros(5000, bool)
    assert C.path_score(long, none) == 10000.0
    assert abs(C.path_score(long, none, "bfloat16") - 10000.0) >= 8


# READ's true edit path: 5 matches, a mismatch, two insertions, 5 matches
PATH = np.array([0] * 5 + [1, 2, 2] + [0] * 5, dtype=np.uint8)


def test_true_score_is_the_edit_paths():
    assert C.true_score(PATH, SC) == 10.0
    # a deletion run of 3 between matches: 34 - 5 - 4.85 - 4.7
    p = np.array([0] * 10 + [3] * 3 + [0] * 7, dtype=np.uint8)
    assert C.true_score(p, SC) == pytest.approx(19.45, abs=1e-4)


def test_shortfall_and_unaligned_bases():
    v = C.check_read([line()], READ, [(100, 111)], False, GENOME, CHROMS,
                     SC, path=PATH)
    assert v.faults == [] and v.shortfall == 0 and v.unaligned == 0
    # the last 5 bases clipped: AS 0 (the insertion extends from 0)
    clipped = line(cigar=b"6M2I5S", AS=0, NM=3, md=b"5%c0" % GENOME[105],
                   qe=len(READ) - 5)
    v = C.check_read([clipped], READ, [(100, 111)], False, GENOME, CHROMS,
                     SC, path=PATH)
    assert v.faults == [] and v.shortfall == 100.0 and v.unaligned == 5


def test_judge_counts():
    reads = [([line()], READ, [(100, 111)], False, PATH),
             ([line(NM=4)], READ, [(100, 111)], False, PATH),
             ([line()], READ, [(0, 11)], False, None),
             ([line(cigar=b"6M2I5S", AS=0, NM=3, md=b"5%c0" % GENOME[105],
                    qe=len(READ) - 5)], READ, [(100, 111)], False, PATH)]
    nums, ctrl, seen = C.judge(reads, GENOME, CHROMS, SC, "bfloat16")
    assert {k: nums[k] for k in ("record_faults", "misplaced", "score_gap",
                                 "score_shortfall")} == {
        "record_faults": 1, "misplaced": 1, "score_gap": 0,
        "score_shortfall": 100.0}
    assert nums["short_reads"] == pytest.approx(100 / 3)
    assert nums["score_deficit"] == pytest.approx(100 / 3)
    assert nums["unaligned_share"] == pytest.approx(100 * 5 / (4 * len(READ)))
    assert any(x.startswith("widest unaligned %.4f" % (100 * 5 / len(READ)))
               for x in seen)
    assert ctrl["record_faults"] == 1
    assert seen[0].startswith("r1: NM")
    assert any(x.startswith("widest score_shortfall 100") for x in seen)

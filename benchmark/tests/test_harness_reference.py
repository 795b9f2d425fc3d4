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


def verdict(lines, parts=((100, 111, False),), reverse=False, read=READ):
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
    v = C.check_read([ln], rc, [(200, 220, False)], True, GENOME, CHROMS,
                     SC)
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
    assert not verdict([line()], parts=((300, 311, False),)).placed
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
    v = C.check_read([line()], READ, [(100, 111, False)], False, GENOME,
                     CHROMS, SC, path=PATH)
    assert v.faults == [] and v.shortfall == 0 and v.unaligned == 0
    # the last 5 bases clipped: AS 0 (the insertion extends from 0)
    clipped = line(cigar=b"6M2I5S", AS=0, NM=3, md=b"5%c0" % GENOME[105],
                   qe=len(READ) - 5)
    v = C.check_read([clipped], READ, [(100, 111, False)], False, GENOME,
                     CHROMS, SC, path=PATH)
    assert v.faults == [] and v.shortfall == 100.0 and v.unaligned == 5


def one_piece(lines, parts, reverse, path):
    """judge's item for a read of one piece, as the generator gives it."""
    return (lines, READ, [(a, b, False) for a, b in parts], reverse, path,
            None if path is None else [(0, len(path))], None)


def test_judge_counts():
    reads = [one_piece([line()], [(100, 111)], False, PATH),
             one_piece([line(NM=4)], [(100, 111)], False, PATH),
             one_piece([line()], [(0, 11)], False, None),
             one_piece([line(cigar=b"6M2I5S", AS=0, NM=3,
                             md=b"5%c0" % GENOME[105], qe=len(READ) - 5)],
                       [(100, 111)], False, PATH)]
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


# reads that span structural variants, made by the generator without noise,
# and records built by hand from where their pieces lie

SV_GENOME = np.frombuffer(b"ACGT", dtype=np.uint8)[
    np.random.default_rng(8).integers(0, 4, 3_000_000)].copy()
SV_CHROMS = {b"chr1": (0, len(SV_GENOME))}


def _sv_read(kind, reverse):
    """The first noise-free read of kind and strand in a pool of 12-16 kb
    SV reads."""
    from benchmark.harness import gen
    from .helpers import sv_mix
    mix = sv_mix()
    mix["length"] = {"dist": "uniform", "lo": 12_000, "hi": 16_000}
    mix["accuracy"] = {"mean": 1.0, "sd": 0.0, "min": 1.0, "max": 1.0}
    block = gen.design(mix)
    for i in range(10 * gen.K):
        rd = gen.read_at(mix, 5, SV_GENOME, i, block=block)
        if rd.kind == kind and rd.reverse == reverse:
            return rd
    raise AssertionError("no %s read" % kind)


def _segments(rd):
    """One exact alignment a piece: (read start, end in the record's
    orientation, reverse, genome start)."""
    n = len(rd.seq)
    _, spans = C.piece_bases(rd.path, rd.cuts, n, rd.reverse)
    out = []
    for (a, b, prev), (qa, qb) in zip(rd.parts, spans):
        rs = rd.reverse != prev
        q0, q1 = (n - qb, n - qa) if rs else (qa, qb)
        out.append((q0, q1, rs, a))
    return out


def _sam(rd, segs, genome=SV_GENOME, name=b"r1"):
    """The records of segs, the first primary, each naming the others in
    SA: all matches, so AS is twice the bases aligned, NM 0."""
    n = len(rd.seq)

    def cigar(q0, q1):
        return (b"%dS" % q0 if q0 else b"") + b"%dM" % (q1 - q0) + (
            b"%dS" % (n - q1) if q1 < n else b"")
    sa = [b"chr1,%d,%c,%s,60,0;" % (g + 1, b"-"[0] if rs else b"+"[0],
                                    cigar(q0, q1))
          for q0, q1, rs, g in segs]
    lines = []
    for j, (q0, q1, rs, g) in enumerate(segs):
        want = C.revcomp(rd.seq) if rs else rd.seq
        assert want[q0:q1] == genome[g:g + q1 - q0].tobytes()
        flag = (0x10 if rs else 0) | (0x800 if j else 0)
        others = b"".join(x for k, x in enumerate(sa) if k != j)
        lines.append(
            b"%s\t%d\tchr1\t%d\t60\t%s\t*\t0\t0\t%s\t*\tAS:i:%d\tNM:i:0\t"
            b"MD:Z:%d\t%sQS:i:%d\tQE:i:%d\n"
            % (name, flag, g + 1, cigar(q0, q1), want, 2 * (q1 - q0),
               q1 - q0, b"SA:Z:%s\t" % others if others else b"", q0, q1))
    return lines


def _judge(rd, lines, genome=SV_GENOME):
    nums, _, seen = C.judge([(lines, rd.seq, rd.parts, rd.reverse, rd.path,
                              rd.cuts, rd.kind)], genome, SV_CHROMS, SC)
    return nums, seen


SV_KINDS = ["clean", "del", "ins", "inv", "dup", "join"]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", SV_KINDS)
def test_split_records_pass_every_number(kind, reverse):
    rd = _sv_read(kind, reverse)
    nums, seen = _judge(rd, _sam(rd, _segments(rd)))
    assert nums == {"record_faults": 0, "misplaced": 0, "score_gap": 0,
                    "score_deficit": 0.0, "short_reads": 0.0,
                    "score_shortfall": 0.0, "unaligned_share": 0.0,
                    "unsplit_share": 0.0, "records_off_source": 0}, seen


@pytest.mark.parametrize("kind", SV_KINDS)
def test_primary_alone_is_unsplit(kind):
    """Without its supplementary records a read of a kind that has to be
    split counts in unsplit_share; every read falls short of its pieces'
    score and leaves genome bases unaligned."""
    rd = _sv_read(kind, True)
    segs = _segments(rd)
    nums, seen = _judge(rd, _sam(rd, segs[:1]))
    assert nums["record_faults"] == 0 and nums["misplaced"] == 0, seen
    split = kind in ("inv", "dup", "join")
    assert nums["unsplit_share"] == (100.0 if split else 0.0)
    if kind != "clean":
        assert nums["short_reads"] == 100.0 and nums["unaligned_share"] > 5


def test_inverted_piece_counts_on_its_own_strand():
    """The inverted piece aligned on the flanks' strand covers nothing."""
    rd = _sv_read("inv", False)
    q0, q1, rs, g = _segments(rd)[1]
    n = len(rd.seq)
    wrong = (n - q1, n - q0, not rs, g)
    genome = SV_GENOME.copy()
    want = C.revcomp(rd.seq) if wrong[2] else rd.seq
    genome[g:g + q1 - q0] = np.frombuffer(want[wrong[0]:wrong[1]],
                                          dtype=np.uint8)
    nums, seen = _judge(rd, _sam(rd, [_segments(rd)[0], wrong], genome),
                        genome)
    assert nums["record_faults"] == 0, seen
    assert nums["unsplit_share"] == 100.0


@pytest.mark.parametrize("kind", ["del", "inv", "dup", "join"])
def test_record_off_every_piece_counts(kind):
    """A supplementary record whose bases match a copy far from every
    piece is sound as a record and counts in records_off_source."""
    rd = _sv_read(kind, False)
    segs = _segments(rd)
    q0, _, rs, g = segs[0]
    far = next(x for x in range(0, len(SV_GENOME) - 500, 100_000)
               if all(x + 500 < a or b < x for a, b, _ in rd.parts))
    genome = SV_GENOME.copy()
    genome[far:far + 300] = SV_GENOME[g:g + 300]
    extra = (q0, q0 + 300, rs, far)
    nums, seen = _judge(rd, _sam(rd, segs + [extra], genome), genome)
    assert nums["record_faults"] == 0 and nums["misplaced"] == 0, seen
    assert nums["records_off_source"] == 1
    assert nums["unsplit_share"] == 0.0


# what the reference read on these reads before it learned of several
# pieces (its numbers, its control's, its notes)
ONE_PIECE_BEFORE = (
    {"record_faults": 2, "misplaced": 1, "score_gap": 67,
     "score_deficit": 25.0, "short_reads": 25.0, "score_shortfall": 100.0,
     "unaligned_share": 100 / 13},
    {"record_faults": 2, "misplaced": 1, "score_gap": 0.0,
     "score_deficit": 25.0, "short_reads": 25.0, "score_shortfall": 100.0,
     "unaligned_share": 100 / 13},
    ["r1: NM b'4', the path has 3",
     "r1: NM b'3', the path has 12; MD differs from the path's",
     "widest score_gap 67.0000: r1", "widest score_shortfall 100.0000: r1",
     "widest unaligned 38.4615: r1"])


def test_one_piece_reads_read_as_before():
    """Reads of one piece read every number, the control's and the notes
    as before, and nothing in the numbers of several pieces."""
    reads = [one_piece([line()], [(100, 111)], False, PATH),
             one_piece([line(NM=4)], [(100, 111)], False, PATH),
             one_piece([line()], [(0, 11)], False, None),
             one_piece([line(cigar=b"6M2I5S", AS=0, NM=3,
                             md=b"5%c0" % GENOME[105], qe=len(READ) - 5)],
                       [(100, 111)], False, PATH),
             one_piece([line(flag=16, seq=C.revcomp(READ))], [(100, 111)],
                       True, PATH)]
    nums, ctrl, seen = C.judge(reads, GENOME, CHROMS, SC, "bfloat16")
    extra = {"unsplit_share": 0.0, "records_off_source": 0}
    before_nums, before_ctrl, before_seen = ONE_PIECE_BEFORE
    assert nums == pytest.approx(dict(before_nums, **extra))
    assert ctrl == pytest.approx(dict(before_ctrl, **extra))
    assert seen == before_seen

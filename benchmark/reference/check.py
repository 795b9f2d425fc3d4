"""The plain reference: it judges the SAM records a run wrote for its reads,
from the reads as they were fed, where each came from, and the genome.

It imports nothing of the program and takes nothing the program made but
the records it judges. A read came from one or more pieces of the genome
(start, end, reverse), in read order: one for a read without a structural
variant; an inversion's middle piece is reversed; an insertion's random
bases lie between two pieces and belong to none. Per read it checks:
  * placement: a mapped read's primary record lies on a piece the read
    came from, on that piece's strand;
  * the record itself: SEQ is the read (reverse-complemented under flag
    0x10), the CIGAR spends the read's whole length with soft clips at
    the ends only, QS and QE are those clips, the alignment lies inside the
    chromosome, one record is primary, and SA names every other record;
  * the alignment: NM and MD as worked out again from the CIGAR, the read
    and the genome, and AS against the path's convex-gap score, worked out
    again in float32 (ngmlr's ConvexAlignFast recurrence along the path:
    match / mismatch per column; a gap's first base gap_open, its k-th
    after that min(gap_extend_min, gap_extend_max + k * gap_decay), and no
    change where a gap extends from a cell whose score is exactly 0
    (ConvexAlignFast.cpp:606-774, as ops/convex_ref.py states it)), summed
    in path order.

Against the read's true edit path (where the generator's path is given)
it also measures how far AS falls short of that path's score (for a read
of several pieces, the sum of each piece's own path's score, the path cut
at the pieces' edges), and how much of the read's genome bases no record
aligns: a fill that misses cells, a band too narrow or a walk that stops
early shows there, where the path's own consistency cannot show it. For a
read of several pieces it also asks which pieces its records cover (a
record matches at least half of a piece's read bases inside that piece, on
its strand) and whether a record lies off every piece.

`judge` returns the numbers compared with their limits. `control_dtype`
recomputes the score in a lower precision and puts it in the program's
place, which is the control that the score limit has to fail.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

_RC = bytes.maketrans(b"ACGTN", b"TGCAN")
_CIG = re.compile(rb"(\d+)([MIDNSHP=X])")
# per CIGAR op: consumes query, consumes reference
_OPS = b"MIDNSHP=X"
_QC = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
_RCON = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)
M, I, D, S = 0, 1, 2, 4
# the generator's path codes: a deletion emits no read base
GEN_DEL = 3
# the kinds of read whose records have to cover two pieces or more (a
# deletion or an insertion may be aligned in one record)
SPLIT_KINDS = ("inv", "dup", "join")


def revcomp(s: bytes) -> bytes:
    return s.translate(_RC)[::-1]


@dataclass
class Record:
    flag: int
    rname: bytes
    pos: int            # 0-based
    mapq: int
    cigar: bytes
    seq: bytes
    tags: Dict[bytes, bytes]

    @classmethod
    def parse(cls, line: bytes) -> "Record":
        f = line.rstrip(b"\n").split(b"\t")
        tags = {t[:2]: t[5:] for t in f[11:]}
        return cls(int(f[1]), f[2], int(f[3]) - 1, int(f[4]), f[5], f[9],
                   tags)

    @property
    def reverse(self):
        return bool(self.flag & 0x10)


@dataclass
class Scoring:
    match: float = 2.0
    mismatch: float = -5.0
    gap_open: float = -5.0
    gap_extend_max: float = -5.0
    gap_extend_min: float = -1.0
    gap_decay: float = 0.15


def cigar_ops(cigar: bytes):
    """(lengths, op codes) with adjacent equal ops merged."""
    found = _CIG.findall(cigar)
    if not found or b"".join(n + o for n, o in found) != cigar:
        raise ValueError("malformed CIGAR")
    lens = np.fromiter((int(n) for n, _ in found), dtype=np.int64,
                       count=len(found))
    codes = np.fromiter((_OPS.index(o) for _, o in found), dtype=np.int64,
                        count=len(found))
    if len(codes) > 1:
        new = np.ones(len(codes), dtype=bool)
        new[1:] = codes[1:] != codes[:-1]
        grp = np.cumsum(new) - 1
        lens = np.bincount(grp, weights=lens).astype(np.int64)
        codes = codes[new]
    return lens, codes


@dataclass
class Path:
    """One record's alignment, column by column (soft clips left out)."""
    code: np.ndarray      # op of each column
    k: np.ndarray         # the column's place in its run of the op
    qi: np.ndarray        # read index (for M and I)
    ri: np.ndarray        # genome index (for M and D)
    eq: np.ndarray        # M: read base == genome base
    qlen: int             # read bases the CIGAR spends
    clip: tuple           # (leading, trailing) soft clips
    rlen: int             # genome bases spanned


def path_of(rec: Record, read: bytes, genome: np.ndarray, g0: int) -> Path:
    """g0: the chromosome's first index in genome."""
    lens, codes = cigar_ops(rec.cigar)
    qc, rc = _QC[codes], _RCON[codes]
    qlen = int(lens[qc].sum())
    inner = np.ones(len(codes), dtype=bool)
    lead = int(lens[0]) if codes[0] == S else 0
    trail = int(lens[-1]) if codes[-1] == S and len(codes) > 1 else 0
    if codes[0] == S:
        inner[0] = False
    if codes[-1] == S and len(codes) > 1:
        inner[-1] = False
    if np.any(~np.isin(codes[inner], (M, I, D))):
        raise ValueError("ops other than M, I, D inside the CIGAR")
    il, ic = lens[inner], codes[inner]
    code = np.repeat(ic, il)
    starts = np.repeat(np.cumsum(il) - il, il)
    k = np.arange(len(code)) - starts
    qstep = np.isin(code, (M, I)).astype(np.int64)
    rstep = np.isin(code, (M, D)).astype(np.int64)
    qi = lead + np.cumsum(qstep) - qstep
    ri = g0 + rec.pos + np.cumsum(rstep) - rstep
    rlen = int(rstep.sum())
    q = np.frombuffer(read, dtype=np.uint8)
    eq = np.zeros(len(code), dtype=bool)
    m = code == M
    if qlen == len(q) and g0 + rec.pos + rlen <= len(genome):
        eq[m] = q[qi[m]] == genome[ri[m]]
    return Path(code, k, qi, ri, eq, qlen, (lead, trail), rlen)


def score_terms(p: Path, sc: Scoring):
    """(the path's score terms in float32, the columns that extend a
    gap)."""
    f = np.float32
    t = np.where(p.eq, f(sc.match), f(sc.mismatch)).astype(f)
    gap = p.code != M
    ext = np.minimum(f(sc.gap_extend_min),
                     f(sc.gap_extend_max)
                     + p.k[gap].astype(f) * f(sc.gap_decay)).astype(f)
    t[gap] = np.where(p.k[gap] == 0, f(sc.gap_open), ext)
    return t, gap & (p.k > 0)


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values rounded to dtype (bfloat16: to nearest, ties to
    even, as torch rounds), back in float32."""
    if dtype == "float32":
        return x.astype(np.float32)
    import torch
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
        getattr(torch, dtype)).to(torch.float32).numpy()


def path_score(terms: np.ndarray, extends: np.ndarray,
               dtype="float32") -> float:
    """The path's score: its terms summed in path order, each partial sum
    rounded to dtype, where a gap extending from a partial sum of exactly 0
    adds nothing. In bulk (NumPy's float32 cumsum, or torch's cumsum in a
    lower dtype) where no extension starts at 0; else one column at a
    time."""
    if not len(terms):
        return 0.0
    if dtype == "float32":
        run = np.cumsum(terms, dtype=np.float32)
    else:
        import torch
        t = torch.from_numpy(terms).to(getattr(torch, dtype))
        run = t.cumsum(0, dtype=t.dtype).to(torch.float32).numpy()
    before = np.concatenate([[0.0], run[:-1]])
    if not np.any(extends & (before <= 0)):
        return float(run[-1])
    terms = _round(terms, dtype)
    v = np.float32(0)
    for t, e in zip(terms.tolist(), extends.tolist()):
        if not (e and v == 0):
            v = _round(np.float32(v + np.float32(t)), dtype)[()] \
                if dtype != "float32" else np.float32(v + np.float32(t))
    return float(v)


def md_of(p: Path, genome: np.ndarray) -> bytes:
    """The MD string of the path (SAM's: matched run lengths, mismatched
    genome bases, ^ and deleted genome bases)."""
    keep = p.code != I
    code, eq, ri, k = p.code[keep], p.eq[keep], p.ri[keep], p.k[keep]
    event = (code == D) & (k == 0) | (code == M) & ~eq
    matched = np.cumsum((code == M) & eq)
    out, last = [], 0
    ev = np.flatnonzero(event)
    d_end = np.flatnonzero(np.diff(np.append(code == D, False).astype(
        np.int8)) == -1)          # last column of each D run
    j = 0
    for e in ev:
        before = int(matched[e]) - last
        if code[e] == M:
            out.append(b"%d%c" % (before, genome[ri[e]]))
        else:
            while d_end[j] < e:
                j += 1
            out.append(b"%d^" % before
                       + genome[ri[e]:ri[d_end[j]] + 1].tobytes())
        last = int(matched[e])
    out.append(b"%d" % (int(matched[-1]) - last if len(matched) else 0))
    return b"".join(out)


def edit_path(codes: np.ndarray) -> Path:
    """The read's true path as its generator made it (one column each: 0 a
    match, 1 a mismatch, 2 an insertion, 3 a deletion; in genome order)."""
    code = np.choose(np.minimum(codes, 3), [M, M, I, D]).astype(np.int64)
    new = np.ones(len(code), dtype=bool)
    new[1:] = code[1:] != code[:-1]
    start = np.maximum.accumulate(np.where(new, np.arange(len(code)), 0))
    k = np.arange(len(code)) - start
    z = np.zeros(len(code), dtype=np.int64)
    return Path(code, k, z, z, codes == 0, int(np.sum(code != D)), (0, 0),
                int(np.sum(code != I)))


def true_score(codes: np.ndarray, sc: Scoring) -> float:
    """The convex-gap score of the read's true path, as path_score gives
    it: what a fill that holds the path in its band reaches at least."""
    return path_score(*score_terms(edit_path(codes), sc))


def pieces_score(codes: np.ndarray, parts, cuts, sc: Scoring) -> float:
    """The sum of each piece's true-path score: the path cut at the
    pieces' first and end columns, a reversed piece's part in its genome
    order."""
    if len(parts) == 1:
        return true_score(codes, sc)
    return sum(true_score(codes[c0:c1][::-1] if p[2] else codes[c0:c1], sc)
               for p, (c0, c1) in zip(parts, cuts))


def piece_bases(codes: np.ndarray, cuts, n: int, reverse: bool):
    """(Whether each of the read's n bases came from the genome, each
    piece's read bases [q0, q1) in the read as fed)."""
    col = np.zeros(len(codes), dtype=bool)
    for c0, c1 in cuts:
        col[c0:c1] = True
    emits = codes != GEN_DEL
    genomic = col[emits]
    before = np.concatenate([[0], np.cumsum(emits)])
    spans = [(int(before[c0]), int(before[c1])) for c0, c1 in cuts]
    if reverse:
        genomic = genomic[::-1]
        spans = [(n - b, n - a) for a, b in spans]
    return genomic, spans


@dataclass
class ReadVerdict:
    faults: List[str] = field(default_factory=list)
    mapped: bool = False
    placed: bool = False
    score_gap: float = 0.0
    control_gap: float = 0.0
    shortfall: float = 0.0     # % of the true path's score that AS misses
    best: float = 0.0          # the true path's score
    as_sum: int = 0            # AS summed over the read's records
    unaligned: int = 0         # genome bases of the read no record aligns
    genomic: int = 0           # the read's bases that came from the genome
    pieces_covered: int = 0    # pieces the records cover (several pieces)
    off_source: bool = False   # a mapped record overlaps no piece


def check_read(lines: List[bytes], read: bytes, parts, reverse: bool,
               genome: np.ndarray, chroms: Dict[bytes, tuple],
               sc: Scoring, control_dtype=None, path=None,
               cuts=None) -> ReadVerdict:
    """chroms: name -> (first index in genome, length); parts: the source
    pieces (start, end, reverse) in read order; path: the read's true
    edit path (edit_path's codes), or None; cuts: each piece's first and
    end column in path (needed for several pieces)."""
    v = ReadVerdict()
    several = len(parts) > 1 and path is not None
    if several:
        genomic, spans = piece_bases(path, cuts, len(read), reverse)
        aligned_in = np.zeros(len(parts), dtype=np.int64)
    else:
        genomic = np.ones(len(read), dtype=bool)
    v.genomic = int(genomic.sum())
    as_sum, covered = 0, np.zeros(len(read), dtype=bool)
    recs = [Record.parse(x) for x in lines]
    mapped = [r for r in recs if not r.flag & 0x4]
    if not mapped:
        if len(recs) != 1 or recs[0].seq != read:
            v.faults.append("unmapped record malformed")
        return v
    v.mapped = True
    if len(mapped) != len(recs):
        v.faults.append("mapped and unmapped records")
    prim = [r for r in mapped if not r.flag & 0x800]
    if len(prim) != 1:
        v.faults.append("%d primary records" % len(prim))
    for i, r in enumerate(mapped):
        want = revcomp(read) if r.reverse else read
        if r.seq != want:
            v.faults.append("SEQ is not the read")
            continue
        if r.rname not in chroms:
            v.faults.append("unknown chromosome")
            continue
        g0, glen = chroms[r.rname]
        try:
            p = path_of(r, want, genome, g0)
        except ValueError as e:
            v.faults.append(str(e))
            continue
        if p.qlen != len(read):
            v.faults.append("CIGAR spends %d of %d bases" % (p.qlen, len(read)))
            continue
        if r.pos < 0 or r.pos + p.rlen > glen:
            v.faults.append("alignment outside the chromosome")
            continue
        t = r.tags
        if (t.get(b"QS") != b"%d" % p.clip[0]
                or t.get(b"QE") != b"%d" % (len(read) - p.clip[1])):
            v.faults.append("QS/QE differ from the clips")
        nm = int(np.sum((p.code == M) & ~p.eq) + np.sum(p.code != M))
        if t.get(b"NM") != b"%d" % nm:
            v.faults.append("NM %s, the path has %d" % (t.get(b"NM"), nm))
        if t.get(b"MD") != md_of(p, genome):
            v.faults.append("MD differs from the path's")
        others = b"".join(
            b"%s,%d,%c,%s,%d,%s;" % (o.rname, o.pos + 1,
                                     b"-"[0] if o.reverse else b"+"[0],
                                     o.cigar, o.mapq, o.tags.get(b"NM", b""))
            for j, o in enumerate(mapped) if j != i)
        if t.get(b"SA", b"") != others:
            v.faults.append("SA does not name the other records")
        terms, extends = score_terms(p, sc)
        ref = int(path_score(terms, extends))
        try:
            got = int(t[b"AS"])
        except (KeyError, ValueError):
            v.faults.append("no AS")
            continue
        v.score_gap = max(v.score_gap, abs(got - ref))
        as_sum += got
        a, b = p.clip[0], len(read) - p.clip[1]
        if r.reverse:
            a, b = len(read) - b, len(read) - a
        covered[a:b] = True
        if several:
            # the read bases this record matches, in the read as fed, and
            # the genome bases they meet
            m = (p.code == M) & p.eq
            q = p.qi[m] if not r.reverse else len(read) - 1 - p.qi[m]
            for k, ((ga, gb, prev), (qa, qb)) in enumerate(zip(parts,
                                                               spans)):
                if r.reverse == (reverse != prev):
                    aligned_in[k] += int(np.sum(
                        (q >= qa) & (q < qb) & (p.ri[m] >= ga)
                        & (p.ri[m] < gb)))
        if control_dtype:
            low = int(path_score(terms, extends, control_dtype))
            v.control_gap = max(v.control_gap, abs(low - ref))
    v.unaligned = int(np.sum(genomic & ~covered))
    if path is not None:
        v.best, v.as_sum = pieces_score(path, parts, cuts, sc), as_sum
        v.shortfall = 100.0 * (v.best - as_sum) / max(abs(v.best), 1.0)
    if several:
        v.pieces_covered = int(sum(
            2 * n >= qb - qa for n, (qa, qb) in zip(aligned_in, spans)
            if qb > qa))

    def span(r):
        g0, _ = chroms.get(r.rname, (0, 0))
        lo = g0 + r.pos
        return lo, lo + sum(int(n) for n, o in _CIG.findall(r.cigar)
                            if o in b"MDN=X")
    for r in prim:
        lo, hi = span(r)
        v.placed = any(lo < b and a < hi and r.reverse == (reverse != prev)
                       for a, b, prev in parts)
    if len(parts) > 1:
        v.off_source = any(not any(lo < b and a < hi for a, b, _ in parts)
                           for lo, hi in map(span, mapped))
    return v


def judge(reads, genome, chroms, sc: Scoring, control_dtype=None):
    """reads: (lines, read, parts, reverse, true edit path or None, cuts,
    kind) of each read checked (cuts, where it has several pieces, and its
    event's kind, or None). Returns (numbers, control numbers or None,
    notes: the first faults, the read behind each widest reading, and how
    many mapped reads of a kind in SPLIT_KINDS were judged).

    Numbers: record_faults and misplaced (reads), score_gap (the widest
    gap between AS and its path's score), unaligned_share (% of the mapped
    reads' genome bases that no record aligns), and against the true
    paths: score_deficit (% of their scores' sum that the mapped reads'
    AS, summed over each read's records, falls short by, read by read),
    short_reads (% of the mapped reads whose AS falls short), and
    score_shortfall (the most, in %, by which one read's does), which no
    limit reads. Of the reads of several pieces: unsplit_share (% of the
    mapped reads of a kind in SPLIT_KINDS whose records cover fewer than
    two pieces) and records_off_source (reads with a mapped record that
    overlaps none of their pieces)."""
    faults, misplaced, gap, cgap = 0, 0, 0.0, 0.0
    short, unal, bases = [], 0, 0
    best_sum, deficit = 0.0, 0.0
    split_kind, unsplit, off_source = 0, 0, 0
    seen, worst = [], {}
    for lines, read, parts, reverse, path, cuts, kind in reads:
        name = lines[0].split(b"\t", 1)[0].decode()
        v = check_read(lines, read, parts, reverse, genome, chroms, sc,
                       control_dtype, path, cuts)
        if v.faults:
            faults += 1
            if len(seen) < 5:
                seen.append("%s: %s" % (name, "; ".join(v.faults)))
        misplaced += v.mapped and not v.placed
        gap = max(gap, v.score_gap)
        cgap = max(cgap, v.control_gap)
        if not v.mapped:
            continue
        off_source += v.off_source
        if kind in SPLIT_KINDS:
            split_kind += 1
            unsplit += v.pieces_covered < 2
        unal += v.unaligned
        bases += v.genomic
        if path is not None:
            short.append(v.shortfall)
            best_sum += v.best
            deficit += max(0.0, v.best - v.as_sum)
        for key, x in (("score_gap", v.score_gap),
                       ("score_shortfall", v.shortfall if path is not None
                        else None),
                       ("unaligned", 100.0 * v.unaligned
                        / max(v.genomic, 1))):
            if x is not None and (key not in worst or x > worst[key][0]):
                worst[key] = (x, name)
    nums = {"record_faults": faults, "misplaced": misplaced,
            "score_gap": gap,
            "score_deficit": 100.0 * deficit / max(best_sum, 1.0),
            "short_reads": 100.0 * np.mean(np.array(short) > 0)
            if short else 0.0,
            "score_shortfall": max(short) if short else 0.0,
            "unaligned_share": 100.0 * unal / max(bases, 1),
            "unsplit_share": 100.0 * unsplit / max(split_kind, 1),
            "records_off_source": off_source}
    ctrl = dict(nums, score_gap=cgap) if control_dtype else None
    seen += ["widest %s %.4f: %s" % (k, x, n) for k, (x, n) in worst.items()]
    if split_kind:
        seen.append("%d mapped reads of a kind in SPLIT_KINDS, %d unsplit"
                    % (split_kind, unsplit))
    return nums, ctrl, seen

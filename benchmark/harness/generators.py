"""The benchmark's own genome and read-noise generators.

The benchmark keeps its own code so that its yardstick does not move when
the repository's generators change. A copy names its original, and
benchmark/tests hold it to that original's draws. Do not edit one: add a
new function beside it.
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# the columns of an edit path, in genome order
MATCH, MISMATCH, INS, DEL = 0, 1, 2, 3


def revcomp(s: bytes) -> bytes:
    """Copy of scripts/fuzz_vs_reference.py:revcomp."""
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def make_genome(rng, n):
    """Copy of chip_smoke.py:make_genome."""
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)


def edit(rng, seq, ins: float, dele: float, sub: float, with_path=True):
    """Independent edits of each source base (uint8 ASCII array): deleted
    with probability `dele` (it emits nothing), an insertion with
    probability `ins` (a random base, then the source base), a substitution
    with probability `sub` (a random base in its place, which may be the
    same). Returns (the read, its edit path: one of MATCH, MISMATCH, INS,
    DEL for each column, in source order; None unless with_path).

    chip_smoke.py:mutate_pacbio's model (one uniform draw a base against
    the three thresholds in this order), with the rates as arguments, and
    one 32-bit draw a base: its top 30 bits against the thresholds, its
    low 2 bits the random base."""
    n = len(seq)
    r = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    u = r >> 2
    a, b, c = (int(x * (1 << 30)) for x in (ins, ins + dele, ins + dele + sub))
    is_ins = u < a
    is_del = (u >= a) & (u < b)
    is_sub = (u >= b) & (u < c)
    rand = BASES[r & 3]
    counts = np.where(is_del, 0, 1 + is_ins.astype(np.int64))
    ends = np.cumsum(counts)
    out = np.empty(int(ends[-1]) if n else 0, dtype=np.uint8)
    keep = ~is_del
    base = np.where(is_sub, rand, seq)
    out[ends[keep] - 1] = base[keep]
    out[ends[is_ins] - 2] = rand[is_ins]
    if not with_path:
        return out.tobytes(), None
    # the path: a deletion is one column, an insertion two (I, then M)
    col = np.where(is_del, DEL, np.where(base != seq, MISMATCH, MATCH))
    width = 1 + is_ins.astype(np.int64)
    path = np.empty(int(width.sum()), dtype=np.uint8)
    last = np.cumsum(width) - 1
    path[last] = col.astype(np.uint8)
    path[last[is_ins] - 1] = INS
    return out.tobytes(), path

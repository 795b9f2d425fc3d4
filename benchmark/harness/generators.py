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


def sv_source(rng, genome, kind: str, L: int, sizes: dict, join_min: int):
    """One read's source before the noise: L bases of genome (uint8 ASCII
    ACGT) carrying kind's event, its size drawn from sizes[kind] (bounds
    inclusive; dup's top is also held to (L - 2000) // 2); a join's two
    halves lie at least join_min apart.

    Copy of scripts/torch_scale_vs_jax.py:sv_read, drawing in its order.
    Returns (kind, the source pieces (start, end, reverse) in read order,
    the bases, each piece's first base in them). An insertion's random
    bases lie between its two pieces and are part of neither."""
    glen = len(genome)

    def piece(a, b):
        return genome[a:b].tobytes()
    lo, hi = sizes.get(kind, (0, 0))
    if kind == "clean":
        p = int(rng.integers(0, glen - L))
        parts = [(p, p + L, False)]
        seq = piece(p, p + L)
    elif kind == "del":
        D = int(rng.integers(lo, hi + 1))
        a = L // 2
        p = int(rng.integers(0, glen - L - D))
        parts = [(p, p + a, False), (p + a + D, p + L + D, False)]
        seq = piece(p, p + a) + piece(p + a + D, p + L + D)
    elif kind == "ins":
        n_ins = int(rng.integers(lo, hi + 1))
        flank = L - n_ins
        a = flank // 2
        p = int(rng.integers(0, glen - flank))
        parts = [(p, p + a, False), (p + a, p + flank, False)]
        seq = (piece(p, p + a) + make_genome(rng, n_ins).tobytes()
               + piece(p + a, p + flank))
        return kind, parts, seq, [0, a + n_ins]
    elif kind == "inv":
        V = int(rng.integers(lo, hi + 1))
        a = (L - V) // 2
        p = int(rng.integers(0, glen - L))
        parts = [(p, p + a, False), (p + a, p + a + V, True),
                 (p + a + V, p + L, False)]
        seq = (piece(p, p + a) + revcomp(piece(p + a, p + a + V))
               + piece(p + a + V, p + L))
    elif kind == "dup":
        U = int(rng.integers(lo, min(hi, (L - 2_000) // 2) + 1))
        a = (L - 2 * U) // 2
        span = L - U
        p = int(rng.integers(0, glen - span))
        parts = [(p, p + a + U, False), (p + a, p + span, False)]
        seq = piece(p, p + a + U) + piece(p + a, p + span)
    elif kind == "join":
        a = L // 2
        p1 = int(rng.integers(0, glen - a))
        p2 = int(rng.integers(0, glen - (L - a)))
        while abs(p2 - p1) < join_min:
            p2 = int(rng.integers(0, glen - (L - a)))
        parts = [(p1, p1 + a, False), (p2, p2 + L - a, False)]
        seq = piece(p1, p1 + a) + piece(p2, p2 + L - a)
    else:
        raise ValueError("unknown event kind %r" % kind)
    starts = np.cumsum([0] + [b - a for a, b, _ in parts[:-1]]).tolist()
    return kind, parts, seq, starts

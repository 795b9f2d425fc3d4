"""The one read generator: it reads a traffic mix's parameters (a JSON file
under benchmark/traffic/) and makes a run's reads from its seed.

Every seed reads the same sizes: the pool is a run of blocks of K reads,
and each block holds one read of each of K strata of the mix's length and
accuracy distributions (their quantiles at (j + 0.5) / K, paired by a fixed
shuffle), in an order drawn from the seed. Where the read lies, its edits
and its strand come from a generator of its own, seeded with the run's
seed and the read's index, so that any read can be made again alone (the
reference does so for the reads it checks).

A read is one piece of the genome through generators.edit(); under
`events` its source is the pieces of generators.sv_source() (a structural
variant), joined and then edited as one. Mix keys:
  source           where the numbers come from
  length           the read's source length, before the edits:
                   {"dist": "lognormal", "mean", "sd", "min", "max"}, or
                   for a later mix {"dist": "uniform" | "loguniform",
                   "lo", "hi"} (ONT's standard reads, say)
  accuracy         {"mean", "sd", "min", "max"}: a normal distribution,
                   clipped; 1 - accuracy edits per source base
  edit_ratio       {"sub", "ins", "del"}: how the edits divide
  reverse_share    the share of reads reverse-complemented
  warmup_batches   warm-up reads, in intake batches of the configuration
                   (drawn as the pool's, named w<i>)
  pool_kbp_per_s   the pool holds this many kbp for each second of the
                   window (twice the fastest rate the cell reached), ...
  pool_max_reads   ... and at most this many reads
  check_share      the share of the pool whose records the reference
                   checks (drawn from the seed), and the longest read
  events           optional: {"kinds": [kind, ...], "sizes": {kind: [lo,
                   hi]}, "join_min"}: each stratum carries one kind, in
                   turn over a fixed shuffle of the strata, so each kind
                   holds K / len(kinds) of them (generators.sv_source's
                   kinds: clean, del, ins, inv, dup, join, with its event
                   sizes in bases, bounds inclusive, and a join's least
                   distance between its halves)
"""

import json
import os
import pickle
import subprocess
import sys
from dataclasses import dataclass
from functools import lru_cache
from statistics import NormalDist

import numpy as np

from . import generators as G

K = 96               # strata a block
DESIGN_SEED = 16     # the fixed shuffle that pairs lengths and accuracies
CHUNK_BASES = 40 * K * 3000   # source bases a child generator makes at a time
POOL, WARM, ORDER, WARM_ORDER, CHECK = 3, 2, 4, 5, 1   # seed streams


def _quantiles(d: dict, u: np.ndarray) -> np.ndarray:
    inv = np.vectorize(NormalDist().inv_cdf)
    dist = d.get("dist", "normal")
    if dist == "uniform":
        return d["lo"] + u * (d["hi"] - d["lo"])
    if dist == "loguniform":
        return np.exp(np.log(d["lo"]) + u * np.log(d["hi"] / d["lo"]))
    if dist == "lognormal":
        s2 = np.log1p((d["sd"] / d["mean"]) ** 2)
        x = np.exp(np.log(d["mean"]) - s2 / 2 + np.sqrt(s2) * inv(u))
    else:
        x = d["mean"] + d["sd"] * inv(u)
    return np.clip(x, d["min"], d["max"])


def design(mix: dict):
    """The block every seed's pool repeats: K (source length, accuracy),
    and under `events` (source length, accuracy, event kind)."""
    d = np.random.default_rng(DESIGN_SEED)
    L = _quantiles(mix["length"], (d.permutation(K) + 0.5) / K)
    acc = _quantiles(mix["accuracy"], (d.permutation(K) + 0.5) / K)
    block = [(int(round(x)), float(a)) for x, a in zip(L, acc)]
    if "events" not in mix:
        return block
    kinds = mix["events"]["kinds"]
    return [s + (kinds[j % len(kinds)],)
            for s, j in zip(block, d.permutation(K))]


def mean_length(mix: dict) -> float:
    return float(np.mean([s[0] for s in design(mix)]))


@dataclass
class Read:
    seq: bytes
    length: int        # the source's length (its pieces, inserted bases)
    reverse: bool
    path: np.ndarray   # the edit path (generators.edit), in source order
    parts: list        # the source pieces (start, end, reverse) in order
    cuts: list         # each piece's first and end path column, or None
    kind: str = None   # the event's kind (None without `events`)


def _seed(seed: int) -> int:
    return seed & (2**64 - 1)


@lru_cache(maxsize=8)
def _order(s: int, stream: int, b: int) -> np.ndarray:
    """The order of block b's strata."""
    return np.random.default_rng([s, stream, b]).permutation(K)


def read_at(mix: dict, seed: int, genome: np.ndarray, i: int,
            warm: bool = False, block=None, with_path=True) -> Read:
    """Pool read i (warm-up read i) of the run seeded with seed (its path
    None unless with_path)."""
    block = block or design(mix)
    s = _seed(seed)
    L, acc, *event = block[_order(s, WARM_ORDER if warm else ORDER,
                                  i // K)[i % K]]
    rng = np.random.default_rng([s, WARM if warm else POOL, i])
    kind = event[0] if event else None
    if kind is None:
        pos = int(rng.integers(0, len(genome) - L))
        src = np.asarray(genome[pos:pos + L])
        parts, starts = [(pos, pos + L, False)], [0]
    else:
        ev = mix["events"]
        kind, parts, bases, starts = G.sv_source(
            rng, genome, kind, L, ev["sizes"], ev["join_min"])
        src = np.frombuffer(bases, dtype=np.uint8)
    err = 1.0 - acc
    r = mix["edit_ratio"]
    tot = float(r["sub"] + r["ins"] + r["del"])
    seq, path = G.edit(rng, src, err * r["ins"] / tot, err * r["del"] / tot,
                       err * r["sub"] / tot, with_path)
    rc = bool(rng.random() < mix["reverse_share"])
    cuts = None
    if path is not None:
        # source base b's own column (its insertions come just before it)
        own = np.flatnonzero(path != G.INS)

        def col(b):
            return int(own[b - 1]) + 1 if b else 0
        cuts = [(col(b0), col(b0 + e - a))
                for b0, (a, e, _) in zip(starts, parts)]
    return Read(G.revcomp(seq) if rc else seq, L, rc, path, parts, cuts,
                kind)


def fasta(name: bytes, seq: bytes) -> bytes:
    return b">" + name + b"\n" + seq + b"\n"


def records(mix: dict, seed: int, genome: np.ndarray, first: int, n: int,
            warm: bool = False):
    """The FASTA records of reads first .. first + n - 1, named w<i> for
    warm-up reads and r<i> for the pool's."""
    block = design(mix)
    p = b"w" if warm else b"r"
    return [fasta(b"%s%d" % (p, i), read_at(mix, seed, genome, i, warm,
                                             block, False).seq)
            for i in range(first, first + n)]


def longest(mix: dict, seed: int, blocks: int):
    """The pool indices of the longest stratum's read in each of the first
    `blocks` blocks."""
    j = int(np.argmax([s[0] for s in design(mix)]))
    return [b * K + int(np.flatnonzero(_order(_seed(seed), ORDER, b) == j)[0])
            for b in range(blocks)]


def _chunk(job):
    mix, seed, npy, first, n, warm = job
    return records(mix, seed, np.load(npy, mmap_mode="r"), first, n, warm)


def chunk_in_child(job):
    """records() of job (mix, seed, genome .npy, first, n, warm) in a child
    Python (`python -m benchmark.harness.gen`), the job as JSON over its
    stdin and the records as a pickle over its stdout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, "-m", "benchmark.harness.gen"],
                       input=json.dumps(job).encode(), capture_output=True,
                       cwd=root)
    if p.returncode:
        raise RuntimeError("read generator failed: %s"
                           % p.stderr.decode(errors="replace")[-2000:])
    return pickle.loads(p.stdout)


def chunk_reads(mix: dict) -> int:
    """The reads a child generator makes at a time: whole blocks of about
    CHUNK_BASES source bases (the feeder is ready once the warm-up reads
    and the first chunk are made)."""
    return K * max(1, round(CHUNK_BASES / (K * mean_length(mix))))


def pool_size(mix: dict, seconds: float) -> int:
    """Reads in the pool: pool_kbp_per_s kbp for each second of the window,
    at the design's mean source length, and at most pool_max_reads."""
    n = int(np.ceil(mix["pool_kbp_per_s"] * 1e3 * seconds
                    / mean_length(mix)))
    return max(1, min(n, mix["pool_max_reads"]))


if __name__ == "__main__":
    sys.stdout.buffer.write(pickle.dumps(_chunk(json.loads(
        sys.stdin.buffer.read())), protocol=pickle.HIGHEST_PROTOCOL))

"""A configuration's reference genome, made once per checkout from its
`genome` entry and kept under benchmark/cache/ (git-ignored): the FASTA
the program maps against, which the program keeps its own caches beside,
and the same bases as a .npy array for the generator and the reference.
Two configurations that state the same genome share one directory.
"""

import os

import numpy as np

from .generators import make_genome


def genome_dir(bench_dir: str, g: dict) -> str:
    return os.path.join(bench_dir, "cache", "genome-%s-%d-%d"
                        % (g["name"], g["length"], g["seed"]))


def _write_fasta(path: str, name: str, g: np.ndarray):
    full = len(g) // 80
    rows = np.empty((full, 81), dtype=np.uint8)
    rows[:, :80] = g[:full * 80].reshape(full, 80)
    rows[:, 80] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(rows.tobytes())
        if len(g) > full * 80:
            f.write(g[full * 80:].tobytes() + b"\n")


def ensure(bench_dir: str, g: dict):
    """(FASTA path, the bases as uint8 ASCII, {name: (first index,
    length)}). The genome is uniform random ACGT: make_genome from
    default_rng(seed)."""
    d = genome_dir(bench_dir, g)
    fa, npy = os.path.join(d, "ref.fa"), os.path.join(d, "genome.npy")
    if not (os.path.exists(fa) and os.path.exists(npy)):
        os.makedirs(d, exist_ok=True)
        bases = make_genome(np.random.default_rng(g["seed"]), g["length"])
        np.save(npy + ".tmp.npy", bases)
        _write_fasta(fa + ".tmp", g["name"], bases)
        os.replace(npy + ".tmp.npy", npy)
        os.replace(fa + ".tmp", fa)
        del bases
    genome = np.load(npy, mmap_mode="r")
    return fa, genome, {g["name"].encode(): (0, len(genome))}

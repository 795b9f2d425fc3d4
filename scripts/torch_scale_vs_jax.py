#!/usr/bin/env python3
"""The port's real-size datasets (chip_smoke.py's phases 4 and 5, the bench
ladder of scripts/torch_bench.py, long SV reads and ultra-long reads on
phase 4's genome) through
the PyTorch/CUDA port (ngmlr_tpu_torch), held read for read and file for
file against the JAX package's SAM digests.

    python3 scripts/torch_scale_vs_jax.py [--device cuda|cpu] [--reads N]
        [--test8] [DATASET...]
    python3 scripts/torch_scale_vs_jax.py --write-jax tests/golden/torch_scale
        [--jobs J] [DATASET...]

The datasets (DATASETS; each made from its seed by the port's generators):
  phase4          chip_smoke.make_dataset(default_rng(1234), 50.0, 256,
                  9000): a 50 Mbp genome, 256 PacBio-like 9 kb reads
  svlong          64 reads of 10-40 kb on phase 4's genome (make_svlong,
                  its own seed): clean, a 1-20 kb deletion, a 0.5-5 kb
                  insertion of random bases, a 1-10 kb inversion, a 1-10 kb
                  tandem duplication, a join of two pieces >= 1 Mbp apart,
                  in turn; fuzz_vs_reference's pacbio_noise at 15%, half
                  reverse-complemented; each read named by its kind and
                  source positions
  ultralong       36 reads of 50-250 kb (log-uniform) on phase 4's genome
                  (make_ultralong, its own seed; scripts/
                  make_ultralong_golden.py's read scale): svlong's kinds
                  in turn at a 1-30 kb deletion, a 0.5-10 kb insertion, a
                  0.4-10 kb inversion, a 1-10 kb tandem duplication;
                  pacbio_noise at a rate drawn in 8-15% a read, half
                  reverse-complemented, named as svlong's. Cut: the genome
                  is 50 Mbp, not a human 3 Gbp (per read, the fill's lane
                  classes and direction planes do not depend on it)
  phase5          chip_smoke.make_dataset(default_rng(2500), 250.0, 256,
                  9000, repeats=True): 250 Mbp with a repeat family, the
                  256 reads outside its copies
  phase5_repeats  the same genome's REPEAT_READS reads inside copies
  bench<S>        scripts/torch_bench.py's prepare_workdir(S) for S in 30,
                  100, 300, 1000, 3000 Mbp: the 576 timed reads (reads.fa;
                  warmup.fa is not held). Written under
                  tempfile.gettempdir() as the bench writes them (TMPDIR),
                  so scripts/torch_bench_prep.py's caches serve both;
                  the others under TMPDIR/ngmlr_scale_vs_jax/, each
                  genome once, the port's caches beside it

The default mode maps each dataset in process under NGMLR_TPU_STRICT=1 on
--device (default cuda; without a card and without --device cpu it raises)
on one Pipeline per genome, twice: with the gate's search, which on the
card must be the device search, and with the other search
(chip_smoke.other_search: the host search on the card), each through
chip_smoke._run_counted (launches equal to the engine's record, no batch
handed back). The native engine must have run (p.native and engine
waves > 0: the runner otherwise drops in silence to the Python path).
Every read's records, and the whole file after @PG, must equal the
committed digests of tests/golden/torch_scale/digests.tsv.gz. --reads N
maps the first N reads of each dataset and holds those reads alone.
Reports each mapping's seconds, launches per kernel, convex_fill's calls
by lane count and class, its largest call's direction planes (B x TpP x L
bytes), the align rows refused by DIRS_CAP, lane_bound_retries and the
peak device memory (align_shapes: the script wraps the fill and the align
dispatch; the package counts neither); a differing read prints the
port's records, the read's
kind and source positions and the JAX package's digest (and, where the
JAX package is importable, its records, from `python -m ngmlr_tpu` on
those reads alone). --test8 also maps tests/data/test_8 once (the
reference binary's ultra-long golden) against its golden, with the same
numbers. Exits 1 on any differing read or broken rule, 2 where a dataset
has no committed digests.

--write-jax DIR runs `JAX_PLATFORMS=cpu python -m ngmlr_tpu -r ref.fa -q
reads.fa -o out.sam -t 1 -x pacbio --skip-write --no-progress` on each
dataset (J processes at a time) and writes DIR/digests.tsv.gz and
DIR/MANIFEST.json (the command, the ngmlr_tpu commit, the generator call,
the genome and reads sha256, the record summary and the JAX process's
seconds and peak RSS); datasets not named keep their committed lines.
"""

import argparse
import collections
import contextlib
import gzip
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

# the generators, the counted run and the other search
import chip_smoke as cs  # noqa: E402
# the bench's datasets (prepare_workdir)
import torch_bench as bench  # noqa: E402
# strip_pg, groups, digest, sam_summary, the digest table, pacbio_noise and
# the JAX subprocess
import torch_fuzz_vs_jax as fuzz  # noqa: E402

SCALE_DIR = os.path.join(REPO, "tests", "golden", "torch_scale")
MANIFEST = "MANIFEST.json"
DIGESTS = "digests.tsv.gz"
PRESET = "pacbio"

SV_SEED = 4040
SV_READS = 64
SV_LEN = (10_000, 40_000)
SV_KINDS = ("clean", "del", "ins", "inv", "dup", "join")
SV_FILE = "svlong.fa"
# event sizes in bases (bounds inclusive) by kind
SV_SIZES = {"del": (1_000, 20_000), "ins": (500, 5_000),
            "inv": (1_000, 10_000), "dup": (1_000, 10_000)}
JOIN_MIN = 1_000_000

# ultra-long reads (scripts/make_ultralong_golden.py's scale) on phase 4's
# genome, svlong's kinds at larger event sizes
UL_SEED = 5050
UL_READS = 36
UL_LEN = (50_000, 250_000)
UL_SIZES = {"del": (1_000, 30_000), "ins": (500, 10_000),
            "inv": (400, 10_000), "dup": (1_000, 10_000)}
UL_ERR = (0.08, 0.15)
UL_FILE = "ultralong.fa"

BENCH_MBP = (30, 100, 300, 1000, 3000)

# the JAX package's added environment by dataset (--write-jax): ultralong's
# one intake batch holds 20,520 subreads, past the 8,192 from which
# ngmlr_tpu's host search_batch rounds the per-subread running maximum of
# its votes (ngmlr_tpu/seed/candidates.py:192-195; ROADMAP section 3), so
# its digests come from the JAX package's device search, which keeps each
# subread apart as the reference's does
JAX_ENV = {"ultralong": {"NGMLR_TPU_DEVICE_SEARCH": "1"}}

# dataset -> (genome, its reads file, the generator call)
DATASETS = {
    "phase4": ("phase4", "reads.fa",
               "chip_smoke.make_dataset(np.random.default_rng(%d), %r, %d, "
               "%d, dir): reads.fa" % (cs.MAPPING_SEED, cs.GENOME_MBP,
                                       cs.N_READS, cs.READ_LEN)),
    "svlong": ("phase4", SV_FILE,
               "scripts/torch_scale_vs_jax.py make_svlong(np.random."
               "default_rng(%d), phase 4's genome): %d reads of %d-%d bp, "
               "kinds %s in turn, pacbio_noise 0.15, on phase4's ref.fa"
               % (SV_SEED, SV_READS, SV_LEN[0], SV_LEN[1],
                  "/".join(SV_KINDS))),
    "ultralong": ("phase4", UL_FILE,
                  "scripts/torch_scale_vs_jax.py make_ultralong(np.random."
                  "default_rng(%d), phase 4's genome): %d reads of %d-%d bp "
                  "(log-uniform), kinds %s in turn, pacbio_noise at a rate "
                  "uniform in %g-%g, on phase4's ref.fa (50 Mbp: the one cut "
                  "from a 3 Gbp human genome)"
                  % (UL_SEED, UL_READS, UL_LEN[0], UL_LEN[1],
                     "/".join(SV_KINDS), UL_ERR[0], UL_ERR[1])),
    "phase5": ("phase5", "reads.fa",
               "chip_smoke.make_dataset(np.random.default_rng(%d), %r, %d, "
               "%d, dir, repeats=True): reads.fa"
               % (cs.LARGE_SEED, cs.LARGE_GENOME_MBP, cs.N_READS,
                  cs.READ_LEN)),
    "phase5_repeats": ("phase5", "repeat_reads.fa",
                       "chip_smoke.make_dataset(np.random.default_rng(%d), "
                       "%r, %d, %d, dir, repeats=True): repeat_reads.fa"
                       % (cs.LARGE_SEED, cs.LARGE_GENOME_MBP, cs.N_READS,
                          cs.READ_LEN)),
}
for _s in BENCH_MBP:
    DATASETS["bench%d" % _s] = (
        "bench%d" % _s, "reads.fa",
        "scripts/torch_bench.py prepare_workdir(%r): reads.fa (the 576 "
        "timed reads)" % float(_s))

# convex_fill's lane classes (csrc/convex_fill.cu fill_r): lanes a thread
LANE_CLASSES = ((768, "R=2"), (2048, "R=4"), (4096, "R=8"),
                (1 << 62, "wide"))


# ---------------------------------------------------------------------------
# the datasets

def sv_read(rng, genome, kind, L, sizes):
    """One read's source before the noise: L bases of genome (ASCII ACGT)
    carrying kind's event, its size drawn from sizes[kind] (bounds
    inclusive; dup's top is also held to (L - 2000) // 2). Returns (kind,
    with ins's length, source pieces (start, end), bases)."""
    glen = len(genome)

    def piece(a, b):
        return genome[a:b].tobytes()
    lo, hi = sizes.get(kind, (0, 0))
    if kind == "clean":
        p = int(rng.integers(0, glen - L))
        parts = [(p, p + L)]
        seq = piece(p, p + L)
    elif kind == "del":
        D = int(rng.integers(lo, hi + 1))
        a = L // 2
        p = int(rng.integers(0, glen - L - D))
        parts = [(p, p + a), (p + a + D, p + L + D)]
        seq = piece(*parts[0]) + piece(*parts[1])
    elif kind == "ins":
        n_ins = int(rng.integers(lo, hi + 1))
        flank = L - n_ins
        a = flank // 2
        p = int(rng.integers(0, glen - flank))
        parts = [(p, p + a), (p + a, p + flank)]
        ins = cs.make_genome(rng, n_ins).tobytes()
        seq = piece(*parts[0]) + ins + piece(*parts[1])
        kind = "ins%d" % n_ins
    elif kind == "inv":
        V = int(rng.integers(lo, hi + 1))
        a = (L - V) // 2
        p = int(rng.integers(0, glen - L))
        parts = [(p, p + a), (p + a, p + a + V), (p + a + V, p + L)]
        seq = (piece(*parts[0]) + fuzz.revcomp(piece(*parts[1]))
               + piece(*parts[2]))
    elif kind == "dup":
        U = int(rng.integers(lo, min(hi, (L - 2_000) // 2) + 1))
        a = (L - 2 * U) // 2
        span = L - U
        p = int(rng.integers(0, glen - span))
        parts = [(p, p + a + U), (p + a, p + span)]
        seq = piece(*parts[0]) + piece(*parts[1])
    else:                                   # a distant join
        a = L // 2
        p1 = int(rng.integers(0, glen - a))
        p2 = int(rng.integers(0, glen - (L - a)))
        while abs(p2 - p1) < JOIN_MIN:
            p2 = int(rng.integers(0, glen - (L - a)))
        parts = [(p1, p1 + a), (p2, p2 + L - a)]
        seq = piece(*parts[0]) + piece(*parts[1])
    return kind, parts, seq


def write_sv_read(f, rng, prefix, i, kind, parts, seq, err):
    """seq through the fuzz's pacbio_noise at err, reverse-complemented
    with probability 1/2, written to f as a FASTA record named by the
    read's number, kind, source pieces (start-end, 0-based, end exclusive)
    and strand."""
    seq = fuzz.pacbio_noise(rng, seq, err)
    rc = rng.random() < 0.5
    if rc:
        seq = fuzz.revcomp(seq)
    name = "%s%d_%s_%s_%s" % (prefix, i, kind, "_".join(
        "%d-%d" % ab for ab in parts), "rev" if rc else "fwd")
    f.write(b">" + name.encode() + b"\n")
    for j in range(0, len(seq), 80):
        f.write(seq[j:j + 80] + b"\n")


def make_svlong(rng, genome, path):
    """SV_READS reads of SV_LEN bases (before the noise) on genome (ASCII
    ACGT), the kinds of SV_KINDS in turn (event sizes SV_SIZES), each
    through the fuzz's pacbio_noise at 15% and reverse-complemented with
    probability 1/2, written to path as FASTA (write_sv_read's names)."""
    with open(path, "wb") as f:
        for i in range(SV_READS):
            kind = SV_KINDS[i % len(SV_KINDS)]
            L = int(rng.integers(SV_LEN[0], SV_LEN[1] + 1))
            write_sv_read(f, rng, "sv", i,
                          *sv_read(rng, genome, kind, L, SV_SIZES), 0.15)
    return path


def make_ultralong(rng, genome, path):
    """UL_READS ultra-long reads on genome (ASCII ACGT): each read's length
    before the noise log-uniform in UL_LEN, the kinds of SV_KINDS in turn
    (event sizes UL_SIZES), each through the fuzz's pacbio_noise at a rate
    drawn uniform in UL_ERR and reverse-complemented with probability 1/2,
    written to path as FASTA (write_sv_read's names)."""
    lo, hi = np.log(UL_LEN[0]), np.log(UL_LEN[1])
    with open(path, "wb") as f:
        for i in range(UL_READS):
            kind = SV_KINDS[i % len(SV_KINDS)]
            L = int(np.exp(rng.uniform(lo, hi)))
            kind, parts, seq = sv_read(rng, genome, kind, L, UL_SIZES)
            err = float(rng.uniform(*UL_ERR))
            write_sv_read(f, rng, "ul", i, kind, parts, seq, err)
    return path


def phase4_genome():
    """Phase 4's genome (ASCII ACGT): make_dataset's first draw."""
    return cs.make_genome(np.random.default_rng(cs.MAPPING_SEED),
                          int(cs.GENOME_MBP * 1e6))


def write_svlong(path, genome=None):
    """svlong's reads file at path, on phase 4's genome."""
    genome = phase4_genome() if genome is None else genome
    return make_svlong(np.random.default_rng(SV_SEED), genome, path)


def write_ultralong(path, genome=None):
    """ultralong's reads file at path, on phase 4's genome."""
    genome = phase4_genome() if genome is None else genome
    return make_ultralong(np.random.default_rng(UL_SEED), genome, path)


# phase 4's genome's reads files written here, beside make_dataset's
PHASE4_EXTRA = ((SV_FILE, write_svlong), (UL_FILE, write_ultralong))


def genome_files(genome, root):
    """Writes a genome's FASTAs once (phase 4's and 5's under root/<genome>,
    the bench's where scripts/torch_bench.py keeps them) and returns
    {"ref": its path, reads file name: its path}."""
    if genome.startswith("bench"):
        if (bench.N_READS, bench.N_WARMUP, bench.READ_LEN) != (576, 16, 9000):
            raise ValueError("BENCH_READS, BENCH_WARMUP or BENCH_READ_LEN is "
                             "set: the bench datasets are the defaults'")
        _, ref, reads, _ = bench.prepare_workdir(float(genome[5:]))
        return {"ref": ref, "reads.fa": reads}
    d = os.path.join(root, genome)
    done = os.path.join(d, "done")
    if not os.path.exists(done):
        if genome == "phase4":
            cs.make_dataset(np.random.default_rng(cs.MAPPING_SEED),
                            cs.GENOME_MBP, cs.N_READS, cs.READ_LEN, d)
        else:
            cs.make_dataset(np.random.default_rng(cs.LARGE_SEED),
                            cs.LARGE_GENOME_MBP, cs.N_READS, cs.READ_LEN, d,
                            repeats=True)
        open(done, "w").close()
    if genome == "phase4":
        todo = [(f, w) for f, w in PHASE4_EXTRA
                if not os.path.exists(os.path.join(d, f))]
        g = phase4_genome() if todo else None
        for fname, write in todo:
            path = os.path.join(d, fname)
            write(path + ".part", g)
            os.replace(path + ".part", path)
    files = {"ref": os.path.join(d, "ref.fa")}
    for g, reads, _ in DATASETS.values():
        if g == genome:
            files[reads] = os.path.join(d, reads)
    return files


def by_genome(names):
    """{genome: [its datasets among names, in DATASETS order]}."""
    out = {}
    for n in DATASETS:
        if n in names:
            out.setdefault(DATASETS[n][0], []).append(n)
    return out


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def read_names(reads_p):
    """The read names of a FASTA file, in file order."""
    with open(reads_p, "rb") as f:
        return [l[1:].split()[0] for l in f if l.startswith(b">")]


def head_reads(reads_p, n, out_p):
    """The first n records of a FASTA file, written to out_p."""
    with open(reads_p, "rb") as f, open(out_p, "wb") as o:
        seen = 0
        for line in f:
            seen += line.startswith(b">")
            if seen > n:
                break
            o.write(line)
    return out_p


def pick_reads(reads_p, names, out_p):
    """The records of names from a FASTA file, written to out_p."""
    keep, on = set(names), False
    with open(reads_p, "rb") as f, open(out_p, "wb") as o:
        for line in f:
            if line.startswith(b">"):
                on = line[1:].split()[0] in keep
            if on:
                o.write(line)
    return out_p


def describe(name):
    """A read's kind and source positions, from its name."""
    f = name.decode().split("_")
    if f[0] == "read":
        return "pacbio 15%%, source %s" % f[2]
    if f[0] == "repeat":
        return "inside a repeat copy, source %s" % f[3]
    return "%s, source %s, %s strand" % (f[1], " + ".join(f[2:-1]), f[-1])


# ---------------------------------------------------------------------------
# the committed digests

def load_manifest(scale_dir=SCALE_DIR):
    path = os.path.join(scale_dir, MANIFEST)
    if not os.path.exists(path):
        return {"datasets": {}}
    with open(path) as f:
        return json.load(f)


def load_digests(scale_dir=SCALE_DIR):
    """{dataset: {read name: sha256}}, the whole file's under "*"."""
    out = {}
    path = os.path.join(scale_dir, DIGESTS)
    if os.path.exists(path):
        with gzip.open(path, "rt") as f:
            for line in f:
                _, ds, read, h = line.split()
                out.setdefault(ds, {})[read] = h
    return out


def digest_lines(dataset, sam):
    """The digest table's lines of one dataset's SAM (@PG stripped)."""
    _, by_read, order = fuzz.groups(sam)
    lines = ["%s\t%s\t*\t%s\n" % (PRESET, dataset,
                                  hashlib.sha256(sam).hexdigest())]
    lines += ["%s\t%s\t%s\t%s\n" % (PRESET, dataset, q.decode(),
                                    fuzz.digest(by_read[q])) for q in order]
    return lines


def hold(want, sam, names, whole=True):
    """The port's SAM (@PG stripped) against a dataset's digests: every read
    of names by its records, and with whole the file. Returns {"reads",
    "identical", "diff" (names, and records of reads not in names),
    "file_identical" (None without whole)}."""
    _, got, _ = fuzz.groups(sam)
    diff = [q for q in names
            if fuzz.digest(got.get(q, [])) != want.get(q.decode())]
    diff += sorted(set(got) - set(names))
    return {"reads": len(names), "identical": len(names) - len(diff),
            "diff": diff,
            "file_identical": (hashlib.sha256(sam).hexdigest() == want["*"]
                               if whole else None)}


def diff_text(dataset, want, sam, diff, jax_sam=None):
    """The first five differing reads: the port's records, the read's kind
    and source positions, the JAX package's digest and, given its SAM, its
    records."""
    _, got, _ = fuzz.groups(sam)
    _, jax, _ = fuzz.groups(jax_sam) if jax_sam is not None \
        else (None, {}, None)
    out = []
    for q in diff[:5]:
        out.append("DIFF %s %s (%s): jax sha256 %s" % (
            dataset, q.decode(), describe(q), want.get(q.decode())))
        out += ["  port: %s" % l[:300].decode(errors="replace")
                for l in got.get(q) or [b"<no record>"]]
        out += ["  jax:  %s" % l[:300].decode(errors="replace")
                for l in jax.get(q, [])]
    return "".join(l + "\n" for l in out)


# ---------------------------------------------------------------------------
# the JAX package's side

def jax_run(dataset, files, out_dir):
    """One dataset through `python -m ngmlr_tpu` on the CPU. Returns (SAM
    with @PG stripped, the child's seconds and peak RSS)."""
    _, reads, _ = DATASETS[dataset]
    out = os.path.join(out_dir, dataset + ".sam")
    cost = fuzz.run_jax_cli(files["ref"], files[reads], out, PRESET, dataset,
                            JAX_ENV.get(dataset))
    with open(out, "rb") as f:
        sam = fuzz.strip_pg(f.read())
    os.remove(out)
    return sam, cost


def jax_records(dataset, ref, reads_p, names, workdir):
    """The JAX package's SAM (@PG stripped) of dataset's reads names alone,
    or None where the JAX package cannot run here."""
    if importlib.util.find_spec("jax") is None:
        return None
    sub = pick_reads(reads_p, names, os.path.join(workdir, "diff_reads.fa"))
    out = os.path.join(workdir, "diff_jax.sam")
    fuzz.run_jax_cli(ref, sub, out, PRESET, "the differing reads",
                     JAX_ENV.get(dataset))
    with open(out, "rb") as f:
        return fuzz.strip_pg(f.read())


def write_jax(out_dir, jobs, names, root):
    """Writes the digests and manifest of names, keeping the other datasets'
    committed lines and entries."""
    os.makedirs(out_dir, exist_ok=True)
    commit = fuzz.git_commit()
    manifest = load_manifest(out_dir)
    kept = []
    path = os.path.join(out_dir, DIGESTS)
    if os.path.exists(path):
        with gzip.open(path, "rt") as f:
            kept = [l for l in f if l.split("\t")[1] not in names]
    jax_cmd = ("%sJAX_PLATFORMS=cpu python -m ngmlr_tpu -r ref.fa -q "
               "reads.fa -o out.sam -t 1 -x %s --skip-write --no-progress, "
               "@PG stripped")
    t0 = time.perf_counter()
    work = []
    for genome, sets in by_genome(names).items():
        t1 = time.perf_counter()
        files = genome_files(genome, root)
        gen_s = time.perf_counter() - t1
        work += [(n, files, gen_s) for n in sets]
    print("datasets generated in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    os.makedirs(root, exist_ok=True)

    def one(item):
        n, files, gen_s = item
        with tempfile.TemporaryDirectory(prefix="ngmlr_scale_jax_",
                                         dir=root) as d:
            sam, cost = jax_run(n, files, d)
        print("%s: %s" % (n, json.dumps(cost)), flush=True)
        return n, files, gen_s, sam, cost
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        done = list(pool.map(one, work))
    lines = list(kept)
    for n, files, gen_s, sam, cost in done:
        lines += digest_lines(n, sam)
        genome, reads, call = DATASETS[n]
        manifest["datasets"][n] = {
            "generator": call, "genome": genome,
            "genome_sha256": sha256_file(files["ref"]),
            "reads_sha256": sha256_file(files[reads]),
            "reads": len(read_names(files[reads])),
            "command": jax_cmd % ("".join(
                "%s=%s " % kv for kv in JAX_ENV.get(n, {}).items()), PRESET),
            "ngmlr_tpu_commit": commit,
            "summary": fuzz.sam_summary(sam),
            "generate_s": gen_s,
            "jax_wall_s": cost["wall_s"], "jax_cpu_s": cost["cpu_s"],
            "jax_peak_rss_gb": cost["peak_rss_gb"],
            "jax_host": "%d CPUs, JAX on the CPU" % os.cpu_count()}
    order = {n: i for i, n in enumerate(DATASETS)}
    lines.sort(key=lambda l: order[l.split("\t")[1]])
    with open(path, "wb") as f:
        f.write(gzip.compress("".join(lines).encode(), 9, mtime=0))
    manifest.update({
        "written_by": "python3 scripts/torch_scale_vs_jax.py --write-jax "
                      "tests/golden/torch_scale [DATASET...] (on the CPU)",
        "digests": {"file": DIGESTS, "line": "preset dataset read sha256 "
                    "(over the read's records joined by newlines in file "
                    "order; read * is the whole file's, @PG stripped)"}})
    manifest["datasets"] = {n: manifest["datasets"][n] for n in DATASETS
                            if n in manifest["datasets"]}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print("wrote the digests of %s to %s in %.1f s (%d jobs)"
          % (", ".join(sorted(names, key=order.get)), out_dir,
             time.perf_counter() - t0, jobs), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the port's side

def port_pipeline(ref, device="cuda"):
    """The port's Pipeline for ref with -x pacbio and the default search gate
    (NGMLR_TPU_DEVICE_SEARCH as the environment holds it), caches beside
    the FASTA. Returns (pipeline, setup s)."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    argv = ["-r", ref, "-x", PRESET]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    p = Pipeline(config_from_args(args, argv), ref, use_cache=True,
                 device=device)
    if p.ctx.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def lane_class(L):
    return next(name for top, name in LANE_CLASSES if L <= top)


@contextlib.contextmanager
def fill_lanes():
    """Counts convex_fill's calls by lane count, and the largest call's
    direction planes (B x TpP x L u8), while inside (a stand-in for the
    wrapper, as chip_smoke.recorded_shapes). Yields {"lanes": Counter,
    "dirs_max": [B, TpP, L] of the largest call}."""
    from ngmlr_tpu_torch.ops import kernels as K
    seen = {"lanes": collections.Counter(), "dirs_max": [0, 0, 0]}
    orig = K.convex_fill
    lock = threading.Lock()

    def cf(genome, readbuf, pk, params, ymin, ymax, L):
        shape = [*ymin.shape, L]
        with lock:
            seen["lanes"][L] += 1
            if np.prod(shape) > np.prod(seen["dirs_max"]):
                seen["dirs_max"] = shape
        return orig(genome, readbuf, pk, params, ymin, ymax, L)
    K.convex_fill = cf
    try:
        yield seen
    finally:
        K.convex_fill = orig


@contextlib.contextmanager
def align_refusals():
    """Records, while inside, the align rows that DeviceContext's
    align_dispatch_pk refused (a problem whose solo launch's direction
    planes pass DIRS_CAP fails, as the reference's maxMatrixSizeMB
    refusal), by wrapping the method as fill_lanes wraps the fill. Yields
    the list of [W, qlen, corridor width] of each refused row."""
    from ngmlr_tpu_torch.ops.device_engine import DeviceContext
    seen = []
    orig = DeviceContext.align_dispatch_pk
    lock = threading.Lock()

    def dispatch(self, pk_all, params, readbuf=None, conservative_L=False):
        pend = orig(self, pk_all, params, readbuf, conservative_L)
        if pend is not None:
            with lock:
                seen.extend([int(pk_all[i, 3]) & ((1 << 28) - 1),
                             int(pk_all[i, 5]), int(pk_all[i, 9])]
                            for i in pend[4])
        return pend
    DeviceContext.align_dispatch_pk = dispatch
    try:
        yield seen
    finally:
        DeviceContext.align_dispatch_pk = orig


@contextlib.contextmanager
def align_shapes(device):
    """fill_lanes and align_refusals together, with the peak device memory
    (torch.cuda.max_memory_allocated after reset_peak_memory_stats; None
    off the card). Yields a dict that holds, after the block, {"fill_lanes"
    (lanes: calls), "lane_classes", "dirs_max_shape", "dirs_max_bytes",
    "dirs_cap_refused" (rows), "refused_rows", "peak_device_bytes"}."""
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {}
    with fill_lanes() as fill, align_refusals() as refused:
        yield out
    classes = collections.Counter()
    for L, n in fill["lanes"].items():
        classes[lane_class(L)] += n
    out.update(fill_lanes=dict(sorted(fill["lanes"].items())),
               lane_classes=dict(classes), dirs_max_shape=fill["dirs_max"],
               dirs_max_bytes=int(np.prod(fill["dirs_max"])),
               dirs_cap_refused=len(refused), refused_rows=refused,
               peak_device_bytes=(torch.cuda.max_memory_allocated()
                                  if cuda else None))


def map_once(tag, p, reads_p):
    """One counted mapping (chip_smoke._run_counted) under
    NGMLR_TPU_STRICT=1, with align_shapes' numbers. Returns {sam (@PG
    stripped), map_s, launches, stats} and align_shapes' keys."""
    old = cs._env("NGMLR_TPU_STRICT", "1")
    try:
        with align_shapes(p.ctx.device) as shapes:
            out, t_run, launches, stats = cs._run_counted(tag, p, reads_p)
    finally:
        cs._env("NGMLR_TPU_STRICT", old)
    return {"sam": fuzz.strip_pg(out), "map_s": t_run, "launches": launches,
            "stats": stats, **shapes}


def check_native(tag, p, run):
    """The native engine built and ran waves in this mapping."""
    cs.check(p.native is not None, "%s: the native engine did not build "
             "(the Python assembly path mapped)" % tag)
    cs.check(run["stats"].get("engine_waves", 0) > 0,
             "%s: the native engine ran no wave" % tag)


def map_both(p, dataset, reads_p, want, names=None):
    """A dataset's reads on p twice (the gate's search, which on the card
    must be the device search, then chip_smoke.other_search), each mapping
    held to want read for read and, unless names cuts the file, whole.
    Returns {mapping: its record} and the failures."""
    whole = names is None
    names = read_names(reads_p) if whole else names
    cs.check(p.ctx.device.type != "cuda" or p.dev_search is not None,
             "%s: the gate left the device search off on the card" % dataset)
    runs, failures = {}, []
    gate = "device" if p.dev_search is not None else "host"
    for name, ctx in (("gate", contextlib.nullcontext((gate, None))),
                      ("other search", cs.other_search(p))):
        tag = "%s, %s" % (dataset, name)
        with ctx as (search, _):
            run = map_once(tag, p, reads_p)
        check_native(tag, p, run)
        held = hold(want, run["sam"], names, whole)
        run.update(held, search=search)
        runs[name] = run
        if held["diff"] or held["file_identical"] is False:
            failures.append("%s: %d reads differ (%s), file identical %s"
                            % (tag, len(held["diff"]), b", ".join(
                                held["diff"][:5]).decode(),
                               held["file_identical"]))
    return runs, failures


def report(run, setup_s):
    keep = ("search", "reads", "identical", "file_identical", "map_s",
            "launches", "lane_classes", "fill_lanes", "dirs_max_shape",
            "dirs_max_bytes", "dirs_cap_refused", "refused_rows",
            "peak_device_bytes")
    rec = {k: run[k] for k in keep}
    rec.update(diff=len(run["diff"]), setup_s=setup_s,
               lane_bound_retries=run["stats"].get("lane_bound_retries", 0),
               engine_waves=run["stats"].get("engine_waves", 0))
    return rec


def scale_datasets(names, device, n_reads, root, digests):
    """Maps each dataset of names both ways on one Pipeline per genome and
    holds it to digests. Returns (exit code, {dataset: {mapping: its
    numbers}})."""
    from ngmlr_tpu_torch.ops import device_engine
    failed, records = False, {}
    t_all = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    for genome, sets in by_genome(names).items():
        files = genome_files(genome, root)
        p, setup_s = port_pipeline(files["ref"], device)
        print("%s: Pipeline on %s in %.2f s" % (genome, p.ctx.device,
                                                setup_s), flush=True)
        with tempfile.TemporaryDirectory(prefix="ngmlr_scale_",
                                         dir=root) as d:
            for n in sets:
                reads_p = files[DATASETS[n][1]]
                names_n = None
                if n_reads:
                    reads_p = head_reads(reads_p, n_reads,
                                         os.path.join(d, n + ".fa"))
                    names_n = read_names(reads_p)
                t0 = time.perf_counter()
                try:
                    runs, failures = map_both(p, n, reads_p, digests[n],
                                              names_n)
                except cs.PhaseError as e:
                    runs, failures = {}, [str(e)]
                records[n] = {m: report(r, setup_s)
                              for m, r in runs.items()}
                for m, r in runs.items():
                    print("dataset=%s %s: %s" % (n, m, json.dumps(
                        records[n][m])), flush=True)
                    if r["diff"]:
                        jax = (jax_records(n, files["ref"], reads_p,
                                           r["diff"], d)
                               if device == "cpu" else None)
                        sys.stdout.write(diff_text(n, digests[n], r["sam"],
                                                   r["diff"], jax))
                print("dataset=%s: %.1f s" % (n, time.perf_counter() - t0),
                      flush=True)
                for f in failures:
                    print("FAIL: %s" % f, flush=True)
                failed |= bool(failures)
        device_engine.set_current(None)
        del p
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    n_held = sum(r["identical"] for d in records.values()
                 for r in d.values())
    n_all = sum(r["reads"] for d in records.values() for r in d.values())
    print("scale: %d datasets, %d mappings, reads held %d of %d, %.1f s"
          % (len(records), sum(len(d) for d in records.values()), n_held,
             n_all, time.perf_counter() - t_all), flush=True)
    return (1 if failed else 0), records


def test8_lanes(device):
    """tests/data/test_8 (the reference binary's ultra-long golden: 13
    reads of 50-250 kb on a 3 Mb genome) mapped once on device with the
    gate's search (chip_smoke._map), each read the reference binary
    survived equal to tests/golden/test_8_ultralong.sam, with
    align_shapes' numbers. Returns (its record, whether every read held)."""
    tag, argv, golden, _ = next(r for r in cs._golden_runs()
                                if r[0].startswith("test_8"))
    with align_shapes(device) as shapes:
        p, out, setup_s, map_s, launches = cs._map(argv, device=device)
    with open(os.path.join(cs.GOLDEN, golden), "rb") as f:
        want = cs._per_read(f.read(), False)
    ours = cs._per_read(out, False)
    bad = [q for q, recs in want.items() if ours.get(q) != recs]
    rec = {"reads": len(want), "identical": len(want) - len(bad),
           "diff": bad, "setup_s": setup_s,
           "map_s": map_s, "launches": launches,
           "lane_bound_retries": p.ctx.stats.get("lane_bound_retries", 0),
           **shapes}
    return rec, not bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("datasets", nargs="*", metavar="DATASET",
                    help="any of %s (default: every committed one)"
                         % ", ".join(DATASETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reads", type=int, default=None,
                    help="map only the first N reads of each dataset")
    ap.add_argument("--test8", action="store_true",
                    help="also map tests/data/test_8 against its golden and "
                         "report its lane classes")
    ap.add_argument("--write-jax", metavar="DIR",
                    help="write the digests (needs the JAX package)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="JAX processes at a time for --write-jax")
    args = ap.parse_args(argv)
    unknown = set(args.datasets) - set(DATASETS)
    if unknown:
        ap.error("unknown datasets: %s" % ", ".join(sorted(unknown)))
    root = os.path.join(tempfile.gettempdir(), "ngmlr_scale_vs_jax")
    if args.write_jax:
        return write_jax(args.write_jax, args.jobs,
                         set(args.datasets or DATASETS), root)
    digests = load_digests()
    names = args.datasets or [n for n in DATASETS if n in digests]
    missing = [n for n in names if n not in digests]
    if missing:
        print("FAIL: no committed digests for %s (write them on the CPU "
              "with --write-jax tests/golden/torch_scale %s)"
              % (", ".join(missing), " ".join(missing)))
        return 2
    code = scale_datasets(set(names), args.device, args.reads, root,
                          digests)[0]
    if args.test8:
        rec, held = test8_lanes(args.device)
        print("golden=test_8: %s" % json.dumps(rec), flush=True)
        if not held:
            print("FAIL: test_8: %d reads differ from its golden"
                  % len(rec["diff"]), flush=True)
            code = 1
    return code


if __name__ == "__main__":
    sys.exit(main())

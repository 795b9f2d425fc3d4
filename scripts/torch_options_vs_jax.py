#!/usr/bin/env python3
"""The CLI's option surface over FASTQ input through the PyTorch/CUDA port
(ngmlr_tpu_torch), held read for read and file for file against the JAX
package's SAM digests.

    python3 scripts/torch_options_vs_jax.py [--device cuda|cpu] [--reads N]
        [--dataset D] [SET...]
    python3 scripts/torch_options_vs_jax.py --write-jax
        tests/golden/torch_options [--jobs J] [SET[/DATASET]...]

The datasets (DATASETS; made from their seeds by the generators of
scripts/torch_fuzz_vs_jax.py, chip_smoke.py and scripts/
torch_scale_vs_jax.py, written under TMPDIR/ngmlr_options_vs_jax/):
  fuzzq      seed 501 of torch_fuzz_vs_jax.make_dataset (150 SV-rich reads
             on the 500 kbp two-chromosome genome), written as
             reads.fastq.gz; each read's per-base qualities are drawn from
             the same numpy generator after the reads (draw_quals), so the
             sequences are make_dataset's bytes
  phase4q    chip_smoke.make_dataset(default_rng(1234), 50.0, 256, 9000):
             phase 4's 50 Mbp genome and its 256 reads, as FASTQ.gz with
             qualities drawn the same way
  ultralong  scripts/torch_scale_vs_jax.py's ultralong (36 reads of
             50-250 kb on phase 4's genome) as committed, FASTA

The option sets (OPTION_SETS: name -> (argv, datasets)) are argv suffixes
that go through each package's own CLI parser and config_from_args; the
readgroup set writes its SAM with -o *.sam.gz (the CLI's gzip writer) and
is compared decompressed.

The default mode maps each (set, dataset) in process under
NGMLR_TPU_STRICT=1 on --device (default cuda; without a card and without
--device cpu it raises), on one Pipeline per (set, dataset), each mapping
through chip_smoke._run_counted (launches equal to the engine's record, no
batch handed back by the device search): the gate's search, which on the
card must be the device search for every set but sub512, whose subreads
pass the device search's SL slots so that the gate keeps the host search;
then the other search (chip_smoke.other_search), or for sub512 the host
search again at SMALL_BATCH-read intake batches; on fuzzq also the gate's
search at SMALL_BATCH-read batches (several batches in flight: wave depth
2 on the card, the reversed QUAL strings written in another thread
interleaving); for readgroup also the port's CLI main in process, writing
-o <dir>/out.sam.gz. Every read's records, and the whole file after @PG,
must equal the committed digests (tests/golden/torch_options). Reports
each mapping's seconds, launches by kernel, score_fill's Rp x Qp buckets,
convex_fill's lane classes and the peak device memory; for k15 the
candidate table's build seconds and the host's peak RSS; for bamfix the
records of 65,536 CIGAR ops or more and the largest op count. With --reads
N only the first N reads of each dataset are mapped and held.

--write-jax DIR runs `JAX_PLATFORMS=cpu python -m ngmlr_tpu -r ref -q
reads -o out.sam -t 1 --skip-write --no-progress <set's argv>` for every
(set, dataset) named (default all; J processes at a time) and writes
DIR/digests.tsv.gz (set, dataset, read, sha256; read * is the file's),
fuzzq's default and scoring SAMs in full (gzip -9, @PG stripped) and
DIR/MANIFEST.json (each command with its environment, wall and CPU
seconds, peak RSS, the ngmlr_tpu commit; each dataset's generator and the
sha256 of its reads' bytes; the cross-checks). Lines of (set, dataset)
pairs not named are kept. Two cross-checks must hold: fuzzq under default
equals seed 501's committed SAM (tests/golden/torch_fuzz) read for read
once QUAL is '*', and phase4q under default equals phase 4's committed
digests (tests/golden/torch_scale) the same way.
"""

import argparse
import collections
import contextlib
import gzip
import hashlib
import json
import os
import re
import resource
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

# phase 4's generator, the counted run and the other search
import chip_smoke as cs  # noqa: E402
# fuzzq's generator, SAM helpers and the JAX subprocess
import torch_fuzz_vs_jax as fuzz  # noqa: E402
# ultralong, the digest hold and the fill's lane classes
import torch_scale_vs_jax as scale  # noqa: E402

OPTIONS_DIR = os.path.join(REPO, "tests", "golden", "torch_options")
MANIFEST = "MANIFEST.json"
DIGESTS = "digests.tsv.gz"

FUZZQ_SEED = 501
# Phred 2-40, PacBio-like: a read's mean quality uniform in QUAL_MEAN, its
# bases normal around it (QUAL_SD), rounded and clipped
QUAL_RANGE = (2, 40)
QUAL_MEAN = (8.0, 24.0)
QUAL_SD = 7.0
SMALL_BATCH = fuzz.SMALL_BATCH
# the readgroup set's output: the placeholder stands for the mapping's
# directory
OUT_GZ = "<dir>/out.sam.gz"
BAM_FIX_OPS = 0x10000

DATASETS = {
    "fuzzq": "torch_fuzz_vs_jax.make_dataset(np.random.default_rng(%d), "
             "dir, %d), its reads as FASTQ.gz with draw_quals from the same "
             "generator after the reads" % (FUZZQ_SEED, fuzz.N_READS),
    "phase4q": "chip_smoke.make_dataset(np.random.default_rng(%d), %r, %d, "
               "%d, dir), its reads as FASTQ.gz with draw_quals from the "
               "same generator after the reads"
               % (cs.MAPPING_SEED, cs.GENOME_MBP, cs.N_READS, cs.READ_LEN),
    "ultralong": "scripts/torch_scale_vs_jax.py's ultralong (FASTA), on "
                 "phase 4's genome",
}

BOTH = ("fuzzq", "phase4q")
# name -> (argv suffix, datasets)
OPTION_SETS = {
    "default": ((), BOTH),
    "ont": (("-x", "ont"), ("fuzzq",)),
    "scoring": (("--match", "1", "--mismatch", "-4", "--gap-open", "-6",
                 "--gap-extend-max", "-4", "--gap-extend-min", "-0.5",
                 "--gap-decay", "0.1"), BOTH),
    "affine": (("--gap-decay", "0"), ("fuzzq",)),
    "fractional": (("--match", "1.5", "--mismatch", "-3.5", "--gap-open",
                    "-4.5", "--gap-decay", "0.07"), BOTH),
    "k11": (("-k", "11", "--kmer-skip", "1"), BOTH),
    "k15": (("-k", "15", "--kmer-skip", "3"), BOTH),
    "bins": (("--bin-size", "2"), BOTH),
    "sub128": (("--subread-length", "128", "--subread-corridor", "20"),
               BOTH),
    "sub512": (("--subread-length", "512", "--subread-corridor", "80"),
               BOTH),
    "strict": (("-i", "0.85", "-R", "0.5", "-s", "0.55", "--max-segments",
                "3"), BOTH),
    "nosplit": (("--no-lowqualitysplit", "--no-smallinv"), ("fuzzq",)),
    "readgroup": (("--rg-id", "run1", "--rg-sm", "NA12878", "--rg-lb",
                   "lib1", "--rg-pl", "PACBIO", "--rg-pu", "u1", "-o",
                   OUT_GZ), ("fuzzq",)),
    "bamfix": (("--bam-fix",), ("ultralong",)),
}
# the set whose gate keeps the host search on the card: its subreads are
# longer than the device search's SL slots
HOST_GATE = "sub512"

# what --write-jax adds to the JAX package's run of a (set, dataset): its
# environment, argv, and why; where its host search_batch is not exact
# (past 8,192 subreads an intake batch, ngmlr_tpu/seed/candidates.py:
# 192-195, ROADMAP section 3)
JAX_EXTRA = {
    ("sub128", "phase4q"): (
        {}, ("--batch-reads", "100"),
        "128 bp subreads make about 70 subreads of a 9 kb read, so a "
        "192-read batch passes the 8,192 subreads from which ngmlr_tpu's "
        "host search_batch rounds the per-subread running maximum of its "
        "votes. Its device search (NGMLR_TPU_DEVICE_SEARCH=1) keeps them "
        "apart, but its v2 launches return at most NE2 entries and the "
        "rows past them rerun one subread at a time through v1 (5,989 "
        "reruns in the port's device search on the card, the same caps), "
        "and on the CPU it had not finished the first batch after 40 min. "
        "100-read batches hold fewer than 8,192 subreads, where the host "
        "search is exact, and a multiple of the 10-read intake group keeps "
        "the file's record order, so the bytes are those of an exact "
        "search at 192"),
    ("bamfix", "ultralong"): (
        {"NGMLR_TPU_DEVICE_SEARCH": "1"}, (),
        "ultralong's one intake batch holds 20,520 subreads, past the 8,192 "
        "from which ngmlr_tpu's host search_batch rounds; its device search "
        "keeps each subread apart, as the reference does (as "
        "scripts/torch_scale_vs_jax.py's JAX_ENV)"),
}
# the SAMs kept in full, so that a differing read can be shown
FULL_SAMS = (("default", "fuzzq"), ("scoring", "fuzzq"))


def pairs(names=None):
    """[(set, dataset)] of OPTION_SETS in order; names hold SET or
    SET/DATASET entries (None: all)."""
    out = []
    for s, (_, dsets) in OPTION_SETS.items():
        for d in dsets:
            if names is None or s in names or "%s/%s" % (s, d) in names:
                out.append((s, d))
    return out


def set_argv(name, out_dir):
    """The set's argv suffix, its output placeholder filled with
    out_dir."""
    return [a.replace("<dir>", out_dir) for a in OPTION_SETS[name][0]]


# ---------------------------------------------------------------------------
# the datasets

def draw_quals(rng, n):
    """n Phred+33 quality bytes, PacBio-like (QUAL_MEAN, QUAL_SD) within
    QUAL_RANGE."""
    mu = rng.uniform(*QUAL_MEAN)
    q = np.clip(np.rint(rng.normal(mu, QUAL_SD, n)), *QUAL_RANGE)
    return (q.astype(np.uint8) + 33).tobytes()


def fasta_records(path):
    """[(name, sequence)] of a FASTA file, in file order."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                out.append([line[1:].split()[0], []])
            else:
                out[-1][1].append(line)
    return [(n, b"".join(s)) for n, s in out]


def fastq_bytes(rng, reads_fa):
    """The reads of a FASTA file as FASTQ bytes, each read's qualities from
    draw_quals(rng, its length), in file order."""
    out = []
    for name, seq in fasta_records(reads_fa):
        out.append(b"@%s\n%s\n+\n%s\n" % (name, seq,
                                          draw_quals(rng, len(seq))))
    return b"".join(out)


def write_gz(path, data, level=6):
    with open(path + ".part", "wb") as f:
        f.write(gzip.compress(data, level, mtime=0))
    os.replace(path + ".part", path)


def make_fuzzq(d):
    """fuzzq in d: ref.fa, reads.fa and reads.fastq.gz. Returns (ref, reads
    FASTQ, the FASTQ's uncompressed bytes)."""
    rng = np.random.default_rng(FUZZQ_SEED)
    ref, reads_fa = fuzz.make_dataset(rng, d, fuzz.N_READS)
    fq = fastq_bytes(rng, reads_fa)
    path = os.path.join(d, "reads.fastq.gz")
    write_gz(path, fq)
    return ref, path, fq


def make_phase4q(d):
    """phase4q in d (phase 4's genome and reads, then their qualities).
    Returns (ref, reads FASTQ, the FASTQ's uncompressed bytes)."""
    rng = np.random.default_rng(cs.MAPPING_SEED)
    ref, reads_fa, _, _ = cs.make_dataset(rng, cs.GENOME_MBP, cs.N_READS,
                                          cs.READ_LEN, d)
    fq = fastq_bytes(rng, reads_fa)
    path = os.path.join(d, "reads.fastq.gz")
    write_gz(path, fq)
    return ref, path, fq


def dataset_files(name, root):
    """(ref, reads) of a dataset under root, written once."""
    if name == "ultralong":
        files = scale.genome_files("phase4", root)
        return files["ref"], files[scale.UL_FILE]
    d = os.path.join(root, name)
    done = os.path.join(d, "done")
    if not os.path.exists(done):
        os.makedirs(d, exist_ok=True)
        (make_fuzzq if name == "fuzzq" else make_phase4q)(d)
        open(done, "w").close()
    return os.path.join(d, "ref.fa"), os.path.join(d, "reads.fastq.gz")


def reads_sha256(path):
    """sha256 of a reads file's bytes (decompressed where gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    h = hashlib.sha256()
    with opener(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def read_names(path):
    """A FASTA or FASTQ(.gz) file's read names, in file order."""
    if not path.endswith(".gz"):
        return scale.read_names(path)
    with gzip.open(path, "rb") as f:
        return [l[1:].split()[0] for i, l in enumerate(f) if i % 4 == 0]


def head_reads(path, n, out_p):
    """The first n reads of a dataset's file, written to out_p (a FASTQ.gz
    stays one)."""
    if not path.endswith(".gz"):
        return scale.head_reads(path, n, out_p)
    with gzip.open(path, "rb") as f:
        lines = [l for i, l in zip(range(4 * n), f)]
    write_gz(out_p, b"".join(lines))
    return out_p


# ---------------------------------------------------------------------------
# SAM facts

def mask_qual(sam):
    """The SAM with every record's QUAL set to '*'."""
    out = []
    for line in sam.splitlines(keepends=True):
        if not line.startswith(b"@"):
            f = line.rstrip(b"\n").split(b"\t")
            f[10] = b"*"
            line = b"\t".join(f) + b"\n"
        out.append(line)
    return b"".join(out)


def op_counts(sam):
    """Each record's CIGAR op count: the CG:B:I tag's where --bam-fix put
    one (the CIGAR is then <len>S), else the CIGAR's."""
    out = []
    for line in sam.splitlines():
        if line.startswith(b"@"):
            continue
        m = re.search(rb"\tCG:B:I((?:,\d+)+)", line)
        if m:
            out.append(m.group(1).count(b","))
        else:
            cig = line.split(b"\t", 6)[5]
            out.append(0 if cig == b"*" else len(re.findall(rb"\d+[^\d]",
                                                            cig)))
    return out


def bam_fix_facts(sam):
    ops = op_counts(sam)
    return {"records_65536_ops": sum(n >= BAM_FIX_OPS for n in ops),
            "cg_tags": sam.count(b"\tCG:B:I,"),
            "max_ops": max(ops, default=0)}


# ---------------------------------------------------------------------------
# the JAX package's side

def load_manifest(out_dir=OPTIONS_DIR):
    path = os.path.join(out_dir, MANIFEST)
    if not os.path.exists(path):
        return {"datasets": {}, "mappings": {}}
    with open(path) as f:
        return json.load(f)


def load_digests(out_dir=OPTIONS_DIR):
    """{(set, dataset): {read name: sha256}}, the file's own under "*"."""
    out = {}
    path = os.path.join(out_dir, DIGESTS)
    if os.path.exists(path):
        with gzip.open(path, "rt") as f:
            for line in f:
                s, d, read, h = line.split()
                out.setdefault((s, d), {})[read] = h
    return out


def digest_lines(key, sam):
    _, by_read, order = fuzz.groups(sam)
    lines = ["%s\t%s\t*\t%s\n" % (*key, hashlib.sha256(sam).hexdigest())]
    lines += ["%s\t%s\t%s\t%s\n" % (*key, q.decode(), fuzz.digest(by_read[q]))
              for q in order]
    return lines


def jax_argv(key, ref, reads, d):
    """The `python -m ngmlr_tpu` command of (set, dataset) writing into d,
    and its output path."""
    suffix = set_argv(key[0], d)
    argv = [sys.executable, "-m", "ngmlr_tpu", "-r", ref, "-q", reads, "-t",
            "1", "--skip-write", "--no-progress"]
    out = os.path.join(d, "out.sam")
    if "-o" in suffix:
        out = suffix[suffix.index("-o") + 1]
    else:
        argv += ["-o", out]
    return argv + suffix + list(JAX_EXTRA.get(key, ({}, (), None))[1]), out


def read_sam(out):
    """An output SAM's bytes (decompressed where gzipped), @PG stripped."""
    with open(out, "rb") as f:
        data = f.read()
    return fuzz.strip_pg(gzip.decompress(data) if out.endswith(".gz")
                         else data)


def jax_run(key, files, root):
    """One (set, dataset) through `python -m ngmlr_tpu` on the CPU. Returns
    (SAM with @PG stripped, the child's cost)."""
    env = JAX_EXTRA.get(key, ({}, (), None))[0]
    with tempfile.TemporaryDirectory(prefix="ngmlr_options_jax_",
                                     dir=root) as d:
        argv, out = jax_argv(key, *files, d)
        cost = fuzz.run_jax_argv(argv, "%s/%s" % key, env)
        return read_sam(out), cost


def cross_checks(sams):
    """fuzzq's default SAM against seed 501's committed SAM, and phase4q's
    against phase 4's committed digests, read for read with QUAL set to
    '*'. Returns {check: {"reads", "identical", "diff"}} for those at
    hand."""
    out = {}
    if ("default", "fuzzq") in sams:
        want = fuzz.committed_sam(FUZZQ_SEED, "pacbio", fuzz.N_READS)
        _, a, _ = fuzz.groups(want)
        _, b, _ = fuzz.groups(mask_qual(sams[("default", "fuzzq")]))
        diff = sorted(q.decode() for q in set(a) | set(b)
                      if a.get(q) != b.get(q))
        out["fuzzq_default_vs_seed501"] = {"reads": len(a), "diff": diff,
                                           "identical": len(a) - len(diff)}
    if ("default", "phase4q") in sams:
        want = scale.load_digests()["phase4"]
        sam = mask_qual(sams[("default", "phase4q")])
        names = [q for q in want if q != "*"]
        held = scale.hold(want, sam, [q.encode() for q in names],
                          whole=False)
        out["phase4q_default_vs_phase4"] = {
            "reads": held["reads"], "identical": held["identical"],
            "diff": [q.decode() for q in held["diff"]]}
    return out


def write_jax(out_dir, jobs, keys, root):
    """Writes the digests, the full SAMs and the manifest of keys, keeping
    the other (set, dataset) pairs' committed lines and entries."""
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(root, exist_ok=True)
    commit = fuzz.git_commit()
    manifest = load_manifest(out_dir)
    names = {"%s/%s" % k for k in keys}
    path = os.path.join(out_dir, DIGESTS)
    kept = []
    if os.path.exists(path):
        with gzip.open(path, "rt") as f:
            kept = [l for l in f if "%s/%s" % tuple(l.split("\t")[:2])
                    not in names]
    t0 = time.perf_counter()
    files = {}
    for d in sorted({d for _, d in keys}):
        t1 = time.perf_counter()
        files[d] = dataset_files(d, root)
        manifest["datasets"][d] = {
            "generator": DATASETS[d],
            "reads_sha256": reads_sha256(files[d][1]),
            "genome_sha256": scale.sha256_file(files[d][0]),
            "reads": len(read_names(files[d][1])),
            "quality": ("Phred %d-%d (+33): a read's mean uniform in "
                        "%g-%g, its bases normal around it, sd %g, rounded "
                        "and clipped" % (*QUAL_RANGE, *QUAL_MEAN, QUAL_SD)
                        if d != "ultralong" else "none (FASTA)"),
            "generate_s": time.perf_counter() - t1}
    print("datasets written in %.1f s" % (time.perf_counter() - t0),
          flush=True)
    # the longest first: ultralong, then phase 4's genome, then fuzzq
    rank = {"ultralong": 0, "phase4q": 1, "fuzzq": 2}
    work = sorted(keys, key=lambda k: rank[k[1]])

    def one(key):
        sam, cost = jax_run(key, files[key[1]], root)
        print("%s/%s: %s" % (*key, json.dumps(cost)), flush=True)
        return key, sam, cost
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        done = list(pool.map(one, work))
    lines = list(kept)
    sams = {}
    for key, sam, cost in done:
        sams[key] = sam
        lines += digest_lines(key, sam)
        env, _, why = JAX_EXTRA.get(key, ({}, (), None))
        argv, _ = jax_argv(key, "ref", "reads", "<dir>")
        rec = {"command": " ".join(
                   ["%s=%s" % kv for kv in env.items()]
                   + ["JAX_PLATFORMS=cpu", "python", "-m", "ngmlr_tpu"]
                   + argv[3:]) + ", @PG stripped",
               "env": env, "ngmlr_tpu_commit": commit,
               "summary": fuzz.sam_summary(sam),
               "jax_wall_s": cost["wall_s"], "jax_cpu_s": cost["cpu_s"],
               "jax_peak_rss_gb": cost["peak_rss_gb"],
               "jax_host": "%d CPUs, JAX on the CPU, %d jobs"
                           % (os.cpu_count(), jobs)}
        if why:
            rec["why"] = why
        if key[0] == "bamfix":
            rec["bam_fix"] = bam_fix_facts(sam)
        manifest["mappings"]["%s/%s" % key] = rec
        if key in FULL_SAMS:
            name = "%s_%s.sam.gz" % (key[1], key[0])
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(gzip.compress(sam, 9, mtime=0))
            manifest.setdefault("sams", {})["%s/%s" % key] = name
    order = {"%s/%s" % k: i for i, k in enumerate(pairs())}
    lines.sort(key=lambda l: order["%s/%s" % tuple(l.split("\t")[:2])])
    with open(path, "wb") as f:
        f.write(gzip.compress("".join(lines).encode(), 9, mtime=0))
    checks = cross_checks(sams)
    manifest.setdefault("cross_checks", {}).update(checks)
    manifest.update({
        "written_by": "python3 scripts/torch_options_vs_jax.py --write-jax "
                      "tests/golden/torch_options [SET[/DATASET]...] (on "
                      "the CPU)",
        "digests": {"file": DIGESTS, "line": "set dataset read sha256 (over "
                    "the read's records joined by newlines in file order; "
                    "read * is the whole file's, @PG stripped; readgroup's "
                    "SAM decompressed)"}})
    manifest["mappings"] = {k: manifest["mappings"][k] for k in order
                            if k in manifest["mappings"]}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    bad = {k: v["diff"][:5] for k, v in checks.items() if v["diff"]}
    for k, v in checks.items():
        print("cross-check %s: %d of %d reads identical"
              % (k, v["identical"], v["reads"]), flush=True)
    print("wrote the digests of %d mappings to %s in %.1f s (%d jobs)"
          % (len(done), out_dir, time.perf_counter() - t0, jobs), flush=True)
    if bad:
        print("FAIL: cross-checks differ: %s" % json.dumps(bad), flush=True)
        return 1
    return 0


# ---------------------------------------------------------------------------
# the port's side

def port_pipeline(name, ref, device="cuda", use_cache=False):
    """The port's Pipeline for ref under the set's argv, through its CLI
    parser and config_from_args, with the default search gate, the
    candidate table's builds timed. Returns (pipeline, setup s, [each
    DeviceSearch build's s])."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    argv = ["-r", ref] + set_argv(name, tempfile.gettempdir())
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    with table_builds(device) as builds:
        p = Pipeline(config_from_args(args, argv), ref, use_cache=use_cache,
                     device=device)
    return p, time.perf_counter() - t0, builds


@contextlib.contextmanager
def table_builds(device):
    """Times each DeviceSearch built inside (its (start, count) table and
    positions on the device). Yields the list of seconds."""
    import torch
    from ngmlr_tpu_torch.seed import device_search as DS
    seen = []
    orig = DS.DeviceSearch.__init__

    def init(self, *a, **kw):
        t0 = time.perf_counter()
        orig(self, *a, **kw)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seen.append(time.perf_counter() - t0)
    DS.DeviceSearch.__init__ = init
    try:
        yield seen
    finally:
        DS.DeviceSearch.__init__ = orig


@contextlib.contextmanager
def score_buckets():
    """Counts score_fill's calls by (Rp, Qp) bucket while inside (a
    stand-in for the wrapper, as scale.fill_lanes). Yields the Counter."""
    from ngmlr_tpu_torch.ops import kernels as K
    seen = collections.Counter()
    orig = K.score_fill
    lock = threading.Lock()

    def sf(genome, readbuf, pk, Rp, Qp):
        with lock:
            seen["%dx%d" % (Rp, Qp)] += 1
        return orig(genome, readbuf, pk, Rp, Qp)
    K.score_fill = sf
    try:
        yield seen
    finally:
        K.score_fill = orig


def map_counted(tag, p, reads_p, batch_reads=None):
    """scale.map_once (a counted mapping under NGMLR_TPU_STRICT=1, with the
    fill's lane classes and the peak device memory) with score_fill's
    buckets, at batch_reads-read intake batches where given."""
    old = p.cfg.batch_reads
    p.cfg.batch_reads = batch_reads or old
    try:
        with score_buckets() as buckets:
            run = scale.map_once(tag, p, reads_p)
    finally:
        p.cfg.batch_reads = old
    run.update(score_buckets=dict(sorted(buckets.items())),
               batch_reads=batch_reads or old)
    return run


def cli_gz_run(tag, name, ref, reads_p, device, d):
    """The set's argv through the port's CLI main in process (its -o
    <d>/out.sam.gz: the gzip writer), counted as chip_smoke._run_counted
    counts (the launches set to 0 just before; on the card equal to the
    new context's record). Returns {sam (decompressed, @PG stripped),
    map_s, launches, stats}."""
    import torch
    from ngmlr_tpu_torch import cli
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.ops import kernels as K
    suffix = set_argv(name, d)
    out = suffix[suffix.index("-o") + 1]
    argv = ["-r", ref, "-q", reads_p, "--skip-write", "--no-progress"]
    old = {v: cs._env(v, x) for v, x in (
        ("NGMLR_TPU_STRICT", "1"),
        ("NGMLR_TORCH_DEVICE", torch.device(device).type))}
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv + suffix)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = dict(K.launches)
    finally:
        for v, x in old.items():
            cs._env(v, x)
    cs.check(rc == 0, "%s: the CLI exited %s" % (tag, rc))
    ctx = device_engine.current()
    stats = {k: v for k, v in ctx.stats.items() if isinstance(v, (int,
                                                                  float))}
    if ctx.device.type == "cuda":
        cs.check_launches(tag, launches, {
            "score_waves": 0, "align_waves": 0, "score_launches": 0,
            "align_launches": 0, "search_v2_launches": 0, **stats})
    else:
        cs.check(not any(launches.values()), "%s: kernels launched on the "
                 "CPU: %s" % (tag, launches))
    fb = [k for k in stats if k.startswith("search_fallback_")]
    cs.check(not fb, "%s: the device search handed batches back: %s"
             % (tag, fb))
    device_engine.set_current(None)
    return {"sam": read_sam(out), "map_s": t_run, "launches": launches,
            "stats": stats, "score_buckets": {}, "batch_reads": None}


def mappings_of(name, dataset):
    """(mapping, search context or None for the gate's, batch size) of a
    (set, dataset): the gate's search, the other search (sub512: the gate's
    at SMALL_BATCH-read batches), and on fuzzq the gate's search at
    SMALL_BATCH-read batches."""
    out = [("gate", None, None)]
    if name == HOST_GATE:
        out.append(("small batches", None, SMALL_BATCH))
        return out
    out.append(("other search", cs.other_search, None))
    if dataset == "fuzzq":
        out.append(("small batches", None, SMALL_BATCH))
    return out


def map_set(name, dataset, files, want, device="cuda", n_reads=None,
            n_mappings=None, workdir=None):
    """One (set, dataset) on a new Pipeline: the first n_mappings of
    mappings_of's mappings (all by default; the CPU tests keep the gate's
    alone), each held to want (the JAX package's digests: every read and,
    unless n_reads cuts the file, the file), and for readgroup the CLI's
    -o *.gz run. Returns ({mapping: its record}, [failures], the setup
    record)."""
    import torch
    from ngmlr_tpu_torch.ops import device_engine
    ref, reads_p = files
    tag0 = "%s/%s" % (name, dataset)
    with tempfile.TemporaryDirectory(prefix="ngmlr_options_",
                                     dir=workdir) as d:
        names = None
        if n_reads:
            ext = ".fastq.gz" if reads_p.endswith(".gz") else ".fa"
            reads_p = head_reads(reads_p, n_reads,
                                 os.path.join(d, "head" + ext))
            names = read_names(reads_p)
        whole = names is None
        names = read_names(reads_p) if whole else names
        p, setup_s, builds = port_pipeline(
            name, ref, device, use_cache=dataset != "fuzzq")
        cuda = p.ctx.device.type == "cuda"
        setup = {"setup_s": setup_s, "table_build_s": builds,
                 "host_peak_rss_gb": resource.getrusage(
                     resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
        gate = "device" if p.dev_search is not None else "host"
        runs, failures = {}, []
        try:
            if cuda:
                want_gate = "host" if name == HOST_GATE else "device"
                cs.check(gate == want_gate, "%s: the gate chose the %s "
                         "search on the card, not the %s search"
                         % (tag0, gate, want_gate))
            todo = mappings_of(name, dataset)[:n_mappings]
            for m, ctx, batch in todo:
                tag = "%s, %s" % (tag0, m)
                with (ctx(p) if ctx else
                      contextlib.nullcontext((gate, None))) as (search, _):
                    run = map_counted(tag, p, reads_p, batch)
                scale.check_native(tag, p, run)
                run["search"] = search
                runs[m] = run
            if name == "readgroup":
                run = cli_gz_run(tag0 + ", cli -o .sam.gz", name, ref,
                                 reads_p, p.ctx.device, d)
                run["search"] = gate
                runs["cli -o .sam.gz"] = run
        except cs.PhaseError as e:
            failures.append(str(e))
        finally:
            device_engine.set_current(None)
            del p
            if cuda:
                torch.cuda.empty_cache()
    for m, run in runs.items():
        held = scale.hold(want, run["sam"], names, whole)
        run.update(held)
        if held["diff"] or held["file_identical"] is False:
            failures.append("%s, %s: %d reads differ (%s), file identical "
                            "%s" % (tag0, m, len(held["diff"]), b", ".join(
                                held["diff"][:5]).decode(),
                                held["file_identical"]))
    return runs, failures, setup


def report(run):
    keep = ("search", "batch_reads", "reads", "identical", "file_identical",
            "map_s", "launches", "score_buckets", "lane_classes",
            "fill_lanes", "dirs_max_bytes", "dirs_cap_refused",
            "peak_device_bytes")
    rec = {k: run.get(k) for k in keep}
    rec.update(diff=len(run.get("diff", [])),
               engine_waves=run["stats"].get("engine_waves", 0),
               lane_bound_retries=run["stats"].get("lane_bound_retries", 0),
               search_counts={k: v for k, v in sorted(run["stats"].items())
                              if k.startswith("search_v")})
    return rec


def options_run(keys, device, n_reads, root, digests, n_mappings=None):
    """Maps each (set, dataset) of keys (map_set) and holds it to digests.
    Returns (exit code, {"set/dataset": {"setup": ..., mapping: its
    numbers}})."""
    failed, records = False, {}
    t_all = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    card = cs.card_line() if device == "cuda" else "cpu"
    for key in keys:
        name, dataset = key
        files = dataset_files(dataset, root)
        t0 = time.perf_counter()
        runs, failures, setup = map_set(
            name, dataset, files, digests[key], device, n_reads, n_mappings,
            root)
        rec = records["%s/%s" % key] = {"setup": dict(setup, card=card)}
        for m, run in runs.items():
            rec[m] = report(run)
            if name == "bamfix":
                rec[m]["bam_fix"] = bam_fix_facts(run["sam"])
            print("options %s/%s %s: %s" % (name, dataset, m,
                                            json.dumps(rec[m])), flush=True)
            if run.get("diff"):
                sys.stdout.write(scale.diff_text(
                    "%s/%s" % key, digests[key], run["sam"], run["diff"]))
        if name == "default" and "gate" in runs and not n_reads:
            rec["cross_check"] = cross_checks({key: runs["gate"]["sam"]})
            for c, v in rec["cross_check"].items():
                if v["diff"]:
                    failures.append("%s: %d reads differ with QUAL masked"
                                    % (c, len(v["diff"])))
        print("options %s/%s: setup %s, %.1f s" % (
            name, dataset, json.dumps(rec["setup"]),
            time.perf_counter() - t0), flush=True)
        for f in failures:
            print("FAIL: %s" % f, flush=True)
        failed |= bool(failures)
    n_held = sum(r.get("identical") or 0 for d in records.values()
                 for m, r in d.items() if m not in ("setup", "cross_check"))
    n_all = sum(r.get("reads") or 0 for d in records.values()
                for m, r in d.items() if m not in ("setup", "cross_check"))
    print("options: %d (set, dataset) pairs, reads held %d of %d, %.1f s, "
          "%s" % (len(records), n_held, n_all, time.perf_counter() - t_all,
                  card), flush=True)
    return (1 if failed else 0), records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sets", nargs="*", metavar="SET",
                    help="any of %s, or SET/DATASET (default: all)"
                         % ", ".join(OPTION_SETS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dataset", choices=sorted(DATASETS),
                    help="map only this dataset's pairs")
    ap.add_argument("--reads", type=int, default=None,
                    help="map only the first N reads of each dataset")
    ap.add_argument("--write-jax", metavar="DIR",
                    help="write the digests (needs the JAX package)")
    ap.add_argument("--jobs", type=int, default=3,
                    help="JAX processes at a time for --write-jax")
    args = ap.parse_args(argv)
    keys = pairs(set(args.sets) if args.sets else None)
    if args.dataset:
        keys = [k for k in keys if k[1] == args.dataset]
    if args.sets and not keys:
        ap.error("no (set, dataset) pair named by %s" % " ".join(args.sets))
    root = os.path.join(tempfile.gettempdir(), "ngmlr_options_vs_jax")
    if args.write_jax:
        return write_jax(args.write_jax, args.jobs, keys, root)
    digests = load_digests()
    missing = ["%s/%s" % k for k in keys if k not in digests]
    if missing:
        print("FAIL: no committed digests for %s (write them on the CPU with "
              "--write-jax tests/golden/torch_options %s)"
              % (", ".join(missing), " ".join(missing)))
        return 2
    return options_run(keys, args.device, args.reads, root, digests)[0]


if __name__ == "__main__":
    sys.exit(main())

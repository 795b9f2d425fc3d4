#!/usr/bin/env python3
"""The SV-rich fuzz of scripts/fuzz_vs_reference.py through the PyTorch/CUDA
port (ngmlr_tpu_torch), held byte for byte against the JAX package's SAM.

    python3 scripts/torch_fuzz_vs_jax.py [--device cuda|cpu] [--preset P]
        [--reads N] [--run-jax] SEED...
    python3 scripts/torch_fuzz_vs_jax.py --digests [--device cuda|cpu]
        [SEED...]
    python3 scripts/torch_fuzz_vs_jax.py --write-jax tests/golden/torch_fuzz
        [--jobs J]

Each seed's dataset is fuzz_vs_reference.make_dataset's (this file carries
its own copy and gives the same bytes): a 500 kbp genome of two chromosomes
(70-column FASTA, one 1 kb N gap) and N reads (default 150) of eight kinds:
short (40-255 bp), clean and 15%-noisy long (1-8 kb), deletion-spanning,
mid-read inversions, translocations between the chromosomes, junk and
N-gap spans, half of them reverse-complemented.

The port maps it in process, under NGMLR_TPU_STRICT=1, on --device (default
cuda; without a card and without --device cpu it raises), three times on
one Pipeline (map_seed): with the default search gate (the device candidate
search on the card, the host search on the CPU), with the other search (the
host search on the card, NGMLR_TPU_DEVICE_SEARCH=0's path; a device search
built on the CPU there), and with the gate's search at SMALL_BATCH-read
intake batches (several batches in flight: wave depth 2 on the card). Every
SAM must equal the JAX package's (@PG aside) byte for byte, record order and
headers included; both packages print '*' for QUAL, so no field is blanked.

The JAX package's SAM comes from tests/golden/torch_fuzz/ where its
MANIFEST.json covers the seed and preset (the first N reads' records of a
file are the N-read dataset's: make_dataset draws the genome first, then
the reads in order); else, with --run-jax, from `python -m ngmlr_tpu` run
as a subprocess on the CPU (JAX_PLATFORMS=cpu; a subprocess, not an
import). With neither, the script exits 2. It never skips the comparison.

--digests maps the sweep's seeds (DIGEST_SEEDS, or the SEEDs given) and
holds each read's records, and each file whole, to the sha256 digests of
tests/golden/torch_fuzz/digests.tsv.gz; a differing read's records are
printed, and the JAX package's are rebuilt on the CPU with
`--device cpu --run-jax --preset P SEED`.

--write-jax DIR writes the committed files on a machine with the JAX
package (the CPU): the six SAMs of SAM_SEEDS, gzip -9 with @PG stripped,
the digests of DIGEST_SEEDS and MANIFEST.json, J JAX processes at a time.

Reports, as fuzz_vs_reference.main does: for each seed and mapping the
reads, identical reads and differing reads, the first five differing reads
with both packages' records, and the kernel launches. Each mapping runs
through chip_smoke._run_counted, so the script holds what phase 12 of
chip_smoke.py holds: on the card the gate must choose the device search, no
batch may leave it, and each mapping's launches must equal its engine's
record (chip_smoke.check_launches); on the CPU the wrappers run their plain
versions and launch none. Exits 1 on any difference or broken rule.
"""

import argparse
import gzip
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the counted run, the other search and the launch rule
import chip_smoke as cs  # noqa: E402

FUZZ_DIR = os.path.join(REPO, "tests", "golden", "torch_fuzz")
MANIFEST = "MANIFEST.json"
DIGESTS = "digests.tsv.gz"
N_READS = 150
# the seeds of the README's round-5 refresh
SAM_SEEDS = ((501, "pacbio"), (502, "pacbio"), (503, "pacbio"),
             (504, "pacbio"), (505, "pacbio"), (506, "ont"))
DIGEST_SEEDS = (tuple((s, "pacbio") for s in range(1, 33))
                + tuple((s, "ont") for s in range(33, 41)))
# the third mapping's intake batch: 150 reads make 8 batches, so on the
# card two batches' waves are in flight at once. A multiple of the 10-read
# intake group: both packages start a group at each batch's first read, so
# another size moves short reads' records within the file (16 does so on
# seed 501 in either package), though no read's records change
SMALL_BATCH = 20

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


# ---------------------------------------------------------------------------
# the datasets: scripts/fuzz_vs_reference.py's generators, the same draws

def revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def pacbio_noise(rng, seq: bytes, err=0.15) -> bytes:
    a = np.frombuffer(seq, dtype=np.uint8)
    r = rng.random(len(a))
    out = []
    rb = BASES[rng.integers(0, 4, size=len(a) + 16)]
    ri = 0
    for i, c in enumerate(a):
        x = r[i]
        if x < err * 4 / 15:          # del
            continue
        if x < err * 14 / 15:         # ins
            out.append(rb[ri])
            ri += 1
            out.append(c)
        elif x < err:                 # sub
            out.append(rb[ri])
            ri += 1
        else:
            out.append(c)
    return bytes(bytearray(out))


def make_dataset(rng, workdir, n_reads):
    """Writes workdir/ref.fa and workdir/reads.fa; returns their paths."""
    glen = 500_000
    g = BASES[rng.integers(0, 4, size=glen)]
    g[200_000:201_000] = ord("N")    # one N gap
    ref = os.path.join(workdir, "ref.fa")
    with open(ref, "wb") as f:
        for name, lo, hi in ((b"fzchr1", 0, 400_000),
                             (b"fzchr2", 400_000, glen)):
            f.write(b">" + name + b"\n")
            gb = g[lo:hi].tobytes()
            for i in range(0, len(gb), 70):
                f.write(gb[i:i + 70] + b"\n")

    reads = os.path.join(workdir, "reads.fa")
    with open(reads, "wb") as f:
        for i in range(n_reads):
            kind = rng.integers(0, 8)
            if kind == 0:        # short read
                L = int(rng.integers(40, 256))
                p = int(rng.integers(0, glen - L))
                seq = g[p:p + L].tobytes()
            elif kind == 1:      # clean long
                L = int(rng.integers(1000, 8000))
                p = int(rng.integers(0, glen - L))
                seq = g[p:p + L].tobytes()
            elif kind == 2:      # noisy long
                L = int(rng.integers(1000, 8000))
                p = int(rng.integers(0, glen - L))
                seq = pacbio_noise(rng, g[p:p + L].tobytes())
            elif kind == 3:      # deletion-spanning (two fragments, gap)
                L = int(rng.integers(800, 3000))
                p = int(rng.integers(0, glen - 2 * L - 20_000))
                gap = int(rng.integers(200, 15_000))
                seq = (g[p:p + L].tobytes()
                       + g[p + L + gap:p + 2 * L + gap].tobytes())
                seq = pacbio_noise(rng, seq, 0.08)
            elif kind == 4:      # inversion in the middle
                L = int(rng.integers(900, 3000))
                p = int(rng.integers(0, glen - 3 * L - 3))
                mid = revcomp(g[p + L:p + 2 * L].tobytes())
                seq = (g[p:p + L].tobytes() + mid
                       + g[p + 2 * L:p + 3 * L].tobytes())
                seq = pacbio_noise(rng, seq, 0.05)
            elif kind == 5:      # translocation across chromosomes
                L = int(rng.integers(800, 2500))
                p1 = int(rng.integers(0, 390_000 - L))
                p2 = int(rng.integers(405_000, glen - L))
                seq = g[p1:p1 + L].tobytes() + g[p2:p2 + L].tobytes()
                seq = pacbio_noise(rng, seq, 0.08)
            elif kind == 6:      # unmappable / junk
                L = int(rng.integers(100, 2000))
                seq = BASES[rng.integers(0, 4, size=L)].tobytes()
            else:                # N-gap spanning
                L = int(rng.integers(1500, 4000))
                p = int(rng.integers(198_000, 199_500))
                seq = g[p:p + L].tobytes()
            if rng.random() < 0.5:
                seq = revcomp(seq)
            if len(seq) == 0:
                seq = b"A"
            f.write(b">fz%d\n" % i)
            for j in range(0, len(seq), 70):
                f.write(seq[j:j + 70] + b"\n")
    return ref, reads


def dataset(seed, n_reads, workdir):
    return make_dataset(np.random.default_rng(seed), workdir, n_reads)


# ---------------------------------------------------------------------------
# SAM bytes

def strip_pg(sam: bytes) -> bytes:
    return b"".join(l for l in sam.splitlines(keepends=True)
                    if not l.startswith(b"@PG"))


def groups(sam: bytes):
    """(header lines, {read: [its records in file order]}, [reads in order
    of their first record])."""
    heads, by_read, order = [], {}, []
    for line in sam.splitlines():
        if line.startswith(b"@"):
            heads.append(line)
            continue
        q = line.split(b"\t", 1)[0]
        if q not in by_read:
            by_read[q] = []
            order.append(q)
        by_read[q].append(line)
    return heads, by_read, order


def read_names(n_reads):
    return [b"fz%d" % i for i in range(n_reads)]


def prefix(sam: bytes, n_reads: int) -> bytes:
    """The headers and the records of reads fz0..fz(n_reads-1), in file
    order: the SAM of the n_reads-read dataset (intake groups of 10 reads
    start at read 0 whatever the count, so filtering keeps their order)."""
    keep = set(read_names(n_reads))
    return b"".join(l for l in sam.splitlines(keepends=True)
                    if l.startswith(b"@") or l.split(b"\t", 1)[0] in keep)


def digest(records) -> str:
    return hashlib.sha256(b"\n".join(records)).hexdigest()


def sam_summary(sam: bytes) -> dict:
    """Counts of a SAM: reads, records, SA:Z records, supplementary (2048)
    and reverse-strand (16) records, unmapped reads (4), reads shorter than
    256 bp (by their primary record's SEQ), records per chromosome."""
    _, by_read, _ = groups(sam)
    s = {"reads": len(by_read), "records": 0, "sa_records": 0,
         "supplementary": 0, "reverse": 0, "unmapped": 0, "short_reads": 0,
         "by_chrom": {}}
    for recs in by_read.values():
        for line in recs:
            f = line.split(b"\t")
            flag = int(f[1])
            s["records"] += 1
            s["short_reads"] += not flag & 2304 and len(f[9]) < 256
            s["sa_records"] += b"\tSA:Z:" in line
            s["supplementary"] += bool(flag & 2048)
            s["reverse"] += bool(flag & 16)
            s["unmapped"] += bool(flag & 4)
            if not flag & 4:
                c = f[2].decode()
                s["by_chrom"][c] = s["by_chrom"].get(c, 0) + 1
    return s


# ---------------------------------------------------------------------------
# the JAX package's side: committed files, or a subprocess on the CPU

def load_manifest(fuzz_dir=FUZZ_DIR):
    path = os.path.join(fuzz_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def committed_sam(seed, preset, n_reads, fuzz_dir=FUZZ_DIR):
    """The committed JAX SAM (@PG stripped) of seed and preset, cut to the
    first n_reads reads; None where the manifest has no such file."""
    m = load_manifest(fuzz_dir)
    for e in (m or {}).get("files", ()):
        if (e["seed"], e["preset"]) == (seed, preset) \
                and e["reads"] >= n_reads:
            with gzip.open(os.path.join(fuzz_dir, e["file"])) as f:
                sam = f.read()
            return sam if n_reads == e["reads"] else prefix(sam, n_reads)
    return None


def committed_digests(fuzz_dir=FUZZ_DIR):
    """{(preset, seed): {read name: sha256}}, the file's own under "*"."""
    out = {}
    with gzip.open(os.path.join(fuzz_dir, DIGESTS), "rt") as f:
        for line in f:
            preset, seed, read, h = line.split()
            out.setdefault((preset, int(seed)), {})[read] = h
    return out


def jax_argv(ref, reads, out, preset):
    return [sys.executable, "-m", "ngmlr_tpu", "-r", ref, "-q", reads,
            "-o", out, "-t", "1", "-x", preset, "--skip-write",
            "--no-progress"]


def run_jax_cli(ref, reads, out, preset, what, env=None):
    """`python -m ngmlr_tpu` (jax_argv) in a subprocess on the CPU; see
    run_jax_argv."""
    return run_jax_argv(jax_argv(ref, reads, out, preset), what, env)


def run_jax_argv(argv, what, env=None):
    """argv (a `python -m ngmlr_tpu` command) in a subprocess on the CPU
    (JAX_PLATFORMS=cpu), single-threaded, with env's variables added.
    Returns the child's {"wall_s", "cpu_s" (user + system),
    "peak_rss_gb"}; raises RuntimeError with the end of its stderr where it
    exits non-zero."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false", **(env or {}))
    with tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        # wait4, not wait: the child's own CPU seconds and peak RSS
        _, status, ru = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            err.seek(0)
            raise RuntimeError("python -m ngmlr_tpu exited %d on %s: %s"
                               % (proc.returncode, what,
                                  err.read().decode()[-2000:]))
    return {"wall_s": wall, "cpu_s": ru.ru_utime + ru.ru_stime,
            "peak_rss_gb": ru.ru_maxrss / 2 ** 20}


def run_jax(seed, preset, n_reads, workdir=None):
    """The JAX package's SAM (@PG stripped) of the dataset, from `python -m
    ngmlr_tpu` in a subprocess on the CPU, single-threaded."""
    with tempfile.TemporaryDirectory(prefix="ngmlr_fuzz_jax_",
                                     dir=workdir) as d:
        ref, reads = dataset(seed, n_reads, d)
        out = os.path.join(d, "jax.sam")
        run_jax_cli(ref, reads, out, preset,
                    "seed %d (%s)" % (seed, preset))
        with open(out, "rb") as f:
            return strip_pg(f.read())


def jax_source(seed, preset, n_reads, may_run_jax):
    """(the JAX package's SAM, where it came from), or (None, why not)."""
    sam = committed_sam(seed, preset, n_reads)
    if sam is not None:
        return sam, "tests/golden/torch_fuzz"
    if not may_run_jax:
        return None, ("no committed file covers seed %d with -x %s at %d "
                      "reads; pass --run-jax where the JAX package is "
                      "installed" % (seed, preset, n_reads))
    if importlib.util.find_spec("jax") is None:
        return None, ("no committed file covers seed %d with -x %s, and the "
                      "JAX package cannot run here" % (seed, preset))
    return run_jax(seed, preset, n_reads), "python -m ngmlr_tpu (CPU)"


def git_commit():
    """HEAD of the checkout, "+dirty" when ngmlr_tpu/ differs from it."""
    def git(*a):
        return subprocess.run(["git", *a], cwd=REPO, capture_output=True,
                              text=True).stdout.strip()
    head = git("rev-parse", "HEAD")
    return head + ("+dirty" if git("status", "--porcelain", "ngmlr_tpu")
                   else "")


def write_jax(out_dir, jobs):
    """Writes the committed files: the SAMs of SAM_SEEDS, the digests of
    DIGEST_SEEDS and the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    commit = git_commit()
    work = list(SAM_SEEDS) + list(DIGEST_SEEDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        sams = list(pool.map(lambda sp: run_jax(sp[0], sp[1], N_READS),
                             work))
    files = []
    for (seed, preset), sam in zip(SAM_SEEDS, sams):
        name = "seed%d_%s.sam.gz" % (seed, preset)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(gzip.compress(sam, 9, mtime=0))
        files.append({"file": name, "seed": seed, "preset": preset,
                      "reads": N_READS, "summary": sam_summary(sam)})
    lines = []
    for (seed, preset), sam in zip(DIGEST_SEEDS, sams[len(SAM_SEEDS):]):
        _, by_read, _ = groups(sam)
        lines.append("%s\t%d\t*\t%s\n" % (preset, seed,
                                          hashlib.sha256(sam).hexdigest()))
        for q in read_names(N_READS):
            if q in by_read:
                lines.append("%s\t%d\t%s\t%s\n" % (preset, seed, q.decode(),
                                                   digest(by_read[q])))
    with open(os.path.join(out_dir, DIGESTS), "wb") as f:
        f.write(gzip.compress("".join(lines).encode(), 9, mtime=0))
    jax_cmd = ("JAX_PLATFORMS=cpu python -m ngmlr_tpu -r ref.fa -q reads.fa "
               "-o out.sam -t 1 -x PRESET --skip-write --no-progress, @PG "
               "stripped")
    manifest = {
        "written_by": "python3 scripts/torch_fuzz_vs_jax.py --write-jax "
                      "tests/golden/torch_fuzz --jobs %d (on the CPU)" % jobs,
        "ngmlr_tpu_commit": commit,
        "command": jax_cmd,
        "dataset": "make_dataset(np.random.default_rng(SEED), dir, READS) of "
                   "scripts/fuzz_vs_reference.py (a copy in this script)",
        "files": [dict(f, command=jax_cmd.replace("PRESET", f["preset"]),
                       ngmlr_tpu_commit=commit) for f in files],
        "digests": {"file": DIGESTS, "reads": N_READS,
                    "line": "preset seed read sha256 (over the read's "
                            "records joined by newlines in file order; read "
                            "* is the whole file's, @PG stripped)",
                    "seeds": {p: [s for s, q in DIGEST_SEEDS if q == p]
                              for p in ("pacbio", "ont")},
                    "command": jax_cmd, "ngmlr_tpu_commit": commit},
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print("wrote %d SAMs and %d digest lines to %s in %.1f s (%d jobs)"
          % (len(files), len(lines), out_dir, time.perf_counter() - t0, jobs))
    return 0


# ---------------------------------------------------------------------------
# the port's side

def port_pipeline(ref, preset, device="cuda"):
    """The port's Pipeline for ref with -x preset and the default search
    gate (NGMLR_TPU_DEVICE_SEARCH as the environment holds it), no cache
    written beside the FASTA. Returns (pipeline, setup s)."""
    from ngmlr_tpu_torch.cli import build_parser, config_from_args
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    argv = ["-r", ref, "-x", preset, "--skip-write"]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    p = Pipeline(config_from_args(args, argv), ref, use_cache=False,
                 device=device)
    return p, time.perf_counter() - t0


def map_dataset(seed, preset, n_reads, device="cuda"):
    """The dataset of seed and n_reads, in a temporary directory, through a
    new port_pipeline and map_seed. Returns (setup s, map_seed's runs)."""
    with tempfile.TemporaryDirectory(prefix="ngmlr_fuzz_") as d:
        ref, reads = dataset(seed, n_reads, d)
        p, setup_s = port_pipeline(ref, preset, device)
        return setup_s, map_seed(p, reads, "seed %d (-x %s)" % (seed, preset))


def map_seed(p, reads_p, tag="fuzz", small_batch=SMALL_BATCH):
    """The three mappings of one dataset on one Pipeline, under
    NGMLR_TPU_STRICT=1, each through chip_smoke._run_counted (launch
    counters set to 0 just before; on the card the launches must be the
    engine's record, no batch may leave the device search): the gate's
    search, which on the card must be the device search; the other search
    (chip_smoke.other_search); and the gate's search at small_batch-read
    intake batches. Returns {name: {sam (@PG stripped), map_s, launches,
    stats, search, batch_reads}}."""
    cs.check(p.ctx.device.type != "cuda" or p.dev_search is not None,
             "%s: the gate left the device search off on the card" % tag)

    def run(name, search, batch_reads):
        old = p.cfg.batch_reads
        p.cfg.batch_reads = batch_reads or old
        try:
            out, t_run, launches, stats = cs._run_counted(
                "%s, %s" % (tag, name), p, reads_p)
        finally:
            p.cfg.batch_reads = old
        return {"sam": strip_pg(out), "map_s": t_run, "launches": launches,
                "stats": stats, "search": search,
                "batch_reads": batch_reads or old}

    gate = "device" if p.dev_search is not None else "host"
    old = cs._env("NGMLR_TPU_STRICT", "1")
    try:
        runs = {"gate": run("gate", gate, None)}
        with cs.other_search(p) as (other, _):
            runs["other search"] = run("other search", other, None)
        runs["small batches"] = run("small batches", gate, small_batch)
    finally:
        cs._env("NGMLR_TPU_STRICT", old)
    return runs


def compare(want: bytes, got: bytes, n_reads):
    """Compares the port's SAM with the JAX package's. Returns (identical
    reads, [differing reads], whole file equal): a read differs where its
    records differ; the file where any byte does (order and headers
    included)."""
    _, a, _ = groups(want)
    _, b, _ = groups(got)
    names = read_names(n_reads)
    same = sum(a.get(q) == b.get(q) for q in names)
    diff = [q for q in names if a.get(q) != b.get(q)]
    diff += sorted((set(a) | set(b)) - set(names))
    return same, diff, want == got


def diff_text(want: bytes, got: bytes, diff) -> str:
    """The first five differing reads, with both packages' records."""
    _, a, _ = groups(want)
    _, b, _ = groups(got)
    out = []
    for q in diff[:5]:
        out.append("DIFF %s" % q.decode())
        out += ["  jax:  %s" % l[:200].decode(errors="replace")
                for l in a.get(q) or [b"<missing in ngmlr_tpu>"]]
        out += ["  port: %s" % l[:200].decode(errors="replace")
                for l in b.get(q) or [b"<missing in ngmlr_tpu_torch>"]]
    return "".join(l + "\n" for l in out)


# ---------------------------------------------------------------------------
# the two modes

def fuzz_seeds(seeds, n_reads, device, may_run_jax):
    """Maps each (seed, preset) of seeds three ways and compares with the
    JAX package's SAM. Returns (exit code, {"SEED_PRESET": its record:
    source, setup_s, the gate's SAM summary, per mapping its search, batch,
    identical and differing reads, file equality, map s and launches, and
    the failures})."""
    failed, records = False, {}
    for seed, preset in seeds:
        want, source = jax_source(seed, preset, n_reads, may_run_jax)
        if want is None:
            print("FAIL: %s" % source)
            return 2, records
        rec = records["%d_%s" % (seed, preset)] = {
            "source": source, "runs": {}, "failures": []}
        try:
            rec["setup_s"], runs = map_dataset(seed, preset, n_reads, device)
        except cs.PhaseError as e:
            runs = {}
            rec["failures"].append("seed %d (-x %s): %s" % (seed, preset, e))
        for name, run in runs.items():
            same, diff, whole = compare(want, run["sam"], n_reads)
            rec["runs"][name] = {
                "search": run["search"], "batch_reads": run["batch_reads"],
                "identical": same, "diff": [q.decode() for q in diff],
                "file_identical": whole, "map_s": run["map_s"],
                "launches": run["launches"]}
            print("seed=%d preset=%s %s (%s search, batches of %d) reads=%d "
                  "identical=%d diff=%d file_identical=%s map_s=%.3f "
                  "setup_s=%.3f launches=%s source=%s"
                  % (seed, preset, name, run["search"], run["batch_reads"],
                     n_reads, same, len(diff), whole, run["map_s"],
                     rec["setup_s"], json.dumps(run["launches"]), source),
                  flush=True)
            sys.stdout.write(diff_text(want, run["sam"], diff))
            if diff or not whole:
                rec["failures"].append(
                    "seed %d (-x %s), %s: reads %s differ, file identical %s"
                    % (seed, preset, name, b", ".join(diff[:5]).decode(),
                       whole))
        if runs:
            rec["summary"] = sam_summary(runs["gate"]["sam"])
            print("seed=%d summary %s" % (seed, json.dumps(rec["summary"])),
                  flush=True)
        for f in rec["failures"]:
            print("FAIL: %s" % f, flush=True)
        failed |= bool(rec["failures"])
    return (1 if failed else 0), records


def fuzz_digests(seeds, device):
    """Maps the sweep's seeds three ways each and holds every read, and
    each file whole, to its committed digest. Returns the exit code."""
    table = committed_digests()
    todo = [sp for sp in DIGEST_SEEDS if not seeds or sp[0] in seeds]
    n_files = 0
    differing = set()     # (seed, read) differing in any mapping
    failed = False
    t0 = time.perf_counter()
    for seed, preset in todo:
        want = table[(preset, seed)]
        try:
            _, runs = map_dataset(seed, preset, N_READS, device)
        except cs.PhaseError as e:
            print("FAIL: seed %d (-x %s): %s" % (seed, preset, e))
            failed = True
            continue
        for name, run in runs.items():
            _, b, _ = groups(run["sam"])
            diff = [q for q in read_names(N_READS)
                    if digest(b.get(q, [])) != want.get(q.decode())]
            diff += sorted(set(b) - set(read_names(N_READS)))
            whole = hashlib.sha256(run["sam"]).hexdigest() == want["*"]
            differing |= {(seed, q) for q in diff}
            n_files += not whole
            print("seed=%d preset=%s %s (%s search) identical=%d diff=%d "
                  "file_identical=%s map_s=%.3f launches=%s"
                  % (seed, preset, name, run["search"],
                     N_READS - len(diff), len(diff), whole,
                     run["map_s"], json.dumps(run["launches"])), flush=True)
            for q in diff[:5]:
                print("DIFF %s (rebuild the JAX records on the CPU: python3 "
                      "scripts/torch_fuzz_vs_jax.py --device cpu --run-jax "
                      "--preset %s %d)" % (q.decode(), preset, seed))
                for l in b.get(q) or [b"<missing in ngmlr_tpu_torch>"]:
                    print("  port: %s" % l[:200].decode(errors="replace"))
            failed |= bool(diff) or not whole
    n_reads = N_READS * len(todo)
    print("digests: %d seeds, %d mappings, reads %d, held in every mapping "
          "%d, differing in any %d, files differing %d, %.1f s"
          % (len(todo), 3 * len(todo), n_reads, n_reads - len(differing),
             len(differing), n_files, time.perf_counter() - t0))
    return 1 if failed else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--preset", default="pacbio", choices=["pacbio", "ont"])
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--run-jax", action="store_true",
                    help="run python -m ngmlr_tpu on the CPU for a seed no "
                         "committed file covers")
    ap.add_argument("--digests", action="store_true",
                    help="hold the sweep's seeds to the committed digests")
    ap.add_argument("--write-jax", metavar="DIR",
                    help="write the committed files (needs the JAX package)")
    ap.add_argument("--jobs", type=int, default=4,
                    help="JAX processes at a time for --write-jax")
    args = ap.parse_args(argv)
    if args.write_jax:
        return write_jax(args.write_jax, args.jobs)
    if args.digests:
        return fuzz_digests(set(args.seeds), args.device)
    if not args.seeds:
        ap.error("name at least one SEED (or --digests, --write-jax)")
    return fuzz_seeds([(s, args.preset) for s in args.seeds], args.reads,
                      args.device, args.run_jax)[0]


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Human-scale run of the PyTorch/CUDA port on one CUDA card: a synthetic
human-like genome (24 chromosomes of 125 Mbp at 3.0 Gbp, N-run gaps,
alpha-satellite-like repeat patches), its encode and k-mer index on the
host, and with --map N, N PacBio-like reads mapped on the card through the
port's Pipeline. The counterpart of scripts/human_scale.py, stage for stage.

    python3 scripts/torch_human_scale.py [GBP] [--map N] [--host-check M]
                                         [--profile DIR]

GBP defaults to 3.0: concatenated coordinates then pass 2^31, so the card
reads genome bytes and index positions in the upper half of the 32-bit
space. The work directory is HUMAN_SCALE_DIR (default _human_scale/ in the
checkout); the FASTA (genome_<GBP>gbp.fa), the reads and the port's
*-enc.torch.npz / *-ht-*.torch.npz caches stay there, so a second run in
the same directory skips generation, encode and index build.

Stages, each timed on its own: generation, encode (or its cache load),
index build (or its cache load), with kept positions, table GB and peak
host RSS. With --map N: N reads of 5-14 kb at ~15% error (10% insertions,
4% deletions, 1% substitutions), named r<i>_<concat position of their
source>; one Pipeline on the card (its construction timed as setup, split
into the genome and index cache loads, the genome upload and the device
search's tables) maps them twice, a warm pass and a steady pass, each with
the launch counters set to 0 just before it. The steady pass gives reads/s,
the mapped share, the placed share (primary records within 2 kb of their
source), the context's stage times and search counters, and launches per
kernel, each equal to its engine's waves. --host-check M (default 16) maps
the first M reads with the device search and again with the host search
on the same Pipeline: the SAMs must be equal, byte for byte. --profile DIR
traces one more pass with torch.profiler (device time by kernel, busy
share). Any failed check exits non-zero.

Prints one JSON line on stdout and a readable block on stderr; every
number carries the card's name and power limit (nvidia-smi). Needs a CUDA
card: without one it raises before generating anything.
"""

import contextlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
KERNELS = ("score_fill", "corridor_windows", "convex_fill",
           "convex_backtrack", "expand_votes")


def peak_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def make_genome_fa(path: str, gbp: float, seed: int = 7):
    """Chromosomes of ~125 Mbp with N-run telomere/centromere gaps, human
    GC-ish base composition, and tandem-repeat patches (so the index sees
    realistic same-bin dedup and frequency-cutoff pressure). The same bytes
    as scripts/human_scale.py's generator for the same arguments. Returns
    its seconds."""
    rng = np.random.default_rng(seed)
    total = int(gbp * 1e9)
    chrom_len = 125_000_000
    n_chrom = max(1, (total + chrom_len - 1) // chrom_len)
    t0 = time.time()
    with open(path, "wb") as f:
        remaining = total
        for ci in range(n_chrom):
            clen = min(chrom_len, remaining)
            remaining -= clen
            if clen <= 0:
                break
            f.write(b">chr%d\n" % (ci + 1))
            # 16 Mbp blocks bound the temporaries
            written = 0
            while written < clen:
                blk = min(1 << 24, clen - written)
                seq = BASES[rng.integers(0, 4, size=blk)]
                # N gaps: one ~100 kb run per ~8 Mbp
                for _ in range(max(1, blk >> 23)):
                    s = int(rng.integers(0, max(1, blk - 100_000)))
                    seq[s:s + int(rng.integers(20_000, 100_000))] = ord("N")
                # tandem repeat patch: ~50 kb of a 171-bp alpha-satellite-like
                # monomer per block (stresses bin dedup + freq cutoff),
                # clamped for blocks shorter than the patch
                mono = BASES[rng.integers(0, 4, size=171)]
                patch = min(50_000, blk)
                s = int(rng.integers(0, max(1, blk - patch)))
                reps = patch // 171
                seq[s:s + reps * 171] = np.tile(mono, reps)
                buf = seq.tobytes()
                # 80-col FASTA
                out = b"\n".join(buf[i:i + 80] for i in range(0, len(buf), 80))
                f.write(out + b"\n")
                written += blk
    return time.time() - t0


def write_reads(path, ref, n, seed=99):
    """n reads sampled from the encoded genome as scripts/human_scale.py
    samples them: 5-14 kb windows with fewer than a quarter N, the
    PacBio-CLR-like profile (10% insertions, 4% deletions, 1%
    substitutions), named r<i>_<source position>. Returns the source
    positions."""
    rng = np.random.default_rng(seed)
    glen = len(ref.codes)
    origin = []
    with open(path, "wb") as f:
        for i in range(n):
            L = int(rng.integers(5000, 14000))
            # retry until the window decodes to mostly ACGT
            for _ in range(10):
                pos = int(rng.integers(1000, glen - L - 1000))
                frag = ref.decode_window(pos, L)
                if frag.count(b"N") < L // 4:
                    break
            r = np.frombuffer(frag, dtype=np.uint8).copy()
            e = rng.random(len(r))
            ins = e < 0.10
            dele = (e >= 0.10) & (e < 0.14)
            sub = (e >= 0.14) & (e < 0.15)
            rand_ins = BASES[rng.integers(0, 4, len(r))]
            rand_sub = BASES[rng.integers(0, 4, len(r))]
            counts = np.where(dele, 0, 1 + ins.astype(np.int64))
            ends = np.cumsum(counts)
            out = np.empty(int(ends[-1]) if len(r) else 0, dtype=np.uint8)
            keep = ~dele
            out[ends[keep] - 1] = np.where(sub, rand_sub, r)[keep]
            ins_k = ins & keep
            out[ends[ins_k] - 2] = rand_ins[ins_k]
            f.write(b">r%d_%d\n" % (i, pos))
            f.write(out.tobytes() + b"\n")
            origin.append(pos)
    return origin


def first_reads(path, out_path, m):
    """Copy the first m records of a one-line-per-sequence FASTA."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    with open(out_path, "wb") as f:
        f.write(b"\n".join(lines[:2 * m]) + b"\n")


def placed_share(sam, ref):
    """Share of the SAM's primary records on their read's source
    chromosome within 2 kb of the source (read names r<i>_<concat
    position>)."""
    near = n_prim = 0
    for line in sam.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        if int(f[1]) & 0x904:
            continue
        n_prim += 1
        src = int(f[0].rsplit(b"_", 1)[1])
        conv = ref.convert(src)
        if conv is None:
            continue
        ref_id, local = conv
        near += (f[2] == ref.name_of(ref_id)
                 and abs(int(f[3]) - 1 - local) <= 2000)
    return near / max(1, n_prim)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return (r.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0] \
        if r.returncode == 0 else "nvidia-smi unavailable"


class Stopwatch:
    """Seconds spent inside chosen callables (each followed by a card
    synchronise), summed by label: wraps obj.attr for the duration of a
    with block."""

    def __init__(self):
        self.s = {}
        self._undo = []

    def wrap(self, label, obj, attr):
        import torch
        raw = vars(obj)[attr]           # a classmethod stays one on undo
        orig = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.s[label] = self.s.get(label, 0.0) \
                    + time.perf_counter() - t0
        setattr(obj, attr, timed)
        self._undo.append((obj, attr, raw))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, attr, raw in reversed(self._undo):
            setattr(obj, attr, raw)


def setup(fa, gbp, workdir):
    """Generation, encode and index, each timed. Returns (ref, result)."""
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    res = {"genome_gbp": gbp, "workdir": workdir}
    if not os.path.exists(fa):
        sys.stderr.write("generating %g Gbp genome...\n" % gbp)
        res["generate_s"] = make_genome_fa(fa + ".part", gbp)
        os.replace(fa + ".part", fa)
    else:
        res["generate_s"] = None
    res["encode_cached"] = os.path.exists(fa + "-enc.torch.npz")
    t0 = time.time()
    ref = ReferenceGenome.from_fasta(fa, use_cache=True)
    res["encode_s"] = time.time() - t0
    res["genome_bytes"] = int(len(ref.codes))
    res["chromosomes"] = len(ref.names)
    res["units"] = int(ref.n_units)
    sys.stderr.write("encode: %.1f s (len=%d, peak RSS %.1f GB)\n"
                     % (res["encode_s"], len(ref.codes), peak_rss_gb()))
    res["index_cached"] = os.path.exists(fa + "-ht-13-2.torch.npz")
    t0 = time.time()
    idx = KmerIndex.load_or_build(ref, fa, use_cache=True)
    res["index_s"] = time.time() - t0
    res["index_positions"] = int(len(idx.positions))
    res["index_gb"] = (idx.bucket_start.nbytes + idx.positions.nbytes) / 1e9
    res["max_position"] = int(idx.positions.max()) if len(idx.positions) \
        else 0
    res["peak_rss_gb_after_index"] = peak_rss_gb()
    sys.stderr.write(
        "index %s: %.1f s, %d positions (max %d), %.2f GB tables, peak RSS "
        "%.1f GB\n" % ("cache load" if res["index_cached"] else "build",
                       res["index_s"], res["index_positions"],
                       res["max_position"], res["index_gb"], peak_rss_gb()))
    del idx
    return ref, res


def map_reads(ref, fa, n_map, host_check, workdir, profile_dir=None):
    """The --map stage on the card (see the module docstring). Each pass
    runs through chip_smoke._run_counted: launch counters set to 0 just
    before it, its launches equal to its engine's waves, no batch handed
    back by the device search (chip_smoke.PhaseError otherwise). Returns
    its numbers, with "fails" listing the checks of shares and SAMs that
    failed."""
    import torch
    import chip_smoke as cs
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    from ngmlr_tpu_torch.seed import device_search
    res = {"map_reads": n_map}
    reads = os.path.join(workdir, "reads_%d.fa" % n_map)
    write_reads(reads, ref, n_map)
    torch.cuda.reset_peak_memory_stats()
    with Stopwatch() as sw:
        sw.wrap("genome_cache_load_s", ReferenceGenome, "from_fasta")
        sw.wrap("index_cache_load_s", KmerIndex, "load_or_build")
        sw.wrap("genome_upload_s", device_engine, "DeviceContext")
        sw.wrap("search_tables_s", device_search, "DeviceSearch")
        t0 = time.perf_counter()
        p = Pipeline(Config(), fa, use_cache=True, device="cuda")
        torch.cuda.synchronize()
        res["setup_s"] = time.perf_counter() - t0
    res["setup_split_s"] = sw.s
    res["device_search"] = p.dev_search is not None
    if p.dev_search is not None:
        res["resident_bytes"] = {
            "genome": p.ctx.genome.nbytes,
            "bucket_pairs": p.dev_search.bucket_pairs.nbytes,
            "positions": p.dev_search.positions.nbytes}
    sys.stderr.write("pipeline setup: %.1f s %s\n"
                     % (res["setup_s"], json.dumps(sw.s)))

    passes = {}
    for tag in ("warm", "steady"):
        out, t_run, launches, st = cs._run_counted(tag + " pass", p,
                                                   reads)
        passes[tag] = dict(map_s=t_run, reads=p.stats["reads"],
                           mapped=p.stats["mapped"], launches=launches,
                           stats=st)
        sys.stderr.write("%s pass: %.2f s, %d/%d mapped, launches %s\n"
                         % (tag, t_run, p.stats["mapped"], p.stats["reads"],
                            json.dumps(launches)))
    steady = passes["steady"]
    res["passes"] = passes
    res["map_warm_s"] = passes["warm"]["map_s"]
    res["map_s"] = steady["map_s"]
    res["reads_per_s"] = steady["reads"] / steady["map_s"]
    res["mapped"] = steady["mapped"]
    res["mapped_share"] = steady["mapped"] / max(1, steady["reads"])
    res["placed_share"] = placed_share(out, ref)
    res["launches"] = steady["launches"]
    res["stats"] = steady["stats"]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["peak_rss_gb"] = peak_rss_gb()
    fails = []
    if p.dev_search is not None:
        fails += ["%s launched no time in the steady pass" % k
                  for k in KERNELS if not steady["launches"][k]]
    if res["mapped_share"] < 0.95:
        fails.append("mapped share %.3f < 0.95" % res["mapped_share"])
    if res["placed_share"] < 0.90:
        fails.append("placed share %.3f < 0.90" % res["placed_share"])

    if host_check:
        sub = os.path.join(workdir, "reads_%d_first_%d.fa" % (n_map,
                                                               host_check))
        first_reads(reads, sub, host_check)
        dev_sam, dev_s, _, _ = cs._run_counted(
            "host check, device search", p, sub)
        first = p.dev_search
        p.dev_search = None
        try:
            host_sam, host_s, host_launches, _ = cs._run_counted(
                "host check, host search", p, sub)
        finally:
            p.dev_search = first
        res["host_check"] = dict(reads=host_check, device_search_s=dev_s,
                                 host_search_s=host_s,
                                 sam_identical=dev_sam == host_sam,
                                 device_search=first is not None,
                                 host_launches=host_launches)
        sys.stderr.write("host check: %s\n" % json.dumps(res["host_check"]))
        if dev_sam != host_sam:
            with open(os.path.join(workdir, "host_check_device.sam"),
                      "wb") as f:
                f.write(dev_sam)
            with open(os.path.join(workdir, "host_check_host.sam"),
                      "wb") as f:
                f.write(host_sam)
            fails.append("the host-search SAM of the first %d reads differs "
                         "from the device search's (both in %s)"
                         % (host_check, workdir))
    if profile_dir:
        # chip_smoke logs to stdout; this script's stdout is its JSON line
        with contextlib.redirect_stdout(sys.stderr):
            (_, t_run, _), prof = cs._profiled(lambda: cs._run_on(p, reads),
                                               profile_dir)
        prof["map_s"] = t_run
        prof["device_busy_share"] = prof["device_ms_total"] / (t_run * 1e3)
        res["profile"] = prof
    res["fails"] = fails
    return res


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("gbp", nargs="?", type=float, default=3.0)
    ap.add_argument("--map", type=int, default=0, metavar="N")
    ap.add_argument("--host-check", type=int, default=16, metavar="M")
    ap.add_argument("--profile", default=None, metavar="DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script "
                           "runs the port on a CUDA card")
    card = card_line()
    workdir = os.environ.get("HUMAN_SCALE_DIR",
                             os.path.join(REPO, "_human_scale"))
    os.makedirs(workdir, exist_ok=True)
    fa = os.path.join(workdir, "genome_%ggbp.fa" % args.gbp)
    t_all = time.time()
    ref, result = setup(fa, args.gbp, workdir)
    result = {"metric": "torch_human_scale", "card": card,
              "device": torch.cuda.get_device_name(0), **result}
    if args.map:
        result.update(map_reads(ref, fa, args.map,
                                min(args.host_check, args.map), workdir,
                                profile_dir=args.profile))
    result["total_s"] = time.time() - t_all
    print(json.dumps(result), flush=True)
    keys = ("generate_s", "encode_s", "index_s", "index_positions",
            "max_position", "index_gb", "setup_s", "setup_split_s",
            "map_warm_s", "map_s", "reads_per_s", "mapped_share",
            "placed_share", "max_memory_allocated", "peak_rss_gb",
            "launches", "host_check", "fails")
    sys.stderr.write("\n## torch_human_scale %g Gbp on %s\n\n" % (args.gbp,
                                                                   card))
    for k in keys:
        if k in result:
            sys.stderr.write("- %s: %s\n" % (k, json.dumps(result[k])))
    if result.get("fails"):
        sys.stderr.write("FAIL: %s\n" % "; ".join(result["fails"]))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
space. Above 4.29 Gbp (4.6: three units of 2^31 bases) the genome maps as
the reference maps it: unit planes on the card, the host search and the
Python assembly path; the index holds int64 positions. The work
directory is HUMAN_SCALE_DIR (default _human_scale/ in the checkout); the
FASTA (genome_<GBP>gbp.fa), the reads and the port's *-enc.torch.npz /
*-ht-*.torch.npz caches stay there, so a second run in the same
directory skips generation, encode and index build.

Stages, each timed on its own: generation, encode (or its cache load),
index build (or its cache load), with kept positions, their type, table
GB and peak host RSS. With --map N: N reads of 5-14 kb at ~15% error (10%
insertions, 4% deletions, 1% substitutions), named r<i>_<concat position
of their source>; one Pipeline on the card (its construction timed as
setup, split into the genome and index cache loads, the genome upload and
the device search's tables) maps them twice, a warm pass and a steady
pass, each with the launch counters set to 0 just before it. The steady
pass gives reads/s,
the mapped share, the placed share (primary records within 2 kb of their
source), the context's stage times and search counters, launches per
kernel, each equal to its engine's waves, and the units of the rows
handed to the four alignment kernels. On a genome past 2^32, PAST_READS
more reads from their own generator start past 2^32 (named from r<N>);
their placed share is reported apart, as are each unit's reads, mapped
reads and placed share; each unmapped read is listed with the distinct
13-mers of 5 kb from its source (a tandem repeat shows few). Checks: mapped
share >= 0.95, placed share >= 0.90, and every kernel of the path
launched (the four alignment kernels, and expand_votes with the device
search); on a multi-unit genome also every read mapped, the past-2^32
placed share >= 0.90, the context holding every unit and a score_fill row
naming the last. --host-check M (default 16) maps the first M reads with
the device search and again with the host search on the same Pipeline:
the SAMs must be equal, byte for byte; on a multi-unit genome the device
search is off, so the check is not run ("n/a" in the JSON). --profile DIR
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
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# on a genome past 2^32, PAST_READS more reads (their own generator) whose
# source windows lie wholly past 2^32
PAST_LO = 1 << 32
PAST_READS = 16
PAST_SEED = 232
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


def write_reads(path, ref, n, seed=99, lo=1000, first=0, mode="wb"):
    """n reads sampled from the encoded genome as scripts/human_scale.py
    samples them: 5-14 kb windows with fewer than a quarter N, the
    PacBio-CLR-like profile (10% insertions, 4% deletions, 1%
    substitutions), named r<i>_<source position> (i from first). With lo,
    every window starts at lo or later; mode "ab" appends to path. Returns
    the source positions."""
    rng = np.random.default_rng(seed)
    glen = len(ref.codes)
    origin = []
    with open(path, mode) as f:
        for i in range(first, first + n):
            L = int(rng.integers(5000, 14000))
            # retry until the window decodes to mostly ACGT
            for _ in range(10):
                pos = int(rng.integers(lo, glen - L - 1000))
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


def placed_reads(sam, ref):
    """{read name: whether its primary record lies on the read's source
    chromosome within 2 kb of the source} over the SAM's mapped primary
    records (read names r<i>_<concat position>)."""
    placed = {}
    for line in sam.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        if int(f[1]) & 0x904:
            continue
        conv = ref.convert(int(f[0].rsplit(b"_", 1)[1]))
        placed[f[0]] = conv is not None and (
            f[2] == ref.name_of(conv[0])
            and abs(int(f[3]) - 1 - conv[1]) <= 2000)
    return placed


def placed_share(placed, names=None):
    """Share of placed primary records (placed_reads), over the reads in
    names only where given."""
    got = [v for k, v in placed.items() if names is None or k in names]
    return sum(got) / max(1, len(got))


def distinct_kmers(ref, pos, n=5000, k=13):
    """Distinct k-mers among the n bases from concatenated position pos (a
    read's source): about n for unique sequence, at most p inside a tandem
    repeat of period p."""
    w = ref.decode_window(pos, n + 2) or b""
    return len({w[i:i + k] for i in range(len(w) - k + 1)})


def read_names(path):
    """The record names of a FASTA, in order."""
    with open(path, "rb") as f:
        return [l[1:].split()[0] for l in f if l.startswith(b">")]


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
    t0 = time.time()
    with Stopwatch() as sw:
        sw.wrap("build_s", KmerIndex, "build")
        idx = KmerIndex.load_or_build(ref, fa, use_cache=True)
    res["index_s"] = time.time() - t0
    # a cache is rebuilt where its positions' type does not fit the genome
    # (a uint32 table past 2^32, written by a build that wrapped them)
    res["index_cached"] = "build_s" not in sw.s
    res["index_positions"] = int(len(idx.positions))
    res["index_gb"] = (idx.bucket_start.nbytes + idx.positions.nbytes) / 1e9
    res["positions_dtype"] = str(idx.positions.dtype)
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
    its numbers, with "fails" listing the checks of shares, units and SAMs
    that failed."""
    import torch
    import chip_smoke as cs
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.index.kmer_index import KmerIndex
    from ngmlr_tpu_torch.io.reference import ReferenceGenome
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.pipeline.runner import Pipeline
    from ngmlr_tpu_torch.seed import device_search
    multi = ref.n_units > 1
    reads = os.path.join(workdir, "reads_%d.fa" % n_map)
    write_reads(reads, ref, n_map)
    past = []
    if len(ref.codes) > PAST_LO + (1 << 20):
        # the past-2^32 set, appended after the reference script's reads
        write_reads(reads, ref, PAST_READS, seed=PAST_SEED, lo=PAST_LO,
                    first=n_map, mode="ab")
        past = read_names(reads)[n_map:]
    res = {"map_reads": n_map, "past_2_32_reads": len(past)}
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
    res["units"] = p.ctx.n_units
    res["resident_bytes"] = {"genome": p.ctx.genome.nbytes}
    if p.dev_search is not None:
        res["resident_bytes"].update(
            bucket_pairs=p.dev_search.bucket_pairs.nbytes,
            positions=p.dev_search.positions.nbytes)
    sys.stderr.write("pipeline setup: %.1f s %s, %d unit(s), genome on the "
                     "card %s\n" % (res["setup_s"], json.dumps(sw.s),
                                    p.ctx.n_units,
                                    list(p.ctx.genome.shape)))

    passes = {}
    for tag in ("warm", "steady"):
        with cs.row_reach() as seen:
            out, t_run, launches, st = cs._run_counted(tag + " pass", p,
                                                       reads)
        passes[tag] = dict(map_s=t_run, reads=p.stats["reads"],
                           mapped=p.stats["mapped"], launches=launches,
                           stats=st, rows=cs.reach_of(seen))
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
    placed = placed_reads(out, ref)
    res["placed_share"] = placed_share(placed)
    if past:
        res["placed_share_past_2_32"] = placed_share(placed, set(past))
    names = read_names(reads)
    if multi:
        # by the unit of each read's source
        by_unit = {}
        for name in names:
            u = int(name.rsplit(b"_", 1)[1]) >> ref.unit_bits
            by_unit.setdefault(u, []).append(name)
        res["by_unit"] = {
            str(u): dict(reads=len(un), mapped=sum(n in placed for n in un),
                         placed_share=placed_share(placed, set(un)))
            for u, un in sorted(by_unit.items())}
    # each unmapped read's source, and how repetitive it is
    res["unmapped"] = [
        dict(read=n.decode(), source_distinct_13mers=distinct_kmers(
            ref, int(n.rsplit(b"_", 1)[1])))
        for n in names if n not in placed]
    res["launches"] = steady["launches"]
    res["stats"] = steady["stats"]
    res["rows"] = steady["rows"]
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["peak_rss_gb"] = peak_rss_gb()
    fails = []
    # the device search adds expand_votes; a multi-unit genome maps through
    # the host search, as the reference maps it
    kernels = KERNELS if p.dev_search is not None else KERNELS[:4]
    fails += ["%s launched no time in the steady pass" % k
              for k in kernels if not steady["launches"][k]]
    if res["mapped_share"] < 0.95:
        fails.append("mapped share %.3f < 0.95" % res["mapped_share"])
    if res["placed_share"] < 0.90:
        fails.append("placed share %.3f < 0.90" % res["placed_share"])
    if past and res["placed_share_past_2_32"] < 0.90:
        fails.append("placed share past 2^32 %.3f < 0.90"
                     % res["placed_share_past_2_32"])
    if multi:
        if steady["mapped"] != steady["reads"]:
            fails.append("%d of %d reads mapped" % (steady["mapped"],
                                                   steady["reads"]))
        if p.ctx.n_units != ref.n_units or p.dev_search is not None:
            fails.append("the context holds %d units of the genome's %d, "
                         "device search %s" % (p.ctx.n_units, ref.n_units,
                                               p.dev_search is not None))
        last = ref.n_units - 1
        units = steady["rows"]["score_fill"]["units"]
        if units[1] != last:
            fails.append("no score_fill row of the steady pass names unit "
                         "%d (units %s)" % (last, units))

    if multi and host_check:
        # the device search is off for a multi-unit genome: both runs would
        # take the host search
        res["host_check"] = "n/a: multi-unit genome, host search only"
        sys.stderr.write("host check: %s\n" % res["host_check"])
        host_check = 0
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
    import chip_smoke as cs
    card = cs.card_line()
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
            "max_position", "positions_dtype", "index_gb", "units",
            "setup_s", "setup_split_s", "map_warm_s", "map_s", "reads_per_s",
            "mapped_share", "placed_share", "placed_share_past_2_32",
            "by_unit", "unmapped", "max_memory_allocated", "peak_rss_gb",
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

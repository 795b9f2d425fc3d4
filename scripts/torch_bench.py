#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end read mapping throughput
on one CUDA card. The port's counterpart of bench.py, function for function.

    python3 scripts/torch_bench.py
    BENCH_GENOME_MBP=30 BENCH_PASSES=5 python3 scripts/torch_bench.py
    NGMLR_TORCH_DEVICE=cpu BENCH_GENOME_MBP=0.2 python3 scripts/torch_bench.py

Generates the deterministic synthetic genome and PacBio-CLR-like reads of
bench.py (~15% error: 10% insertions, 4% deletions, 1% substitutions; seed
1234, the same draws in the same order, so both benches write byte-identical
FASTAs into the same work directory under tempfile.gettempdir()), maps them
end-to-end through ngmlr_tpu_torch's Pipeline, and reports reads/s as the
best of BENCH_PASSES passes (default 3), every pass time in `pass_s`.
The port keeps its own caches beside the FASTAs (`*-enc.torch.npz`,
`*-ht-13-2.torch.npz`); scripts/torch_bench_prep.py builds them ahead.

Baseline: the reference maps ~3 Gbp of PacBio reads in ~90 min on a 10-core
Opteron node (README "Introduction") = 60 reads/s at ~8.9 kb mean read
length (BASELINE.md). vs_baseline = our reads/s divided by that 60 r/s.

Scales: 30, 100, 300, 1000 and 3000 Mbp, climbed in ascending order while
the deadline allows (the next scale's cost is extrapolated from the last
one's set-up and map seconds), the largest completed scale reported;
BENCH_GENOME_MBP pins one scale, BENCH_SCALES gives a list. A watchdog
(BENCH_DEADLINE_S, default 840 s) and SIGTERM/SIGINT handlers print the
best-so-far result as the one JSON line however the process ends.

Knobs, as bench.py names them: BENCH_READS (576), BENCH_WARMUP (16),
BENCH_READ_LEN (9000), BENCH_DEADLINE_S, BENCH_GENOME_MBP, BENCH_SCALES,
BENCH_PASSES, BENCH_BATCH_READS, BENCH_VERBOSE. The device is the port's
CLI's: NGMLR_TORCH_DEVICE (default cuda). Without a card and without
NGMLR_TORCH_DEVICE=cpu the line carries an `error` and the exit code is 1;
the bench never maps on the CPU unless asked to.

The line holds bench.py's keys (metric, value, unit, vs_baseline,
genome_mbp, n_reads, pass_s, gcups_convex_dp, gcups_convex_dp_padded,
stage_split_s, stage_counts, host_other_s) and the card's facts: `device`
(name and power limit from nvidia-smi; "cpu" on the CPU), `peak_device_bytes`
(torch.cuda.max_memory_allocated over the scale; null on the CPU), `setup_s`
(work directory, reference and index load, tables on the card),
`kernel_launches` (the five kernels' launches in the best pass; the plain
versions that run on the CPU count none) and `mapped_frac`. A pass starts
and ends with torch.cuda.synchronize() on the card. The line carries an
`error` when the native assembly engine ran no wave on a flat genome (the
Pipeline fell back to the Python assembly path, ~8x slower), when, on the
card, a kernel's launches differ from the engine's record of the pass
(chip_smoke.check_launches), or, as "crashed: ...", when the run raised.

Prints exactly one JSON line on stdout.
"""

import gc
import io
import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the generator (chip_smoke.mutate_pacbio at its default err = 0.15 draws
# and writes as bench.py's), card_line and check_launches
import chip_smoke as cs  # noqa: E402

SCALES_MBP = [30.0, 100.0, 300.0, 1000.0, 3000.0]
# 3 intake batches: measures steady state (prep of batch N+1 overlapped
# with batch N's waves), which is how long runs behave
N_READS = int(os.environ.get("BENCH_READS", "576"))
N_WARMUP = int(os.environ.get("BENCH_WARMUP", "16"))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", "9000"))
BASELINE_RPS = 60.0
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "840"))
T_START = time.time()
NO_SCALE = "no scale completed before deadline"

# best-so-far result; the watchdog/signal handlers print whatever is here
RESULT = {
    "metric": "reads_per_sec_per_chip",
    "value": 0.0,
    "unit": "reads/s",
    "vs_baseline": 0.0,
    "error": NO_SCALE,
}
_emit_lock = threading.Lock()
_emitted = False


def emit(exit_code=None):
    """Print the one JSON line exactly once (thread/signal safe)."""
    global _emitted
    with _emit_lock:
        if not _emitted:
            _emitted = True
            sys.stdout.write(json.dumps(RESULT) + "\n")
            sys.stdout.flush()
    if exit_code is not None:
        os._exit(exit_code)


def _on_signal(signum, frame):
    emit(exit_code=1)


def _watchdog():
    # hard-exit slightly before the external deadline so the JSON line
    # wins the race against SIGKILL; a daemon thread fires even while the
    # main thread is inside a long numpy/torch call
    delay = max(5.0, DEADLINE_S - (time.time() - T_START) - 5.0)
    timer = threading.Timer(delay, emit, kwargs={"exit_code": 2})
    timer.daemon = True
    timer.start()
    return timer


def remaining_s():
    return DEADLINE_S - (time.time() - T_START)


def revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def workdir_for(genome_mbp: float) -> str:
    return os.path.join(
        tempfile.gettempdir(),
        "ngmlr_bench_g%s_r%d_n%d_w%d" % (genome_mbp, READ_LEN, N_READS,
                                         N_WARMUP))


def cache_ready(genome_mbp: float) -> bool:
    """True when a scale's full prep artifact set exists (FASTAs + the
    port's encoded-reference and index caches), so running it costs load
    + passes only."""
    d = workdir_for(genome_mbp)
    return all(os.path.exists(os.path.join(d, f)) for f in (
        "ref.fa", "reads.fa", "warmup.fa",
        "ref.fa-enc.torch.npz", "ref.fa-ht-13-2.torch.npz"))


def prepare_workdir(genome_mbp: float):
    """Genome + reads FASTAs for one scale (cached across runs)."""
    rng = np.random.default_rng(1234)
    glen = int(genome_mbp * 1e6)
    tmpdir = workdir_for(genome_mbp)
    os.makedirs(tmpdir, exist_ok=True)
    ref_path = os.path.join(tmpdir, "ref.fa")
    reads_path = os.path.join(tmpdir, "reads.fa")
    warmup_path = os.path.join(tmpdir, "warmup.fa")
    if not (os.path.exists(ref_path) and os.path.exists(reads_path)
            and os.path.exists(warmup_path)):
        genome = cs.make_genome(rng, glen)
        with open(ref_path + ".tmp", "wb") as f:
            f.write(b">bench_chr1\n")
            g = genome.tobytes()
            for i in range(0, len(g), 80):
                f.write(g[i:i + 80] + b"\n")

        # warmup reads span the same length distribution as the timed set
        with open(reads_path + ".tmp", "wb") as fr, \
                open(warmup_path + ".tmp", "wb") as fw:
            for i in range(N_READS + N_WARMUP):
                lo, hi = READ_LEN // 2, READ_LEN * 3 // 2
                if i < N_WARMUP:
                    L = lo + (hi - lo) * i // max(1, N_WARMUP - 1)
                else:
                    L = int(rng.integers(lo, hi))
                pos = int(rng.integers(0, glen - L))
                read = cs.mutate_pacbio(rng, genome[pos:pos + L])
                if rng.random() < 0.5:
                    read = revcomp(read)
                target = fw if i < N_WARMUP else fr
                target.write(b">read_%d_%d\n" % (i, pos))
                for j in range(0, len(read), 80):
                    target.write(read[j:j + 80] + b"\n")
        del genome
        os.rename(warmup_path + ".tmp", warmup_path)
        os.rename(reads_path + ".tmp", reads_path)
        os.rename(ref_path + ".tmp", ref_path)
    return tmpdir, ref_path, reads_path, warmup_path


def cpu_times():
    with open("/proc/stat") as f:
        parts = f.readline().split()
    # user nice system idle iowait irq softirq steal
    return [int(x) for x in parts[1:9]]


def bench_device() -> str:
    """The device the bench maps on: NGMLR_TORCH_DEVICE, as the port's CLI
    reads it (default cuda)."""
    return os.environ.get("NGMLR_TORCH_DEVICE", "cuda")


def launch_error(launches, ds):
    """None when a pass's launches are those its engine recorded (the
    stats' increments over the pass, ds), as chip_smoke.check_launches
    holds them; else what differs."""
    try:
        cs.check_launches("best pass", launches, ds)
    except cs.PhaseError as e:
        return str(e)
    return None


def run_scale(genome_mbp: float):
    """Map the read set at one genome scale; update RESULT on completion.

    Returns (prep_s, map_s) so the caller can extrapolate whether the next
    scale fits the deadline."""
    import torch
    from ngmlr_tpu_torch.config import Config
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.ops import kernels as K
    from ngmlr_tpu_torch.pipeline.runner import Pipeline

    dev = bench_device()
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_prep0 = time.time()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, ref_path, reads_path, _ = prepare_workdir(genome_mbp)
    cfg = Config()
    if os.environ.get("BENCH_BATCH_READS"):
        cfg.batch_reads = int(os.environ["BENCH_BATCH_READS"])

    def _mark(what):
        sys.stderr.write("bench[%g]: %s at +%.0fs\n"
                         % (genome_mbp, what, time.time() - T_START))
        sys.stderr.flush()
    _mark("workdir ready")
    pipeline = Pipeline(cfg, ref_path, use_cache=True, device=dev)
    sync()
    _mark("pipeline init (ref+index load, tables on the device)")

    t_map0 = time.time()
    # no separate warmup: the first timed pass absorbs the kernels' build
    # (nvcc, once per checkout) and the first-touch costs, and the best
    # pass discards it. The host shows run-to-run variance; take the best
    # pass, and report every pass in the JSON so the distribution is visible
    best = None
    passes = []
    for _ in range(int(os.environ.get("BENCH_PASSES", "3"))):
        sync()
        s0 = dict(pipeline.ctx.stats)
        K.reset_launches()
        c0 = cpu_times()
        t0 = time.time()
        stats = pipeline.run(reads_path, io.BytesIO())
        sync()
        el = time.time() - t0
        c1 = cpu_times()
        launches = dict(K.launches)
        s1 = dict(pipeline.ctx.stats)
        passes.append(el)
        if best is None or el < best[0]:
            best = (el, s0, s1, stats, c0, c1, launches)
    elapsed, s0, s1, stats, c0, c1, launches = best
    if os.environ.get("BENCH_VERBOSE"):
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        dc = [b - a for a, b in zip(c0, c1)]
        tot = max(sum(dc), 1)
        sys.stderr.write(
            "cpu during best pass: user=%d%% sys=%d%% idle=%d%% steal=%d%% "
            "(process minflt=%d majflt=%d)\n"
            % (100 * dc[0] // tot, 100 * dc[2] // tot,
               100 * dc[3] // tot, 100 * dc[7] // tot,
               ru.ru_minflt, ru.ru_majflt))
    ds = {k: v - s0.get(k, 0) for k, v in s1.items()}
    # a flag, not a count: the pass ran under it when the context did
    ds["plain_kernels"] = s1.get("plain_kernels", 0)

    rps = N_READS / elapsed
    host_other = elapsed - ds.get("score_s", 0) - ds.get("align_s", 0) \
        - ds.get("align_fetch_s", 0) - ds.get("upload_s", 0)
    if os.environ.get("BENCH_VERBOSE"):
        sys.stderr.write("bench stats [%g Mbp]: elapsed=%.2fs %s "
                         "host_other=%.2fs\n"
                         % (genome_mbp, elapsed,
                            " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                                     else f"{k}={v}"
                                     for k, v in sorted(ds.items())),
                            host_other))
    mapped_frac = stats["mapped"] / max(1, stats["reads"])
    # align wall = dispatch (pack+upload+launch) + combined-wave fetch
    # (kernel wait + D2H transfer); align_fetch_s lives outside align_s
    a_s = ds.get("align_s", 0.0) + ds.get("align_fetch_s", 0.0)
    gcups_pad = (ds.get("cells_align", 0) / a_s / 1e9) if a_s else 0.0
    gcups_useful = (ds.get("cells_align_useful", 0) / a_s / 1e9) if a_s else 0.0
    stage_counts = {
        k: int(v) for k, v in sorted(ds.items())
        if not isinstance(v, float)
        and k in ("align_problems", "align_waves", "engine_waves",
                  "score_problems", "score_waves", "fire_rounds")}
    errors = []
    if pipeline.ref.n_units == 1 and not stage_counts.get("engine_waves"):
        errors.append("the native assembly engine ran no wave (the Python "
                      "assembly path mapped this scale)")
    bad = launch_error(launches, ds) if on_card else None
    if bad:
        errors.append(bad)
    with _emit_lock:
        RESULT.pop("error", None)
        RESULT.update({
            "value": rps,
            "unit": f"reads/s ({READ_LEN}bp PacBio-like, "
                    f"{mapped_frac:.0%} mapped)",
            "vs_baseline": rps / BASELINE_RPS,
            "genome_mbp": genome_mbp,
            "n_reads": N_READS,
            "pass_s": passes,
            "gcups_convex_dp": gcups_useful,
            "gcups_convex_dp_padded": gcups_pad,
            # stage split of the best pass: where the time goes, without
            # a rerun
            "stage_split_s": {
                k: v for k, v in sorted(ds.items())
                if isinstance(v, float) and k.endswith("_s")},
            "stage_counts": stage_counts,
            "host_other_s": host_other,
            "mapped_frac": mapped_frac,
            "device": cs.card_line() if on_card else "cpu",
            "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                  if on_card else None),
            "setup_s": t_map0 - t_prep0,
            "kernel_launches": launches,
        })
        if errors:
            RESULT["error"] = "; ".join(errors)
    # free the scale's state before the next one: the module's current
    # context would otherwise keep this genome on the device
    device_engine.set_current(None)
    del pipeline
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return t_map0 - t_prep0, time.time() - t_map0


def main():
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    _watchdog()

    try:
        import torch
        if torch.device(bench_device()).type == "cuda" \
                and not torch.cuda.is_available():
            RESULT["error"] = ("no CUDA card: torch.cuda.is_available() is "
                               "false (NGMLR_TORCH_DEVICE=cpu maps with the "
                               "plain versions on the CPU)")
            emit(exit_code=1)
        if os.environ.get("BENCH_GENOME_MBP"):
            scales = [float(os.environ["BENCH_GENOME_MBP"])]
        elif os.environ.get("BENCH_SCALES"):
            scales = [float(x)
                      for x in os.environ["BENCH_SCALES"].split(",")]
        else:
            scales = list(SCALES_MBP)
        _scale_loop(scales)
    except BaseException as e:   # the one JSON line must land regardless
        import traceback
        traceback.print_exc()
        crash = "crashed: %r" % (e,)
        with _emit_lock:
            err = RESULT.get("error", NO_SCALE)
            RESULT["error"] = crash if err == NO_SCALE \
                else "%s; %s" % (err, crash)
        emit(exit_code=1)
    emit(exit_code=1 if "error" in RESULT else None)


def _scale_loop(scales):
    prev = None
    for mbp in scales:
        if prev is not None:
            # extrapolate: prep (genome gen + index build, or their cache
            # loads) scales ~linearly with genome size; mapping time grows
            # mildly (candidate search). 1.4x margin on prep, 2x on map.
            p_mbp, p_prep, p_map = prev
            est = p_prep * (mbp / p_mbp) * 1.4 + p_map * 2.0
            if remaining_s() < est + 15.0:
                sys.stderr.write(
                    "bench: stopping at %g Mbp (next scale %g Mbp needs "
                    "~%.0fs, %.0fs left)\n" % (p_mbp, mbp, est, remaining_s()))
                break
        prep_s, map_s = run_scale(mbp)
        if "error" in RESULT:
            break
        prev = (mbp, prep_s, map_s)


if __name__ == "__main__":
    main()

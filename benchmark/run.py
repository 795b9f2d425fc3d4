#!/usr/bin/env python3
"""Run one cell of the benchmark of ngmlr_tpu_torch (BENCHMARK.json).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Makes (on a checkout's first run) or loads the configuration's genome and
the program's caches beside it, builds the program's Pipeline on the card,
and starts a feeder process that makes the warm-up reads and the read pool
from --seed and streams them through one Pipeline.run over an OS pipe
(harness/window.py, harness/feed.py). The window opens when the warm-up
reads are written and lasts --seconds. With
--trace 0 the line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read under torch.profiler. Then the plain reference
(reference/check.py) judges the records of the checked reads, and the last
line of stdout is one JSON object: correct, attempted, failed, metrics,
device (and with --trace 1 breakdown), the card, and last the checks, each
number beside its limit. The checks are also the last lines of stderr.

Exits 2, printing no result, where torch sees no CUDA card or fewer than
the cell asks for, and 3 where jax, jaxlib, flax or ngmlr_tpu was loaded.
"""

import os
import sys
import time


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


AGE0, CLOCK0 = process_age(), time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

from benchmark.harness.bench import Bench, cache_env, log  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ngmlr_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole: ngmlr_tpu_torch is not ngmlr_tpu."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        "nvidia-smi unavailable"


def card_missing(chips: int):
    """Why this machine cannot run the cell, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return "the cell asks for %d cards, torch sees %d" % (
            chips, torch.cuda.device_count())
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec()
    bench = Bench(spec, args.workload)
    cache_env(spec.dir)
    why = card_missing(bench.cell["chips"])
    if why:
        log("no run: " + why)
        return 2
    report = run(bench, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log("no result: the process loaded %s" % ", ".join(bad))
        return 3
    for name, (value, limit) in report["checks"].items():
        log("check %s %s limit %s" % (name, value, limit))
    sys.stdout.write(json.dumps(report) + "\n")
    sys.stdout.flush()
    return 0


def run(bench: Bench, seed: int, seconds: float, trace: bool) -> dict:
    """One run of the cell; on a device other than the card (the harness's
    CPU tests) the line's device says "cpu" and its memory reads 0."""
    import torch
    on_card = bench.device == "cuda"
    bench.setup()
    r = bench.run(seed, seconds, trace)
    setup_s = AGE0 + (r.window.t_open - CLOCK0)
    metrics = bench.metrics(r, trace, setup_s)
    if on_card:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": bench.cell["chips"],
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    breakdown = None
    if r.trace is not None:
        device["busy_s"] = r.trace.busy_s
        device["window_s"] = r.trace.window_s
        breakdown = {"device_ops": [list(x) for x in r.trace.device_ops],
                     "idle_gaps": [list(x) for x in r.trace.idle_gaps]}
    log("window: %.3f s, %d reads (%.3f Mbp) finished in it, %d handed, "
        "%d unmapped, pool wrapped: %s"
        % (r.seconds, len(r.bases), r.mbp, r.attempted, r.unmapped,
           bool(r.wrapped)))
    bench.free()
    nums, _ = bench.judge(r)
    limits = bench.spec.limits(bench.cell["name"])
    checks = {k: [nums[k], limits[k]] for k in limits}
    card = card_line() if on_card else "cpu"
    log("card: %s" % card)
    report = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": r.attempted,
              # a read fails when it never gets a record; an unmapped
              # record is the program's answer, judged by unmapped_share
              "failed": r.missing,
              "metrics": metrics, "device": device}
    if breakdown:
        report["breakdown"] = breakdown
    report["card"] = card
    report["checks"] = checks
    return report


if __name__ == "__main__":
    sys.exit(main())

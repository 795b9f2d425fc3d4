#!/usr/bin/env python3
"""Readings for a cell's limits: the program's numbers over many seeds, the
control's, and those of faults planted in the program, in one process on
the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 301-312 \\
        --seconds <s> [--check-share X] [--faults narrow75,unmap3 \\
        --fault-seeds 401-403] [--out FILE]

For each of --seeds it runs one window of the cell as benchmark/run.py
does (one Pipeline built once, then one Pipeline.run a seed) and judges
the checked reads twice: as the program wrote them (the lower readings)
and with the score recomputed in the control's precision in the program's
place (an upper reading). Then, for each fault and each of --fault-seeds,
a window with the fault planted (upper readings):

  narrow<P>  the fill's band cut to P% of its width (each align problem's
             corridor width, as the device engine or, on one card, the
             native wave receives it): a fill that misses cells;
  unmap<N>   the SAM writer writes every N-th pool read unmapped: an answer
             refused where it is produced.
  nosupp     the SAM writer drops every supplementary record and every SA
             tag: a split read reported as its primary record alone.

Each line also gives the window's lane-bound retries (a counter of the
program's) and the align rows that DIRS_CAP refused, read from each native
wave's plan (pipeline/native_engine.py's observe_waves).

--check-share replaces the mix's share of checked reads, so that a short
window checks as many reads as a run does. Prints one JSON line a window
and a last line with, for each number, the largest program reading, the
smallest control reading and each fault's smallest. The benchmark's own
runs plant nothing and never run the control.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import argparse  # noqa: E402
import ctypes  # noqa: E402

import numpy as np  # noqa: E402

from benchmark.harness.bench import Bench, cache_env, log  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402

# the precision below the float32 the configurations state
CONTROL = "bfloat16"

ACTIVE = {"fault": "none"}


def seeds_of(text: str):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def _factor(prefix: str) -> int:
    f = ACTIVE["fault"]
    return int(f[len(prefix):]) if f.startswith(prefix) else 0


def _narrowed(pk, n: int):
    """A copy of align rows [P, 12] with each corridor width (column 9)
    cut to n%."""
    pk = pk.copy()
    pk[:, 9] = (pk[:, 9] * n // 100).clip(min=1)
    return pk


def plant_faults():
    """Wraps the program's align dispatch (the Python wave's and the
    native wave's launch) and SAM writer; each wrapper acts only while
    ACTIVE names its fault."""
    from ngmlr_tpu_torch.ops import device_engine
    from ngmlr_tpu_torch.out import sam
    from ngmlr_tpu_torch.pipeline import native_engine
    dispatch = device_engine.DeviceContext.align_dispatch_pk
    launch = native_engine.NativeWave.launch
    write_read = sam.SamWriter.write_read

    def narrow_dispatch(self, pk_all, *a, **k):
        n = _factor("narrow")
        if n and len(pk_all):
            pk_all = _narrowed(pk_all, n)
        return dispatch(self, pk_all, *a, **k)

    def narrow_launch(self, apk_p, na: int, spk_p, ns: int):
        n = _factor("narrow")
        if n and na:
            rows = np.ctypeslib.as_array(
                ctypes.cast(apk_p, ctypes.POINTER(ctypes.c_int32)),
                shape=(na, 12))
            # the engine keeps its own rows; the copy lives until the
            # wave's next launch, past its fetch
            self.narrowed = _narrowed(rows, n)
            apk_p = ctypes.c_void_p(self.narrowed.ctypes.data)
        return launch(self, apk_p, na, spk_p, ns)

    def unmap_write(self, read, records, mapped):
        n = _factor("unmap")
        if n and read.name[:1] == b"r" and \
                int(read.name[1:].split(b"_")[0]) % n == 0:
            mapped = False
        if ACTIVE["fault"] == "nosupp":
            records = [r for r in records if r.align.primary]
        return write_read(self, read, records, mapped)
    device_engine.DeviceContext.align_dispatch_pk = narrow_dispatch
    native_engine.NativeWave.launch = narrow_launch
    sam.SamWriter.write_read = unmap_write


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 301-312,400")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--check-share", type=float, default=None)
    p.add_argument("--faults", default="", help="e.g. narrow75,unmap3")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    plant_faults()
    spec = Spec()
    cache_env(spec.dir)
    bench = Bench(spec, args.workload)
    if args.check_share is not None:
        bench.mix["check_share"] = args.check_share
    bench.setup()
    runs = [("none", s) for s in seeds_of(args.seeds)]
    runs += [(f, s) for f in filter(None, args.faults.split(","))
             for s in seeds_of(args.fault_seeds)]
    from ngmlr_tpu_torch.pipeline import native_engine
    lines = []
    for fault, seed in runs:
        ACTIVE["fault"] = fault
        refused = []      # the align rows DIRS_CAP refused, a wave each
        with native_engine.observe_waves(
                lambda wave: refused.append(len(wave.launched()[1]))):
            r = bench.run(seed, args.seconds)
        nums, ctrl = bench.judge(r, CONTROL if fault == "none" else None)
        line = {"seed": seed, "fault": fault, "program": nums,
                "control": ctrl, "metrics": bench.metrics(r, False, 0.0),
                "reads_in_window": int(len(r.bases)),
                "checked": len(r.checked),
                "lane_bound_retries": r.delta("lane_bound_retries"),
                "dirs_cap_refused_rows": sum(refused)}
        lines.append(line)
        log(json.dumps(line))
        print(json.dumps(line), flush=True)
    ACTIVE["fault"] = "none"
    sound = [x for x in lines if x["fault"] == "none"]
    keys = list(sound[0]["program"])
    summary = {"workload": args.workload, "seeds": len(sound),
               "lower": {k: max(x["program"][k] for x in sound)
                         for k in keys},
               "control": {k: min(x["control"][k] for x in sound)
                           for k in keys}}
    for f in sorted({x["fault"] for x in lines} - {"none"}):
        summary[f] = {k: min(x["program"][k] for x in lines
                             if x["fault"] == f) for k in keys}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for x in lines + [summary]:
                f.write(json.dumps(x) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

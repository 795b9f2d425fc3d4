"""The 95th percentile (nearest rank), over every read finished in the
window, of the seconds from the feeder handing the read to the pipe to the
sink receiving its last record (host clock)."""

from benchmark.harness.window import p95


def read(run):
    if len(run.latencies) == 0:
        return None
    return p95(run.latencies)

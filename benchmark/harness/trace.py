"""The device trace of a --trace 1 run: torch.profiler over the program's
run, read back over the window only.

The window's edges are two instant markers (`bench.window.open`,
`bench.window.close`) recorded on the host threads that see them, where
the profiler records every thread; elsewhere, the wall-clock nanoseconds
the window noted at the same moments (the profiler's clock is the wall
clock; where both exist, their offset is kept in `notes`). Device activity is every event the
profiler puts on the card (kernels, copies, sets). Busy time is the union
of those intervals inside the window; the idle gaps are what is left,
each named by the host-side profiler events that overlap it most.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

OPEN, CLOSE = "bench.window.open", "bench.window.close"


def _t(e):
    """(start, end) of a profiler event in ns."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]            # device seconds by event name
    device_ops: List[Tuple[str, float]]   # the ten longest, by name
    idle_gaps: List[Tuple[str, float]]    # the ten longest gaps
    notes: List[str] = field(default_factory=list)

    def seconds_of(self, *fragments) -> float:
        """Device seconds of the events whose names hold any fragment."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(f in n for f in fragments))


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace and
    arguments, at most 100 characters: `fill_tiled<2, 128>`."""
    name = name.split("(anonymous namespace)::")[-1]
    if name.startswith("void "):
        name = name[5:]
    return (name.split("(", 1)[0].strip() or name)[:100]


def merge(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stop = np.append(last[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[stop]], axis=1)


def summarize(events, is_device, edges_ns=None) -> TraceSummary:
    """events: the profiler's events; is_device(e) tells the card's;
    edges_ns: the window's (open, close) on the wall clock, used where the
    markers are missing."""
    marks = {}
    dev, host = [], []
    for e in events:
        name = e.name()
        if name in (OPEN, CLOSE):
            marks[name] = _t(e)[0]
            continue
        s, t = _t(e)
        if t <= s:
            continue
        (dev if is_device(e) else host).append((name, s, t))
    notes = []
    if OPEN in marks and CLOSE in marks:
        w0, w1 = marks[OPEN], marks[CLOSE]
        if edges_ns:
            notes.append("markers - wall clock: %d, %d ns" % (
                w0 - edges_ns[0], w1 - edges_ns[1]))
    elif edges_ns:
        w0, w1 = edges_ns
        notes.append("no markers: the window's wall-clock edges")
    else:
        raise RuntimeError("the trace holds no window markers")
    by_name: Dict[str, float] = {}
    iv = []
    for name, s, t in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
            iv.append((s, t))
    busy = merge(np.asarray(iv, dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    # the gaps between busy intervals, inside the window
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    top = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:10]]
    hs = np.asarray([h[1] for h in host], dtype=np.int64)
    ht = np.asarray([h[2] for h in host], dtype=np.int64)
    idle = []
    for g0, g1 in top:
        over = np.minimum(ht, g1) - np.maximum(hs, g0)
        hit = np.flatnonzero(over > 0)
        names = {}
        for k in hit:
            names[host[k][0]] = names.get(host[k][0], 0) + int(over[k])
        label = " + ".join(n for n, _ in sorted(
            names.items(), key=lambda kv: -kv[1])[:2]) or "host, no profiled op"
        idle.append((label, float(g1 - g0) * 1e-9))
    short: Dict[str, float] = {}
    for name, sec in by_name.items():
        short[short_name(name)] = short.get(short_name(name), 0.0) + sec
    ops = sorted(short.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=float(w1 - w0) * 1e-9, busy_s=busy_s,
                        kernel_s=by_name, device_ops=ops, idle_gaps=idle,
                        notes=notes)


class Tracer:
    """torch.profiler over CPU and CUDA activity, started before the
    program's run; mark() drops the window's markers."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig
            self.prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except TypeError:       # a torch without profile_all_threads
            self.prof = profile(activities=acts)
        self.prof.start()

    @staticmethod
    def mark(what: str):
        from torch.profiler import record_function
        with record_function("bench.window." + what):
            pass

    def finish(self, edges_ns=None) -> TraceSummary:
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        return summarize(events,
                         lambda e: str(e.device_type()).endswith("CUDA"),
                         edges_ns)

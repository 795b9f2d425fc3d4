"""The measured window: a feeder process (harness/feed.py) that streams
FASTA records into an OS pipe, the program's one run over that pipe, and a
sink that timestamps each SAM record as the program writes it.

The loop is closed: the pipe holds what the program has not read yet, and
a full pipe blocks the feeder. The feeder writes the warm-up reads first,
then the pool's reads, wrapping round the pool (and saying so on stderr)
if it runs out. The window opens when the sink receives the last warm-up
read's records and lasts `seconds`; at its end the feeder stops and
closes the pipe, and the program drains what it holds. Those reads are
judged too, but count in no metric.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

clock = time.monotonic     # the feeder's clock too


def read_name(line: bytes) -> bytes:
    i = line.find(b"\t")
    return line[:i] if i >= 0 else line.rstrip(b"\n")


def pool_index(name: bytes) -> int:
    """r<i> or r<i>_<pass> -> i."""
    return int(name[1:].split(b"_", 1)[0])


class Sink:
    """The program's output stream. Keeps, for every read, the time its
    last record was written, the unmapped reads, and the records of the
    reads in `keep`."""

    def __init__(self, keep, last_warm: bytes,
                 on_open: Callable[[float], None]):
        self.keep = keep
        self.last_warm = last_warm
        self.on_open = on_open
        self.done: Dict[bytes, float] = {}
        self.lines: Dict[bytes, List[bytes]] = {}
        self.header: List[bytes] = []
        self.unmapped = set()
        self._prev = None

    def write(self, b: bytes) -> int:
        t = clock()
        if b[:1] == b"@":
            self.header.append(bytes(b))
            return len(b)
        name = read_name(b)
        if name != self._prev:
            self._prev = name
            flag = b[len(name) + 1:b.index(b"\t", len(name) + 1)]
            if int(flag) & 0x4:
                self.unmapped.add(name)
        self.done[name] = t
        if name in self.keep:
            self.lines.setdefault(name, []).append(bytes(b))
        if name == self.last_warm:
            self.on_open(t)
        return len(b)

    def flush(self):
        pass


class Feed:
    """The feeder child process (harness/feed.py) over the pipe's write end
    `wfd`, which it inherits (and this process closes). `job` is its job
    without `fd` and `open_wait`. The constructor returns when the child
    has made the warm-up reads and the pool's first chunk; the child then
    writes into the pipe and makes the rest as it goes. finish() fills
    `handed` (name -> the time its write returned), `lengths` (of the pool
    reads made, by index), `wrapped` and `starved_s`."""

    def __init__(self, job: dict, wfd: int, open_wait: float = 600.0):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.n = job["n_pool"] if "n_pool" in job else len(
            job["records"][1])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.harness.feed"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, pass_fds=(wfd,))
        os.close(wfd)
        self.proc.stdin.write(json.dumps(dict(
            job, fd=wfd, open_wait=open_wait)).encode() + b"\n")
        self.proc.stdin.flush()
        try:
            pickle.load(self.proc.stdout)
        except EOFError:
            self.proc.wait()
            raise RuntimeError("the feeder ended before its reads were made "
                               "(exit %s)" % self.proc.returncode) from None
        self.handed: Dict[bytes, float] = {}
        self.lengths = np.zeros(0, dtype=np.int64)
        self.wrapped = False
        self.starved_s = 0.0

    def close_at(self, t: float):
        self.proc.stdin.write(b"%r\n" % t)
        self.proc.stdin.flush()

    def finish(self, timeout: float = 120.0):
        """Waits for the child and reads its report."""
        try:
            rep = pickle.load(self.proc.stdout)
        except EOFError:
            rep = None
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=timeout)
        if rep is None or rc:
            raise RuntimeError("the feeder failed (exit %s)" % rc)
        n = self.n
        self.handed = {
            b"r%d" % (i % n) + (b"_%d" % (i // n) if i >= n else b""): t
            for i, t in enumerate(rep["handed"])}
        self.lengths = np.asarray(rep["lengths"], dtype=np.int64)
        self.wrapped = rep["wrapped"]
        self.starved_s = rep["starved_s"]


@dataclass
class Window:
    t_open: Optional[float] = None
    t_close: Optional[float] = None
    ns_open: int = 0            # the same moments on the wall clock
    ns_close: int = 0
    stats_open: dict = field(default_factory=dict)
    stats_close: dict = field(default_factory=dict)
    cpu_open: dict = field(default_factory=dict)     # host_cpu() at the
    cpu_close: dict = field(default_factory=dict)    # edges
    opened: threading.Event = field(default_factory=threading.Event)
    closed: threading.Event = field(default_factory=threading.Event)


def host_cpu(pids=()) -> Dict[str, float]:
    """CPU seconds so far of each of this process's threads, keyed by the
    Python thread's name where it has one (else the OS's) and its id, and
    of each process in pids, keyed pid:<pid> (/proc)."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    paths = [("%s:%s" % (names.get(int(t), ""), t),
              "/proc/self/task/%s" % t) for t in os.listdir("/proc/self/task")]
    paths += [("pid:%d" % p, "/proc/%d" % p) for p in pids]
    for key, path in paths:
        try:
            with open(path + "/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if key[:1] == ":":
                with open(path + "/comm") as f:
                    key = f.read().strip() + key
        except OSError:
            continue
        out[key] = (int(fields[11]) + int(fields[12])) / tick
    return out


def run_window(pipeline, feed: Feed, rfd: int, last_warm: bytes, keep,
               seconds: float, mark: Callable[[str], None] = None):
    """One Pipeline.run over the pipe's read end `rfd`, which `feed`
    writes; returns (window, sink, the run's stats). `mark(what)` is called
    at the window's open and close ("open", "close"), on the thread that
    sees it."""
    w = Window()

    def on_open(t):
        if w.t_open is not None:
            return
        w.stats_open = dict(pipeline.ctx.stats)
        w.cpu_open = host_cpu([feed.proc.pid])
        w.ns_open = time.time_ns() - int((clock() - t) * 1e9)
        w.t_open = t
        w.t_close = t + seconds
        feed.close_at(w.t_close)
        if mark:
            mark("open")
        w.opened.set()

    def closer():
        w.opened.wait()
        while clock() < w.t_close:
            time.sleep(max(0.0, w.t_close - clock()))
        w.stats_close = dict(pipeline.ctx.stats)
        w.cpu_close = host_cpu([feed.proc.pid])
        w.ns_close = time.time_ns() - int((clock() - w.t_close) * 1e9)
        if mark:
            mark("close")
        w.closed.set()

    sink = Sink(keep, last_warm, on_open)
    timer = threading.Thread(target=closer, daemon=True)
    # the timer waits for the window to open; a run that never opens it
    # ends with the feeder's open_wait, and the timer with the process
    timer.start()
    try:
        stats = pipeline.run("/dev/fd/%d" % rfd, sink)
    finally:
        os.close(rfd)
        feed.finish()
    if w.t_open is None:
        raise RuntimeError("the window never opened: the last warm-up read "
                           "%r was never written" % last_warm)
    if not w.closed.wait(timeout=max(0.0, w.t_close - clock()) + 60):
        raise RuntimeError("the window never closed")
    timer.join()
    return w, sink, stats


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[int(np.ceil(0.95 * len(v))) - 1])


def account(t_open: float, t_close: float, handed: Dict[bytes, float],
            done: Dict[bytes, float], length_of: Callable):
    """The window's reads: every pool read whose last record came in
    [t_open, t_close). Returns (bases, latencies in s, names) of them."""
    names, bases, lat = [], [], []
    for name, t in done.items():
        if name[:1] != b"r" or not (t_open <= t < t_close):
            continue
        names.append(name)
        bases.append(length_of(name))
        lat.append(t - handed[name])
    return (np.asarray(bases, dtype=np.int64),
            np.asarray(lat, dtype=np.float64), names)


def slices(t_open: float, t_close: float, done: Dict[bytes, float],
           length_of: Callable, n: int = 5):
    """kbp/s of the pool reads finished in each of n equal slices of the
    window: whether a run was slow all through or for a while."""
    edges = np.linspace(t_open, t_close, n + 1)
    kb = np.zeros(n)
    for name, t in done.items():
        if name[:1] == b"r" and t_open <= t < t_close:
            kb[min(n - 1, np.searchsorted(edges, t, "right") - 1)] += \
                length_of(name) / 1e3
    return kb / ((t_close - t_open) / n)

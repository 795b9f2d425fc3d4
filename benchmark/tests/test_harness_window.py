"""The window's accounting: throughput, the latency tail and the reads at
its edges, with a fake program behind the pipe."""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness import window


def test_account_counts_only_reads_finished_inside():
    handed = {b"r0": 0.0, b"r1": 0.5, b"r2": 1.0, b"r3": 1.2, b"r4": 1.9}
    done = {b"w5": 1.0, b"r0": 0.9, b"r1": 1.5, b"r2": 2.0, b"r3": 1.99,
            b"r4": 2.5}
    lens = {0: 100, 1: 200, 2: 300, 3: 400, 4: 500}
    bases, lat, names = window.account(1.0, 2.0, handed, done,
                                       lambda n: lens[window.pool_index(n)])
    assert sorted(names) == [b"r1", b"r3"]      # r0 before, r2 at close
    assert bases.sum() == 600
    assert sorted(np.round(lat, 6)) == [0.79, 1.0]


def test_p95_is_the_nearest_rank():
    assert window.p95(range(1, 101)) == 95
    assert window.p95(range(1, 21)) == 19
    assert window.p95([3.0]) == 3.0
    assert window.p95([5, 1, 4, 2, 3]) == 5


def test_pool_index_of_wrapped_names():
    assert window.pool_index(b"r17") == 17
    assert window.pool_index(b"r17_3") == 17


class FakePipeline:
    """Reads FASTA from the path and writes one SAM-like record per read,
    `delay` seconds after reading it (two for every third read)."""

    def __init__(self, delay):
        self.delay = delay
        self.ctx = SimpleNamespace(stats={"emit_s": 0.0})

    def run(self, path, out):
        out.write(b"@HD\tVN:1.0\n")
        with open(path, "rb") as f:
            i = 0
            while True:
                head = f.readline()
                if not head:
                    break
                seq = f.readline().rstrip(b"\n")
                time.sleep(self.delay)
                name = head[1:].rstrip(b"\n")
                for _ in range(1 + (i % 3 == 0)):
                    out.write(b"%s\t0\tchr1\t1\t60\t%dM\t*\t0\t0\t%s\t*\n"
                              % (name, len(seq), seq))
                self.ctx.stats["emit_s"] += self.delay
                i += 1
        return {}


def _reads(n, prefix, L):
    return [b">%s%d\n%s\n" % (prefix, i, b"A" * (L + i)) for i in range(n)]


def _feed(warm, pool, open_wait=600.0):
    """A feeder process over a new pipe, streaming these records; returns
    (the feed, the pipe's read end)."""
    rfd, wfd = os.pipe()
    feed = window.Feed({"records": [[r.decode("latin-1") for r in x]
                                    for x in (warm, pool)]}, wfd, open_wait)
    return feed, rfd


@pytest.mark.parametrize("n_pool,wraps", [(400, False), (7, True)])
def test_window_over_a_fake_program(n_pool, wraps):
    feed, rfd = _feed(_reads(3, b"w", 10), _reads(n_pool, b"r", 50))
    keep = {b"r1", b"r2"}
    w, sink, _ = window.run_window(FakePipeline(0.002), feed, rfd, b"w2",
                                   keep, 0.4)
    assert feed.proc.poll() is not None
    assert feed.lengths.tolist() == [50 + i for i in range(n_pool)]

    def length_of(name):
        return int(feed.lengths[window.pool_index(name)])
    assert w.t_close - w.t_open == pytest.approx(0.4)
    assert w.stats_close["emit_s"] > w.stats_open["emit_s"]
    bases, lat, names = window.account(w.t_open, w.t_close, feed.handed,
                                       sink.done, length_of)
    assert 20 < len(names) < 400
    assert all(sink.done[n] >= w.t_open for n in names)
    assert (lat > 0).all()
    # every handed read was written, also those drained after the close
    assert set(feed.handed) <= set(sink.done)
    assert any(t >= w.t_close for t in sink.done.values())
    # the kept reads' records: one for r1, two for every third read
    assert len(sink.lines[b"r1"]) == 1 and set(sink.lines) == keep
    assert feed.wrapped == wraps
    assert any(b"_" in n for n in feed.handed) == wraps
    # the feeder's CPU is read apart from this process's threads
    assert "pid:%d" % feed.proc.pid in w.cpu_close


def test_window_that_never_opens_raises():
    feed, rfd = _feed(_reads(2, b"w", 5), _reads(1, b"r", 5), open_wait=0.3)
    with pytest.raises(RuntimeError, match="never opened"):
        window.run_window(FakePipeline(0.0), feed, rfd, b"w9", set(), 0.05)
    assert feed.proc.poll() is not None


def test_host_cpu_names_this_thread():
    cpu = window.host_cpu()
    me = threading.current_thread()
    assert "%s:%d" % (me.name, me.native_id) in cpu
    assert all(v >= 0 for v in cpu.values())


def test_slices_split_the_window():
    done = {b"r0": 1.0, b"r1": 1.5, b"r2": 2.9, b"w1": 1.2, b"r3": 3.1}
    ks = window.slices(1.0, 3.0, done, lambda n: 1000, n=2)
    assert ks.tolist() == [2.0, 1.0]


def test_pool_made_while_feeding_keeps_its_order():
    """The feeder's pool, made chunk by chunk by two workers while the
    writer reads it, gives every record in order; a failed chunk stops the
    writer with the generator's error."""
    from benchmark.harness import feed as F

    def run(job):
        time.sleep(0.01 * (job % 3))
        return [b"%d" % (job * 10 + k) for k in range(10)]
    pool = F.Pool(100, [b"%d" % k for k in range(10)])
    maker = threading.Thread(target=pool.make, args=(range(1, 10), 10, 2,
                                                     run))
    maker.start()
    got = [pool.get(j)[0] for j in range(100)]
    maker.join()
    assert got == [b"%d" % k for k in range(100)]

    def bad(job):
        raise ValueError("no genome")
    pool = F.Pool(30, [b"0"])
    threading.Thread(target=pool.make, args=([1], 1, 2, bad)).start()
    with pytest.raises(RuntimeError, match="no genome"):
        pool.get(5)

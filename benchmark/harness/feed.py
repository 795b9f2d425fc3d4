"""The feeder: a child process that makes a run's reads and streams them
into the program's pipe, as `cat reads.fa | ngmlr` does, so that none of
the load's work runs in the program's process.

    python -m benchmark.harness.feed     (run by window.Feed)

It reads one JSON job line on stdin: `fd`, the pipe's write end it
inherited; `open_wait`; and either `records` (the warm-up and pool FASTA
records, latin-1 text) or what the generator needs to make them (`mix`,
`seed`, `npy`, `n_warm`, `n_pool`, `workers`). It makes the warm-up reads
and the pool's first chunk, writes one pickle to stdout ({"ready": True}),
then writes the warm-up records and the pool's into the pipe, one write
loop a record, noting the monotonic clock after each pool record. The
pool's later chunks are made while it streams, by `workers` child
generators, at most AHEAD chunks past the one being written; past the
pool's last read it wraps round (saying so on stderr). A line on stdin
gives the window's close on that clock; at the close (or `open_wait`
seconds after the first write, if no close came) it closes the pipe and
writes a last pickle: {"handed": the times, in the order written,
"lengths": the lengths of the pool reads made, "wrapped": whether the pool
ran out, "starved_s": the seconds the writer waited for a chunk once
the window was open}.
"""

import json
import os
import pickle
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

clock = time.monotonic

AHEAD = 4     # chunks made ahead of the one being written


def _write(fd: int, rec: bytes):
    view = memoryview(rec)
    while view:
        view = view[os.write(fd, view):]


class Pool:
    """The pool's records as they are made, in order, and the writer's
    place in them."""

    def __init__(self, n: int, records=()):
        self.n = n
        self.recs = list(records)
        self.pos = 0
        self.stop = False
        self.error = None
        self.cond = threading.Condition()

    def add(self, recs):
        with self.cond:
            self.recs.extend(recs)
            self.cond.notify_all()

    def get(self, j: int):
        """Record j, and the seconds waited for it."""
        with self.cond:
            self.pos = j
            self.cond.notify_all()
            if len(self.recs) > j:
                return self.recs[j], 0.0
            t0 = clock()
            self.cond.wait_for(lambda: len(self.recs) > j or self.error)
            if self.error:
                raise RuntimeError("read generator failed: %s" % self.error)
            return self.recs[j], clock() - t0

    def make(self, jobs, chunk: int, workers: int, run):
        """Runs `run(job)` for jobs in order, at most `workers` at a time
        and AHEAD chunks of `chunk` reads past the writer's place, adding
        each result in order as it comes."""
        try:
            with ThreadPoolExecutor(workers) as ex:
                pending = deque()
                for c, job in enumerate(jobs):
                    while True:
                        while pending and pending[0].done():
                            self.add(pending.popleft().result())
                        with self.cond:
                            if self.stop:
                                return
                            if len(pending) < workers and \
                                    self.pos >= (c - AHEAD) * chunk:
                                break
                            self.cond.wait(0.05)
                    pending.append(ex.submit(run, job))
                while pending and not self.stop:
                    self.add(pending.popleft().result())
        except BaseException as e:        # reported to the writer
            with self.cond:
                self.error = repr(e)[-2000:]
                self.cond.notify_all()


def stream(fd: int, warm, pool: Pool, close_at, give_up: float):
    """Writes warm, then the pool round and round, until close_at() (a time
    or None) has passed, or give_up while it is None. Returns (the time
    each pool record's write returned, whether the pool wrapped, the
    seconds waited for records)."""
    handed, wrapped, starved = [], False, 0.0
    try:
        for rec in warm:
            _write(fd, rec)
        i = 0
        while True:
            t_close = close_at()
            if clock() >= (give_up if t_close is None else t_close):
                break
            j, lap = i % pool.n, i // pool.n
            rec, waited = pool.get(j)
            if t_close is not None:
                starved += waited
            if lap:
                if not wrapped:
                    wrapped = True
                    sys.stderr.write(
                        "feeder: the window outlasted the pool of %d reads; "
                        "reads repeat from here, named r<i>_<lap>\n" % pool.n)
                cut = rec.index(b"\n")
                rec = rec[:cut] + b"_%d" % lap + rec[cut:]
            _write(fd, rec)
            handed.append(clock())
            i += 1
    except BrokenPipeError:
        pass
    finally:
        os.close(fd)
    return handed, wrapped, starved


class Lines:
    """Lines from a file descriptor, read without a buffered reader (whose
    lock a thread blocked in it would hold at the interpreter's exit)."""

    def __init__(self, fd: int):
        self.fd, self.rest = fd, b""

    def readline(self) -> bytes:
        while b"\n" not in self.rest:
            more = os.read(self.fd, 1 << 16)
            if not more:
                line, self.rest = self.rest, b""
                return line
            self.rest += more
        line, _, self.rest = self.rest.partition(b"\n")
        return line + b"\n"


def main():
    stdin = Lines(0)
    job = json.loads(stdin.readline())
    maker = None
    if "records" in job:
        warm, recs = ([r.encode("latin-1") for r in x] for x in job["records"])
        pool = Pool(len(recs), recs)
    else:
        import numpy as np
        from benchmark.harness import gen
        genome = np.load(job["npy"], mmap_mode="r")
        mix, seed = job["mix"], job["seed"]
        warm = gen.records(mix, seed, genome, 0, job["n_warm"], warm=True)
        n, chunk = job["n_pool"], gen.chunk_reads(mix)
        pool = Pool(n, gen.records(mix, seed, genome, 0, min(chunk, n)))
        jobs = [[mix, seed, job["npy"], a, min(chunk, n - a), False]
                for a in range(chunk, n, chunk)]
        maker = threading.Thread(target=pool.make, args=(
            jobs, chunk, job["workers"], gen.chunk_in_child), daemon=True)
        maker.start()
    out = sys.stdout.buffer
    pickle.dump({"ready": True}, out)
    out.flush()
    close = []

    def listen():
        line = stdin.readline()
        if line.strip():
            close.append(float(line))
    threading.Thread(target=listen, daemon=True).start()
    handed, wrapped, starved = stream(
        job["fd"], warm, pool, lambda: close[0] if close else None,
        clock() + job["open_wait"])
    with pool.cond:
        pool.stop = True
        pool.cond.notify_all()
    if maker:
        maker.join()
    lengths = [len(r) - r.index(b"\n") - 2 for r in pool.recs]
    pickle.dump({"handed": handed, "lengths": lengths, "wrapped": wrapped,
                 "starved_s": starved}, out)
    out.flush()


if __name__ == "__main__":
    main()

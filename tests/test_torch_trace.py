"""The port's own tracing (ngmlr_tpu_torch), on the CPU: the counters of
DeviceContext.stats, each batch's waits in Pipeline.run, the ngmlr.* spans
a torch profiler records from the prep, wave and main threads, and the
names of the program's threads.
"""

import io
import os
import sys
import threading
import time

import pytest
import torch

from ngmlr_tpu_torch.cli import build_parser, config_from_args
from ngmlr_tpu_torch.ops import device_engine
from ngmlr_tpu_torch.pipeline import batcher
from ngmlr_tpu_torch.pipeline.runner import Pipeline

from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

REF = os.path.join(DATA_DIR, "test_2/ref_chr21_20kb.fa")
READS = os.path.join(DATA_DIR, "test_2/reads_100_2200bp.fa")
BATCH_READS = 10
N_READS = 12             # test_2's reads: two intake batches of 10
SPANS = {"ngmlr.intake": "MainThread", "ngmlr.emit": "MainThread",
         "ngmlr.prep.enc": "ngmlr-prep", "ngmlr.prep.search": "ngmlr-prep",
         "ngmlr.prep.score": "ngmlr-prep",
         "ngmlr.waves.engine": "ngmlr-wave",
         "ngmlr.waves.dispatch": "ngmlr-wave",
         "ngmlr.waves.fetch": "ngmlr-wave", "ngmlr.waves.post": "ngmlr-wave",
         "ngmlr.waves.records": "ngmlr-wave"}


def _pipeline(batch_reads):
    argv = ["-r", REF, "-q", READS]
    cfg = config_from_args(build_parser().parse_args(argv), argv)
    cfg.batch_reads = batch_reads
    return Pipeline(cfg, REF, use_cache=True, device="cpu")


def _records(sam_bytes):
    return [l for l in sam_bytes.split(b"\n") if not l.startswith(b"@PG")]


class _Names:
    """Samples, while a run lasts, the threads' names: Python's and the
    operating system's (/proc/self/task/*/comm)."""

    def __init__(self):
        self.py, self.os = set(), set()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            self.py.update(t.name for t in threading.enumerate())
            for tid in os.listdir("/proc/self/task"):
                try:
                    with open("/proc/self/task/%s/comm" % tid) as f:
                        self.os.add(f.read().strip())
                except OSError:
                    pass
            self._stop.wait(0.01)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=10)
        assert not self._t.is_alive()


@pytest.fixture(scope="module")
def run():
    """test_2 at two wave slots, 10 reads a batch, with the profiler's
    ranges made to raise: with no profiler recording, no span may open
    one."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with the profiler off")

    clocks = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGMLR_TPU_WAVE_DEPTH", "2")
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        account = Pipeline._account

        def keep(self, clk):
            clocks.append(clk)
            account(self, clk)
        mp.setattr(Pipeline, "_account", keep)
        p = _pipeline(BATCH_READS)
        out = io.BytesIO()
        with _Names() as names:
            p.run(READS, out)
    return p, clocks, names, out.getvalue()


def test_every_counter_is_there_after_a_run(run):
    p, clocks, _, sam = run
    st = p.ctx.stats
    assert set(device_engine.STAT_KEYS) <= set(st)
    n_batches = -(-N_READS // BATCH_READS)
    assert st["batches"] == len(clocks) == n_batches
    assert [c.id for c in clocks] == list(range(n_batches))
    for key in ("intake_s", "engine_wait_s", "engine_cpu_s", "emit_s",
                "waves_wall_s", "main_wait_prep_s"):
        assert st[key] > 0, key
    assert st["native_failed"] == 0
    with open(os.path.join(GOLDEN_DIR, "test_2.sam"), "rb") as f:
        assert _records(sam) == _records(f.read())


def test_a_batch_is_its_waits_its_waves_and_its_emit(run):
    """From prep's end to emission's end a batch is in exactly one of: the
    wait for a wave slot, its waves, the wait behind an older batch, its
    emission; and the run's counters are those intervals' sums."""
    p, clocks, _, _ = run
    st = p.ctx.stats
    parts = {"batch_wait_wave_s": [], "waves_wall_s": [],
             "batch_wait_emit_s": [], "emit_s": []}
    for c in clocks:
        steps = [c.wave_start - c.prep_end, c.wave_end - c.wave_start,
                 c.emit_start - c.wave_end, c.emit_end - c.emit_start]
        assert min(steps) >= 0, steps
        assert abs(c.emit_end - c.prep_end - sum(steps)) < 1e-3
        for key, v in zip(parts, steps):
            parts[key].append(v)
    for key, vs in parts.items():
        assert st[key] == pytest.approx(sum(vs), abs=1e-6), key


def test_the_program_names_its_threads(run):
    _, _, names, _ = run
    assert {"ngmlr-prep_0", "ngmlr-wave_0", "ngmlr-wave_1"} <= names.py
    assert any(n.startswith("ngmlr-eng") for n in names.os), names.os
    assert all(len(n) <= 15 for n in names.os)
    # the Python path's wave batcher
    wb = batcher.WaveBatcher(device_engine.DeviceContext(
        torch.zeros(16, dtype=torch.uint8).numpy(), device="cpu"))
    got = wb.map_jobs([lambda: threading.current_thread().name] * 3)
    assert got == [batcher.JOB_THREAD] * 3


def test_add_loses_no_update():
    ctx = device_engine.DeviceContext(
        torch.zeros(16, dtype=torch.uint8).numpy(), device="cpu")
    n_threads, n_adds = 8, 10_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(n_adds):
                ctx.add("batches", 1)
                ctx.add("intake_s", 0.5)
        ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert ctx.stats["batches"] == n_threads * n_adds
    assert ctx.stats["intake_s"] == 0.5 * n_threads * n_adds


def test_spans_reach_the_profiler_from_every_thread(tmp_path, monkeypatch):
    """Under torch.profiler (every thread), each ngmlr.* span is opened
    with its batch's number as its input and lands in the trace from its
    own thread, as a host event and never a device one; no ngmlr.* span
    lies inside another on the same thread (the idle gaps are labelled by
    the largest overlaps)."""
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig

    # test_2's first six reads (99-594 bases), two a batch: three batches
    with open(READS) as f:
        recs = f.read().split(">")[1:7]
    reads = tmp_path / "six.fa"
    reads.write_text("".join(">" + r for r in recs))
    monkeypatch.setenv("NGMLR_TPU_WAVE_DEPTH", "2")
    real = torch._C._profiler._RecordFunctionFast
    entered = []

    def record(name, inputs):
        entered.append((name, tuple(inputs), threading.current_thread().name))
        return real(name, inputs)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", record)
    p = _pipeline(2)
    prof = profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        p.run(str(reads), io.BytesIO())
    finally:
        prof.stop()

    assert p.ctx.stats["batches"] == 3
    assert {n for n, _, _ in entered} == set(SPANS)
    for name, inputs, thread in entered:
        assert thread.startswith(SPANS[name]), (name, thread)
        assert inputs in ((0,), (1,), (2,), (3,)), (name, inputs)  # 3: EOF
    for bid in range(3):
        assert {n for n, i, _ in entered if i == (bid,)} == set(SPANS), bid

    events = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ngmlr."):
            assert str(e.device_type()).endswith("CPU"), e.name()
            events.append((e.name(), e.start_thread_id(), e.start_ns(),
                           e.end_ns()))
    assert {e[0] for e in events} == set(SPANS)
    tids = {}
    for name, tid, _, _ in events:
        tids.setdefault(SPANS[name], set()).add(tid)
    assert len(tids["MainThread"]) == len(tids["ngmlr-prep"]) == 1
    assert not (tids["MainThread"] & tids["ngmlr-prep"]
                or (tids["MainThread"] | tids["ngmlr-prep"])
                & tids["ngmlr-wave"])
    by_thread = {}
    for name, tid, s, t in events:
        by_thread.setdefault(tid, []).append((s, t, name))
    for spans in by_thread.values():
        spans.sort()
        for (s0, t0, n0), (s1, t1, n1) in zip(spans, spans[1:]):
            assert s1 >= t0, (n0, n1)


def test_a_span_times_its_block_and_feeds_its_key():
    ctx = device_engine.DeviceContext(
        torch.zeros(16, dtype=torch.uint8).numpy(), device="cpu")
    with ctx.span("intake", "intake_s", 4) as sp:
        time.sleep(0.01)
    assert sp.t1 - sp.t0 >= 0.01
    assert ctx.stats["intake_s"] == sp.t1 - sp.t0
    with ctx.span(None, "emit_s") as sp2:
        pass
    assert ctx.stats["emit_s"] == sp2.t1 - sp2.t0

"""One cell's set-up and runs: the genome, the program's Pipeline, the read
pool, the window, the metrics and the reference's verdict."""

import gc
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from ..reference import check as reference
from . import gen, genome as genome_mod, peaks, window
from .spec import Spec


def log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def cache_env(bench_dir: str):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(bench_dir, "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


class Bench:
    def __init__(self, spec: Spec, cell_name: str, device: str = "cuda"):
        self.spec = spec
        self.cell = spec.cell(cell_name)
        self.conf = spec.config(self.cell["config"])
        self.mix = spec.mix(self.cell["traffic"])
        self.device = device
        self.pipeline = None

    def setup(self):
        """The genome (made on a checkout's first run) and the Pipeline
        (which builds its caches beside the FASTA on that run)."""
        from ngmlr_tpu_torch.cli import build_parser, config_from_args
        from ngmlr_tpu_torch.pipeline.runner import Pipeline
        t0 = time.perf_counter()
        self.fasta, self.genome, self.chroms = genome_mod.ensure(
            self.spec.dir, self.conf["genome"])
        t1 = time.perf_counter()
        argv = ["-r", self.fasta] + list(self.conf["argv"])
        self.cfg = config_from_args(build_parser().parse_args(argv), argv)
        self.pipeline = Pipeline(self.cfg, self.fasta, use_cache=True,
                                 device=self.device)
        t2 = time.perf_counter()
        log("setup: genome %.2f s, pipeline %.2f s" % (t1 - t0, t2 - t1))

    def run(self, seed: int, seconds: float, trace: bool = False):
        """One window; returns a namespace the metrics and the report
        read."""
        t0 = time.perf_counter()
        n_warm = self.mix["warmup_batches"] * self.cfg.batch_reads
        n_pool = gen.pool_size(self.mix, seconds)
        pick = np.random.default_rng(
            [seed & (2**64 - 1), gen.CHECK]).random(n_pool)
        keep = {b"r%d" % i for i in np.flatnonzero(
            pick < self.mix["check_share"])}
        keep |= {b"r%d" % i for i in gen.longest(self.mix, seed, 2)
                 if i < n_pool}
        rfd, wfd = os.pipe()
        try:
            feed = window.Feed(dict(
                mix=self.mix, seed=seed, npy=self.genome.filename,
                n_warm=n_warm, n_pool=n_pool, workers=3), wfd)
        except BaseException:
            os.close(rfd)
            raise
        log("reads: %d warm-up, a pool of %d made as they are fed; the "
            "feeder ready in %.2f s" % (n_warm, n_pool,
                                       time.perf_counter() - t0))

        # the harness's own objects out of the collector's way: they would
        # lengthen the program's collections
        gc.collect()
        gc.freeze()
        tracer = None
        if trace:
            from .trace import Tracer
            tracer = Tracer()
        w, sink, _ = window.run_window(
            self.pipeline, feed, rfd, b"w%d" % (n_warm - 1), keep, seconds,
            mark=tracer.mark if tracer else None)
        r = SimpleNamespace(window=w, sink=sink, feeder=feed, seed=seed,
                            peaks=peaks, trace=None, wrapped=feed.wrapped)
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()
        if tracer:
            r.trace = tracer.finish((w.ns_open, w.ns_close))
            for note in r.trace.notes:
                log("trace: " + note)
        r.seconds = w.t_close - w.t_open
        lengths = feed.lengths

        def length_of(name):
            return int(lengths[window.pool_index(name)])
        r.bases, r.latencies, _ = window.account(
            w.t_open, w.t_close, feed.handed, sink.done, length_of)
        r.mbp = float(r.bases.sum()) / 1e6
        r.stats_open, r.stats_close = w.stats_open, w.stats_close

        def delta(*keys):
            return sum(r.stats_close.get(k, 0) - r.stats_open.get(k, 0)
                       for k in keys)
        r.delta = delta
        r.attempted = len(feed.handed)
        r.missing = sum(1 for n in feed.handed if n not in sink.done)
        r.unmapped = sum(1 for n in sink.unmapped if n in feed.handed)
        r.checked = [n for n in sink.lines if n in feed.handed]
        gc.unfreeze()
        per_mbp = {k: delta(k) / max(r.mbp, 1e-9) for k in (
            "prep_enc_s", "prep_search_s", "prep_score_stage_s",
            "waves_wall_s", "align_s", "align_fetch_s", "emit_s")}
        log("window kbp/s in 5 slices: " + " ".join("%.0f" % x for x in (
            window.slices(w.t_open, w.t_close, sink.done, length_of))))
        log("window stats, s per Mbp: " + ", ".join(
            "%s %.4f" % kv for kv in per_mbp.items()))
        log("window: %d lane-bound retries" % delta("lane_bound_retries"))
        cpu = {k: w.cpu_close[k] - w.cpu_open.get(k, 0.0)
               for k in w.cpu_close}
        feeder = "pid:%d" % feed.proc.pid
        own = sum(v for k, v in cpu.items() if k != feeder)
        um = [length_of(n) for n in sink.unmapped if n in feed.handed]
        if um:
            log("unmapped reads: %d, lengths %s (all handed: %s)" % (
                len(um), "/".join("%d" % x for x in np.percentile(
                    um, [0, 50, 100])), "/".join("%d" % x for x in (
                        np.percentile(lengths, [0, 50, 100])))))
        if feed.starved_s > 0.05:
            log("feeder: waited %.2f s in the window for reads to be made"
                % feed.starved_s)
        # the feeder's work per Mbp is fixed: its CPU-s per Mbp handed
        # tells how fast the host ran in this window
        handed_mbp = sum(lengths[window.pool_index(n)]
                         for n in feed.handed) / 1e6
        log("window host CPU s: this process %.2f over %d threads, the "
            "feeder %.2f (%.4f a Mbp handed); busiest: %s" % (
                own, sum(1 for k, v in cpu.items() if k != feeder and v > 0),
                cpu.get(feeder, 0.0),
                cpu.get(feeder, 0.0) / max(handed_mbp, 1e-9), ", ".join(
                    "%s %.2f" % kv for kv in sorted(
                        cpu.items(), key=lambda kv: -kv[1])[:8])))
        return r

    def judge(self, r, control_dtype=None):
        """The reference's numbers over the checked reads, each made again
        from the run's seed, and the control's where asked."""
        sc = reference.Scoring(**self.conf["scoring"])
        block = gen.design(self.mix)
        reads = []
        for name in r.checked:
            i = window.pool_index(name)
            rd = gen.read_at(self.mix, r.seed, self.genome, i, block=block)
            if len(rd.seq) != r.feeder.lengths[i]:
                raise RuntimeError("read %s made again differs" % name)
            reads.append((r.sink.lines[name], rd.seq, rd.parts, rd.reverse,
                          rd.path, rd.cuts, rd.kind))
        t0 = time.perf_counter()
        nums, ctrl, seen = reference.judge(reads, self.genome, self.chroms,
                                           sc, control_dtype)
        share = 100.0 * r.unmapped / max(1, r.attempted)
        nums.update(missing=r.missing, unmapped_share=share)
        if ctrl is not None:
            ctrl.update(missing=r.missing, unmapped_share=share)
        log("reference: %d reads (%.1f Mbp) checked in %.2f s"
            % (len(reads), sum(len(x[1]) for x in reads) / 1e6,
               time.perf_counter() - t0))
        for s in seen:
            log("reference: " + s)
        log("reference numbers: " + json.dumps(nums))
        return nums, ctrl

    def metrics(self, r, trace: bool, setup_s: float):
        r.setup_s = setup_s
        out = {}
        for m in self.spec.metrics_for(self.cell["name"], trace):
            v = self.spec.reader(m["name"])(r)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out

    def free(self):
        """Drop the program's state and its device memory."""
        from ngmlr_tpu_torch.ops import device_engine
        device_engine.set_current(None)
        self.pipeline = None
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

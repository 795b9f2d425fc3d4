"""End-to-end mapping pipeline.

Orchestrates: reference + index load → read intake → candidate search →
batched candidate scoring → long-read assembly / short-read alignment →
SAM output.

Batching model (TPU-first redesign of the reference's per-thread loop,
NGM.cpp:190-246 + CS.cpp:412-503): the host builds large batches of reads,
all compute-heavy stages (candidate scoring, banded alignments) run as
batched kernels, and records are emitted in the reference's order — within
each intake group of 10 reads (cBatchSize, CS.cpp:34), short reads first in
input order, then long reads in input order (short reads are written
immediately by SendToBuffer while long-read groups complete at the score
flush; CS.cpp:276-318, ScoreBuffer.cpp:132-162).
"""

import sys
import time
from typing import IO, List, Optional

import numpy as np

from ..config import Config
from ..io.reads import Read, read_batches
from ..io.reference import ReferenceGenome, _CHAR2CODE
from ..index.kmer_index import KmerIndex
from ..seed.candidates import search_batch
from ..align.aligner import AlignerConfig
from ..ops import device_engine
from ..out.sam import SamWriter
from .longread import LongReadProcessor
from .score_stage import score_read_batch
from .shortread import process_short_read

INTAKE_GROUP = 10  # the reference's cBatchSize (CS.cpp:34)


class BatchClock:
    """An intake batch's number, which each of its spans carries, and the
    moments (time.perf_counter) it passes between the stages of
    Pipeline.run: prep's end, its waves' start and end, its emission's
    start and end."""

    __slots__ = ("id", "prep_end", "wave_start", "wave_end", "emit_start",
                 "emit_end")

    def __init__(self, bid: int):
        self.id = bid


def _wave_depth(device) -> int:
    """Concurrent in-flight batches: 2 on a CUDA device (straggler align
    waves of batch N overlap batch N+1's bulk wave), 1 on the CPU, where
    the extra thread starves the prep thread. NGMLR_TPU_WAVE_DEPTH
    overrides."""
    import os
    v = os.environ.get("NGMLR_TPU_WAVE_DEPTH")
    if v:
        return int(v)
    return 2 if device.type == "cuda" else 1


def device_search_wanted(n_units: int, device, subread_len: int) -> bool:
    """The device candidate search gate: NGMLR_TPU_DEVICE_SEARCH=1 turns it
    on, =0 off; unset, it is on for a CUDA device at any genome size (on
    the H100 it beats the host search from a chromosome up, and a small
    genome pays only its table build once). Never for a multi-unit genome
    (its tables are uint32; the host search carries int64 positions) nor
    for subreads longer than the search's SL slots (--subread-length past
    its default)."""
    import os
    from ..seed.device_search import SL
    use_dev = os.environ.get("NGMLR_TPU_DEVICE_SEARCH")
    if n_units > 1 or subread_len > SL:
        return False
    return use_dev == "1" or (use_dev != "0" and device.type == "cuda")


class Pipeline:
    def __init__(self, cfg: Config, reference_path: str,
                 use_cache: bool = True, device=None):
        self.cfg = cfg.normalized()
        self.ref = ReferenceGenome.from_fasta(reference_path,
                                              use_cache=use_cache,
                                              skip_save=cfg.skip_save)
        self.index = KmerIndex.load_or_build(
            self.ref, reference_path, k=cfg.kmer_length,
            kmer_skip=cfg.kmer_skip, bin_size=cfg.bin_size,
            max_prefix_freq=cfg.max_prefix_freq,
            use_cache=use_cache, skip_save=cfg.skip_save)
        # -t/--threads maps to the device count (the reference's worker
        # pool, NGM.cpp:334-348, becomes data parallelism over wave
        # problems on a device mesh; output is bit-identical for any -t).
        # device: one device, or a list of devices, the mesh as given
        unit_spec = None
        if self.ref.n_units > 1:
            # TableUnit analog (>4.29 Gbp genomes, DIVERGENCES #5)
            unit_spec = (self.ref.n_units, self.ref.unit_bits,
                         self.ref.unit_plane_len)
        self.ctx = device_engine.DeviceContext(self.ref.codes,
                                               n_devices=cfg.threads,
                                               unit_spec=unit_spec,
                                               device=device)
        device_engine.set_current(self.ctx)
        # candidate search runs on the card (the host path is the oracle
        # and the CPU's search; at human scale it dominates the host's wall
        # time), on the primary device of a mesh. Decided once here: a
        # batch never changes search midway
        self.dev_search = None
        if device_search_wanted(self.ref.n_units, self.ctx.device,
                                self.cfg.read_part_length):
            from ..seed.device_search import DeviceSearch
            self.dev_search = DeviceSearch(self.index, device=self.ctx.device)
        import os as _os
        self.processor = LongReadProcessor(self.ref, self.cfg)
        self.acfg = self.processor.acfg
        # native (C++) per-read assembly engine: the default long-read path
        # (the Python LongReadProcessor is the oracle and the per-read
        # fallback). Disabled for the --stdout debug modes, whose dump
        # ordering requires the serial Python path, and by NGMLR_TPU_NATIVE=0.
        self.native = None
        self._native_pool = None
        if self.ref.n_units > 1:
            from ..native import _warn_fallback
            _warn_fallback(
                "multi-unit genome (> one 2^%d slab): the native long-read "
                "engine does not carry unit descriptors yet — using the "
                "Python assembly path (slower, same output)"
                % self.ref.unit_bits)
        if (_os.environ.get("NGMLR_TPU_NATIVE", "1") != "0"
                and not cfg.stdout_mode
                and self.ref.n_units == 1):
            try:
                from .native_engine import NativeEngine
                self.native = NativeEngine(self.ref, self.cfg,
                                           self.acfg.params)
                # one engine instance per in-flight batch (an engine handle
                # holds one batch's state): WAVE_DEPTH=2 runs two batches'
                # waves concurrently only if each has its own engine
                import queue as _queue
                depth = _wave_depth(self.ctx.device)
                self._native_pool = _queue.Queue()
                self._native_pool.put(self.native)
                for _ in range(max(depth - 1, 0)):
                    self._native_pool.put(NativeEngine(self.ref, self.cfg,
                                                       self.acfg.params))
            except Exception:
                self.native = None
        self.stats = {"reads": 0, "mapped": 0, "unmapped": 0}

    def run(self, query_path: str, out: IO[bytes], progress: bool = False,
            shard: int = 0, n_shards: int = 1):
        """Two-level pipelined intake:

          * batch N+1's candidate search + subread scoring (host numpy +
            device score wave) runs in a background prep thread while
            earlier batches' alignment waves execute,
          * wave depth 2 (the CUDA default, see _wave_depth) lets TWO
            batches' alignment waves fly concurrently, so the long tail of
            straggler waves (retries, SV realigns of a few reads) of batch
            N overlaps batch N+1's bulk wave. On the CPU the default stays
            1 (the extra thread starves the prep thread). SAM emission
            stays strictly in batch order on this thread either way.

        Debug-dump modes force depth 1 so stdout stays in the reference's
        single-threaded order.

        Each batch is numbered at intake; its spans carry the number, and
        its waits go to ctx.stats when it is emitted (_account)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        writer = SamWriter(self.ref, self.cfg, out)
        writer.write_prolog()
        t0 = time.time()
        self._read_bp = 0
        depth = _wave_depth(self.ctx.device)
        if self.cfg.stdout_mode:
            depth = 1
        batches = read_batches(query_path, self.cfg.batch_reads,
                               shard=shard, n_shards=n_shards)
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="ngmlr-prep") as prep_pool, \
                ThreadPoolExecutor(max_workers=depth,
                                   thread_name_prefix="ngmlr-wave") as wave_pool:
            inflight = deque()   # (batch, clock, prep, outcomes-future)
            nxt = self._intake(batches, 0)
            prep_fut = (prep_pool.submit(self._prepare_batch, *nxt)
                        if nxt is not None else None)
            while nxt is not None or inflight:
                if nxt is not None and len(inflight) < depth:
                    # a wave slot is free: whatever this waits is prep's
                    with self.ctx.span(None, "main_wait_prep_s"):
                        prep = prep_fut.result()
                    cur, clk = nxt
                    nxt = self._intake(batches, clk.id + 1)
                    prep_fut = (prep_pool.submit(self._prepare_batch, *nxt)
                                if nxt is not None else None)
                    self._read_bp += sum(len(r.seq) for r in cur
                                         if not r.empty)
                    inflight.append(
                        (cur, clk, prep, wave_pool.submit(
                            self._compute_waves, cur, prep, clk)))
                    continue
                batch, clk, prep, fut = inflight.popleft()
                outcomes, job_key = fut.result()
                self._emit(batch, prep, outcomes, job_key, writer, clk)
                self._account(clk)
                if progress:
                    self._progress_line(t0)
        self.stats["lines"] = writer.lines
        self.stats["elapsed_s"] = time.time() - t0
        return self.stats

    def _progress_line(self, t0: float):
        """The reference's progress line (NGM.cpp:390-428, format
        documented in its README): Processed: N (alignRate), R/S, RL,
        Time: cs score align (stage shares of device+search time, the
        csTime/scoreTime/alignTime split of CS.cpp:474-480), Align:
        success ratio, avg corridor width, avg aligned fraction."""
        el = max(time.time() - t0, 1e-9)
        n = max(1, self.stats["reads"])
        mapped = self.stats["mapped"]
        ds = self.ctx.stats
        cs_s = ds.get("prep_search_s", 0.0)
        sc_s = ds.get("score_s", 0.0)
        al_s = ds.get("align_s", 0.0)
        tot_s = max(cs_s + sc_s + al_s, 1e-9)
        a_all = max(ds.get("alignment_all", 0), 1)
        from ..log import Log
        Log.progress(
            "Processed: %d (%.2f), R/S: %.2f, RL: %d, "
            "Time: %.2f %.2f %.2f, Align: %.2f, %d, %.2f",
            n, mapped / n, n / el,
            self._read_bp // n,
            100.0 * cs_s / tot_s, 100.0 * sc_s / tot_s,
            100.0 * al_s / tot_s,
            ds.get("alignment_ok", 0) / a_all,
            ds.get("corridor_sum", 0) // a_all,
            self.stats.get("align_frac_sum", 0.0) / max(1, mapped))

    # ------------------------------------------------------------------

    def _intake(self, batches, bid: int):
        """The next intake batch and its clock, or None at the input's
        end."""
        with self.ctx.span("intake", "intake_s", bid):
            reads = next(batches, None)
        return None if reads is None else (reads, BatchClock(bid))

    def _prepare_batch(self, batch: List[Read], clk: BatchClock):
        """Stage 1 of a batch: read-code upload, candidate search, batched
        subread scoring. Runs in a background thread for batch N+1 while
        batch N's alignment waves execute."""
        cfg = self.cfg
        ctx = self.ctx
        rpl = cfg.read_part_length

        with ctx.span("prep.enc", "prep_enc_s", clk.id):
            total = sum(len(r.seq) for r in batch if not r.empty)
            buf = np.empty(total, dtype=np.uint8)
            off = 0
            for r in batch:
                if r.empty:
                    continue
                n = len(r.seq)
                buf[off:off + n] = _CHAR2CODE[np.frombuffer(r.seq,
                                                            dtype=np.uint8)]
                r.buf_offset = off
                off += n
            readbuf = ctx.upload_reads(buf)

            # --- candidate search for every subread / short read at once --
            seqs: List[bytes] = []
            owners: List[tuple] = []       # (read_idx, subread_idx or -1)
            for ri, read in enumerate(batch):
                if read.empty:
                    continue
                n = read.subread_count(rpl)
                if n == 0:
                    seqs.append(read.seq)
                    owners.append((ri, -1))
                else:
                    for j in range(n):
                        seqs.append(read.subread_seq(j, rpl))
                        owners.append((ri, j))

        with ctx.span("prep.search", "prep_search_s", clk.id):
            if self.dev_search is not None:
                # descriptor path: the subreads are views of the read buffer
                # already uploaded above — no re-encode, no k-mer upload
                starts = np.empty(len(owners), dtype=np.int32)
                lens = np.empty(len(owners), dtype=np.int32)
                for oi, ((ri, j), s) in enumerate(zip(owners, seqs)):
                    starts[oi] = (batch[ri].buf_offset
                                  + (0 if j < 0 else j * rpl))
                    lens[oi] = len(s)
                # on a mesh it runs on the primary device, its replica
                cands = self.dev_search.search_views(readbuf.primary, starts,
                                                     lens, cfg.sensitivity,
                                                     cfg.min_kmer_hits)
            else:
                cands = search_batch(self.index, seqs, cfg.sensitivity,
                                     cfg.min_kmer_hits,
                                     n_units=self.ref.n_units,
                                     unit_bits=self.ref.unit_bits)

        with ctx.span("prep.score", "prep_score_stage_s", clk.id) as sp:
            per_read_long = {}
            per_read_short = {}
            for (ri, j), cand in zip(owners, cands):
                if j < 0:
                    per_read_short[ri] = cand
                else:
                    per_read_long.setdefault(ri, {})[j] = cand

            # --- batched scoring for long reads ----------------------------
            long_ris = sorted(per_read_long.keys())
            long_reads = [batch[ri] for ri in long_ris]
            cand_lists = [[per_read_long[ri][j]
                           for j in range(batch[ri].subread_count(rpl))]
                          for ri in long_ris]
            scored_batch = score_read_batch(self.ref, cfg, long_reads,
                                            cand_lists, readbuf=readbuf)
            # ri -> (array-native batch handle, local index); the native
            # engine consumes the arrays wholesale, the Python path
            # materializes per-read ScoredSubread lists lazily
            scored_by_ri = {ri: (scored_batch, li)
                            for li, ri in enumerate(long_ris)}
        clk.prep_end = sp.t1
        return readbuf, per_read_short, scored_by_ri

    def _compute_waves(self, batch: List[Read], prep, clk: BatchClock):
        """Stage 2 of a batch: per-read jobs with wave-batched alignments.
        Runs in a wave-pool thread; up to two batches concurrently. Its
        seconds go to waves_wall_s, a counter and no profiler range: the
        engine's and the waves' named spans run inside it."""
        with self.ctx.span(None, "waves_wall_s") as sp:
            out = self._waves(batch, prep, clk.id)
        clk.wave_start, clk.wave_end = sp.t0, sp.t1
        return out

    def _waves(self, batch: List[Read], prep, bid: int):
        cfg = self.cfg
        readbuf, per_read_short, scored_by_ri = prep
        from . import batcher as _batcher

        def make_short_job(read, cand):
            return lambda: process_short_read(self.ref, cfg, read, cand, self.acfg)

        def make_long_job(read, scored):
            sb, li = scored
            return lambda: self.processor.process(read, sb.subreads(li))

        import os

        # --- native engine path for long reads ---------------------------
        native_out = {}
        if (self.native is not None and not self.cfg.stdout_mode
                and not os.environ.get("NGMLR_TPU_SYNC")):
            from .native_engine import FAILED
            long_ris = sorted(scored_by_ri.keys())
            short_ris = sorted(ri for ri, cand in per_read_short.items()
                               if len(cand.locations) > 0)
            if long_ris or short_ris:
                # ScoredBatch rows are already in sorted(long_ris) order;
                # short reads ride the same engine batch (their candidate
                # scoring + alignment waves coalesce with the long reads')
                sb = scored_by_ri[long_ris[0]][0] if long_ris else None
                all_ris = long_ris + short_ris
                try:
                    eng = self._native_pool.get()
                    try:
                        outs = eng.run_batch(
                            self.ctx, readbuf,
                            [batch[ri] for ri in all_ris], sb,
                            shorts=[per_read_short[ri] for ri in short_ris],
                            batch=bid)
                    finally:
                        self._native_pool.put(eng)
                except BaseException as e:
                    # dispatch-level failure: every read of this batch falls
                    # back to the Python path (reference semantics: log and
                    # keep going, NGM.cpp:262-265)
                    if os.environ.get("NGMLR_TPU_STRICT"):
                        raise
                    from ..log import Log
                    Log.warning("native engine batch failed: %r", e)
                    outs = [FAILED] * len(all_ris)
                n_failed = 0
                for ri, o in zip(all_ris, outs):
                    if o is FAILED:
                        n_failed += 1
                    else:
                        native_out[ri] = o
                if n_failed:
                    self.ctx.add("native_failed", n_failed)

        jobs = []
        job_key = {}
        precomputed = {}
        for ri, read in enumerate(batch):
            if read.empty:
                continue
            if ri in per_read_short:
                cand = per_read_short[ri]
                if len(cand.locations) > 0:
                    if ri in native_out:
                        precomputed[ri] = native_out[ri]
                    else:
                        job_key[ri] = len(jobs)
                        jobs.append(make_short_job(read, cand))
            elif ri in scored_by_ri:
                if ri in native_out:
                    precomputed[ri] = native_out[ri]
                else:
                    job_key[ri] = len(jobs)
                    jobs.append(make_long_job(read, scored_by_ri[ri]))
        if os.environ.get("NGMLR_TPU_SYNC") or self.cfg.stdout_mode:
            # profiling mode — and all --stdout debug modes: jobs run
            # serially in this thread so the dump order matches the
            # reference's single-threaded (-t 1) output exactly. The
            # batch's readbuf is bound thread-locally (NOT via
            # ctx.readbuf, which the prep thread overwrites when it
            # uploads batch N+1 mid-batch).
            _batcher.set_thread_batcher(
                _batcher.SerialBinding(self.ctx, readbuf))
            outcomes = []
            try:
                for job in jobs:
                    try:
                        outcomes.append(job())
                    except BaseException as e:
                        if os.environ.get("NGMLR_TPU_STRICT"):
                            raise
                        from ..log import Log
                        Log.warning("Error processing read: %r", e)
                        outcomes.append(None)
            finally:
                _batcher.set_thread_batcher(None)
        else:
            wb = _batcher.WaveBatcher(self.ctx, readbuf=readbuf)
            outcomes = wb.map_jobs(jobs)
        for ri, o in precomputed.items():
            job_key[ri] = len(outcomes)
            outcomes.append(o)
        return outcomes, job_key

    def _emit(self, batch: List[Read], prep, outcomes, job_key,
              writer: SamWriter, clk: BatchClock):
        """Emit in reference order (shorts first per intake group of 10,
        then longs; NGM.cpp:190-246 + CS.cpp:276-318)."""
        with self.ctx.span("emit", "emit_s", clk.id) as sp:
            self._write(batch, prep, outcomes, job_key, writer)
        clk.emit_start, clk.emit_end = sp.t0, sp.t1

    def _account(self, clk: BatchClock):
        """An emitted batch's two waits: prepared, for a wave slot; its
        waves ended, for its emission, behind an older batch still in its
        waves or behind the main thread's wait on prep (run() takes a
        prepared batch first whenever a wave slot is free)."""
        self.ctx.add("batch_wait_wave_s", clk.wave_start - clk.prep_end)
        self.ctx.add("batch_wait_emit_s", clk.emit_start - clk.wave_end)
        self.ctx.add("batches", 1)

    def _write(self, batch: List[Read], prep, outcomes, job_key,
               writer: SamWriter):
        readbuf, per_read_short, scored_by_ri = prep
        for g0 in range(0, len(batch), INTAKE_GROUP):
            group = list(range(g0, min(g0 + INTAKE_GROUP, len(batch))))
            for ri in group:
                read = batch[ri]
                if read.empty or ri not in per_read_short:
                    continue
                if ri not in job_key or outcomes[job_key[ri]] is None:
                    writer.write_read(read, [], False)
                    self._count(False)
                else:
                    mapped, records, _ = outcomes[job_key[ri]]
                    writer.write_read(read, records, mapped)
                    self._count(mapped and len(records) > 0)
            for ri in group:
                read = batch[ri]
                if read.empty or ri not in scored_by_ri:
                    continue
                if outcomes[job_key[ri]] is None:   # per-read failure
                    writer.write_read(read, [], False)
                    self._count(False)
                    continue
                mapped, records = outcomes[job_key[ri]]
                writer.write_read(read, records, mapped)
                is_mapped = mapped and any(not r.align.skip for r in records)
                if is_mapped and read.length > 0:
                    bp = sum(read.length - r.align.qstart - r.align.qend
                             for r in records if not r.align.skip)
                    self.stats["align_frac_sum"] = (
                        self.stats.get("align_frac_sum", 0.0)
                        + min(1.0, bp / read.length))
                self._count(is_mapped)

    def _count(self, mapped: bool):
        self.stats["reads"] += 1
        if mapped:
            self.stats["mapped"] += 1
        else:
            self.stats["unmapped"] += 1

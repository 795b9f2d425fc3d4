"""Device-resident compute engine on PyTorch: the genome and each read batch
live in device memory; every kernel input is a handful of scalars per
problem and every output is a few bytes per problem.

  * the encoded genome (uint8 codes, SequenceProvider enc4 space: A=0,T=1,
    G=2,C=3,N=4) is uploaded ONCE; reference windows are gathered inside
    the kernels from (decode_start, diff, hi) descriptors that reproduce
    DecodeRefSequence / DecodeRefSequenceExact byte-for-byte
    (ngmlr src/SequenceProvider.cpp:493-625) with 'x' as code 5,
  * the read batch is uploaded once per batch (code space as above); every
    query anywhere in the pipeline is a (start, len, revcomp) view of a read
    (AlignmentBuffer::extractReadSeq semantics, AlignmentBuffer.cpp:1515-1549),
  * all four corridor generators of AlignmentBuffer.cpp:52-197 are affine
    formulas — corridors travel as (mode, 2 floats, 2 ints) and the
    per-wavefront row windows are recomputed on the device,
  * backtracking runs on the device over the direction planes (which never
    leave device memory) and returns a 2-bit-packed op stream.

The kernels (ops/kernels.py, csrc/*.cu) reproduce the JAX package's
ngmlr_tpu.ops.device_engine bit for bit, which in turn reproduces
ConvexAlignFast::fwdFillMatrix (ngmlr src/ConvexAlignFast.cpp:606-774)
exactly. With -t N every score and align wave runs over a mesh of devices
(parallel/mesh.py): the genome and each read buffer are replicated on every
device, each wave's padded blocks split into contiguous per-shard slices,
and the results gathered back in problem order; each kernel computes one
problem per block, so the bytes do not depend on the mesh. A genome of
more than one 2^31 slab (the TableUnit analog) lives on each device as a
[U, planeP] stack of unit planes; a problem's unit rides in bits 28+ of its
W column and the kernels read that unit's plane.

With NGMLR_TPU_NO_PALLAS set when a context is built (the CLI's --nosse),
its score and align waves call the plain PyTorch versions of the four
alignment kernels directly, on the tensors of the device they run on: the
JAX package's switch to its XLA scan twins
(ngmlr_tpu/ops/device_engine.py:317-318, 484-485).
"""

from dataclasses import dataclass
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler
from torch._C import _profiler as _cprofiler

from . import kernels
from ..parallel.mesh import make_mesh
from .types import (STOP, DIAG, INS, DEL, XCODE, NCODE,  # noqa: F401
                    CORRIDOR_FULL, CORRIDOR_LINEAR, CORRIDOR_ENDPOINTS,
                    CORRIDOR_ANCHORS)

MAX_SEQ_LEN = 100000  # ssw guard (StrippedSW.h:87)
MAX_UNITS = 8         # genome planes a W column can name (bits 28-30)


def _pow2(x: int, lo: int) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def _size_class(x: int, lo: int) -> int:
    """Smallest bucket >= x from the {2^n, 1.5*2^n} size classes — halves
    the average padding waste of pure pow2 at a modest shape-count cost."""
    v = lo
    while True:
        if x <= v:
            return v
        if x <= v + v // 2:
            return v + v // 2
        v *= 2


def resolve_device(device=None) -> torch.device:
    """The explicit device of a context: "cuda" unless the caller asks for
    the CPU. There is no silent CPU path: asking for CUDA without a card
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ngmlr_tpu_torch: device %r requested but torch.cuda is not "
            "available; pass device='cpu' (or NGMLR_TORCH_DEVICE=cpu for the "
            "CLI) to run the plain PyTorch kernels on the CPU" % str(dev))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(dev))
    return dev


def _indexed(dev: torch.device) -> torch.device:
    """cuda -> cuda:<current card>: a mesh's devices compare equal to the
    devices of the tensors on them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _shard_rows(n: int, n_shards: int, pad) -> Tuple[int, List[slice]]:
    """Split a block of n problems over n_shards in contiguous slices, in
    order, as the reference's shard_map splits the batch axis: every shard
    holds pad(ceil(n / n_shards)) rows (pad rounds a count up to the
    block's tile). Returns (rows per shard, the slices of the shards that
    hold a problem); a shard past the problems gets no slice and no
    launch."""
    per = pad(max((n + n_shards - 1) // n_shards, 1))
    return per, [slice(lo, min(n, lo + per)) for lo in range(0, n, per)]


def _pad_score(n: int) -> int:
    return max(_pow2(n, 8), 8)


def _pad_align(n: int) -> int:
    return max((n + 7) // 8 * 8, 8)


# ---------------------------------------------------------------------------
# wave planning: which launches a wave's rows go into, at what padded shapes
# (csrc/wave_plan.h is the same plan in C++, for the native wave)
# ---------------------------------------------------------------------------

def dirs_cap() -> int:
    """Bytes of direction planes (B x TpP x L u8) one align launch may hold:
    NGMLR_TPU_DIRS_CAP_GB GiB, 4 by default. Ultra-long reads split into
    launches of their own under it, and a problem too big for even a solo
    launch fails like the reference's maxMatrixSizeMB refusal
    (AlignmentMatrixFast.cpp:45-58)."""
    return int(os.environ.get("NGMLR_TPU_DIRS_CAP_GB", "4")) << 30


def _size_class_vec(x: np.ndarray, lo: int) -> np.ndarray:
    """Vectorized _size_class: smallest {2^n, 1.5*2^n} bucket >= x."""
    mx = int(x.max()) if len(x) else lo
    classes = [lo]
    v = lo
    while classes[-1] < mx:
        classes.append(v + v // 2)
        v *= 2
        classes.append(v)
    arr = np.asarray(classes, dtype=np.int64)
    return arr[np.searchsorted(arr, x)]


def align_lanes(pk_all: np.ndarray, conservative_L: bool) -> np.ndarray:
    """Each align row's lane count L: its lane bound (DeviceContext.
    _lane_bound, vectorized; width + 3 when conservative_L) rounded to a
    multiple of 128 up to 1024, then to a {2^n, 1.5*2^n} class."""
    W = (pk_all[:, 3] & ((1 << 28) - 1)).astype(np.int64)  # hi: unit
    qlen = pk_all[:, 5].astype(np.int64)
    width = pk_all[:, 9].astype(np.int64)
    mode = pk_all[:, 7]
    if conservative_L:
        wb = width + 3
    else:
        # _lane_bound vectorized (see its docstring for the geometry)
        kk = pk_all.view(np.float32)[:, 10].astype(np.float64)
        b_ep = np.where(
            kk > 0,
            (width.astype(np.float64) * kk / (kk + 1.0)).astype(np.int64)
            + 6,
            width + 3)
        wb = np.where(mode == CORRIDOR_LINEAR, width // 2 + 4,
                      np.where(mode == CORRIDOR_FULL, width + 3, b_ep))
        wb = np.maximum(
            np.minimum.reduce([wb, width + 3, W + 2, qlen + 2]), 8)
    # lanes: multiples of 128 up to 1024, then size classes
    return np.where(wb <= 1024, (wb + 127) // 128 * 128,
                    _size_class_vec(np.maximum(wb, 1), 1024))


def plan_align_rows(pk_all: np.ndarray, conservative_L: bool, cap: int):
    """The launch chains of a wave's align rows int32 [P, 12], on one
    device: rows bucketed by (L, Wp, Hp), Wp and Hp the pow2 classes (at
    least 256) of each row's own W and qlen, so that a launch's shape never
    depends on which problems shared its wave (wave composition is
    nondeterministic across threads); buckets in ascending key order, rows
    by descending T = W + qlen - 1; a bucket split wherever its direction
    planes (rows padded to 8) would pass cap bytes, and a row too big for a
    solo launch refused. Returns (chunks [(L, Wp, Hp, row indices)], refused
    rows, cells, useful cells): cells the padded B x (Wp + Hp) x L work of
    the chunks' rows, useful cells their qlen x min(width, W)."""
    W = (pk_all[:, 3] & ((1 << 28) - 1)).astype(np.int64)  # hi: unit
    qlen = pk_all[:, 5].astype(np.int64)
    width = pk_all[:, 9].astype(np.int64)
    T_arr = W + qlen - 1
    L_arr = align_lanes(pk_all, conservative_L)
    Wc_arr = np.int64(1) << np.ceil(
        np.log2(np.maximum(W, 256))).astype(np.int64)
    Hc_arr = np.int64(1) << np.ceil(
        np.log2(np.maximum(qlen, 256))).astype(np.int64)
    bucket_key = (L_arr << 40) | (Wc_arr << 20) | Hc_arr
    tpp_arr = Wc_arr + Hc_arr
    failed: List[int] = []
    chunks = []   # (L, [row indices])
    for bk in np.unique(bucket_key):
        idxs = np.nonzero(bucket_key == bk)[0]
        idxs = idxs[np.argsort(-T_arr[idxs], kind="stable")]
        L = int(L_arr[idxs[0]])
        chunk: List[int] = []
        chunk_tpp = 0
        for i in idxs.tolist():
            tpp = int(tpp_arr[i])
            if not chunk:
                if 8 * tpp * L > cap:
                    failed.append(i)
                    continue
                chunk = [i]
                chunk_tpp = tpp
                continue
            n1 = (len(chunk) + 8) // 8 * 8
            if n1 * chunk_tpp * L > cap:
                chunks.append((L, chunk))
                if 8 * tpp * L > cap:
                    chunk = []
                    failed.append(i)
                    continue
                chunk = [i]
                chunk_tpp = tpp
            else:
                chunk.append(i)
        if chunk:
            chunks.append((L, chunk))
    out = []
    cells = useful = 0
    for L, idxs in chunks:
        idxs = np.asarray(idxs)
        Wp, Hp = int(Wc_arr[idxs[0]]), int(Hc_arr[idxs[0]])
        out.append((L, Wp, Hp, idxs))
        cells += len(idxs) * (Wp + Hp) * L
        useful += int(np.sum(qlen[idxs] * np.minimum(width[idxs], W[idxs])))
    return out, failed, cells, useful


def plan_score_rows(pk: np.ndarray):
    """The launches of a wave's score rows int32 [P, 7]: rows past the ssw
    maxSeqLen guard (StrippedSW.h:87) score -1 whatever a kernel would say,
    so they are not launched; the others bucket by (Rp, Qp), small windows
    at 64-granularity (the hot subread shape 306x256 -> 320x256), larger
    rare probes at pow2 to bound the number of shapes. Returns (live mask,
    buckets [(Rp, Qp, row indices)] in ascending (Rp, Qp), cells, useful
    cells)."""
    W = (pk[:, 3] & ((1 << 28) - 1)).astype(np.int64)  # high bits: unit
    qlen = np.maximum(pk[:, 5].astype(np.int64), 1)
    live = (W + 1 < MAX_SEQ_LEN) & (qlen + 1 < MAX_SEQ_LEN)
    Rp = np.where(
        W <= 512,
        np.maximum(64, (W + 63) // 64 * 64),
        np.int64(1) << np.ceil(np.log2(np.maximum(W, 512))).astype(np.int64))
    Qp = np.int64(1) << np.ceil(np.log2(np.maximum(qlen, 64))
                                ).astype(np.int64)
    key = Rp * (1 << 20) + Qp
    buckets = []
    cells = useful = 0
    for k in np.unique(key[live]):
        idxs = np.nonzero((key == k) & live)[0]
        rp, qp = int(k >> 20), int(k & ((1 << 20) - 1))
        buckets.append((rp, qp, idxs))
        cells += len(idxs) * rp * qp
        useful += int(np.sum(W[idxs] * qlen[idxs]))
    return live, buckets, cells, useful


def align_block(pk_all: np.ndarray, rows: np.ndarray, B: int) -> np.ndarray:
    """The B-row block one align launch takes: the rows, then inert slots
    (width 1, k 1.0, zero length)."""
    blk = np.zeros((B, 12), dtype=np.int32)
    blk[:, 9] = 1
    blk.view(np.float32)[:, 10] = 1.0
    blk[: len(rows)] = pk_all[rows]
    return blk


def score_block(pk: np.ndarray, rows: np.ndarray, B: int) -> np.ndarray:
    """The B-row block one score launch takes: the rows, then zero rows."""
    blk = np.zeros((B, 7), dtype=np.int32)
    blk[: len(rows)] = pk[rows]
    return blk


class ReadBuffer:
    """A read batch's code buffer on a context's devices: one u8 replica
    per device (shards sharing a device share it). upload_reads returns
    one, and every readbuf= argument of the engine takes one."""

    def __init__(self, replicas):
        self.replicas = replicas                 # {torch.device: tensor}
        self.primary = next(iter(replicas.values()))


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RefDesc:
    """Device recipe for a decoded reference window of length W:
    window[i] = CODE2CHAR[genome[ds + i - diff]] if (i >= diff and i < W and
    ds + i - diff < hi) else 'x'. Produced by ReferenceGenome.decode_*_desc.

    `unit` names the genome plane of a multi-unit genome (> one 2^31
    slab); ds and hi are then local to that plane."""
    ds: int
    diff: int
    hi: int
    W: int
    unit: int = 0


@dataclass(frozen=True)
class QryDesc:
    """Query = read byte range [start, start+length) of the batch read
    buffer, reverse-complemented iff rev."""
    start: int          # absolute offset into the batch read-code buffer
    length: int
    rev: bool


@dataclass
class ScoreProblem:
    ref: RefDesc
    qry: QryDesc
    result: float = 0.0


@dataclass
class AlignProblem:
    ref: RefDesc
    qry: QryDesc
    corridor_mode: int
    corridor_f: Tuple[float, float]    # (k, d) / (k_align, corridor_right)
    corridor_i: int                    # full: base offset; linear: corridor//2
    width: int
    # results:
    score: float = 0.0
    best_x: int = -1
    best_y: int = -1
    stop_x: int = -1
    stop_y: int = -1
    ok: bool = False                   # backtrack reached STOP inside corridor
    ops: Optional[np.ndarray] = None   # packed op stream [ceil(T/4)] uint8

    @property
    def T(self) -> int:
        return self.ref.W + self.qry.length - 1


# ---------------------------------------------------------------------------
# device context
# ---------------------------------------------------------------------------

_current: Optional["DeviceContext"] = None


def set_current(ctx: Optional["DeviceContext"]):
    global _current
    _current = ctx


def current() -> Optional["DeviceContext"]:
    return _current


# Every counter of DeviceContext.stats, declared up front so that a snapshot
# taken at any moment holds them all. Two kinds of key are left out on
# purpose, as callers read their absence: mesh_problems_psum (off a mesh)
# and search_fallback_* (a device search that never fell back); so are the
# per-shape search_v2_class_<B>x<L> launch counts.
STAT_KEYS = (
    # score and align waves: host seconds, waves, problems, launches (one
    # per shard holding a problem of each wave = the waves on one device)
    "score_s", "score_waves", "score_problems", "score_launches",
    "align_s", "align_fetch_s", "align_waves", "align_problems",
    "align_launches", "lane_bound_retries", "upload_s",
    # DP cells, padded (what the kernels compute, bucket slack included)
    # and useful (the problems' own corridor areas)
    "cells_score", "cells_score_useful", "cells_align", "cells_align_useful",
    # NGMStats' alignment counts (AlignmentBuffer.cpp:60,120,188)
    "alignment_ok", "alignment_all", "corridor_sum",
    # device candidate search (seed/device_search.py)
    "search_count_s", "search_v2_launches", "search_v1_launches",
    "search_v1_outliers", "search_v2_retry", "search_v1_rerun",
    # pipeline stages (pipeline/runner.py): intake and emit on the main
    # thread, prep's three stages on the prep thread, each batch's waves
    # on a wave thread
    "intake_s", "prep_enc_s", "prep_search_s", "prep_score_stage_s",
    "waves_wall_s", "emit_s",
    # the pipeline's queues: the main thread blocked on the prep thread with
    # a wave slot free, and per emitted batch its waits for a wave slot and,
    # its waves ended, for its emission
    "main_wait_prep_s", "batch_wait_wave_s", "batch_wait_emit_s", "batches",
    # native engine (pipeline/native_engine.py): waves, those whose device
    # round trip ran in native code (csrc/wave.cu), the wave thread's
    # seconds blocked while the engine's workers run, their CPU seconds,
    # reads handed back to the Python path
    "engine_waves", "native_waves", "engine_wait_s", "engine_cpu_s",
    "native_failed",
    # the Python path's wave batcher (pipeline/batcher.py)
    "fire_rounds",
)


class Span:
    """One timed interval of a DeviceContext (see DeviceContext.span).
    After the block, t0 and t1 hold its perf_counter edges."""

    __slots__ = ("ctx", "name", "key", "batch", "t0", "t1", "_rf")

    def __init__(self, ctx, name, key, batch):
        self.ctx, self.name, self.key, self.batch = ctx, name, key, batch
        self._rf = None

    def __enter__(self):
        # the process-wide flag a recording torch profiler sets, seen from
        # every thread (torch._C._autograd._profiler_enabled() reads False
        # under the kineto profiler)
        if self.name is not None and _profiler._is_profiler_enabled:
            # a function-scope range, not record_function's user scope: the
            # profiler also draws a user-scope range on the card's timeline
            # (gpu_user_annotation, over the kernels launched inside it),
            # which a trace reader counts as device activity. The batch's
            # number is the range's one input (a profiler keeps it only
            # where it records inputs and follows one thread)
            self._rf = _cprofiler._RecordFunctionFast(
                "ngmlr." + self.name,
                [] if self.batch is None else [self.batch])
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.key is not None:
            self.ctx.add(self.key, self.t1 - self.t0)
        return False


class DeviceContext:
    """Holds the device-resident genome and the per-batch read buffers.

    ``device``: "cuda" by default, "cpu" for the plain PyTorch kernels, or
    a list of devices, the mesh as given (one entry per shard; entries may
    repeat). For one device, ``n_devices`` (the CLI's -t) or
    NGMLR_TPU_DEVICES widens it to a mesh (parallel/mesh.make_mesh:
    "cuda" -> cuda:0 .. cuda:N-1, clamped with a warning to the visible
    cards; the CPU is one device). Every score and align wave is then
    split over the mesh: genome and read buffer replicated, problems in
    contiguous per-shard slices, results gathered in problem order and
    bit-identical to one device's (the reference's shard_map waves,
    ngmlr_tpu/ops/device_engine.py:170-264)."""

    def __init__(self, genome_codes: np.ndarray,
                 n_devices: Optional[int] = None,
                 unit_spec: Optional[Tuple[int, int, int]] = None,
                 device=None):
        if isinstance(device, (list, tuple)):
            self.devices = [_indexed(resolve_device(d)) for d in device]
        else:
            nd_env = os.environ.get("NGMLR_TPU_DEVICES")
            self.devices = make_mesh(int(nd_env) if nd_env else n_devices,
                                     _indexed(resolve_device(device)))
        self.device = self.devices[0]            # the primary device
        self.n_devices = len(self.devices)
        self.mesh = self.devices if self.n_devices > 1 else None
        self.n_units = 1 if unit_spec is None else int(unit_spec[0])
        if self.n_units > MAX_UNITS:
            # W | unit << 28 reaches the int32 sign bit at unit 8
            raise ValueError(
                "a genome of %d units: at most %d units (%d 2^%d-base slabs) "
                "fit the unit bits of the W column"
                % (self.n_units, MAX_UNITS, MAX_UNITS, int(unit_spec[1])))
        self.genome_len = int(len(genome_codes))
        # pad the device genome to a size class with N codes: gathers mask
        # by hi/valid and never read the padding as sequence
        if self.n_units > 1:
            # TableUnit analog: genome planes [U, planeP], plane u holding
            # the plane_len codes from u << bits (its slab plus the halo)
            _, bits, plane_len = unit_spec
            planeP = _size_class(int(plane_len) + 8, 1 << 20)
            buf = np.full((self.n_units, planeP), NCODE, dtype=np.uint8)
            for u in range(self.n_units):
                seg = genome_codes[u << bits: (u << bits) + plane_len]
                buf[u, : len(seg)] = seg
        else:
            n = _size_class(self.genome_len + 8, 1 << 20)
            buf = np.full(n, NCODE, dtype=np.uint8)
            buf[: self.genome_len] = genome_codes
        # one replica per device
        self.genomes = {d: torch.from_numpy(buf).to(d)
                        for d in dict.fromkeys(self.devices)}
        self.genome = self.genomes[self.device]
        self.readbuf = None
        self.readbuf_len = 0
        # observability (the reference's csTime/scoreTime/alignTime split,
        # NGMStats.h:11-54): host seconds and counts per stage, written
        # from the prep, wave and engine threads at once, so only through
        # add() and span(), under the lock
        self._stats_lock = threading.Lock()
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        # --nosse: the plain versions of the four alignment kernels, on
        # this context's devices, chosen once here and by nothing else
        self.plain_kernels = bool(os.environ.get("NGMLR_TPU_NO_PALLAS"))
        self.stats["plain_kernels"] = int(self.plain_kernels)

    def add(self, key: str, value) -> None:
        """Add value to stats[key] (0 where absent), under the lock."""
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + value

    def add_all(self, pairs) -> None:
        """add() for every (key, value) pair at once: one update of stats,
        so that a snapshot (dict(stats)) holds all of them or none."""
        with self._stats_lock:
            self.stats.update({k: self.stats.get(k, 0) + v
                               for k, v in pairs})

    def span(self, name: Optional[str], key: Optional[str] = None,
             batch: Optional[int] = None) -> Span:
        """A timed block: its seconds go to stats[key] where a key is given.
        While a torch profiler records, a named span is also the profiler
        range "ngmlr.<name>", with the batch's number as its input; a span
        without a name feeds its counter only, which keeps an outer
        interval from taking the labels of the named spans inside it."""
        return Span(self, name, key, batch)

    def _upload(self, arr: np.ndarray, device=None):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device if device is None else device)

    def _params_vec(self, params: Tuple[float, ...], device=None):
        """Device-cached score-parameter vector (uploads once per value and
        device)."""
        cache = getattr(self, "_pvec_cache", None)
        if cache is None:
            cache = self._pvec_cache = {}
        key = (params, self.device if device is None else device)
        if key not in cache:
            cache[key] = self._upload(np.asarray(params, dtype=np.float32),
                                      key[1])
        return cache[key]

    def upload_reads(self, read_codes: np.ndarray) -> ReadBuffer:
        """Upload a concatenated read-batch code buffer to every device;
        returns its ReadBuffer (also set as the context default). Batches
        can be in flight concurrently — each wave binds the buffer it was
        built against."""
        t0 = time.perf_counter()
        # pad so clipped gathers never read past the end
        n = _pow2(len(read_codes) + 8, 4096)
        buf = np.full(n, NCODE, dtype=np.uint8)
        buf[: len(read_codes)] = read_codes
        self.readbuf = ReadBuffer({d: self._upload(buf, d)
                                   for d in dict.fromkeys(self.devices)})
        self.readbuf_len = len(read_codes)
        self.add("upload_s", time.perf_counter() - t0)
        return self.readbuf

    def _replicas(self, readbuf) -> ReadBuffer:
        """The ReadBuffer a wave binds: the given one, or the context
        default for None. Raises when a device of the mesh has no
        replica."""
        rb = self.readbuf if readbuf is None else readbuf
        if rb is None:
            raise ValueError("no read buffer: upload_reads first")
        missing = [str(d) for d in dict.fromkeys(self.devices)
                   if d not in rb.replicas]
        if missing:
            raise ValueError("the read buffer has no replica on %s"
                             % ", ".join(missing))
        return rb

    def _upload_shards(self, blocks):
        """One upload per device of the (device, block) pairs of a wave;
        returns each block's device tensor (a view of its device's
        upload)."""
        by_dev = {}
        for i, (d, _) in enumerate(blocks):
            by_dev.setdefault(d, []).append(i)
        out = [None] * len(blocks)
        for d, ids in by_dev.items():
            big = self._upload(np.concatenate([blocks[i][1] for i in ids]), d)
            off = 0
            for i in ids:
                n = len(blocks[i][1])
                out[i] = big[off:off + n]
                off += n
        return out

    def _check_units(self, pk: np.ndarray):
        """Every row's unit (bits 28+ of its W column) must name a plane of
        the genome: a flat genome has unit 0 only. Raises, never clamps."""
        unit = (pk[:, 3].astype(np.int64) >> 28) & 0xF
        bad = np.nonzero(unit >= self.n_units)[0]
        if len(bad):
            raise ValueError(
                "row %d names genome unit %d, but the genome has %d unit%s"
                % (bad[0], unit[bad[0]], self.n_units,
                   "" if self.n_units == 1 else "s"))

    def _count(self, pk):
        """On a mesh, the shard's real problems (qlen > 0) counted on its
        device, as the reference's shard bodies psum them; None on one
        device."""
        if self.mesh is None:
            return None
        return (pk[:, 5] > 0).sum()

    # -- scoring -----------------------------------------------------------

    def score_wave(self, problems: Sequence[ScoreProblem],
                   readbuf=None) -> None:
        """Fill .result of every problem (ungapped local segment score,
        StrippedSW semantics)."""
        pend = self.score_dispatch(problems, readbuf)
        self.score_finalize(pend)

    def score_dispatch(self, problems: Sequence[ScoreProblem], readbuf=None):
        """Object-path wrapper over score_dispatch_np (the WaveBatcher /
        Python-oracle entry point)."""
        if not problems:
            return None
        pk = np.zeros((len(problems), 7), dtype=np.int32)
        pku = pk.view(np.uint32)
        for bi, p in enumerate(problems):
            pku[bi, 0] = p.ref.ds
            pku[bi, 1] = p.ref.hi
            pk[bi, 2:7] = (p.ref.diff, p.ref.W | (p.ref.unit << 28),
                           p.qry.start, p.qry.length, 1 if p.qry.rev else 0)
        return (problems, self.score_dispatch_np(pk, readbuf))

    def score_finalize(self, pend, fetched=None) -> None:
        if pend is None:
            return
        problems, np_pend = pend
        scores = self.score_finalize_np(np_pend, fetched)
        for p, s in zip(problems, scores.tolist()):
            p.result = s

    def score_wave_np(self, pk: np.ndarray, readbuf=None) -> np.ndarray:
        """Array fast path for bulk candidate scoring: pk int32 [P, 7] rows
        laid out as (ds u32, hi u32, diff, W, qstart, qlen, qrev). Returns
        f32 [P] scores (ScoreBuffer's role, ScoreBuffer.cpp:87-130)."""
        return self.score_finalize_np(self.score_dispatch_np(pk, readbuf))

    def score_dispatch_np(self, pk: np.ndarray, readbuf=None):
        """Async half of score_wave_np: upload + launches, no fetch.
        Returns an opaque pending for score_finalize_np."""
        t0 = time.perf_counter()
        P = len(pk)
        if P == 0:
            return None
        rb = self._replicas(readbuf)
        self._check_units(pk)
        live, buckets, cells, useful = plan_score_rows(pk)
        if self.mesh is not None:
            # the reference's shards count every row with qlen > 0, the
            # guarded ones too: count here those no shard is handed
            guarded = int(np.count_nonzero(~live & (pk[:, 5] > 0)))
            if guarded:
                self.add("mesh_problems_psum", guarded)
        metas = []     # (shard's problem indices, Rp, Qp)
        blocks = []    # (device, padded shard block)
        for rp, qp, idxs in buckets:
            per, shards = _shard_rows(len(idxs), self.n_devices, _pad_score)
            for s, rows in enumerate(shards):
                sub = idxs[rows]
                blocks.append((self.devices[s], score_block(pk, sub, per)))
                metas.append((sub, rp, qp))
        self.add("score_waves", len(buckets))
        self.add("cells_score", cells)
        self.add("cells_score_useful", useful)
        pending = []
        score_fill = (kernels.score_fill_plain if self.plain_kernels
                      else kernels.score_fill)
        # ONE packed upload per device and wave; per-shard blocks are views
        for (d, _), pkd, (idxs, rp, qp) in zip(
                blocks, self._upload_shards(blocks), metas):
            scores = score_fill(self.genomes[d], rb.replicas[d], pkd, rp, qp)
            pending.append((idxs, scores, self._count(pkd)))
        self.add("score_launches", len(pending))
        self.add("score_problems", P)
        self.add("score_s", time.perf_counter() - t0)
        return (P, live, pending)

    def _fetch(self, tensors):
        """Device -> host for a list of result tensors, in one transfer per
        device."""
        by_dev = {}
        for i, t in enumerate(tensors):
            by_dev.setdefault(t.device, []).append(i)
        out = [None] * len(tensors)
        for ids in by_dev.values():
            host = torch.cat([tensors[i].reshape(-1).view(torch.uint8)
                              for i in ids]).cpu().numpy()
            off = 0
            for i in ids:
                t = tensors[i]
                nb = t.numel() * t.element_size()
                dt = {torch.float32: np.float32, torch.int32: np.int32,
                      torch.int64: np.int64, torch.uint8: np.uint8}[t.dtype]
                out[i] = host[off:off + nb].view(dt).reshape(tuple(t.shape))
                off += nb
        return out

    def _fetch_waves(self, a_items, s_items):
        """ONE fetch (a transfer per device) of align pending items' (packed,
        scalars) and score pending items' scores; the shards' problem
        counts ride along into mesh_problems_psum. Returns (align pairs,
        score arrays)."""
        tensors = [x for _, p, s, _, _, _ in a_items for x in (p, s)]
        tensors += [s for _, s, _ in s_items]
        counts = [c for *_, c in a_items + s_items if c is not None]
        flat = self._fetch(tensors + counts)
        na = 2 * len(a_items)
        fa = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(a_items))]
        if counts:
            self.add("mesh_problems_psum",
                     sum(int(c) for c in flat[len(tensors):]))
        return fa, flat[na:len(tensors)]

    def score_finalize_np(self, pend, fetched=None) -> np.ndarray:
        """Fetch + scatter the scores of a score_dispatch_np pending.
        `fetched` optionally supplies pre-fetched per-bucket score arrays
        (the combined-wave fetch path)."""
        if pend is None:
            return np.zeros(0, dtype=np.float32)
        t0 = time.perf_counter()
        P, live, pending = pend
        out = np.full(P, -1.0, dtype=np.float32)   # guarded rows stay -1
        if fetched is None:
            _, fetched = self._fetch_waves([], pending)
        for (idxs, _, _), scores in zip(pending, fetched):
            out[idxs] = scores[:len(idxs)]
        self.add("score_s", time.perf_counter() - t0)
        return out

    # -- banded convex alignment --------------------------------------------

    def align_wave(self, problems: Sequence[AlignProblem],
                   params: Tuple[float, ...], readbuf=None) -> None:
        pend = self.align_dispatch(problems, params, readbuf)
        self.align_finalize(pend)

    @staticmethod
    def _lane_bound(p: "AlignProblem") -> int:
        """Upper bound on the max anti-diagonal window height (lanes the
        kernel must hold). The corridor's cross-section along x+y=t is
        roughly width/(1 + 1/k) — a LINEAR corridor (k=1) occupies only
        every other (x-y) parity at fixed t, so half its width — which
        halves the padded lane count vs the naive width+3. The kernels
        report the realized max height (hmax scalar); align_finalize
        re-runs conservatively if this bound is ever exceeded, so a bound
        bug degrades speed, never correctness."""
        w = p.width
        if p.corridor_mode == CORRIDOR_LINEAR:
            b = w // 2 + 4
        elif p.corridor_mode in (CORRIDOR_ENDPOINTS, CORRIDOR_ANCHORS):
            k = float(p.corridor_f[0])
            b = int(w * k / (k + 1.0)) + 6 if k > 0 else w + 3
        else:                                   # CORRIDOR_FULL
            b = w + 3
        return max(min(b, w + 3, p.ref.W + 2, p.qry.length + 2), 8)

    def align_dispatch_pk(self, pk_all: np.ndarray,
                          params: Tuple[float, ...], readbuf=None,
                          conservative_L: bool = False):
        """Array-path align dispatch. pk_all: int32 [P, 12] rows laid out as
        (ds u32, hi u32, diff, W, qstart, qlen, qrev, corridor_mode,
        corridor_i, width, k f32 bits, d f32 bits) — the layout the kernels
        consume and the native engine produces. ONE packed host->device
        upload per wave, one fused launch chain per (L, Wp, Hp) chunk."""
        P = len(pk_all)
        if P == 0:
            return None
        rb = self._replicas(readbuf)
        self._check_units(pk_all)
        t0 = time.perf_counter()
        chunks, failed, cells, useful = plan_align_rows(
            pk_all, conservative_L, dirs_cap())

        # build every chunk's padded shard blocks, upload ONCE per device,
        # launch on slices
        metas = []     # (L, shard's problem indices, Wp, Hp)
        blocks = []    # (device, padded shard block)
        for L, Wp, Hp, idxs in chunks:
            B, shards = _shard_rows(len(idxs), self.n_devices, _pad_align)
            for s, rows in enumerate(shards):
                sub = idxs[rows]
                blocks.append((self.devices[s], align_block(pk_all, sub, B)))
                metas.append((L, sub, Wp, Hp))
        self.add("align_waves", len(chunks))
        self.add("cells_align", cells)
        self.add("cells_align_useful", useful)
        blks = self._upload_shards(blocks)
        pending = []
        for (d, _), blk, (L, idxs, Wp, Hp) in zip(blocks, blks, metas):
            packed_ops, scalars = _convex_kernel(
                self.genomes[d], rb.replicas[d], blk,
                self._params_vec(tuple(params), d), Wp=Wp, Hp=Hp, L=L,
                plain=self.plain_kernels)
            # a conservative launch accepts its results unconditionally
            # (hmax <= width+3 is proven for monotone corridors; the
            # sentinel makes the retry recursion terminate even if that
            # proof is ever violated)
            pending.append((idxs, packed_ops, scalars,
                            (1 << 30) if conservative_L else L,
                            int(packed_ops.shape[0]) // len(blk),
                            self._count(blk)))
        self.add("align_launches", len(pending))
        self.add("align_problems", P)
        self.add("align_s", time.perf_counter() - t0)
        return (pk_all, pending, params, rb, failed)

    def fetch_waves_np(self, apend, spend):
        """ONE device -> host transfer covering an align pending and a score
        pending (the native engine posts both kinds of results to the wave
        gate together). Returns (align results tuple, scores f32)."""
        a_items = [] if apend is None else apend[1]
        s_items = [] if spend is None else spend[2]
        t0 = time.perf_counter()
        fa, fs = self._fetch_waves(a_items, s_items)
        self.add("align_fetch_s", time.perf_counter() - t0)
        a_res = self.align_finalize_pk(apend, fetched=fa)
        s_res = self.score_finalize_np(spend, fetched=fs)
        return a_res, s_res

    def align_finalize_pk(self, pend, fetched=None):
        """Returns (scores f32 [P], best_x i32, best_y i32, stop_x, stop_y,
        ok u8, ops) where ops[i] is the packed op-stream row (np.uint8) or
        None for failed rows. `fetched` optionally supplies pre-fetched
        per-chunk (packed, scalars) pairs (the combined-wave fetch path)."""
        if pend is None:
            return None
        t0 = time.perf_counter()
        pk_all, pending, params, readbuf, failed = pend
        P = len(pk_all)
        scores = np.zeros(P, dtype=np.float32)
        bx = np.full(P, -1, dtype=np.int32)
        by = np.full(P, -1, dtype=np.int32)
        sx = np.full(P, -1, dtype=np.int32)
        sy = np.full(P, -1, dtype=np.int32)
        ok = np.zeros(P, dtype=np.uint8)
        ops: List[Optional[np.ndarray]] = [None] * P
        if fetched is None:
            fetched, _ = self._fetch_waves(pending, [])
            self.add("align_fetch_s", time.perf_counter() - t0)
        n_ok = 0
        corr_sum = 0
        lane_retry: List[int] = []
        for (idxs, _, _, L, T4, _), (packed, scalars) in zip(pending,
                                                             fetched):
            packed = packed.reshape(-1, T4)
            for bi, i in enumerate(idxs):
                (score_i, bxi, byi, sxi, syi, okf, hmax) = scalars[bi]
                if int(hmax) > L:
                    # the _lane_bound estimate was too tight for this
                    # corridor — re-run with the conservative width+3
                    # lane count (correctness safety net; should never
                    # fire for the analytic bounds)
                    lane_retry.append(int(i))
                    continue
                scores[i] = np.int32(score_i).view(np.float32)
                bx[i], by[i] = int(bxi), int(byi)
                sx[i], sy[i] = int(sxi), int(syi)
                ok[i] = 1 if okf else 0
                ops[i] = packed[bi]
                n_ok += int(ok[i])
                corr_sum += int(pk_all[i, 9])
        if lane_retry:
            self.add("lane_bound_retries", len(lane_retry))
            # re-dispatch the subset conservatively (over the mesh too);
            # splice results back
            sub = np.ascontiguousarray(pk_all[lane_retry])
            r = self.align_finalize_pk(self.align_dispatch_pk(
                sub, params, readbuf, conservative_L=True))
            (s2, bx2, by2, sx2, sy2, ok2, ops2) = r
            for j, i in enumerate(lane_retry):
                scores[i] = s2[j]
                bx[i], by[i] = bx2[j], by2[j]
                sx[i], sy[i] = sx2[j], sy2[j]
                ok[i] = ok2[j]
                ops[i] = ops2[j]
                n_ok += int(ok2[j])
                corr_sum += int(pk_all[i, 9])
        # NGMStats corridorLen/alignmentCount/invalidAligmentCount
        # (AlignmentBuffer.cpp:60,120,188)
        self.add("alignment_ok", n_ok)
        self.add("alignment_all", P)
        self.add("corridor_sum", corr_sum)
        self.add("align_s", time.perf_counter() - t0)
        return (scores, bx, by, sx, sy, ok, ops)

    def align_dispatch(self, problems: Sequence[AlignProblem],
                       params: Tuple[float, ...], readbuf=None,
                       conservative_L: bool = False):
        """Object-path wrapper over align_dispatch_pk (the WaveBatcher /
        Python-oracle entry point)."""
        if not problems:
            return None
        P = len(problems)
        pk = np.zeros((P, 12), dtype=np.int32)
        pku = pk.view(np.uint32)
        pkf = pk.view(np.float32)
        for bi, p in enumerate(problems):
            pku[bi, 0] = p.ref.ds
            pku[bi, 1] = p.ref.hi
            pk[bi, 2:10] = (p.ref.diff, p.ref.W | (p.ref.unit << 28),
                            p.qry.start, p.qry.length,
                            1 if p.qry.rev else 0,
                            p.corridor_mode, p.corridor_i, p.width)
            pkf[bi, 10:12] = p.corridor_f
        pend = self.align_dispatch_pk(pk, params, readbuf,
                                      conservative_L=conservative_L)
        return (problems, pend)

    def align_finalize(self, pend) -> None:
        if pend is None:
            return
        problems, pk_pend = pend
        r = self.align_finalize_pk(pk_pend)
        if r is None:
            return
        scores, bx, by, sx, sy, ok, ops = r
        for i, p in enumerate(problems):
            p.score = float(scores[i])
            p.best_x, p.best_y = int(bx[i]), int(by[i])
            p.stop_x, p.stop_y = int(sx[i]), int(sy[i])
            p.ok = bool(ok[i])
            p.ops = ops[i]


# ---------------------------------------------------------------------------
# the fused convex kernel chain
# ---------------------------------------------------------------------------

def _convex_kernel(genome, readbuf, pk, params, Wp: int, Hp: int, L: int,
                   plain: bool = False):
    """Fused banded convex-gap alignment of align rows pk int32 [B, 12]:
    corridor windows -> fill -> backtrack + 2-bit pack. params: f32 [6]
    score params. plain: call the kernels' plain versions (--nosse).
    Returns (packed_ops uint8 [B * (Wp+Hp)/4] flat, scalars int32 [B, 7] =
    (score bits, best_x, best_y, stop_x, stop_y, ok, hmax))."""
    if plain:
        windows, fill, walk = (kernels.corridor_windows_plain,
                               kernels.convex_fill_plain,
                               kernels.convex_backtrack_plain)
    else:
        windows, fill, walk = (kernels.corridor_windows, kernels.convex_fill,
                               kernels.convex_backtrack)
    Tp = Wp + Hp
    ymin, ymax, hmax = windows(pk, Tp)
    dirs, best, by, bx = fill(genome, readbuf, pk, params, ymin, ymax, L)
    packed, sx, sy, state = walk(dirs, ymin, pk, bx, by)
    ok = (state == kernels.DONE).to(torch.int32)
    scalars = torch.stack([best.view(torch.int32), bx, by, sx, sy, ok, hmax],
                          dim=1)
    return packed.reshape(-1), scalars

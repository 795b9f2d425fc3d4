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
exactly. This module is the single-device slice of that engine: the mesh
(-t N over several cards) and the multi-unit genome planes are not ported
yet (ROADMAP items 4 and 6) and raise.
"""

from dataclasses import dataclass
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .types import (STOP, DIAG, INS, DEL, XCODE, NCODE,  # noqa: F401
                    CORRIDOR_FULL, CORRIDOR_LINEAR, CORRIDOR_ENDPOINTS,
                    CORRIDOR_ANCHORS)

MAX_SEQ_LEN = 100000  # ssw guard (StrippedSW.h:87)


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


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RefDesc:
    """Device recipe for a decoded reference window of length W:
    window[i] = CODE2CHAR[genome[ds + i - diff]] if (i >= diff and i < W and
    ds + i - diff < hi) else 'x'. Produced by ReferenceGenome.decode_*_desc.

    `unit` names the genome plane of a multi-unit genome (> one 2^31
    slab); only unit 0 exists in this port (ROADMAP item 6)."""
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


class DeviceContext:
    """Holds the device-resident genome and the per-batch read buffer on
    one device (``device``: "cuda" by default, "cpu" for the plain PyTorch
    kernels)."""

    def __init__(self, genome_codes: np.ndarray,
                 n_devices: Optional[int] = None,
                 unit_spec: Optional[Tuple[int, int, int]] = None,
                 device=None):
        self.device = resolve_device(device)
        nd_env = os.environ.get("NGMLR_TPU_DEVICES")
        nd = int(nd_env) if nd_env else int(n_devices or 1)
        avail = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        if nd > 1 and avail > 1:
            raise NotImplementedError(
                "-t %d over %d visible cards: the multi-GPU mesh is not "
                "ported yet (ROADMAP open item 1.4)" % (nd, avail))
        if nd > avail:
            import sys as _sys
            _sys.stderr.write(
                "ngmlr-tpu: %d devices requested, %d available — using %d\n"
                % (nd, avail, avail))
        self.n_devices = 1
        if unit_spec is not None and int(unit_spec[0]) > 1:
            raise NotImplementedError(
                "a genome of %d units (> one 2^31 slab): the genome planes "
                "are not ported yet (ROADMAP open item 1.6)"
                % int(unit_spec[0]))
        self.n_units = 1
        self.genome_len = int(len(genome_codes))
        # pad the device genome to a size class with N codes: gathers mask
        # by hi/valid and never read the padding as sequence
        n = _size_class(self.genome_len + 8, 1 << 20)
        buf = np.full(n, NCODE, dtype=np.uint8)
        buf[: self.genome_len] = genome_codes
        self.genome = torch.from_numpy(buf).to(self.device)
        self.readbuf = None
        self.readbuf_len = 0
        # observability (the reference's csTime/scoreTime/alignTime split,
        # NGMStats.h:11-54): wall seconds + launch/problem counts per stage.
        # Stats are mutated from concurrent finalize threads — guard the
        # read-modify-write updates
        self._stats_lock = threading.Lock()
        self.stats = {"score_s": 0.0, "score_waves": 0, "score_problems": 0,
                      "align_s": 0.0, "align_waves": 0, "align_problems": 0,
                      "upload_s": 0.0,
                      # DP-cell accounting, split per stage and padded vs
                      # useful so GCUPS can be reported honestly (padded =
                      # what the kernel actually computes incl. bucket
                      # slack; useful = the problems' own corridor areas)
                      "cells_score": 0, "cells_score_useful": 0,
                      "cells_align": 0, "cells_align_useful": 0}

    def _upload(self, arr: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _params_vec(self, params: Tuple[float, ...]):
        """Device-cached score-parameter vector (uploads once per value)."""
        cache = getattr(self, "_pvec_cache", None)
        if cache is None:
            cache = self._pvec_cache = {}
        if params not in cache:
            cache[params] = self._upload(np.asarray(params, dtype=np.float32))
        return cache[params]

    def upload_reads(self, read_codes: np.ndarray):
        """Upload a concatenated read-batch code buffer; returns the device
        tensor (also set as the context default). Batches can be in flight
        concurrently — each wave binds the buffer it was built against."""
        t0 = time.perf_counter()
        # pad so clipped gathers never read past the end
        n = _pow2(len(read_codes) + 8, 4096)
        buf = np.full(n, NCODE, dtype=np.uint8)
        buf[: len(read_codes)] = read_codes
        self.readbuf = self._upload(buf)
        self.readbuf_len = len(read_codes)
        self.stats["upload_s"] += time.perf_counter() - t0
        return self.readbuf

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
        readbuf = self.readbuf if readbuf is None else readbuf
        t0 = time.perf_counter()
        P = len(pk)
        if P == 0:
            return None
        W = (pk[:, 3] & ((1 << 28) - 1)).astype(np.int64)  # high bits: unit
        qlen = np.maximum(pk[:, 5].astype(np.int64), 1)
        # problems past the ssw maxSeqLen guard score -1 whatever the
        # kernel says (StrippedSW.h:87): they are not launched
        live = (W + 1 < MAX_SEQ_LEN) & (qlen + 1 < MAX_SEQ_LEN)
        # small problems bucket at 64-granularity (the hot subread shape is
        # 306x256 -> 320x256); larger rare probes use pow2 to bound the
        # number of distinct shapes
        Rp = np.where(
            W <= 512,
            np.maximum(64, (W + 63) // 64 * 64),
            np.int64(1) << np.ceil(np.log2(np.maximum(W, 512))).astype(np.int64))
        Qp = np.int64(1) << np.ceil(np.log2(np.maximum(qlen, 64))
                                    ).astype(np.int64)
        key = Rp * (1 << 20) + Qp
        metas = []
        blocks = []
        off = 0
        for k in np.unique(key[live]):
            idxs = np.nonzero((key == k) & live)[0]
            rp, qp = int(k >> 20), int(k & ((1 << 20) - 1))
            n = len(idxs)
            Pp = max(_pow2(n, 8), 8)
            pkb = np.zeros((Pp, 7), dtype=np.int32)
            pkb[:n] = pk[idxs]
            blocks.append(pkb)
            metas.append((idxs, rp, qp, off, Pp))
            off += Pp
        pending = []
        if blocks:
            # ONE packed upload per wave; per-bucket slices are views
            big = self._upload(np.concatenate(blocks, axis=0))
            for idxs, rp, qp, boff, Pp in metas:
                scores = kernels.score_fill(self.genome, readbuf,
                                            big[boff:boff + Pp], rp, qp)
                pending.append((idxs, scores))
                n = len(idxs)
                with self._stats_lock:
                    self.stats["score_waves"] += 1
                    self.stats["cells_score"] += n * rp * qp
                    self.stats["cells_score_useful"] += int(
                        np.sum(W[idxs] * qlen[idxs]))
        with self._stats_lock:
            self.stats["score_problems"] += P
            self.stats["score_s"] += time.perf_counter() - t0
        return (P, live, pending)

    def _fetch(self, tensors):
        """Device -> host for a list of result tensors, in one transfer."""
        if not tensors:
            return []
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
        host = flat.cpu().numpy()
        out, off = [], 0
        for t in tensors:
            nb = t.numel() * t.element_size()
            dt = {torch.float32: np.float32, torch.int32: np.int32,
                  torch.uint8: np.uint8}[t.dtype]
            out.append(host[off:off + nb].view(dt).reshape(tuple(t.shape)))
            off += nb
        return out

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
            fetched = self._fetch([s for _, s in pending])
        for (idxs, _), scores in zip(pending, fetched):
            out[idxs] = scores[:len(idxs)]
        with self._stats_lock:
            self.stats["score_s"] += time.perf_counter() - t0
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

    @staticmethod
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
        readbuf = self.readbuf if readbuf is None else readbuf
        t0 = time.perf_counter()
        pkf = pk_all.view(np.float32)
        W = (pk_all[:, 3] & ((1 << 28) - 1)).astype(np.int64)  # hi: unit
        qlen = pk_all[:, 5].astype(np.int64)
        width = pk_all[:, 9].astype(np.int64)
        mode = pk_all[:, 7]
        T_arr = W + qlen - 1
        if conservative_L:
            wb = width + 3
        else:
            # _lane_bound vectorized (see its docstring for the geometry)
            kk = pkf[:, 10].astype(np.float64)
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
        L_arr = np.where(wb <= 1024, (wb + 127) // 128 * 128,
                         self._size_class_vec(np.maximum(wb, 1), 1024))
        pvec = self._params_vec(tuple(params))
        failed: List[int] = []
        chunks = []   # (L, [row indices])
        # bucket ALSO by per-problem pow2 classes of W and qlen: the launch
        # shape (Wp, Hp) then depends only on each problem's own geometry,
        # never on which problems happened to share a wave (wave
        # composition is nondeterministic across threads)
        Wc_arr = np.int64(1) << np.ceil(
            np.log2(np.maximum(W, 256))).astype(np.int64)
        Hc_arr = np.int64(1) << np.ceil(
            np.log2(np.maximum(qlen, 256))).astype(np.int64)
        bucket_key = (L_arr << 40) | (Wc_arr << 20) | Hc_arr
        tpp_arr = Wc_arr + Hc_arr
        # cap device memory held by one launch's direction planes
        # (B x TpP x L u8); ultra-long reads split into their own launches,
        # and a problem too big for even a solo launch fails like the
        # reference's maxMatrixSizeMB refusal (AlignmentMatrixFast.cpp:45-58)
        DIRS_CAP = int(os.environ.get("NGMLR_TPU_DIRS_CAP_GB", "4")) << 30
        for bk in np.unique(bucket_key):
            idxs = np.nonzero(bucket_key == bk)[0]
            idxs = idxs[np.argsort(-T_arr[idxs], kind="stable")]
            L = int(L_arr[idxs[0]])
            chunk: List[int] = []
            chunk_tpp = 0
            for i in idxs.tolist():
                tpp = int(tpp_arr[i])
                if not chunk:
                    if 8 * tpp * L > DIRS_CAP:
                        failed.append(i)
                        continue
                    chunk = [i]
                    chunk_tpp = tpp
                    continue
                n1 = (len(chunk) + 8) // 8 * 8
                if n1 * chunk_tpp * L > DIRS_CAP:
                    chunks.append((L, chunk))
                    if 8 * tpp * L > DIRS_CAP:
                        chunk = []
                        failed.append(i)
                        continue
                    chunk = [i]
                    chunk_tpp = tpp
                else:
                    chunk.append(i)
            if chunk:
                chunks.append((L, chunk))

        # build every chunk's padded block, upload ONCE, launch on slices
        t_pack0 = time.perf_counter()
        metas = []
        blocks = []
        off = 0
        for L, idxs in chunks:
            Wp = int(Wc_arr[idxs[0]])
            Hp = int(Hc_arr[idxs[0]])
            B = max((len(idxs) + 7) // 8 * 8, 8)
            blk = np.zeros((B, 12), dtype=np.int32)
            blkf = blk.view(np.float32)
            blk[:, 9] = 1   # empty slots: width 1, zero-length → inert
            blkf[:, 10] = 1.0
            blk[: len(idxs)] = pk_all[idxs]
            blocks.append(blk)
            metas.append((L, idxs, Wp, Hp, off, B))
            off += B
        t_up0 = time.perf_counter()
        big = self._upload(np.concatenate(blocks, axis=0)) if blocks else None
        t_launch0 = time.perf_counter()
        pending = []
        for L, idxs, Wp, Hp, boff, B in metas:
            packed_ops, scalars = _convex_kernel(
                self.genome, readbuf, big[boff:boff + B], pvec,
                Wp=Wp, Hp=Hp, L=L)
            # a conservative launch accepts its results unconditionally
            # (hmax <= width+3 is proven for monotone corridors; the
            # sentinel makes the retry recursion terminate even if that
            # proof is ever violated)
            pending.append((idxs, packed_ops, scalars,
                            (1 << 30) if conservative_L else L,
                            int(packed_ops.shape[0]) // B))
            with self._stats_lock:
                self.stats["align_waves"] += 1
                self.stats["cells_align"] += len(idxs) * (Wp + Hp) * L
                self.stats["cells_align_useful"] += int(
                    np.sum(qlen[idxs] * np.minimum(width[idxs], W[idxs])))
        t_end = time.perf_counter()
        with self._stats_lock:
            self.stats["align_problems"] += P
            self.stats["align_s"] += t_end - t0
            self.stats["align_pack_s"] = (self.stats.get("align_pack_s", 0.0)
                                          + t_up0 - t_pack0)
            self.stats["align_upload_s"] = (
                self.stats.get("align_upload_s", 0.0) + t_launch0 - t_up0)
            self.stats["align_launch_s"] = (
                self.stats.get("align_launch_s", 0.0) + t_end - t_launch0)
        return (pk_all, pending, params, readbuf, failed)

    def fetch_waves_np(self, apend, spend):
        """ONE device -> host transfer covering an align pending and a score
        pending (the native engine posts both kinds of results to the wave
        gate together). Returns (align results tuple, scores f32)."""
        a_items = [] if apend is None else apend[1]
        s_items = [] if spend is None else spend[2]
        t0 = time.perf_counter()
        flat = self._fetch([x for _, p, s, _, _ in a_items for x in (p, s)]
                           + [s for _, s in s_items])
        na = 2 * len(a_items)
        fa = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(a_items))]
        fs = flat[na:]
        with self._stats_lock:
            self.stats["align_fetch_s"] = (
                self.stats.get("align_fetch_s", 0.0)
                + time.perf_counter() - t0)
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
            flat = self._fetch([x for _, p, s, _, _ in pending
                                for x in (p, s)])
            fetched = [(flat[2 * i], flat[2 * i + 1])
                       for i in range(len(pending))]
            with self._stats_lock:
                self.stats["align_fetch_s"] = (
                    self.stats.get("align_fetch_s", 0.0)
                    + time.perf_counter() - t0)
        n_ok = 0
        corr_sum = 0
        lane_retry: List[int] = []
        for (idxs, _, _, L, T4), (packed, scalars) in zip(pending, fetched):
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
            with self._stats_lock:
                self.stats["lane_bound_retries"] = (
                    self.stats.get("lane_bound_retries", 0) + len(lane_retry))
            # re-dispatch the subset conservatively; splice results back
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
        with self._stats_lock:
            self.stats["alignment_ok"] = (self.stats.get("alignment_ok", 0)
                                          + n_ok)
            self.stats["alignment_all"] = (self.stats.get("alignment_all", 0)
                                           + P)
            self.stats["corridor_sum"] = (self.stats.get("corridor_sum", 0)
                                          + corr_sum)
            self.stats["align_s"] += time.perf_counter() - t0
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

def _convex_kernel(genome, readbuf, pk, params, Wp: int, Hp: int, L: int):
    """Fused banded convex-gap alignment of align rows pk int32 [B, 12]:
    corridor windows -> fill -> backtrack + 2-bit pack. params: f32 [6]
    score params. Returns (packed_ops uint8 [B * (Wp+Hp)/4] flat, scalars
    int32 [B, 7] = (score bits, best_x, best_y, stop_x, stop_y, ok, hmax))."""
    Tp = Wp + Hp
    ymin, ymax, hmax = kernels.corridor_windows(pk, Tp)
    dirs, best, by, bx = kernels.convex_fill(genome, readbuf, pk, params,
                                             ymin, ymax, L)
    packed, sx, sy, state = kernels.convex_backtrack(dirs, ymin, pk, bx, by)
    ok = (state == kernels.DONE).to(torch.int32)
    scalars = torch.stack([best.view(torch.int32), bx, by, sx, sy, ok, hmax],
                          dim=1)
    return packed.reshape(-1), scalars

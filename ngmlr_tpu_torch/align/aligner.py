"""Interval alignment: corridor generation + retry loop.

Rebuild of AlignmentBuffer::computeAlignment and the corridor generators
(ngmlr src/AlignmentBuffer.cpp:52-197, 226-465). Float32
truncation points of the originals are preserved because corridor geometry
feeds the kernel and the validPath check, both of which decide retries.

All four corridor generators are affine formulas; they are represented as
(mode, float pair, int) scalars and evaluated on device
(ngmlr_tpu.ops.device_engine._corridor_offs). `materialize_offsets` is the
host twin used by tests and the oracle kernels.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..io.reads import SeqView
from ..ops.device_engine import (AlignProblem, RefDesc, CORRIDOR_FULL,
                                 CORRIDOR_LINEAR, CORRIDOR_ENDPOINTS,
                                 CORRIDOR_ANCHORS)
from ..ops import device_engine
from .cigar import Align, ops_convert

f32 = np.float32

DEFAULT_PARAMS = (2.0, -5.0, -5.0, -5.0, -1.0, 0.15)


@dataclass(frozen=True)
class Corridor:
    mode: int
    cf: Tuple[float, float]   # (k, d) / (k_align, corridor_right)
    ci: int                   # full: base offset; linear: corridor//2
    width: int


@dataclass
class RefWin:
    """A decoded reference window: host bytes + device descriptor."""
    desc: RefDesc
    data: bytes

    @property
    def W(self) -> int:
        return len(self.data)


def corridor_full(ref_seq_len: int) -> Corridor:
    """getCorridorFull (AlignmentBuffer.cpp:84-105)."""
    w = ref_seq_len
    off = int(f32(w) * f32(-0.2))
    length = w + int(f32(w) * f32(0.2))
    return Corridor(CORRIDOR_FULL, (1.0, 0.0), off, length)


def corridor_linear(corridor: int) -> Corridor:
    """getCorridorLinear (AlignmentBuffer.cpp:68-82)."""
    return Corridor(CORRIDOR_LINEAR, (1.0, 0.0), corridor // 2, corridor)


def corridor_endpoints(corridor: int, ref_len: int, qry_len: int,
                       realign: bool) -> Corridor:
    """getCorridorEndpoints (AlignmentBuffer.cpp:107-127)."""
    width = corridor // (1 if realign else 4)
    k = f32(qry_len) / f32(ref_len)
    d = f32(width) / f32(2.0)
    return Corridor(CORRIDOR_ENDPOINTS, (float(k), float(d)), 0, width)


def corridor_with_anchors(interval, corridor_multiplier: int, ref_len: int,
                          qry_len: int, external_qstart: int,
                          read_part_length: int,
                          full_read_length: int) -> Corridor:
    """getCorridorEndpointsWithAnchors (AlignmentBuffer.cpp:129-197)."""
    k_align = f32(qry_len) / f32(ref_len)
    corridor_left = f32(0.0)
    corridor_right = f32(0.0)
    for a in interval.anchors:
        if a.is_reverse:
            anchor_x = int(a.on_ref - interval.on_ref_start)
            anchor_y = full_read_length - a.on_read - read_part_length - external_qstart
        else:
            anchor_x = int(a.on_ref - interval.on_ref_start)
            anchor_y = a.on_read - external_qstart
        x_found = f32(anchor_x)
        x_expect = f32(anchor_y) / k_align
        diff = f32(x_expect - x_found)
        if diff > 0:
            corridor_right = max(corridor_right, diff)
        else:
            corridor_left = max(corridor_left, f32(diff * f32(-1.0)))

    corridor_left = f32(corridor_left + f32(128))
    corridor_right = f32(corridor_right + f32(128))
    # NOTE: sequential update — right uses the already-updated left
    corridor_left = f32(corridor_left + f32(corridor_left + corridor_right) * f32(0.1))
    corridor_right = f32(corridor_right + f32(corridor_left + corridor_right) * f32(0.1))
    corridor_left = f32(corridor_left * corridor_multiplier)
    corridor_right = f32(corridor_right * corridor_multiplier)

    width = int(f32(corridor_left + corridor_right))
    return Corridor(CORRIDOR_ANCHORS, (float(k_align), float(corridor_right)),
                    0, width)


def materialize_offsets(c: Corridor, qry_len: int) -> np.ndarray:
    """Host twin of the device corridor evaluation (tests / oracle path)."""
    i = np.arange(qry_len, dtype=np.float32)
    if c.mode == CORRIDOR_FULL:
        return np.full(qry_len, c.ci, dtype=np.int64)
    if c.mode == CORRIDOR_LINEAR:
        return np.arange(qry_len, dtype=np.int64) - c.ci
    k, d = f32(c.cf[0]), f32(c.cf[1])
    if c.mode == CORRIDOR_ENDPOINTS:
        return np.trunc((i - d) / k).astype(np.int64)
    return np.trunc(i / k - d).astype(np.int64)


@dataclass
class AlignerConfig:
    score_match: float = 2.0
    score_mismatch: float = -5.0
    score_gap_open: float = -5.0
    score_gap_extend_max: float = -5.0
    score_gap_extend_min: float = -1.0
    score_gap_decay: float = 0.15
    stdout_mode: int = 0      # --stdout 6: corridor/backtrack dump
    max_matrix_size_mb: int = 10000   # IConfig.h:47

    @property
    def params(self):
        return (self.score_match, self.score_mismatch, self.score_gap_open,
                self.score_gap_extend_max, self.score_gap_extend_min,
                self.score_gap_decay)


# The reference's per-computeAlignment-attempt id (static int alignmentId,
# AlignmentBuffer.cpp:241); feeds the --stdout 6 dump consumed by its
# convex-align-vis.r script.
_ALIGNMENT_ID = [0]


def _dump6_path(dbg6, problem):
    """revBacktrack's per-step path dump (ConvexAlignFast.cpp:375-377):
    every visited non-STOP cell from the best cell down, replayed from the
    packed op stream."""
    import sys
    aid, rid = dbg6
    w = sys.stdout.write
    x, y = problem.best_x, problem.best_y
    ops = problem.ops
    if ops is None or y <= 0:
        return
    t = x + y
    while t >= 0 and x >= 0 and y >= 0:
        e = (int(ops[t >> 2]) >> ((t & 3) * 2)) & 3
        if e == 0:          # STOP cell (not printed) or walk failure point
            break
        w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, x, y, 2))
        if e == 1:          # diag
            x -= 1
            y -= 1
        elif e == 2:        # ins
            y -= 1
        else:               # del
            x -= 1
        t = x + y


def align_banded(ref_win: RefWin, qry_view: SeqView, corridor: Corridor,
                 external_qstart: int, external_qend: int,
                 params=DEFAULT_PARAMS, dbg6=None,
                 max_matrix_mb=None, sv: bool = False) -> Optional[Align]:
    """One SingleAlign call: device fill + device backtrack + host CIGAR
    conversion. Returns None on backtrack failure (out-of-corridor path /
    no alignment); the caller checks final cigar length == full read length.
    A realign's row (sv) counts in the split path's counters as it is
    posted (native/engine.cpp align_banded alike).
    """
    if qry_view.length == 0 or ref_win.W == 0:
        return None
    if max_matrix_mb is not None:
        # AlignmentMatrixFast::prepare refuses a direction matrix over
        # maxMatrixSizeMB and SingleAlign fails, which the caller's retry
        # loop treats like any invalid alignment (AlignmentMatrixFast.cpp
        # :45-58). Matrix bytes = corridor cells = height x width.
        if qry_view.length * corridor.width // 1_000_000 >= max_matrix_mb:
            return None
    if dbg6 is not None:
        # SingleAlign header (ConvexAlignFast.cpp:474-476). The per-row
        # corridor dump (:634-638) lives only in the SCALAR fwdFillMatrix —
        # the shipped SSE path doesn't print it — so it appears only under
        # --nosse, exactly like the reference.
        import os
        import sys
        aid, rid = dbg6
        w = sys.stdout.write
        w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, ref_win.W, qry_view.length, -1))
        if os.environ.get("NGMLR_TPU_NO_PALLAS"):
            offs = materialize_offsets(corridor, qry_view.length)
            for y in range(qry_view.length):
                o = int(offs[y])
                w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, o, y, 0))
                w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, o + corridor.width, y, 1))
    problem = AlignProblem(ref_win.desc, qry_view.desc(), corridor.mode,
                           corridor.cf, corridor.ci, corridor.width)
    from ..pipeline import batcher as _batcher
    if sv:
        # the useful fill cells the row asks for, reckoned as the wave
        # planner reckons them; a row DIRS_CAP refuses counts here alone
        _batcher.add_stats([("sv_align_rows", 1), (
            "cells_sv_useful",
            qry_view.length * min(corridor.width, problem.ref.W))])
    wb = _batcher.current()
    if wb is not None:
        wb.align(problem, params)
    else:
        device_engine.current().align_wave([problem], params)
    if dbg6 is not None:
        _dump6_path(dbg6, problem)
    out = None
    if problem.ok:
        out = ops_convert(problem.ops, problem.best_x, problem.best_y,
                          ref_win.data, qry_view.to_bytes(),
                          external_qstart, external_qend)
    if dbg6 is not None:
        final_len = out[1] if out is not None else -1
        sys.stdout.write("%d\t%d\t%d\t%d\t%d\n" % (
            dbg6[0], dbg6[1], int(problem.score), final_len, -3))
    if out is None:
        return None
    align, final_len = out
    align.score = problem.score
    align._final_cigar_length = final_len
    return align


def compute_alignment(interval, corridor: int, qry_view: SeqView,
                      external_qstart: int, external_qend: int,
                      full_read_length: int, ref_win: RefWin,
                      cfg: AlignerConfig,
                      realign: bool = False, full_alignment: bool = False,
                      short_read: bool = False,
                      read_part_length: int = 256,
                      read=None) -> Optional[Align]:
    """computeAlignment retry loop (AlignmentBuffer.cpp:226-465).

    `ref_win` wraps the decoded [onRefStart, onRefStop] window
    (decode_exact output); refSeqLen in reference terms = W + 1.
    """
    if ref_win is None or qry_view is None:
        return None
    ref_seq_len = ref_win.W + 1   # reference's refSeqLen (incl. NUL slot)
    retry = 1 if full_alignment else 5
    max_corridor = ref_seq_len * 2
    corridor = min(corridor, max_corridor)
    qry_len = qry_view.length

    mult = 1
    while corridor * mult <= max_corridor and retry > 0:
        retry -= 1
        if full_alignment:
            c = corridor_full(ref_seq_len)
        elif short_read:
            c = corridor_linear(corridor * mult)
        elif mult < 3 and not realign and interval is not None and len(interval.anchors) > 0:
            c = corridor_with_anchors(
                interval, mult, ref_win.W, qry_len, external_qstart,
                read_part_length, full_read_length)
        else:
            c = corridor_endpoints(corridor * mult, ref_win.W, qry_len, realign)

        dbg6 = None
        if cfg.stdout_mode == 6:
            # per-attempt dump: anchors + meta lines (AlignmentBuffer.cpp
            # :332-349), then the SingleAlign dump inside align_banded;
            # alignmentId increments per attempt (:403)
            import sys
            aid = _ALIGNMENT_ID[0]
            _ALIGNMENT_ID[0] += 1
            rid = read.read_id if read is not None else 0
            w = sys.stdout.write
            if interval is not None:
                for a in interval.anchors:
                    if a.is_reverse:
                        ay = (full_read_length - a.on_read - read_part_length
                              - external_qstart)
                    else:
                        ay = a.on_read - external_qstart
                    w("%d\t%d\t%d\t%d\t%d\n" % (
                        aid, rid, int(a.on_ref - interval.on_ref_start), ay, 3))
            w("%d\t%d\t%d\t%s\t%d\n" % (
                aid, rid, rid,
                read.name.decode() if read is not None else "", -4))
            is_rev = int(interval.is_reverse) if interval is not None else 0
            w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, is_rev, c.width, -5))
            w("%d\t%d\t%d\t%d\t%d\n" % (aid, rid, external_qstart,
                                        external_qend, -6))
            dbg6 = (aid, rid)

        align = align_banded(ref_win, qry_view, c,
                             external_qstart, external_qend, cfg.params,
                             dbg6=dbg6, max_matrix_mb=cfg.max_matrix_size_mb,
                             sv=realign)
        if align is not None and align._final_cigar_length == full_read_length:
            return align
        mult += 1
    return None

"""Backtracking and CIGAR/MD generation for the convex-gap kernel.

Host-side rebuild of ConvexAlignFast::revBacktrack + convertCigar
(ngmlr src/ConvexAlignFast.cpp:335-433, 112-333):

  * walk the direction plane from the best cell to the first STOP,
  * abort ("corridor too small") if the path touches the outer 10% of the
    corridor (AlignmentMatrixFast::validPath, AlignmentMatrixFast.cpp:213-220)
    — this triggers the corridor-retry loop upstream,
  * text CIGAR merges =/X into M; MD string, NM, Identity, QStart/QEnd
    (including the caller's external clips), per-position mismatch counts
    over a 32-cell shift-register window (nmPerPosition) feeding
    small-inversion detection, first/last alignment positions,
  * validity requires CIGAR length == read length (ConvexAlignFast.cpp checks
    upstream at AlignmentBuffer.cpp:415).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..ops.types import STOP, DIAG, INS, DEL, WavefrontResult

MAX_INDEL_WINDOW = 1  # maxIndelLength (ConvexAlignFast.cpp:169)


@dataclass
class Align:
    """Result record (the reference's Align struct, IAlignment.h:112-191)."""
    cigar: str = ""
    md: str = ""
    score: float = -1.0
    identity: float = 0.0
    nm: int = 0
    mq: int = 0
    qstart: int = 0             # soft-clipped bases at read start (incl external)
    qend: int = 0               # soft-clipped bases at read end (incl external)
    position_offset: int = 0    # offset of alignment start within the ref window
    alignment_length: int = 0
    cigar_op_count: int = 0
    first_ref_pos: int = 0
    first_read_pos: int = 0
    last_ref_pos: int = 0
    last_read_pos: int = 0
    nm_per_position: Optional[np.ndarray] = None  # [n, 3] (readPos, refPos, nm)
    skip: bool = False
    primary: bool = False
    sv_type: int = 0
    mapped_interval: Optional[object] = None

    def aligned_read_bp(self, read_length: int) -> int:
        return read_length - self.qstart - self.qend


def valid_path(x: int, y: int, offsets: np.ndarray, width: int) -> bool:
    """AlignmentMatrixFast.cpp:213-220 (float truncation preserved)."""
    min_c = int(np.float32(offsets[y]) + np.float32(0.1) * np.float32(width))
    max_c = int(np.float32(min_c) + np.float32(width) - np.float32(0.1) * np.float32(width))
    return min_c < x < max_c


def backtrack(res: WavefrontResult, offsets: np.ndarray, width: int,
              qry_len: int) -> Optional[Tuple[List[Tuple[int, int]], int, int]]:
    """revBacktrack: returns (binary cigar [(op, len), ...], ref_position,
    qstart) or None on failure. Ops use the kernel's DIAG/INS/DEL plus
    soft-clip sentinel -1."""
    if res.best_y <= 0:
        return None
    ops: List[Tuple[int, int]] = []
    cur_op = -1  # CIGAR_S
    cur_len = qend = (qry_len - res.best_y) - 1
    cigar_string_length = qend

    x, y = res.best_x, res.best_y
    d = res.dir_at(x, y)
    while d != STOP:
        if not valid_path(x, y, offsets, width):
            return None
        if d == DIAG:
            x -= 1
            y -= 1
            cigar_string_length += 1
        elif d == INS:
            y -= 1
            cigar_string_length += 1
        elif d == DEL:
            x -= 1
        else:
            return None
        if d == cur_op:
            cur_len += 1
        else:
            ops.append((cur_op, cur_len))
            cur_op, cur_len = d, 1
        d = res.dir_at(x, y)
    ops.append((cur_op, cur_len))
    ops.append((-1, y + 1))          # leading soft clip
    cigar_string_length += y + 1
    ops.reverse()
    if cigar_string_length != qry_len:
        return None
    return ops, x + 1, y + 1


def _popcount32(v: int) -> int:
    return bin(v & 0xFFFFFFFF).count("1")


def decode_op_stream(packed: np.ndarray, t_best: int) -> np.ndarray:
    """Unpack the device backtrack op stream (4 ops/byte, op for wavefront t
    at bits (t%4)*2 of byte t//4) into the backward-walk op sequence
    (nonzero ops for t descending from t_best)."""
    nbytes = (t_best >> 2) + 1
    b = packed[:nbytes].astype(np.uint8)
    vals = np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], axis=1).reshape(-1)
    vals = vals[: t_best + 1][::-1]
    return vals[vals != 0]


def ops_backtrack(packed: np.ndarray, best_x: int, best_y: int,
                  qry_len: int) -> Optional[Tuple[List[Tuple[int, int]], int, int]]:
    """revBacktrack equivalent over the device op stream: returns
    (binary cigar [(op, len), ...] forward order, ref_position, qstart) or
    None on cigar-length mismatch. The corridor validPath checks already ran
    on device."""
    if best_y <= 0:
        return None
    t_best = best_x + best_y
    if t_best >= len(packed) * 4:
        return None
    walk = decode_op_stream(packed, t_best)
    n_diag = int(np.count_nonzero(walk == DIAG))
    n_ins = int(np.count_nonzero(walk == INS))
    n_del = len(walk) - n_diag - n_ins
    y_stop = best_y - n_diag - n_ins
    x_stop = best_x - n_diag - n_del
    qend = (qry_len - best_y) - 1
    cigar_string_length = qend + n_diag + n_ins + y_stop + 1
    if cigar_string_length != qry_len:
        return None
    ops: List[Tuple[int, int]] = [(-1, qend)]
    if len(walk):
        change = np.nonzero(np.diff(walk))[0] + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(walk)]])
        for s, e in zip(starts, ends):
            ops.append((int(walk[s]), int(e - s)))
    ops.append((-1, y_stop + 1))
    ops.reverse()
    return ops, x_stop + 1, y_stop + 1


def ops_convert(packed: np.ndarray, best_x: int, best_y: int,
                ref_window: bytes, qry: bytes,
                external_qstart: int, external_qend: int
                ) -> Optional[Tuple[Align, int]]:
    """Native (C++) op-stream -> Align conversion with Python fallback."""
    from ..native import get_lib, CigarResult
    import ctypes

    lib = get_lib()
    qry_len = len(qry)
    if lib is not None:
        buf = np.ascontiguousarray(packed)
        # worst-case CIGAR ~6 chars/op with ops <= path length; the MD adds
        # deleted reference bases. The C++ side reports overflow (rc=2) and
        # we fall back to the Python path, so tight caps are safe.
        cigar_cap = 4 * qry_len + 4096
        md_cap = 6 * qry_len + 4096
        nm_cap = 2 * (qry_len + 1)
        cigar_buf = ctypes.create_string_buffer(cigar_cap)
        md_buf = ctypes.create_string_buffer(md_cap)
        nm_buf = np.empty((nm_cap, 3), dtype=np.int32)
        out = CigarResult()
        rc = lib.ops_convert(
            buf.ctypes.data, len(buf), best_x, best_y,
            ref_window, len(ref_window), qry, qry_len,
            external_qstart, external_qend,
            cigar_buf, cigar_cap, md_buf, md_cap,
            nm_buf.ctypes.data, nm_cap, ctypes.byref(out))
        if rc == 1:
            return None
        if rc == 0:
            align = Align()
            align.cigar = cigar_buf.raw[:out.cigar_len].decode()
            align.md = md_buf.raw[:out.md_len].decode()
            align.nm = out.nm
            align.identity = float(out.identity)
            align.alignment_length = out.alignment_length
            align.cigar_op_count = out.cigar_op_count
            align.qstart = out.qstart
            align.qend = out.qend
            align.position_offset = out.ref_position
            align.first_ref_pos = out.first_ref_pos
            align.first_read_pos = out.first_read_pos
            align.last_ref_pos = out.last_ref_pos
            align.last_read_pos = out.last_read_pos
            align.nm_per_position = nm_buf[:out.nm_pos_count].copy()
            return align, out.final_cigar_length
        # rc == 2: buffer overflow — fall through to the Python path

    bt = ops_backtrack(packed, best_x, best_y, qry_len)
    if bt is None:
        return None
    ops, ref_position, _ = bt
    return convert_cigar(ops, ref_window, ref_position, qry,
                         external_qstart, external_qend)


def backtrack_and_convert(res: WavefrontResult, offsets: np.ndarray, width: int,
                          ref_window: bytes, qry: bytes,
                          external_qstart: int, external_qend: int
                          ) -> Optional[Tuple[Align, int]]:
    """Native (C++) fast path for backtrack + convert_cigar; falls back to
    the Python oracle when the native library is unavailable."""
    from ..native import get_lib, CigarResult
    import ctypes

    lib = get_lib()
    if lib is None:
        bt = backtrack(res, offsets, width, len(qry))
        if bt is None:
            return None
        ops, ref_position, _ = bt
        return convert_cigar(ops, ref_window, ref_position, qry,
                             external_qstart, external_qend)

    dirs = np.ascontiguousarray(res.dirs)
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int64))
    qry_len = len(qry)
    cigar_cap = 16 * qry_len + 64
    md_cap = 16 * qry_len + 64
    nm_cap = 2 * (qry_len + 1)
    cigar_buf = ctypes.create_string_buffer(cigar_cap)
    md_buf = ctypes.create_string_buffer(md_cap)
    nm_buf = np.zeros((nm_cap, 3), dtype=np.int32)
    out = CigarResult()
    rc = lib.backtrack_and_convert(
        dirs.ctypes.data, dirs.shape[0] * 4, dirs.shape[1],
        res.best_x, res.best_y,
        offs.ctypes.data, len(offs), width,
        ref_window, len(ref_window),
        qry, qry_len,
        external_qstart, external_qend,
        cigar_buf, cigar_cap, md_buf, md_cap,
        nm_buf.ctypes.data, nm_cap,
        ctypes.byref(out))
    if rc == 1:
        return None
    if rc == 2:  # buffer overflow — retry through the Python path
        bt = backtrack(res, offsets, width, qry_len)
        if bt is None:
            return None
        ops, ref_position, _ = bt
        return convert_cigar(ops, ref_window, ref_position, qry,
                             external_qstart, external_qend)

    align = Align()
    align.cigar = cigar_buf.raw[:out.cigar_len].decode()
    align.md = md_buf.raw[:out.md_len].decode()
    align.nm = out.nm
    align.identity = float(out.identity)
    align.alignment_length = out.alignment_length
    align.cigar_op_count = out.cigar_op_count
    align.qstart = out.qstart
    align.qend = out.qend
    align.position_offset = out.ref_position
    align.first_ref_pos = out.first_ref_pos
    align.first_read_pos = out.first_read_pos
    align.last_ref_pos = out.last_ref_pos
    align.last_read_pos = out.last_read_pos
    align.nm_per_position = nm_buf[:out.nm_pos_count].copy()
    return align, out.final_cigar_length


def convert_cigar(ops: List[Tuple[int, int]], ref_window: bytes,
                  ref_position: int, qry: bytes,
                  external_qstart: int, external_qend: int) -> Tuple[Align, int]:
    """convertCigar (ConvexAlignFast.cpp:112-333).

    ops: output of backtrack() — [(op, len)] with leading/trailing clips as
    op == -1; DIAG ops are split into =/X here by comparing sequences
    (the kernel stores one DIAG code; equality re-derives EQ vs X exactly
    as the fill assigned them).
    Returns (align, final_cigar_length).
    """
    align = Align()
    refseq = ref_window[ref_position:]

    # re-split DIAG runs into =/X by sequence comparison
    expanded: List[Tuple[int, int]] = [ops[0]]
    rp = 0                      # position in refseq
    qp = ops[0][1]              # read position after leading clip
    for op, length in ops[1:-1]:
        if op == DIAG:
            run_op = None
            run_len = 0
            for i in range(length):
                eq = qry[qp + i] == refseq[rp + i]
                o = ("EQ" if eq else "X")
                if o == run_op:
                    run_len += 1
                else:
                    if run_op is not None:
                        expanded.append((run_op, run_len))
                    run_op, run_len = o, 1
            expanded.append((run_op, run_len))
            rp += length
            qp += length
        elif op == INS:
            expanded.append(("I", length))
            qp += length
        elif op == DEL:
            expanded.append(("D", length))
            rp += length
    expanded.append(ops[-1])

    buffer = 0
    pos_in_ref = 0
    pos_in_read = 0
    cigar_op_count = 0
    exact_alignment_length = 0
    final_cigar_length = 0
    cigar_parts: List[str] = []
    md_parts: List[str] = []
    nm_pos: List[Tuple[int, int, int]] = []

    def add_position(ref_p, read_p, yi):
        if read_p > 16 and ref_p > 16:
            nm_pos.append((read_p - 16, ref_p - 16, yi))

    clip0 = expanded[0][1]
    align.qstart = clip0 + external_qstart
    if align.qstart > 0:
        cigar_parts.append(f"{align.qstart}S")
        cigar_op_count += 1
        final_cigar_length += align.qstart
    pos_in_read = clip0
    align.first_ref_pos = 0
    align.first_read_pos = pos_in_read

    matches = 0
    alignment_length = 0
    cigar_m_length = 0
    md_eq_length = 0
    ref_index = 0
    yi = 0

    def flush_m():
        nonlocal cigar_m_length, final_cigar_length, cigar_op_count
        if cigar_m_length > 0:
            cigar_parts.append(f"{cigar_m_length}M")
            cigar_op_count += 1
            final_cigar_length += cigar_m_length
            cigar_m_length = 0

    for op, length in expanded[1:-1]:
        alignment_length += length
        if op == "X":
            cigar_m_length += length
            for _ in range(length):
                md_parts.append(str(md_eq_length))
                md_eq_length = 0
                md_parts.append(chr(refseq[ref_index]))
                ref_index += 1
                buffer = ((buffer << 1) | 1) & 0xFFFFFFFF
                yi = _popcount32(buffer)
                add_position(pos_in_ref, pos_in_read, yi)
                pos_in_ref += 1
                pos_in_read += 1
            exact_alignment_length += length
        elif op == "EQ":
            cigar_m_length += length
            md_eq_length += length
            matches += length
            for _ in range(length):
                buffer = (buffer << 1) & 0xFFFFFFFF
                yi = _popcount32(buffer)
                add_position(pos_in_ref, pos_in_read, yi)
                pos_in_ref += 1
                pos_in_read += 1
            ref_index += length
            exact_alignment_length += length
        elif op == "D":
            flush_m()
            cigar_parts.append(f"{length}D")
            cigar_op_count += 1
            md_parts.append(str(md_eq_length))
            md_eq_length = 0
            md_parts.append("^")
            for k in range(length):
                md_parts.append(chr(refseq[ref_index]))
                ref_index += 1
                buffer = (buffer << 1) & 0xFFFFFFFF
                if k < MAX_INDEL_WINDOW:
                    buffer |= 1
                    yi = max(0, yi + 1)
                add_position(pos_in_ref, pos_in_read, yi)
                pos_in_ref += 1
            exact_alignment_length += length
        elif op == "I":
            flush_m()
            cigar_parts.append(f"{length}I")
            cigar_op_count += 1
            final_cigar_length += length
            for k in range(length):
                buffer = (buffer << 1) & 0xFFFFFFFF
                if k < MAX_INDEL_WINDOW:
                    buffer |= 1
                    yi = max(0, yi + 1)
            pos_in_read += length
            exact_alignment_length += length

    md_parts.append(str(md_eq_length))
    flush_m()

    align.qend = expanded[-1][1] + external_qend
    if align.qend > 0:
        cigar_parts.append(f"{align.qend}S")
        cigar_op_count += 1
    final_cigar_length += align.qend

    align.identity = float(np.float32(matches) * np.float32(1.0) /
                           np.float32(alignment_length)) if alignment_length else 0.0
    align.nm = alignment_length - matches
    align.alignment_length = exact_alignment_length
    align.cigar = "".join(cigar_parts)
    align.md = "".join(md_parts)
    align.cigar_op_count = cigar_op_count
    align.last_ref_pos = pos_in_ref
    align.last_read_pos = pos_in_read
    align.position_offset = ref_position
    align.nm_per_position = (np.asarray(nm_pos, dtype=np.int32).reshape(-1, 3)
                             if nm_pos else np.zeros((0, 3), np.int32))
    return align, final_cigar_length

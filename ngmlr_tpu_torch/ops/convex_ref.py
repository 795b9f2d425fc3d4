"""Scalar oracle for the convex-gap banded aligner (test reference only).

Direct, slow implementation of the production recurrence of the reference's
ConvexAlignFast::fwdFillMatrix (ngmlr src/ConvexAlignFast.cpp:606-774).
Used to validate the wavefront kernel (ops/convex.py) and, on the card, the
CUDA fill and backtrack cell-for-cell; never on the hot path.

Note on the 'x' sentinel: the *scalar* ConvexAlign scores ref 'x' as
mismatch*100 (ConvexAlign.cpp:512-513) but the production ConvexAlignFast —
the default aligner (AlignmentBuffer.h:345-363) — scores it as a plain
mismatch (ConvexAlignFast.cpp:657-659). We implement the production
semantics.
"""

import numpy as np

from .types import STOP, DIAG, INS, DEL


def fill_matrix(ref: bytes, qry: bytes, offsets: np.ndarray, width: int,
                mat=2.0, mis=-5.0, gap_open=-5.0, gap_ext=-5.0,
                gap_ext_min=-1.0, gap_decay=0.15):
    """Returns (best_score, best_x, best_y, dirs[H,W] uint8).

    offsets: per-row corridor offset (int array, len == len(qry));
    width: corridor length (constant per alignment, as produced by every
    corridor generator in AlignmentBuffer.cpp:52-197).
    """
    f = np.float32
    mat, mis = f(mat), f(mis)
    gap_open, gap_ext = f(gap_open), f(gap_ext)
    gap_ext_min, gap_decay = f(gap_ext_min), f(gap_decay)

    H, W = len(qry), len(ref)
    score = np.zeros((H, W), dtype=np.float32)
    dirs = np.zeros((H, W), dtype=np.uint8)
    runs = np.zeros((H, W), dtype=np.int32)

    def cell(x, y):
        if x < 0 or y < 0:
            return f(0), STOP, 0
        if x < max(0, offsets[y]) or x >= min(W, offsets[y] + width):
            return f(0), STOP, 0
        return score[y, x], dirs[y, x], runs[y, x]

    best = f(-1.0)
    best_x = best_y = 0
    for y in range(H):
        for x in range(max(0, int(offsets[y])), min(W, int(offsets[y]) + width)):
            diag_score = cell(x - 1, y - 1)[0]
            up_s, up_d, up_r = cell(x, y - 1)
            lf_s, lf_d, lf_r = cell(x - 1, y)

            eq = qry[y] == ref[x]
            diag_cell = f(diag_score + (mat if eq else mis))

            if up_d == INS:
                ins_run = up_r
                up_cell = f(0) if up_s == 0 else f(up_s + min(gap_ext_min,
                                                   f(gap_ext + f(ins_run * gap_decay))))
            else:
                ins_run = 0
                up_cell = f(up_s + gap_open)
            if lf_d == DEL:
                del_run = lf_r
                lf_cell = f(0) if lf_s == 0 else f(lf_s + min(gap_ext_min,
                                                   f(gap_ext + f(del_run * gap_decay))))
            else:
                del_run = 0
                lf_cell = f(lf_s + gap_open)

            max_cell = max(f(0), lf_cell, diag_cell, up_cell)

            if del_run > 0 and max_cell == lf_cell:
                s, d, r = max_cell, DEL, del_run + 1
            elif ins_run > 0 and max_cell == up_cell:
                s, d, r = max_cell, INS, ins_run + 1
            elif max_cell == diag_cell:
                s, d, r = max_cell, DIAG, 0
            elif max_cell == lf_cell:
                s, d, r = max_cell, DEL, 1
            elif max_cell == up_cell:
                s, d, r = max_cell, INS, 1
            else:
                s, d, r = f(0), STOP, 0
            score[y, x], dirs[y, x], runs[y, x] = s, d, r

            if max_cell > best:
                best = max_cell
                best_x, best_y = x, y

    return float(best), best_x, best_y, dirs

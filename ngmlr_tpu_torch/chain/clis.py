"""Constrained longest-increasing-subsequence chaining + interval extraction.

Rebuild of AlignmentBuffer::cLIS and getIntervalsFromAnchors
(ngmlr src/AlignmentBuffer.cpp:490-564, 876-1115), including the
reference's traceback tie rules (highest-index predecessor with maximal DP,
earliest best end) and the repeated extract-and-remove loop that keeps only
chains containing at least one unique anchor.
"""

import math
from typing import List, Tuple

import numpy as np

from .structs import Anchor, Interval

f32 = np.float32


def clis(anchors: List[Anchor], read_part_length: int = 256) -> List[int]:
    """Returns indices of the chain, ascending (AlignmentBuffer.cpp:490-564).

    Dispatches to the native C++ DP (ngmlr_tpu/native/cigar_native.cpp
    clis_chain) when available; this Python twin is the test oracle."""
    n = len(anchors)
    if n == 0:
        return []
    from ..native import get_lib
    lib = get_lib()
    if lib is not None and n > 4:
        on_read = np.fromiter((a.on_read for a in anchors), np.int64, n)
        on_ref = np.fromiter((a.on_ref for a in anchors), np.int64, n)
        is_rev = np.fromiter((a.is_reverse for a in anchors), np.uint8, n)
        out = np.empty(n, np.int32)
        scratch = np.empty(2 * n, np.int32)
        m = lib.clis_chain(on_read.ctypes.data, on_ref.ctypes.data,
                           is_rev.ctypes.data, n, read_part_length,
                           out.ctypes.data, scratch.ctypes.data,
                           scratch[n:].ctypes.data)
        return out[:m].tolist()
    dp = [1] * n
    trace = [-1] * n
    max_length = 1
    best_end = 0
    max_ref_diff = float(read_part_length) * 2.0

    for i in range(n):
        ai = anchors[i]
        for j in range(i - 1, -1, -1):
            aj = anchors[j]
            if dp[j] + 1 <= dp[i]:
                continue
            if aj.is_reverse != ai.is_reverse:
                continue
            ref_diff = (aj.on_ref - ai.on_ref) if aj.is_reverse else (ai.on_ref - aj.on_ref)
            read_diff = ai.on_read - aj.on_read
            diff = abs(ref_diff - read_diff)
            max_diff = int(max(abs(ref_diff), read_diff) * 0.25)
            if ((diff < max_diff
                 or (ai.on_read == aj.on_read and abs(ref_diff) <= read_part_length))
                    and ref_diff < max_ref_diff and ref_diff >= 0):
                dp[i] = dp[j] + 1
                trace[i] = j
        if dp[i] > max_length:
            best_end = i
            max_length = dp[i]

    out = []
    i = best_end
    while trace[i] != -1:
        out.append(i)
        i = trace[i]
    out.append(i)
    out.reverse()
    return out


def linreg(xs: List[float], ys: List[float]) -> Tuple[float, float, float]:
    """LinearRegression.cpp:11-45 (double precision)."""
    n = len(xs)
    sumx = sum(xs)
    sumx2 = sum(x * x for x in xs)
    sumxy = sum(x * y for x, y in zip(xs, ys))
    sumy = sum(ys)
    sumy2 = sum(y * y for y in ys)
    denom = n * sumx2 - sumx * sumx
    if denom == 0:
        return 0.0, 0.0, 0.0
    m = (n * sumxy - sumx * sumy) / denom
    b = (sumy * sumx2 - sumx * sumxy) / denom
    num = sumxy - sumx * sumy / n
    den = math.sqrt((sumx2 - sumx * sumx / n) * (sumy2 - sumy * sumy / n))
    r = num / den if den != 0 else float("nan")
    return m, b, r


def get_intervals_from_anchors(anchors: List[Anchor], read_length: int,
                               max_segment_count: int,
                               max_clis_runs: int = 100,
                               read_part_length: int = 256,
                               dump_read=None) -> List[Interval]:
    """getIntervalsFromAnchors (AlignmentBuffer.cpp:876-1115).

    dump_read: when --stdout 1 is active, the Read whose cLIS-chain anchors
    (DP_TYPE_CLIS, AlignmentBuffer.cpp:1003-1021) and new segments
    (DP_TYPE_SEQMENTS, :1075-1082) are dumped."""
    from ..native import std_sort_perm
    # std::sort semantics incl. introsort tie order (AlignmentBuffer.cpp:881)
    order = std_sort_perm(np.asarray([a.on_read for a in anchors],
                                     dtype=np.int64))
    pool = [anchors[i] for i in order]
    intervals: List[Interval] = []
    clis_run_number = 0
    run_number = 0
    finished = False

    while clis_run_number < max_segment_count and not finished:
        run_number += 1
        if run_number >= max_clis_runs:
            break
        if not pool:
            finished = True
            break
        chain = clis(pool, read_part_length)
        if len(chain) < 1:
            finished = True
            break

        chain_set = set(chain)
        picked = [pool[i] for i in chain]
        remaining = [pool[i] for i in range(len(pool)) if i not in chain_set]

        min_on_read = 2 ** 31 - 1
        max_on_read = 0
        min_on_ref = 2 ** 62
        max_on_ref = 0
        is_reverse = False
        interval_score = f32(0.0)
        reg_x: List[float] = []
        reg_y: List[float] = []
        is_unique = False

        for a in picked:
            is_unique = is_unique or a.is_unique
            on_read = a.on_read
            is_reverse = a.is_reverse
            interval_score = f32(interval_score + f32(a.score))
            if is_reverse:
                if on_read < min_on_read:
                    min_on_read = on_read
                    min_on_ref = a.on_ref + read_part_length
                if on_read + read_part_length > max_on_read:
                    max_on_read = on_read + read_part_length
                    max_on_ref = a.on_ref
            else:
                if on_read < min_on_read:
                    min_on_read = on_read
                    min_on_ref = a.on_ref
                if on_read + read_part_length > max_on_read:
                    max_on_read = on_read + read_part_length
                    max_on_ref = a.on_ref + read_part_length
            reg_y.append(float(on_read))
            reg_x.append(float(a.on_ref + read_part_length if is_reverse else a.on_ref))

        if is_unique:
            if dump_read is not None:
                # DP_TYPE_CLIS + pre-increment run number (cpp:1003-1021)
                from ..pipeline.longread import _dot_plot_line
                for a in picked:
                    if a.is_reverse:
                        _dot_plot_line(dump_read, a.on_read,
                                       a.on_read + read_part_length,
                                       a.on_ref + read_part_length, a.on_ref,
                                       a.score, a.is_reverse,
                                       1 + clis_run_number, 0)
                    else:
                        _dot_plot_line(dump_read, a.on_read,
                                       a.on_read + read_part_length,
                                       a.on_ref, a.on_ref + read_part_length,
                                       a.score, a.is_reverse,
                                       1 + clis_run_number, 0)
            if len(reg_x) == 1:
                reg_x = [float(min_on_ref), float(max_on_ref)]
                reg_y = [float(min_on_read), float(max_on_read)]
            m, b, r = linreg(reg_x, reg_y)

            iv = Interval()
            iv.anchors = picked
            iv.is_reverse = is_reverse
            iv.score = float(interval_score)
            iv.on_read_start = min_on_read
            iv.on_read_stop = max_on_read
            iv.on_ref_start = min_on_ref
            iv.on_ref_stop = max_on_ref
            iv.m, iv.b, iv.r = m, b, r
            if iv.length_on_read() > 0 and iv.length_on_ref() > 0:
                intervals.append(iv)
            clis_run_number += 1
            if dump_read is not None:
                # DP_TYPE_SEQMENTS + post-increment run number (cpp:1075)
                from ..pipeline.longread import _dot_plot_line
                _dot_plot_line(dump_read, iv.on_read_start, iv.on_read_stop,
                               iv.on_ref_start, iv.on_ref_stop, iv.score,
                               iv.is_reverse, 200 + clis_run_number, 0)

        pool = remaining
    return intervals

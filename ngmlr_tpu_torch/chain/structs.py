"""Anchor / Interval records and geometric predicates.

Host-side rebuild of the reference structs (IAlignment.h:37-108) and the
interval predicates of AlignmentBuffer (ngmlr src/AlignmentBuffer.cpp
:566-860, 2334-2360). All coordinate quirks (reverse-strand ref coordinates
running high→low, float corridor checks) preserved.
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

f32 = np.float32


@dataclass
class Anchor:
    on_read: int
    on_ref: int
    score: float
    is_reverse: bool
    is_unique: bool


@dataclass
class Interval:
    on_read_start: int = 0
    on_read_stop: int = 0
    on_ref_start: int = 0
    on_ref_stop: int = 0
    m: float = 0.0
    b: float = 0.0
    r: float = 0.0
    score: float = 0.0
    id: int = 0
    is_reverse: bool = False
    is_processed: bool = False
    is_assigned: bool = False
    anchors: List[Anchor] = field(default_factory=list)

    def length_on_read(self) -> int:
        return self.on_read_stop - self.on_read_start

    def length_on_ref(self) -> int:
        return abs(self.on_ref_stop - self.on_ref_start)

    def copy_coords(self) -> "Interval":
        return Interval(self.on_read_start, self.on_read_stop,
                        self.on_ref_start, self.on_ref_stop,
                        self.m, self.b, self.r, self.score, self.id,
                        self.is_reverse)


def is_same_direction(a: Interval, b: Interval) -> bool:
    return a.is_reverse == b.is_reverse


def is_contained(a: Interval, b: Interval) -> bool:
    """AlignmentBuffer.cpp:792-797."""
    return (a.on_read_start >= b.on_read_start and a.on_read_stop <= b.on_read_stop
            and a.on_ref_start >= b.on_ref_start and a.on_ref_stop <= b.on_ref_stop
            and a.is_reverse == b.is_reverse)


def c_round(v: float) -> int:
    """C round(): half away from zero (Python's round is banker's)."""
    import math
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def _interval_in_corridor(k: float, d: float, corridor: float,
                          testee: Interval, switched: bool) -> bool:
    """isIntervalInCorridor (AlignmentBuffer.cpp:592-639)."""
    on_ref_start = testee.on_ref_start
    on_ref_stop = testee.on_ref_stop
    if switched:
        on_ref_start, on_ref_stop = on_ref_stop, on_ref_start

    y = float(testee.on_read_start)
    upper = c_round((y - (d + corridor)) / k)
    lower = c_round((y - (d - corridor)) / k)
    if upper < lower:
        upper, lower = lower, upper
    in_corridor = lower <= on_ref_start <= upper

    y = float(testee.on_read_stop)
    upper = c_round((y - (d + corridor)) / k)
    lower = c_round((y - (d - corridor)) / k)
    if upper < lower:
        upper, lower = lower, upper
    return in_corridor and (lower <= on_ref_stop <= upper)


def is_compatible(a: Interval, b: Interval, corridor_size: float = 8192.0) -> bool:
    """isCompatible (AlignmentBuffer.cpp:709-752): a inside b's regression
    corridor; opposite strands tested with flipped coordinates so inversions
    stay in the segment."""
    if not (b.m != 0 and b.b != 0 and (b.r * b.r) > 0.8):
        return False
    if a.is_reverse == b.is_reverse:
        return _interval_in_corridor(b.m, b.b, corridor_size, a, False)
    return (_interval_in_corridor(b.m, b.b, corridor_size, a, True)
            or _interval_in_corridor(a.m, a.b, corridor_size, b, True))


def get_overlap_on_read(a: Interval, b: Interval) -> int:
    return max(0, min(a.on_read_stop, b.on_read_stop)
               - max(a.on_read_start, b.on_read_start))


def get_distance_on_read(a: Interval, b: Interval) -> int:
    if b.on_read_start < a.on_read_start:
        return max(0, a.on_read_start - b.on_read_stop)
    return max(0, b.on_read_start - a.on_read_stop)


def get_distance_on_ref(a: Interval, b: Interval) -> int:
    """AlignmentBuffer.cpp:2346-2360."""
    if b.is_reverse:
        if b.on_ref_stop < a.on_ref_stop:
            return max(0, a.on_ref_stop - b.on_ref_start)
        return max(0, b.on_ref_stop - a.on_ref_start)
    if b.on_ref_start < a.on_ref_start:
        return max(0, a.on_ref_start - b.on_ref_stop)
    return max(0, b.on_ref_start - a.on_ref_stop)


def is_duplication(a: Interval, b: Interval):
    """isDuplication (AlignmentBuffer.cpp:836-860); returns (bool, dupLength)."""
    overlap_on_read = get_overlap_on_read(a, b)
    if a.is_reverse:
        overlap_on_ref = max(0, min(a.on_ref_start, b.on_ref_start)
                             - max(a.on_ref_stop, b.on_ref_stop))
    else:
        overlap_on_ref = max(0, min(a.on_ref_stop, b.on_ref_stop)
                             - max(a.on_ref_start, b.on_ref_start))
    overlap_diff = max(0, overlap_on_ref - overlap_on_read)
    rp = 256
    dup = (overlap_on_ref >= rp and overlap_on_read <= rp and overlap_diff > 0)
    return dup, overlap_diff


def can_span_deletion_insertion(a: Interval, b: Interval, corridor_size: float,
                                read_part_length: int = 256) -> bool:
    """canSpanDeletionInsertion (AlignmentBuffer.cpp:754-776)."""
    distance_on_read = get_distance_on_read(a, b)
    distance_on_ref = get_distance_on_ref(a, b)
    return abs(distance_on_ref - distance_on_read) < corridor_size


def merge_intervals(a: Interval, b: Interval) -> Interval:
    """mergeIntervals (AlignmentBuffer.cpp:800-828) — mutates and returns a."""
    if a.on_read_start > b.on_read_start:
        a.on_read_start = b.on_read_start
        a.on_ref_start = b.on_ref_start
    if a.on_read_stop < b.on_read_stop:
        a.on_read_stop = b.on_read_stop
        a.on_ref_stop = b.on_ref_stop
    a.score = float(f32(a.score) + f32(b.score))
    a.anchors = a.anchors + b.anchors
    a.is_assigned = a.is_assigned and b.is_assigned
    return a

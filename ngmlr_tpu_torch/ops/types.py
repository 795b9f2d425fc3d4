"""Codes shared by the alignment kernels and the host: direction codes,
the sequence codes that never match, the corridor modes, and the
host-side view of one filled direction plane (the CIGAR oracles in
align/cigar.py read it)."""

from dataclasses import dataclass

import numpy as np

STOP, DIAG, INS, DEL = 0, 1, 2, 3
XCODE = 5            # 'x' (undecodable) — never equals a query code
NCODE = 4

# corridor modes (AlignmentBuffer.cpp:52-197)
CORRIDOR_FULL, CORRIDOR_LINEAR, CORRIDOR_ENDPOINTS, CORRIDOR_ANCHORS = 0, 1, 2, 3


@dataclass
class WavefrontResult:
    score: float
    best_x: int
    best_y: int
    dirs: np.ndarray       # packed [T//4, L] uint8: 4 wavefronts per byte
    L: int

    def dir_at(self, x: int, y: int) -> int:
        if x < 0 or y < 0:
            return STOP
        t = x + y
        if t >= self.dirs.shape[0] * 4:
            return STOP
        return (int(self.dirs[t >> 2, y % self.L]) >> ((t & 3) * 2)) & 3

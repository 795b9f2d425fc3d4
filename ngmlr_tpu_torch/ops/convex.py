"""Banded convex-gap DP as a batched anti-diagonal wavefront scan: the
oracle of the fill that convex_fill computes on the mapping path.

Rebuild of ConvexAlignFast (ngmlr src/ConvexAlignFast.cpp:606-774, the
production recurrence), after the JAX package's XLA scan
(ngmlr_tpu/ops/convex.py). For cell (x, y), all three dependencies (diag
(x-1,y-1), up (x,y-1), left (x-1,y)) lie on the previous two
anti-diagonals t-1/t-2 (t = x+y), so the per-cell convex-gap run-length
state (indelRun) propagates exactly using only elementwise ops and static
cyclic shifts:

  * lanes form a ring buffer over rows: lane(y) = y mod L. The active rows of
    a wavefront are a contiguous window whose bounds move by at most 1 per
    step, so with L >= max_window + 2 each residue class has at most one
    active row, and inactive lanes hold exactly the reference's
    out-of-corridor `empty` element {score 0, dir STOP, run 0}
    (AlignmentMatrixFast.h:74-131),
  * left neighbor = same lane at t-1; up = lane-1 at t-1; diag = lane-1 at
    t-2: all static cyclic rolls,
  * best-cell tracking reproduces the reference's first-in-row-major-order
    strict-maximum rule (ConvexAlignFast.cpp:752-758) via lexicographic
    (score desc, y asc, x asc) selection.

Output per alignment: direction plane [T, L] (uint8: 0 STOP / 1 DIAG /
2 INS / 3 DEL) packed 4 wavefronts a byte, best score/x/y. Backtracking and
CIGAR generation are host-side (align/cigar.py). _wavefront_kernel runs
on the device of its inputs as a Python loop over wavefronts; it is an
oracle, never on the mapping path.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .device_engine import resolve_device
from .types import STOP, DIAG, INS, DEL, WavefrontResult  # noqa: F401

DEFAULT_PARAMS = (2.0, -5.0, -5.0, -5.0, -1.0, 0.15)


@dataclass
class BandSpec:
    """Host-side description of one banded alignment problem."""
    ref: bytes
    qry: bytes
    offsets: np.ndarray       # int64 [H] per-row corridor offset
    width: int                # corridor length (constant per row; all four
                              # corridor generators in AlignmentBuffer.cpp
                              # :52-197 produce constant-length rows)

    ymin: Optional[np.ndarray] = None   # int32 [T]
    ymax: Optional[np.ndarray] = None   # int32 [T]
    T: int = 0
    L: int = 0

    def prepare(self) -> "BandSpec":
        H, W = len(self.qry), len(self.ref)
        off = np.asarray(self.offsets, dtype=np.int64)
        lo = np.clip(off, 0, W)
        hi = np.clip(off + self.width, 0, W)
        hi = np.maximum(hi, lo)
        y = np.arange(H, dtype=np.int64)
        key_hi = y + hi                       # strictly increasing
        key_lo = y + lo
        T = W + H - 1
        t = np.arange(T, dtype=np.int64)
        # active rows on wavefront t: ymin(t) <= y <= ymax(t)
        self.ymin = np.searchsorted(key_hi, t, side="right").astype(np.int32)
        self.ymax = (np.searchsorted(key_lo, t, side="right") - 1).astype(np.int32)
        self.T = T
        win = self.ymax - self.ymin + 1
        self.L = int(max(1, win.max() if len(win) else 1)) + 2
        return self


def _wavefront_kernel(ref_codes, qry_codes, ymin, ymax, params, L: int):
    """ref/qry codes: uint8 [B, Tp] ASCII; ymin/ymax: int32 [B, Tp];
    params: f32 [6] = mat, mis, gap_open, gap_ext, gap_ext_min, gap_decay;
    all on one device. Returns (dirs uint8 [Tp // 4, B, L], 4 wavefronts a
    byte, best f32 [B], best_y i32 [B], best_x i32 [B]).
    """
    B, Tp = ref_codes.shape
    dev = ref_codes.device
    mat, mis, go, ge, gemin, gdecay = (params[i] for i in range(6))
    lanes = torch.arange(L, dtype=torch.int32, device=dev)[None, :]  # [1, L]
    BIG = 2 ** 30
    s1 = torch.zeros((B, L), dtype=torch.float32, device=dev)
    s2 = torch.zeros_like(s1)
    d1 = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    r1 = torch.zeros((B, L), dtype=torch.int32, device=dev)
    best = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    by = torch.zeros(B, dtype=torch.int32, device=dev)
    bx = torch.zeros(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((Tp, B, L), dtype=torch.uint8, device=dev)
    for t in range(Tp):
        ym, yx = ymin[:, t], ymax[:, t]                        # [B], [B]
        r = torch.remainder(lanes - ym[:, None], L)            # [B, L]
        y = ym[:, None] + r
        valid = (y <= yx[:, None]) & (ym <= yx)[:, None]
        x = t - y

        rc = torch.gather(ref_codes, 1, x.clamp(0, Tp - 1).long())
        qc = torch.gather(qry_codes, 1, y.clamp(0, Tp - 1).long())
        eq = rc == qc

        up_s = torch.roll(s1, 1, dims=1)
        up_d = torch.roll(d1, 1, dims=1)
        up_r = torch.roll(r1, 1, dims=1)
        diag_s = torch.roll(s2, 1, dims=1)
        lf_s, lf_d, lf_r = s1, d1, r1

        diag_cell = diag_s + torch.where(eq, mat, mis)

        # ge + run * gdecay: a multiply, then an add (no fused operation)
        ins_ext = up_d == INS
        up_gap = torch.minimum(gemin, ge + up_r.to(torch.float32) * gdecay)
        up_cell = torch.where(ins_ext,
                              torch.where(up_s == 0.0, 0.0, up_s + up_gap),
                              up_s + go)
        del_ext = lf_d == DEL
        lf_gap = torch.minimum(gemin, ge + lf_r.to(torch.float32) * gdecay)
        lf_cell = torch.where(del_ext,
                              torch.where(lf_s == 0.0, 0.0, lf_s + lf_gap),
                              lf_s + go)

        max_cell = torch.maximum(lf_cell.clamp_min(0.0),
                                 torch.maximum(diag_cell, up_cell))

        c1 = del_ext & (max_cell == lf_cell)
        c2 = ~c1 & ins_ext & (max_cell == up_cell)
        c3 = ~c1 & ~c2 & (max_cell == diag_cell)
        c4 = ~c1 & ~c2 & ~c3 & (max_cell == lf_cell)
        c5 = ~c1 & ~c2 & ~c3 & ~c4 & (max_cell == up_cell)

        new_d = torch.where(c1 | c4, DEL,
                            torch.where(c2 | c5, INS,
                                        torch.where(c3, DIAG, STOP)))
        new_r = torch.where(c1, lf_r + 1,
                            torch.where(c2, up_r + 1,
                                        (c4 | c5).to(torch.int32)))
        new_s = torch.where(new_d == STOP, 0.0, max_cell)

        new_s = torch.where(valid, new_s, 0.0)
        new_d = torch.where(valid, new_d, STOP).to(torch.uint8)
        new_r = torch.where(valid, new_r, 0).to(torch.int32)

        # best tracking: lexicographic (score desc, y asc, x asc) ==
        # first strict maximum in the reference's row-major scan
        cand = torch.where(valid, new_s, float("-inf"))
        m = cand.amax(dim=1)                                   # [B]
        y_m = torch.where(valid & (cand == m[:, None]), y,
                          BIG).amin(dim=1).to(torch.int32)
        x_m = t - y_m
        better = (m > best) | ((m == best)
                               & ((y_m < by) | ((y_m == by) & (x_m < bx))))
        best = torch.where(better, m, best)
        by = torch.where(better, y_m, by)
        bx = torch.where(better, x_m, bx)

        dirs[t] = new_d
        s1, d1, r1, s2 = new_s, new_d, new_r, s1
    # pack 4 wavefronts per byte (2-bit directions), as the JAX package does
    d4 = dirs.reshape(Tp // 4, 4, B, L)
    packed = d4[:, 0] | (d4[:, 1] << 2) | (d4[:, 2] << 4) | (d4[:, 3] << 6)
    return packed, best, by, bx


def run_batch(specs: List[BandSpec], params=DEFAULT_PARAMS,
              device=None) -> List[WavefrontResult]:
    """Run band problems, bucketed by padded (T, L) shape, on `device`
    ("cuda" unless the CPU is asked for)."""
    dev = resolve_device(device)
    for sp in specs:
        if sp.ymin is None:
            sp.prepare()
    results: List[Optional[WavefrontResult]] = [None] * len(specs)

    buckets = {}
    for i, sp in enumerate(specs):
        # power-of-two padding, the JAX package's compiled kernel shapes
        Tp = 256
        while Tp < sp.T:
            Tp *= 2
        L = 128
        while L < sp.L:
            L *= 2
        buckets.setdefault((Tp, L), []).append(i)

    pvec = torch.tensor(params, dtype=torch.float32, device=dev)
    for (Tp, L), idxs in buckets.items():
        B = len(idxs)
        ref_c = np.zeros((B, Tp), dtype=np.uint8)
        qry_c = np.full((B, Tp), 255, dtype=np.uint8)  # never equals ref pad 0
        ymin = np.zeros((B, Tp), dtype=np.int32)
        ymax = np.full((B, Tp), -1, dtype=np.int32)    # empty window on padding
        for bi, i in enumerate(idxs):
            sp = specs[i]
            ref_c[bi, :len(sp.ref)] = np.frombuffer(sp.ref, dtype=np.uint8)
            qry_c[bi, :len(sp.qry)] = np.frombuffer(sp.qry, dtype=np.uint8)
            ymin[bi, :sp.T] = sp.ymin
            ymax[bi, :sp.T] = sp.ymax
        packed, best, by, bx = (a.cpu().numpy() for a in _wavefront_kernel(
            *(torch.from_numpy(a).to(dev) for a in (ref_c, qry_c, ymin, ymax)),
            pvec, L=L))
        for bi, i in enumerate(idxs):
            results[i] = WavefrontResult(
                float(best[bi]), int(bx[bi]), int(by[bi]),
                packed[:, bi, :], L)
    return results

"""Batched ungapped local-segment scorer: the oracle of the candidate
scores that score_fill computes on the mapping path.

The reference scores every (subread, candidate window) pair with the
vendored striped Smith-Waterman library (StrippedSW/ssw, ngmlr
src/StrippedSW.cpp:118-160). StrippedSW passes gap penalties of -1 into
ssw_align's **uint8** weight parameters (StrippedSW.h:20-21 -> ssw.h:
117-118), i.e. penalty 255 per gap position. With 266-base subreads the
maximum attainable score is < 255, so a gapped path can never win: the
computed score is exactly the best *ungapped* local segment score

    H(i,j) = max(0, H(i-1,j-1) + s(ref_i, qry_j)),   score = max H

with s = +1 match, -1 mismatch, 0 whenever either side is not ACGT
(nt_table maps everything else to code 4 and the matrix row/col 4 is all
zero, StrippedSW.cpp:111-116, StrippedSW.h:24-39).

score_batch_kernel is that recurrence as a loop over reference columns
carrying an int32 [B, Q] H plane, on the device of its inputs (the JAX
package's lax.scan twin, ngmlr_tpu/ops/ungapped.py); score_pair_numpy is
its scalar numpy twin. Neither is on the mapping path.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .device_engine import MAX_SEQ_LEN, _pow2, resolve_device

# nt codes: A=0,C=1,G=2,T=3, other=4 (ssw nt_table order; only equality and
# the "is ACGT" property matter)
_NT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT[_c] = _i
    _NT[_c + 32] = _i


def nt_codes(seq: bytes) -> np.ndarray:
    return _NT[np.frombuffer(seq, dtype=np.uint8)]


def _guarded(ref: bytes, qry: bytes) -> bool:
    """ssw's maxSeqLen guard (StrippedSW.cpp:133-134)."""
    return len(ref) + 1 >= MAX_SEQ_LEN or len(qry) + 1 >= MAX_SEQ_LEN


def score_pair_numpy(ref: bytes, qry: bytes) -> float:
    """Single-pair twin of the kernel (plus ssw's maxSeqLen guard)."""
    if _guarded(ref, qry):
        return -1.0
    r = nt_codes(ref).astype(np.int32)
    q = nt_codes(qry).astype(np.int32)
    h = np.zeros(len(q) + 1, dtype=np.int32)
    best = 0
    for rc in r:
        s = np.where((q == rc) & (q < 4), 1, np.where((q < 4) & (rc < 4), -1, 0))
        h[1:] = np.maximum(h[:-1] + s, 0)
        h[0] = 0
        m = h.max()
        if m > best:
            best = int(m)
    return float(best)


def score_batch_kernel(ref_codes: torch.Tensor,
                       qry_codes: torch.Tensor) -> torch.Tensor:
    """Scores for [B, R] x [B, Q] uint8 nt-code batches (pad with code 4),
    on the device of the inputs.

    Padding code 4 scores 0 against everything, which cannot change a local
    maximum. Returns float32 [B].
    """
    B, R = ref_codes.shape
    q = qry_codes.to(torch.int32)             # [B, Q]
    q_is_acgt = q < 4
    ref = ref_codes.to(torch.int32)
    h = torch.zeros_like(q)
    best = torch.zeros(B, dtype=torch.int32, device=q.device)
    for i in range(R):
        rc = ref[:, i:i + 1]                  # [B, 1]
        s = torch.where((q == rc) & q_is_acgt, 1,
                        torch.where(q_is_acgt & (rc < 4), -1, 0))
        h = (F.pad(h[:, :-1], (1, 0)) + s).clamp_min(0)
        best = torch.maximum(best, h.amax(dim=1))
    return best.to(torch.float32)


def score_batch(refs, qrys, device=None) -> np.ndarray:
    """Score a python list of (ref bytes, qry bytes) with padding + guard,
    on `device` ("cuda" unless the CPU is asked for).

    Shapes are padded to power-of-two buckets, as the JAX package pads them
    to reuse its compiled kernel. A pair past ssw's maxSeqLen guard scores
    -1, as there; it is left out of the kernel, whose answer the guard
    would overwrite (the JAX package scans it, padding the batch to its
    length)."""
    if len(refs) != len(qrys):
        raise ValueError("score_batch: %d refs for %d queries"
                         % (len(refs), len(qrys)))
    dev = resolve_device(device)
    out = np.full(len(refs), -1.0, dtype=np.float32)
    live = [i for i, (r, q) in enumerate(zip(refs, qrys))
            if not _guarded(r, q)]
    if not live:
        return out
    maxr = _pow2(max(len(refs[i]) for i in live), 64)
    maxq = _pow2(max(len(qrys[i]) for i in live), 64)
    npad = _pow2(len(live), 8)
    rc = np.full((npad, maxr), 4, dtype=np.uint8)
    qc = np.full((npad, maxq), 4, dtype=np.uint8)
    for row, i in enumerate(live):
        rc[row, :len(refs[i])] = nt_codes(refs[i])
        qc[row, :len(qrys[i])] = nt_codes(qrys[i])
    scores = score_batch_kernel(torch.from_numpy(rc).to(dev),
                                torch.from_numpy(qc).to(dev))
    out[live] = scores.cpu().numpy()[:len(live)]
    return out

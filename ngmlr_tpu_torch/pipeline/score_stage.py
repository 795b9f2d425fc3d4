"""Candidate scoring stage (the reference's ScoreBuffer).

Rebuild of ScoreBuffer (ngmlr src/ScoreBuffer.cpp) as one batched
kernel launch per read batch instead of 1024-pair buffers per thread:

  * per (subread, candidate): reference window = 306 decoded bases centred
    20 left of the candidate location (refMaxLen = ((266+40)|1)+1, window
    start loc - corridor/2; ScoreBuffer.h:65-76, ScoreBuffer.cpp:110-116),
  * query = subread sequence, reverse-complemented for reverse candidates,
  * score = ungapped local segment kernel (see ngmlr_tpu.ops.ungapped),
  * per subread: sort candidates by score (descending), subread MQ =
    ceil(60*(best-second)/best) (ScoreBuffer.cpp:33-45).
"""

from typing import List, Optional

import math
import numpy as np

from ..config import Config
from ..io.reads import Read, SeqView
from ..io.reference import ReferenceGenome
from ..ops.device_engine import RefDesc, ScoreProblem
from ..ops import device_engine
from ..seed.candidates import SubreadCandidates
from .longread import ScoredSubread

MAX_MQ = 60.0


def compute_mq(best: float, second: Optional[float]) -> int:
    """ScoreBuffer::computeMQ (ScoreBuffer.cpp:33-45) — float32 arithmetic."""
    if second is None:
        return int(MAX_MQ)
    if best <= 0:
        return 0  # reference divides by zero here; rare corner, see docstring
    f = np.float32
    val = f(MAX_MQ) * (f(best) - f(second)) / f(best)
    return int(math.ceil(float(val)))


class ScoredBatch:
    """Array-native result of a batch's subread candidate scoring: all
    fields flattened over (read, subread, candidate) with candidates
    already in the per-subread std::sort order. The native engine consumes
    the arrays directly (zero re-marshalling); `subreads(i)` materializes
    the per-read ScoredSubread lists for the Python oracle/fallback path."""

    def __init__(self, n_subs, on_read, mq, counts, sub_bounds,
                 read_sub_bounds, loc, rev, score):
        self.n_subs = n_subs                  # int32 [n_reads]
        self.on_read = on_read                # int64 [total_subs]
        self.mq = mq                          # int32 [total_subs]
        self.counts = counts                  # int64 [total_subs]
        self.sub_bounds = sub_bounds          # int64 [total_subs + 1]
        self.read_sub_bounds = read_sub_bounds  # int64 [n_reads + 1]
        self.loc = loc                        # int64 [total_cands] (sorted)
        self.rev = rev                        # uint8
        self.score = score                    # float32

    def subreads(self, i: int) -> List[ScoredSubread]:
        out: List[ScoredSubread] = []
        for s in range(int(self.read_sub_bounds[i]),
                       int(self.read_sub_bounds[i + 1])):
            a, b = int(self.sub_bounds[s]), int(self.sub_bounds[s + 1])
            out.append(ScoredSubread(int(self.on_read[s]), self.loc[a:b],
                                     self.rev[a:b], self.score[a:b],
                                     int(self.mq[s])))
        return out


def score_read_batch(ref: ReferenceGenome, cfg: Config,
                     reads: List[Read],
                     candidates_per_read: List[List[SubreadCandidates]],
                     readbuf=None) -> ScoredBatch:
    """Scores all subread candidates of a batch of long reads at once.

    candidates_per_read[i][j] = candidates of subread j of read i.
    """
    rpl = cfg.read_part_length
    corridor = cfg.read_part_corridor
    qry_max_len = rpl + 10
    ref_max_len = ((qry_max_len + corridor) | 1) + 1   # ScoreBuffer.h:72

    # one packed int32 [P, 7] array for the whole batch (the descriptor
    # math is decode_window_desc vectorized; reference.py:222-236)
    loc_chunks: List[np.ndarray] = []
    rev_chunks: List[np.ndarray] = []
    qstart_chunks: List[int] = []
    qlen_chunks: List[int] = []
    counts: List[int] = []       # candidates per subread (incl. zeros)
    on_read: List[int] = []
    n_subs = np.asarray([len(subs) for subs in candidates_per_read],
                        dtype=np.int32)
    for ri, (read, subs) in enumerate(zip(reads, candidates_per_read)):
        for j, cand in enumerate(subs):
            n = len(cand.locations)
            counts.append(n)
            on_read.append(j * rpl)
            if n == 0:
                continue
            loc_chunks.append(cand.locations)
            rev_chunks.append(cand.reverse)
            qstart_chunks.append(read.buf_offset + j * rpl)
            qlen_chunks.append(len(read.subread_seq(j, rpl)))

    counts_a = np.asarray(counts, dtype=np.int64)
    sub_bounds = np.concatenate([[0], np.cumsum(counts_a)])
    read_sub_bounds = np.concatenate(
        [[0], np.cumsum(n_subs.astype(np.int64))])
    mq = np.zeros(len(counts_a), dtype=np.int32)
    if loc_chunks:
        nz = counts_a[counts_a > 0]
        locs = np.concatenate(loc_chunks)
        revs = np.concatenate(rev_chunks).astype(np.uint8)
        qstarts = np.repeat(np.asarray(qstart_chunks, np.int64), nz)
        qlens = np.repeat(np.asarray(qlen_chunks, np.int64), nz)
        P = len(locs)
        pos = locs - (corridor >> 1)
        length = np.int64(ref_max_len - 2)
        valid = (pos >= 0) & (pos < ref.concat_len)
        end = np.maximum(pos + length - ref.concat_len, 0)
        ln = length - end
        d = (pos & 1) + 2 * ((ln + 1) // 2)
        hi = np.minimum(pos + d, len(ref.codes))
        W = (hi - pos) + end
        if ref.n_units > 1:
            # TableUnit analog: unit-local ds/hi, unit id in W's high bits
            u = np.where(valid, pos >> ref.unit_bits, 0)
            base = u << ref.unit_bits
            pos = pos - base
            hi = hi - base
            W = W | (u << 28)
        pk = np.zeros((P, 7), dtype=np.int32)
        pku = pk.view(np.uint32)
        pku[:, 0] = np.where(valid, pos, 0).astype(np.uint32)
        pku[:, 1] = np.where(valid, hi, 0).astype(np.uint32)
        pk[:, 3] = np.where(valid, W, 0).astype(np.int32)
        pk[:, 4] = qstarts.astype(np.int32)
        pk[:, 5] = qlens.astype(np.int32)
        pk[:, 6] = revs.astype(np.int32)
        all_scores = device_engine.current().score_wave_np(pk, readbuf=readbuf)

        # per-subread std::sort desc incl. introsort tie order
        # (ScoreBuffer.cpp:173) — ONE segmented native call for the batch
        from ..native import std_sort_perm_f32_segmented
        order = std_sort_perm_f32_segmented(all_scores, sub_bounds, desc=True)
        all_scores = all_scores[order]
        locs = locs[order]
        revs = revs[order]

        # computeMQ vectorized (ScoreBuffer.cpp:33-45, f32-exact: operands
        # and results are exact f32 values; ceil of f32-exact is exact).
        # NOTE: the CS zero-hit rule (>90% k-mers without hits => MQ 0,
        # CS.cpp:221-225) is dead upstream: computeMQ overwrites
        # mappingQlty unconditionally after scoring (ScoreBuffer.cpp:38-45).
        starts = sub_bounds[:-1]
        has = counts_a > 0
        multi = counts_a > 1
        best = np.zeros(len(counts_a), np.float32)
        second = np.zeros(len(counts_a), np.float32)
        best[has] = all_scores[starts[has]]
        second[multi] = all_scores[starts[multi] + 1]
        f60 = np.float32(MAX_MQ)
        val = np.zeros(len(counts_a), np.float32)
        pos_best = multi & (best > 0)
        val[pos_best] = (f60 * (best[pos_best] - second[pos_best])
                         / best[pos_best])
        mq = np.where(~has, 0,
                      np.where(~multi, int(MAX_MQ),
                               np.where(best <= 0, 0,
                                        np.ceil(val.astype(np.float64))
                                        .astype(np.int64)))).astype(np.int32)
    else:
        locs = np.zeros(0, np.int64)
        revs = np.zeros(0, np.uint8)
        all_scores = np.zeros(0, np.float32)

    return ScoredBatch(n_subs, np.asarray(on_read, dtype=np.int64), mq,
                       counts_a, sub_bounds, read_sub_bounds,
                       np.ascontiguousarray(locs, dtype=np.int64),
                       np.ascontiguousarray(revs, dtype=np.uint8),
                       np.ascontiguousarray(all_scores, dtype=np.float32))

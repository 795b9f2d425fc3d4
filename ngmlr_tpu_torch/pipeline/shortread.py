"""Short-read path (reads <= read_part_length).

Rebuild of ScoreBuffer::scoreShortRead (ngmlr src/ScoreBuffer.cpp
:216-286) and AlignmentBuffer::processShortRead (AlignmentBuffer.cpp
:2550-2660).
"""

from typing import List, Tuple

import numpy as np

from ..config import Config
from ..io.reads import Read, SeqView
from ..io.reference import ReferenceGenome
from ..ops.device_engine import RefDesc, ScoreProblem
from ..align.aligner import AlignerConfig, RefWin, compute_alignment
from ..chain.structs import Interval
from ..seed.candidates import SubreadCandidates
from .longread import AlignmentRecord, LongReadProcessor
from .score_stage import compute_mq

f32 = np.float32


def process_short_read(ref: ReferenceGenome, cfg: Config, read: Read,
                       cand: SubreadCandidates,
                       acfg: AlignerConfig) -> Tuple[bool, List[AlignmentRecord], int]:
    """Returns (mapped, records, read_mq)."""
    n = len(cand.locations)
    if n == 0:
        return False, [], 0

    # -- dedup by location (ScoreBuffer.cpp:225-239): the unsigned
    # subtraction keeps everything except exact duplicate locations
    from ..native import std_sort_perm
    order = std_sort_perm(cand.locations.astype(np.int64))
    locs = cand.locations[order]
    revs = cand.reverse[order]
    keep = np.ones(len(locs), dtype=bool)
    keep[1:] = locs[1:] != locs[:-1]
    locs = locs[keep]
    revs = revs[keep]

    # -- score candidates (corridor len*0.3+256; window len+corridor)
    corridor = int(read.length * 0.3 + 256)
    fwd_view = SeqView(read, 0, read.length, False)
    rev_view = SeqView(read, 0, read.length, True)
    problems = []
    for i in range(len(locs)):
        desc = ref.decode_window_desc(int(locs[i]) - (corridor >> 1),
                                      read.length + corridor)
        if desc is None:
            desc = RefDesc(0, 0, 0, 0)
        problems.append(ScoreProblem(
            desc, (rev_view if revs[i] else fwd_view).desc()))
    LongReadProcessor._score_wave(problems)
    scores = np.asarray([p.result for p in problems], dtype=np.float32)

    sorder = std_sort_perm(scores.astype(np.float32), desc=True)
    locs, revs, scores = locs[sorder], revs[sorder], scores[sorder]
    read_mq = compute_mq(float(scores[0]), float(scores[1]) if len(scores) > 1 else None)

    # -- align top candidates (processShortRead, AlignmentBuffer.cpp:2550-2660)
    records: List[AlignmentRecord] = []
    last_score = 0
    for k in range(len(locs)):
        if not (int(scores[k]) >= last_score or len(records) < 2):
            break
        last_score = int(scores[k])
        ref_extend = int(f32(read.length) * f32(0.15))
        iv = Interval()
        iv.on_read_start = 0
        iv.on_read_stop = read.length
        iv.on_ref_start = int(locs[k]) - ref_extend
        iv.on_ref_stop = int(locs[k]) + read.length + ref_extend
        iv.is_reverse = bool(revs[k])
        short_read_corridor = cfg.read_part_length + 2 * ref_extend

        read_part_seq = rev_view if iv.is_reverse else fwd_view
        ref_win = None
        if iv.on_ref_start < iv.on_ref_stop:
            ref_seq_length = iv.on_ref_stop - iv.on_ref_start + 1
            data = ref.decode_exact(iv.on_ref_start, ref_seq_length)
            if data is not None:
                ref_win = RefWin(
                    ref.decode_exact_desc(iv.on_ref_start, ref_seq_length),
                    data)
        align = None
        if ref_win is not None:
            align = compute_alignment(iv, short_read_corridor, read_part_seq,
                                      0, 0, read.length, ref_win, acfg,
                                      short_read=True,
                                      read_part_length=cfg.read_part_length,
                                      read=read)
        mapped = align is not None and align.score > 0.0
        if mapped:
            residues = read.length - align.qstart - align.qend
            if cfg.min_residues < 1.0:
                mapped = (residues * 1.0 / read.length) > cfg.min_residues
            else:
                mapped = residues > cfg.min_residues
        if mapped:
            align.mq = read_mq
            loc = iv.on_ref_start + align.position_offset
            records.append(AlignmentRecord(align, loc, iv.is_reverse, align.score))

    if records:
        records[0].align.primary = True
        return True, records, read_mq
    return False, [], read_mq

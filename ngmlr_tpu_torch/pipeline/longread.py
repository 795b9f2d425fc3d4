"""Long-read assembly: anchors → cLIS intervals → segments → SV-aware merge
→ final banded alignments → reconciliation.

Host-side rebuild of AlignmentBuffer::processLongReadLIS and its helpers
(ngmlr src/AlignmentBuffer.cpp:2845-3464 and the functions it
calls). Control-heavy per-read logic stays on the host; every alignment and
every scoring probe goes through the batched TPU kernels
(ngmlr_tpu.ops.convex / ngmlr_tpu.ops.ungapped).

Each helper carries the file:line of the reference function it rebuilds.
"""

from dataclasses import dataclass, field
import math
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..io.reads import Read, SeqView
from ..io.reference import ReferenceGenome
from ..io.fastx import reverse_complement
from ..ops.device_engine import ScoreProblem
from ..ops import device_engine
from ..align.aligner import AlignerConfig, RefWin, compute_alignment
from ..align.cigar import Align
from ..chain.structs import (Anchor, Interval, c_round, can_span_deletion_insertion,
                             get_distance_on_read, get_distance_on_ref,
                             get_overlap_on_read, is_compatible, is_contained,
                             is_duplication, is_same_direction, merge_intervals)
from ..chain.clis import get_intervals_from_anchors

f32 = np.float32

SV_NONE, SV_INVERSION, SV_TRANSLOCATION, SV_UNKNOWN = 0, 1, 2, 3


# stdout debug dump machinery (AlignmentBuffer.h:91-103, printDotPlotLine
# AlignmentBuffer.cpp:467-476; R visualization per the reference README)
DP_TYPE_UNFILTERED, DP_TYPE_CLIS = 0, 1
DP_TYPE_SEQMENTS, DP_TYPE_SEQMENTS_CONS = 200, 400
DP_TYPE_RESULT, DP_TYPE_RESULT_CONS = 600, 800
DP_STATUS_OK, DP_STATUS_NOHIT, DP_STATUS_LOWSCORE = 0, 2, 3


def _dot_plot_line(read, a, b, c, d, score, rev, type_, status):
    import sys as _sys
    _sys.stdout.write("%d\t%s\t%d\t%d\t%d\t%d\t%f\t%d\t%d\t%d\n" % (
        read.read_id, read.name.decode(), a, b, c, d, score,
        1 if rev else 0, type_, status))


def _std_sorted(items, key, desc=False, dtype=np.int64):
    """std::sort order incl. the reference's introsort tie behavior for
    ranges > 16 (AlignmentBuffer.cpp:3035/3135/3279/3312)."""
    from ..native import std_sort_perm
    keys = np.asarray([key(x) for x in items], dtype=dtype)
    return [items[i] for i in std_sort_perm(keys, desc=desc)]


@dataclass
class ScoredSubread:
    """A subread after candidate scoring: all candidates sorted by score
    (descending); anchors use the FULL list (MappedRead::numScores, used by
    processLongReadLIS at AlignmentBuffer.cpp:2926-2999)."""
    on_read: int
    locations: np.ndarray
    reverse: np.ndarray
    scores: np.ndarray
    mq: int


@dataclass
class AlignmentRecord:
    """An Align plus its mapping location (the reference's LocationScore)."""
    align: Align
    location: int          # concat coordinate
    reverse: bool
    score: float
    # filled by the SAM writer after convert():
    ref_id: int = -1
    local_pos: int = -1


class LongReadProcessor:
    def __init__(self, ref: ReferenceGenome, cfg: Config):
        self.ref = ref
        self.cfg = cfg
        self.acfg = AlignerConfig(cfg.score_match, cfg.score_mismatch,
                                  cfg.score_gap_open, cfg.score_gap_extend_max,
                                  cfg.score_gap_extend_min, cfg.score_gap_decay,
                                  stdout_mode=cfg.stdout_mode,
                                  max_matrix_size_mb=cfg.max_matrix_size_mb)
        self.rpl = cfg.read_part_length

    # ------------------------------------------------------------------
    # small helpers around intervals and the reference genome
    # ------------------------------------------------------------------

    def extend_interval_stop(self, iv: Interval, read_bp: int, read_length: int):
        """extendIntervalStop (AlignmentBuffer.cpp:2386-2429)."""
        chrom = self.ref.get_chr_borders(iv.on_ref_start, iv.on_ref_stop)
        if chrom.start == 0 and chrom.end == 0:
            return False
        length_ratio = min(1.0, (iv.length_on_read() * 1.0 / iv.length_on_ref() * 1.0)
                           if iv.length_on_ref() else 1.0)
        extend_on_read = min(read_length - iv.on_read_stop, read_bp)
        extend_on_ref = c_round(extend_on_read / length_ratio)
        if iv.is_reverse:
            max_extend = 0 if iv.on_ref_stop < chrom.start else iv.on_ref_stop - chrom.start
        else:
            max_extend = 0 if iv.on_ref_stop > chrom.end else chrom.end - iv.on_ref_stop
        if extend_on_ref > max_extend:
            extend_on_ref = max_extend
            extend_on_read = min(extend_on_read,
                                 max(0, c_round(extend_on_ref * length_ratio) - 1))
        iv.on_read_stop += extend_on_read
        if iv.is_reverse:
            iv.on_ref_stop -= extend_on_ref
        else:
            iv.on_ref_stop += extend_on_ref
        return True

    def extend_interval_start(self, iv: Interval, read_bp: int):
        """extendIntervalStart (AlignmentBuffer.cpp:2431-2468)."""
        chrom = self.ref.get_chr_borders(iv.on_ref_start, iv.on_ref_stop)
        if chrom.start == 0 and chrom.end == 0:
            return False
        length_ratio = min(1.0, (iv.length_on_read() * 1.0 / iv.length_on_ref() * 1.0)
                           if iv.length_on_ref() else 1.0)
        extend_on_read = min(iv.on_read_start, read_bp)
        extend_on_ref = c_round(extend_on_read / length_ratio)
        if iv.is_reverse:
            max_extend = 0 if iv.on_ref_start > chrom.end else chrom.end - iv.on_ref_start
        else:
            max_extend = 0 if iv.on_ref_start < chrom.start else iv.on_ref_start - chrom.start
        if extend_on_ref > max_extend:
            extend_on_ref = max_extend
            extend_on_read = min(extend_on_read,
                                 max(0, c_round(extend_on_ref * length_ratio) - 1))
        iv.on_read_start -= extend_on_read
        if iv.is_reverse:
            iv.on_ref_start += extend_on_ref
        else:
            iv.on_ref_start -= extend_on_ref
        return True

    @staticmethod
    def shorten_interval_start(iv: Interval, read_bp: int):
        """shortenIntervalStart (AlignmentBuffer.cpp:2471-2490)."""
        if iv.on_read_start >= iv.on_read_stop:
            return False
        length_ratio = max(1.1, (iv.length_on_read() * 1.0 / iv.length_on_ref() * 1.0)
                           if iv.length_on_ref() else 1.1)
        ref_bp = c_round(read_bp / length_ratio)
        if read_bp < iv.length_on_read() and ref_bp < iv.length_on_ref():
            iv.on_read_start += read_bp
            iv.on_ref_start = (iv.on_ref_start - ref_bp if iv.is_reverse
                               else iv.on_ref_start + ref_bp)
            return True
        return False

    @staticmethod
    def shorten_interval_end(iv: Interval, read_bp: int):
        """shortenIntervalEnd (AlignmentBuffer.cpp:2492-2513)."""
        if iv.on_read_start >= iv.on_read_stop:
            return False
        length_ratio = max(1.1, (iv.length_on_read() * 1.0 / iv.length_on_ref() * 1.0)
                           if iv.length_on_ref() else 1.1)
        ref_bp = c_round(read_bp / length_ratio)
        if read_bp < iv.length_on_read() and ref_bp < iv.length_on_ref():
            iv.on_read_stop -= read_bp
            iv.on_ref_stop = (iv.on_ref_stop + ref_bp if iv.is_reverse
                              else iv.on_ref_stop - ref_bp)
            return True
        return False

    def spans_chromosome_border(self, a: Interval, b: Interval) -> bool:
        """spansChromosomeBorder (AlignmentBuffer.cpp:778-790)."""
        ca = self.ref.get_chr_start((a.on_ref_stop + a.on_ref_start) // 2)
        cb = self.ref.get_chr_start((b.on_ref_stop + b.on_ref_start) // 2)
        return ca.start != cb.start

    # -- read sequence extraction (extractReadSeq, AlignmentBuffer.cpp:1515-1549)

    def extract_read_seq(self, read: Read, on_read_start: int, read_seq_len: int,
                         is_reverse: bool, rev_comp: bool = False) -> Optional[SeqView]:
        if read_seq_len <= 0 or read_seq_len > 200000000:
            return None
        return SeqView(read, on_read_start, read_seq_len,
                       is_reverse != rev_comp)

    def extract_ref_window(self, on_ref_start: int, on_ref_stop: int) -> Optional[RefWin]:
        """extractReferenceSequenceForAlignment (AlignmentBuffer.cpp:199-223)."""
        if on_ref_start >= on_ref_stop:
            return None
        ref_seq_length = on_ref_stop - on_ref_start + 1
        if ref_seq_length <= 0:
            return None
        data = self.ref.decode_exact(on_ref_start, ref_seq_length)
        if data is None:
            return None
        return RefWin(self.ref.decode_exact_desc(on_ref_start, ref_seq_length),
                      data)

    @staticmethod
    def _score_wave(problems: List[ScoreProblem]) -> None:
        from . import batcher as _batcher
        wb = _batcher.current()
        if wb is not None:
            wb.score(problems)
        else:
            device_engine.current().score_wave(problems)

    # ------------------------------------------------------------------
    # gap-overlap machinery (translocation guard)
    # ------------------------------------------------------------------

    def _interval_score_problem(self, iv: Interval,
                                read: Read) -> Optional[ScoreProblem]:
        """scoreInterval (AlignmentBuffer.cpp:2515-2548) as a device request;
        None means the reference would return 0.0 without scoring."""
        if iv.on_read_start >= iv.on_read_stop:
            return None
        read_seq = self.extract_read_seq(read, iv.on_read_start,
                                         iv.length_on_read(), iv.is_reverse)
        if read_seq is None:
            return None
        on_ref_start = iv.on_ref_stop if iv.is_reverse else iv.on_ref_start
        on_ref_stop = iv.on_ref_start if iv.is_reverse else iv.on_ref_stop
        if on_ref_start >= on_ref_stop:
            return None
        ref_win = self.extract_ref_window(on_ref_start, on_ref_stop)
        if ref_win is None:
            return None
        return ScoreProblem(ref_win.desc, read_seq.desc())

    def score_interval(self, iv: Interval, read: Read) -> float:
        """scoreInterval (AlignmentBuffer.cpp:2515-2548)."""
        prob = self._interval_score_problem(iv, read)
        if prob is None:
            return 0.0
        self._score_wave([prob])
        return prob.result

    def _gap_overlaps(self, gap: Interval, all_intervals: List,
                      read: Optional[Read]) -> bool:
        """gapOverlapsWithInterval (AlignmentBuffer.cpp:2685-2742).

        all_intervals entries are (snap_start, snap_stop, interval): the
        reference's IntervalTree copies start/stop when built (before the
        merge phase mutates interval coordinates), so the range test uses
        the snapshot while the payload uses live values."""
        min_overlap = 50.0
        max_length_alignment_check = 1000
        min_gap_length = int(self.rpl * 1.5)
        overlaps = False
        if gap.on_read_start >= gap.on_read_stop:
            return False
        if gap.length_on_read() <= min_gap_length:
            return False
        for (snap_start, snap_stop, node) in all_intervals:
            if snap_stop < gap.on_read_start or snap_start > gap.on_read_stop:
                continue
            if node.is_processed:
                continue
            if node.length_on_read() < (int(4.5 * self.rpl) + gap.length_on_read()):
                overlap = get_overlap_on_read(node, gap)
                overlap_percent = overlap * 100.0 / gap.length_on_read()
                better_score = True
                if overlap_percent > min_overlap:
                    if read is not None and gap.length_on_read() < max_length_alignment_check:
                        iv = Interval()
                        iv.on_read_start = gap.on_read_start
                        iv.on_read_stop = gap.on_read_stop
                        iv.on_ref_start = node.on_ref_start
                        iv.on_ref_stop = node.on_ref_stop
                        iv.is_reverse = node.is_reverse
                        p1 = self._interval_score_problem(iv, read)
                        p2 = self._interval_score_problem(gap, read)
                        self._score_wave([p for p in (p1, p2) if p is not None])
                        s1 = (p1.result if p1 else 0.0) / iv.length_on_read()
                        s2 = (p2.result if p2 else 0.0) / gap.length_on_read()
                        better_score = s1 > s2
                overlaps = overlaps or (overlap_percent > min_overlap and better_score)
        return overlaps

    def gap_overlaps_between(self, first: Interval, second: Interval,
                             all_intervals: List[Interval], read: Read) -> bool:
        """gapOverlapsWithInterval(first, second, ...) (AlignmentBuffer.cpp:2662-2683)."""
        gap = Interval()
        gap.on_read_start = first.on_read_stop + 1
        gap.on_read_stop = max(0, second.on_read_start - 1)
        gap.on_ref_start = first.on_ref_stop
        gap.on_ref_stop = second.on_ref_start
        gap.is_reverse = first.is_reverse
        return self._gap_overlaps(gap, all_intervals, read)

    def gap_to_end_overlaps(self, second: Interval, read_length: int,
                            all_intervals: List[Interval]) -> bool:
        """gapToEndOverlapsWithInterval (AlignmentBuffer.cpp:2744-2755)."""
        gap = Interval()
        gap.on_read_start = min(read_length, second.on_read_stop + 1)
        gap.on_read_stop = read_length
        return self._gap_overlaps(gap, all_intervals, None)

    def gap_from_start_overlaps(self, second: Interval,
                                all_intervals: List[Interval]) -> bool:
        """gapFromStartOverlapsWithInterval (AlignmentBuffer.cpp:2757-2768)."""
        gap = Interval()
        gap.on_read_start = 0
        gap.on_read_stop = max(0, second.on_read_start - 1)
        return self._gap_overlaps(gap, all_intervals, None)

    def close_gap_on_read(self, first: Interval, second: Interval, read_length: int):
        """closeGapOnRead (AlignmentBuffer.cpp:2770-2791)."""
        if first.on_read_stop < second.on_read_stop:
            distance = get_distance_on_read(first, second)
            max_distance = int(0.25 * read_length)
            if 0 < distance < max_distance:
                self.extend_interval_stop(first, distance, read_length)
                self.extend_interval_start(second, distance)

    def extend_to_read_start(self, iv: Interval, read_length: int,
                             all_intervals: List[Interval], read: Read):
        """extendToReadStart (AlignmentBuffer.cpp:2793-2817)."""
        max_extend = min(c_round(read_length * 0.25), iv.length_on_read())
        extend = iv.on_read_start
        if extend > 0:
            if extend > self.rpl:
                if extend <= max_extend:
                    if not self.gap_from_start_overlaps(iv, all_intervals):
                        self.extend_interval_start(iv, extend)
            else:
                self.extend_interval_start(iv, extend)

    def extend_to_read_stop(self, iv: Interval, read_length: int,
                            all_intervals: List[Interval], read: Read):
        """extendToReadStop (AlignmentBuffer.cpp:2819-2843).

        NOTE: the reference's short-extend branch calls extendIntervalStart —
        preserved (it looks like an upstream copy/paste quirk but it is the
        shipped behavior)."""
        max_extend = min(c_round(read_length * 0.25), iv.length_on_read())
        extend = read_length - iv.on_read_stop
        if extend > 0:
            if extend > self.rpl:
                if extend <= max_extend:
                    if not self.gap_to_end_overlaps(iv, read_length, all_intervals):
                        self.extend_interval_stop(iv, extend, read_length)
            else:
                self.extend_interval_start(iv, extend)

    # ------------------------------------------------------------------
    # alignment of one interval (+ SV machinery)
    # ------------------------------------------------------------------

    def estimate_corridor(self, iv: Interval) -> int:
        """estimateCorridor (AlignmentBuffer.cpp:1454-1467)."""
        on_read = iv.on_read_stop - iv.on_read_start
        on_ref = iv.on_ref_stop - iv.on_ref_start
        diff = on_read - on_ref
        corridor_from_diff = int(abs(diff) * f32(2.1))
        corridor_from_length = int(abs(on_read) * f32(0.20))
        return min(8192, max(corridor_from_diff, corridor_from_length))

    def align_interval(self, read: Read, iv: Interval, read_seq: Optional[SeqView],
                       realign: bool, full_alignment: bool) -> Optional[Align]:
        """alignInterval (AlignmentBuffer.cpp:1469-1513)."""
        if read_seq is None:
            return None
        min_read_seq_length = 10
        if (abs(iv.on_read_start - iv.on_read_stop) == 0
                or abs(iv.on_ref_start - iv.on_ref_stop) == 0
                or read_seq.length < min_read_seq_length):
            return None
        corridor = self.estimate_corridor(iv)
        if iv.is_reverse:
            qend = iv.on_read_start
            qstart = read.length - iv.on_read_stop
        else:
            qstart = iv.on_read_start
            qend = read.length - iv.on_read_stop
        ref_win = self.extract_ref_window(iv.on_ref_start, iv.on_ref_stop)
        if ref_win is None:
            return None
        return compute_alignment(iv, corridor, read_seq, qstart, qend,
                                 read.length, ref_win, self.acfg,
                                 realign=realign, full_alignment=full_alignment,
                                 short_read=False, read_part_length=self.rpl,
                                 read=read)

    def _sv_probes(self, align: Align, iv: Interval, read_part_seq: SeqView,
                   inv_mid_ref: int, inv_mid_read: int, inversion_length: int,
                   read: Optional[Read] = None
                   ) -> Optional[Tuple[ScoreProblem, ScoreProblem]]:
        """checkForSV's two scoring probes (AlignmentBuffer.cpp:1158-1230);
        None when the reference answers SV_NONE without scoring."""
        read_check_length = 50
        ref_check_length = 250
        if inversion_length <= 10:
            return None
        check_loc = (iv.on_ref_start + align.position_offset + inv_mid_ref
                     - ref_check_length - inversion_length // 2)
        ref_seq_length = inversion_length + 2 * ref_check_length
        ref_desc = self.ref.decode_window_desc(check_loc, ref_seq_length)
        if ref_desc is None:
            from ..ops.device_engine import RefDesc
            ref_desc = RefDesc(0, 0, 0, 0)   # empty reference -> scores 0
        full_len = read_part_seq.length
        if not (read_check_length <= inv_mid_read
                and (inv_mid_read + read_check_length) < full_len):
            return None
        read_seq = read_part_seq.sub(inv_mid_read - read_check_length,
                                     inv_mid_read + read_check_length)
        if read_seq.length == 0:
            return None
        if self.cfg.stdout_mode == 4 and read is not None:
            # printInvCandidateFa (AlignmentBuffer.cpp:1213-1216);
            # inversionNumber is a checkForSV local, so always 1 (:1160,1175)
            import sys as _sys
            ref_bytes = self.ref.decode_window(check_loc, ref_seq_length) or b""
            rev_read = reverse_complement(read_seq.to_bytes())
            _sys.stdout.write(">%s_1/1\n%s\n>%s_1/2\n%s\n" % (
                read.name.decode(), ref_bytes.rstrip(b"\x00").decode(),
                read.name.decode(), rev_read.decode()))
        return (ScoreProblem(ref_desc, read_seq.desc()),
                ScoreProblem(ref_desc, read_seq.revcomp().desc()))

    def _sv_verdict(self, score_fwd: float, score_rev: float) -> int:
        """checkForSV's decision (AlignmentBuffer.cpp:1231-1265)."""
        read_check_length = 50
        min_score = 1.0 * read_check_length / 4.0
        ratio = (score_rev / score_fwd) if score_fwd != 0 else float("inf")
        if score_fwd == 0 and score_rev == 0:
            ratio = float("nan")
        if ratio > self.cfg.inv_score_ratio and score_rev > min_score:
            return SV_INVERSION
        if score_rev < min_score and score_fwd < min_score and self.cfg.low_quality_split:
            return SV_TRANSLOCATION
        return SV_NONE

    def detect_misalignment(self, align: Align, aligned_iv: Interval,
                            read_part_seq: SeqView, read: Read):
        """detectMisalignment (AlignmentBuffer.cpp:1267-1452).

        Returns (sv_type, left_of_inv, right_of_inv). Vectorized run
        detection over nmPerPosition: an 'inversion row' has windowed
        identity in (0, 0.75) i.e. nm_count in [9, 31]; rows <= 21 apart
        merge into one peak (the reference's 20-step countdown closes a
        peak on the 21st consecutive clean row); a trailing peak without
        21 clean rows before alignment_length never closes. All peaks'
        scoring probes fire as ONE device wave."""
        max_check_count = max(1, int((read.length / 1000.0) / 2.0))
        nmp = align.nm_per_position
        n_rows = align.alignment_length

        n_use = min(len(nmp), n_rows)
        nm_count = nmp[:n_use, 2]
        if self.cfg.stdout_mode in (2, 3):
            # mappingLocation (AlignmentBuffer.cpp:1299-1302)
            conv = self.ref.convert(aligned_iv.on_ref_start
                                    + align.position_offset)
            dbg_name, dbg_loc = ((self.ref.name_of(conv[0]).decode(), conv[1])
                                 if conv else ("*", 0))
        if self.cfg.stdout_mode == 3:
            # stdoutErrorProfile (AlignmentBuffer.cpp:1304-1309)
            import sys as _sys
            w = _sys.stdout.write
            rn = read.name.decode()
            for i in range(n_use):
                w("%s\t%d\t%d\t%s\n" % (dbg_name, dbg_loc + int(nmp[i, 1]),
                                        int(nmp[i, 2]), rn))
            # the reference prints ALL alignmentLength entries; the tail
            # beyond the filled count is its zero-initialized buffer
            for i in range(n_use, n_rows):
                w("%s\t%d\t0\t%s\n" % (dbg_name, dbg_loc, rn))
        inv_rows = np.nonzero((nm_count >= 9) & (nm_count <= 31))[0]
        if len(inv_rows) == 0:
            return SV_NONE, None, None
        breaks = np.nonzero(np.diff(inv_rows) > 21)[0]
        g_start = np.concatenate([[0], breaks + 1])
        g_end = np.concatenate([breaks, [len(inv_rows) - 1]])
        # a peak closes only if 21 clean rows follow before n_rows
        closed = inv_rows[g_end] + 21 <= n_rows - 1
        g_start, g_end = g_start[closed], g_end[closed]

        check_count = len(g_start)
        peaks = []
        probes = []
        for s, e in zip(g_start, g_end):
            first, last = int(inv_rows[s]), int(inv_rows[e])
            start_inv, start_inv_read = int(nmp[first, 1]), int(nmp[first, 0])
            stop_inv, stop_inv_read = int(nmp[last, 1]), int(nmp[last, 0])
            if self.cfg.stdout_mode == 2:
                # stdoutInversionBed (AlignmentBuffer.cpp:1348-1352)
                import sys as _sys
                _sys.stdout.write("%s\t%d\t%d\t%s\t%d\n" % (
                    dbg_name, dbg_loc + start_inv, dbg_loc + stop_inv,
                    read.name.decode(), 0))
            mid_ref = (start_inv + stop_inv) // 2
            mid_read = (start_inv_read + stop_inv_read) // 2
            inv_len = abs(stop_inv - start_inv)
            pr = self._sv_probes(align, aligned_iv, read_part_seq,
                                 mid_ref, mid_read, inv_len, read=read)
            peaks.append((mid_ref, mid_read, pr))
            if pr is not None:
                probes.extend(pr)
        if probes:
            from . import batcher as _batcher
            _batcher.add_stats([("sv_probes", len(probes))])
            self._score_wave(probes)

        best_result = SV_NONE
        best_mid_ref = 0
        best_mid_read = 0
        for mid_ref, mid_read, pr in peaks:
            result = (SV_NONE if pr is None
                      else self._sv_verdict(pr[0].result, pr[1].result))
            if best_result == SV_NONE or result == SV_INVERSION:
                best_result = result
                best_mid_ref = mid_ref
                best_mid_read = mid_read

        if check_count > max_check_count:
            return SV_NONE, None, None
        if best_result == SV_NONE:
            return SV_NONE, None, None

        left = Interval()
        right = Interval()
        if aligned_iv.is_reverse:
            additional_qstart = align.qstart - align.first_read_pos
            left.on_read_stop = read.length - align.qstart
            left.on_read_start = read.length - (additional_qstart + best_mid_read)
            left.on_ref_start = aligned_iv.on_ref_start + align.position_offset + align.first_ref_pos
            left.on_ref_stop = aligned_iv.on_ref_start + align.position_offset + best_mid_ref
            left.is_reverse = aligned_iv.is_reverse
            right.on_read_start = read.length - (align.last_read_pos + additional_qstart)
            right.on_read_stop = read.length - (best_mid_read + additional_qstart)
            right.on_ref_start = aligned_iv.on_ref_start + align.position_offset + best_mid_ref
            right.on_ref_stop = aligned_iv.on_ref_start + align.position_offset + align.last_ref_pos
            right.is_reverse = aligned_iv.is_reverse
        else:
            left.on_read_start = aligned_iv.on_read_start + align.first_read_pos
            left.on_read_stop = aligned_iv.on_read_start + best_mid_read
            left.on_ref_start = aligned_iv.on_ref_start + align.position_offset + align.first_ref_pos
            left.on_ref_stop = aligned_iv.on_ref_start + align.position_offset + best_mid_ref
            left.is_reverse = aligned_iv.is_reverse
            right.on_read_start = aligned_iv.on_read_start + best_mid_read
            right.on_read_stop = aligned_iv.on_read_start + align.last_read_pos
            right.on_ref_start = aligned_iv.on_ref_start + align.position_offset + best_mid_ref
            right.on_ref_stop = aligned_iv.on_ref_start + align.position_offset + align.last_ref_pos
            right.is_reverse = aligned_iv.is_reverse
        return best_result, left, right

    def realign_sv(self, iv: Interval, left_of_inv: Interval,
                   right_of_inv: Interval, read: Read, records: List[AlignmentRecord],
                   mq: int) -> int:
        """realign (AlignmentBuffer.cpp:1551-1776). Appends records on success."""
        from . import batcher as _batcher
        _batcher.add_stats([("sv_realign_tries", 1)])
        # the left/right re-alignments are independent — run them as one
        # wave instead of two sequential ones (reference computes them
        # back-to-back, AlignmentBuffer.cpp:1575-1650; results identical)
        def _aln(iv_part):
            seq_len = iv_part.on_read_stop - iv_part.on_read_start
            return self.align_interval(
                read, iv_part,
                self.extract_read_seq(read, iv_part.on_read_start, seq_len,
                                      iv_part.is_reverse),
                realign=True, full_alignment=False)

        wb = _batcher.current()
        if wb is not None and not getattr(wb, "serial", False):
            (align_left, err_l), (align_right, err_r) = wb.corun(
                [lambda: _aln(left_of_inv), lambda: _aln(right_of_inv)])
        else:
            align_left, err_l = None, None
            align_right, err_r = None, None
            try:
                align_left = _aln(left_of_inv)
            except BaseException as e:
                err_l = e
            if align_left is not None and align_left.score > 0.0:
                try:
                    align_right = _aln(right_of_inv)
                except BaseException as e:
                    err_r = e
        if err_l is not None:
            raise err_l
        if align_left is None or align_left.score <= 0.0:
            return SV_NONE   # right-side outcome (even an error) is moot:
            # the reference never evaluates it past a failed left
        if err_r is not None:
            raise err_r
        align_left.mq = mq
        loc_left = left_of_inv.on_ref_start + align_left.position_offset

        inv = Interval()
        inv.on_read_start = read.length - align_left.qend
        inv.on_ref_start = loc_left + align_left.last_ref_pos
        inv.is_reverse = not left_of_inv.is_reverse

        if align_right is None or align_right.score <= 0.0:
            return SV_NONE
        align_right.mq = mq
        loc_right = right_of_inv.on_ref_start + align_right.position_offset
        inv.on_read_stop = align_right.qstart
        inv.on_ref_stop = loc_right + align_right.first_ref_pos

        if not inv.is_reverse:
            tmp = read.length - inv.on_read_start
            inv.on_read_start = read.length - inv.on_read_stop
            inv.on_read_stop = tmp

        inversion_length = abs(inv.on_ref_stop - inv.on_ref_start)
        sv_result = SV_NONE
        align_inv = None
        loc_inv = 0
        if inversion_length > self.cfg.min_inversion_length:
            read_seq_len = inv.on_read_stop - inv.on_read_start

            def _inv_aln(rc):
                return self.align_interval(
                    read, inv,
                    self.extract_read_seq(read, inv.on_read_start,
                                          read_seq_len, inv.is_reverse,
                                          rev_comp=rc),
                    realign=True, full_alignment=True)

            if wb is not None:
                (align_inv, e1), (align_inv_rev, e2) = wb.corun(
                    [lambda: _inv_aln(False), lambda: _inv_aln(True)])
                if e1 is not None:
                    raise e1
                if e2 is not None:
                    raise e2
            else:
                align_inv = _inv_aln(False)
                align_inv_rev = _inv_aln(True)
            if (align_inv is not None and align_inv.score > 0.0
                    and align_inv.aligned_read_bp(read.length) > self.cfg.min_inversion_length
                    and (align_inv_rev is None or align_inv_rev.score < align_inv.score)):
                align_inv.mq = mq
                loc_inv = inv.on_ref_start + align_inv.position_offset
                sv_result = SV_INVERSION
            else:
                sv_result = SV_TRANSLOCATION
        else:
            sv_result = SV_NONE

        if sv_result == SV_NONE:
            return SV_NONE

        records.append(AlignmentRecord(align_left, loc_left, left_of_inv.is_reverse,
                                       align_left.score))
        align_left.mapped_interval = _interval_from_align(align_left, loc_left,
                                                          left_of_inv.is_reverse,
                                                          len(records) - 1, read.length)
        records.append(AlignmentRecord(align_right, loc_right, right_of_inv.is_reverse,
                                       align_right.score))
        align_right.mapped_interval = _interval_from_align(align_right, loc_right,
                                                           right_of_inv.is_reverse,
                                                           len(records) - 1, read.length)
        if sv_result == SV_INVERSION and align_inv is not None:
            records.append(AlignmentRecord(align_inv, loc_inv, inv.is_reverse,
                                           align_inv.score))
            align_inv.mapped_interval = _interval_from_align(align_inv, loc_inv,
                                                             inv.is_reverse,
                                                             len(records) - 1, read.length)
        return sv_result

    def compute_mapping_quality(self, align: Align, read_length: int,
                                tree: List[Tuple[int, int, int]]) -> int:
        """computeMappingQuality (AlignmentBuffer.cpp:1877-1926)."""
        q_lo, q_hi = align.qstart, read_length - align.qend
        mq_sum = 0
        mq_count = 0
        for (start, stop, value) in tree:
            if start <= q_hi and stop >= q_lo:
                mq_sum += value
                mq_count += 1
        if mq_count == 0:
            return 0
        return int(np.float32(mq_sum) * np.float32(1.0) / np.float32(mq_count))

    def align_single_or_multiple(self, read: Read, iv: Interval,
                                 records: List[AlignmentRecord],
                                 tree: List[Tuple[int, int, int]]):
        """alignSingleOrMultipleIntervals (AlignmentBuffer.cpp:1790-1875)."""
        read_seq_len = iv.on_read_stop - iv.on_read_start
        read_part_seq = self.extract_read_seq(read, iv.on_read_start, read_seq_len,
                                              iv.is_reverse)
        if read_part_seq is None:
            return
        align = self.align_interval(read, iv, read_part_seq, realign=False,
                                    full_alignment=False)
        if align is None or align.score <= 0.0:
            return
        sv_type = SV_NONE
        if self.cfg.small_inversion_detection or self.cfg.low_quality_split:
            sv_type, left, right = self.detect_misalignment(align, iv,
                                                            read_part_seq, read)
            if sv_type != SV_NONE:
                mq = self.compute_mapping_quality(align, read.length, tree)
                sv_type = self.realign_sv(iv, left, right, read, records, mq)
        if sv_type == SV_NONE:
            if _satisfies_constraints(align, read.length, self.cfg):
                align.mq = self.compute_mapping_quality(align, read.length, tree)
                loc = iv.on_ref_start + align.position_offset
                records.append(AlignmentRecord(align, loc, iv.is_reverse, align.score))
                align.mapped_interval = _interval_from_align(
                    align, loc, iv.is_reverse, len(records) - 1, read.length)

    # ------------------------------------------------------------------
    # the main flow
    # ------------------------------------------------------------------

    def process(self, read: Read, subreads: List[ScoredSubread]
                ) -> Tuple[bool, List[AlignmentRecord]]:
        """processLongReadLIS (AlignmentBuffer.cpp:2845-3464)."""
        cfg = self.cfg
        rpl = self.rpl
        max_num_scores = 1000

        tree: List[Tuple[int, int, int]] = []
        anchors: List[Anchor] = []
        dump = cfg.stdout_mode == 1
        for sub in subreads:
            n = len(sub.scores)
            if n >= max_num_scores or n == 0:
                if dump:
                    _dot_plot_line(read, sub.on_read, sub.on_read + rpl,
                                   0, 0, 0.0, 0, DP_TYPE_UNFILTERED,
                                   DP_STATUS_NOHIT)
                continue
            tree.append((sub.on_read, sub.on_read + rpl, sub.mq))
            unique = n == 1
            if cfg.stdout_mode == 7:   # AlignmentBuffer.cpp:2944-2946
                import sys as _sys
                for k in range(n):
                    _sys.stdout.write("%f\n" % float(sub.scores[k]))
            for k in range(n):
                anchors.append(Anchor(sub.on_read, int(sub.locations[k]),
                                      float(sub.scores[k]), bool(sub.reverse[k]),
                                      unique))
                if dump:   # AlignmentBuffer.cpp:2975-2990
                    loc = int(sub.locations[k])
                    st = DP_STATUS_OK if unique else DP_STATUS_LOWSCORE
                    if sub.reverse[k]:
                        _dot_plot_line(read, sub.on_read, sub.on_read + rpl,
                                       loc + rpl, loc, float(sub.scores[k]),
                                       1, DP_TYPE_UNFILTERED, st)
                    else:
                        _dot_plot_line(read, sub.on_read, sub.on_read + rpl,
                                       loc, loc + rpl, float(sub.scores[k]),
                                       0, DP_TYPE_UNFILTERED, st)

        max_segment_count = max(10, cfg.max_segments_for(read.length) * 2)
        intervals = get_intervals_from_anchors(anchors, read.length,
                                               max_segment_count,
                                               cfg.max_clis_runs, rpl,
                                               dump_read=read if dump else None)
        intervals = _std_sorted(intervals, lambda iv: iv.on_read_start)

        # --- segment building (AlignmentBuffer.cpp:3039-3096) -------------
        segments: List[List[Interval]] = []
        # the reference's intervalsTree: (snapshot start, snapshot stop, iv)
        all_intervals: List = []
        for iv in intervals:
            processed = False
            for seg in segments:
                for piv in seg:
                    if is_contained(iv, piv):
                        processed = True
                        break
                    if is_compatible(iv, piv):
                        if len(seg) < 1000:
                            seg.append(iv)
                            all_intervals.append((iv.on_read_start, iv.on_read_stop, iv))
                            processed = True
                            break
                if processed:
                    break
            if not processed:
                segments.append([iv])
                all_intervals.append((iv.on_read_start, iv.on_read_stop, iv))

        # --- segment merge / SV split (AlignmentBuffer.cpp:3114-3258) -----
        final: List[Interval] = []
        for seg in segments:
            seg[:] = _std_sorted(seg, lambda iv: iv.on_read_start)
            last = seg[0]
            self.extend_interval_start(last, 2 * rpl)
            is_first = True
            for j in range(1, len(seg)):
                cur = seg[j]
                if is_same_direction(cur, last):
                    dup, dup_length = is_duplication(cur, last)
                    if not dup:
                        if self.gap_overlaps_between(last, cur, all_intervals, read):
                            # possible translocation
                            if is_first:
                                self.extend_to_read_start(last, read.length,
                                                          all_intervals, read)
                                is_first = False
                            self.extend_interval_stop(last, 2 * rpl, read.length)
                            self.extend_interval_start(cur, 2 * rpl)
                            final.append(last)
                            last = cur
                        else:
                            corridor_size = min(4096, min(cur.length_on_read(),
                                                          last.length_on_read()))
                            if (can_span_deletion_insertion(cur, last, corridor_size)
                                    and not self.spans_chromosome_border(cur, last)):
                                last = merge_intervals(last, cur)
                                cur.is_processed = True
                            else:
                                if is_first:
                                    self.extend_to_read_start(last, read.length,
                                                              all_intervals, read)
                                    is_first = False
                                self.close_gap_on_read(last, cur, read.length)
                                self.extend_interval_stop(last, 2 * rpl, read.length)
                                self.extend_interval_start(cur, 2 * rpl)
                                final.append(last)
                                last = cur
                    else:
                        # duplication
                        if is_first:
                            self.extend_to_read_start(last, read.length,
                                                      all_intervals, read)
                            is_first = False
                        self.close_gap_on_read(last, cur, read.length)
                        max_extend = min(max(cur.on_read_start - last.on_read_stop
                                             + int(dup_length), 0), 2 * rpl)
                        self.extend_interval_stop(last, max_extend, read.length)
                        self.extend_interval_start(cur, max_extend)
                        final.append(last)
                        last = cur
                else:
                    # inversion
                    if is_first:
                        self.extend_to_read_start(last, read.length,
                                                  all_intervals, read)
                        is_first = False
                    self.close_gap_on_read(last, cur, read.length)
                    self.extend_interval_stop(last, 2 * rpl, read.length)
                    self.extend_interval_start(cur, 2 * rpl)
                    final.append(last)
                    last = cur
            if is_first:
                self.extend_to_read_start(last, read.length, all_intervals, read)
                is_first = False
            self.extend_interval_stop(last, 2 * rpl, read.length)
            self.extend_to_read_stop(last, read.length, all_intervals, read)
            final.append(last)

        # --- close gaps between neighbouring final intervals (3282-3302) --
        final = _std_sorted(final, lambda iv: iv.on_read_start)
        if final:
            last = final[0]
            for i in range(1, len(final)):
                cur = final[i]
                if len(cur.anchors) > 1:
                    if (not is_compatible(last, cur)
                            and get_distance_on_read(last, cur) > 0
                            and (len(cur.anchors) > 2 or len(last.anchors) > 2)):
                        self.close_gap_on_read(last, cur, read.length)
                if len(cur.anchors) > 1 or len(last.anchors) == 1:
                    last = cur

        # --- coverage check (3311-3338) ------------------------------------
        final = _std_sorted(final, lambda iv: iv.score, desc=True,
                            dtype=np.float32)
        if dump:   # "Final intervals" (AlignmentBuffer.cpp:3318)
            for i, iv in enumerate(final):
                _dot_plot_line(read, iv.on_read_start, iv.on_read_stop,
                               iv.on_ref_start, iv.on_ref_stop, iv.score,
                               iv.is_reverse, DP_TYPE_SEQMENTS_CONS + i,
                               DP_STATUS_OK)
        read_bp_covered = sum(iv.length_on_read() for iv in final)
        aligned = read_bp_covered * 1.0 / read.length
        mapped = (aligned > cfg.min_residues if cfg.min_residues < 1.0
                  else read_bp_covered > cfg.min_residues)
        if not mapped:
            return False, []

        # --- align final intervals (3343-3416) ------------------------------
        records: List[AlignmentRecord] = []
        for iv in final:
            # trim vs already-aligned intervals
            for rec in records:
                aligned_iv = rec.align.mapped_interval
                overlap = get_overlap_on_read(iv, aligned_iv)
                if 0 < overlap < iv.length_on_read() * 0.95:
                    if iv.on_read_start < aligned_iv.on_read_start:
                        self.shorten_interval_end(iv, overlap)
                    else:
                        self.shorten_interval_start(iv, overlap)
            if iv.on_ref_start > iv.on_ref_stop:
                iv.on_ref_start, iv.on_ref_stop = iv.on_ref_stop, iv.on_ref_start
            if not cfg.skip_align:    # --skip-align (AlignmentBuffer.cpp:3398)
                self.align_single_or_multiple(read, iv, records, tree)

        if not records:
            return False, []

        mapped = self.reconcile_read(read, records)
        if mapped:
            _sort_read(records)
        return mapped, records

    # ------------------------------------------------------------------

    def reconcile_read(self, read: Read, records: List[AlignmentRecord]) -> bool:
        """reconcileRead (AlignmentBuffer.cpp:2089-2309)."""
        cfg = self.cfg
        segs: List[Interval] = []
        for i, rec in enumerate(records):
            seg = _interval_from_align(rec.align, rec.location, rec.reverse, i,
                                       read.length)
            segs.append(seg)
            if cfg.stdout_mode == 5:   # mapped segments (AlignmentBuffer.cpp:2133)
                import sys as _sys
                _sys.stdout.write("%s\t%d\t%d\t%d\t%d\t%d\t%d\t%f\n" % (
                    read.name.decode(), i, read.length, seg.on_read_start,
                    seg.on_read_stop, 1 if rec.reverse else 0,
                    rec.align.mq, rec.align.score))
            if cfg.stdout_mode == 1:   # results (AlignmentBuffer.cpp:2155-2170)
                # NOTE: the swap keys on the FIRST record's strand
                # (readIsReverse, :2099), not this segment's
                if not records[0].reverse:
                    _dot_plot_line(read, seg.on_read_start, seg.on_read_stop,
                                   seg.on_ref_start, seg.on_ref_stop,
                                   seg.score, seg.is_reverse,
                                   DP_TYPE_RESULT + i, DP_STATUS_OK)
                else:
                    _dot_plot_line(read, seg.on_read_stop, seg.on_read_start,
                                   seg.on_ref_start, seg.on_ref_stop,
                                   seg.score, seg.is_reverse,
                                   DP_TYPE_RESULT + i, DP_STATUS_OK)

        best_segments: List[int] = []
        _best_segment_combination(read.length, segs, best_segments)

        top_score = 0.0
        top_idx = 0
        aligned_bp_sum = 0
        for idx in best_segments:
            segs[idx].is_processed = True
            aligned_bp_sum += segs[idx].on_read_stop - segs[idx].on_read_start
            if segs[idx].score > top_score:
                top_idx = idx
                top_score = segs[idx].score
        if best_segments:
            records[segs[top_idx].id].align.primary = True
        aligned = aligned_bp_sum * 1.0 / read.length
        mapped = (aligned > cfg.min_residues if cfg.min_residues < 1.0
                  else aligned_bp_sum > cfg.min_residues)

        # filter short isolated intervals (2228-2252)
        min_on_read_length = 1000
        for a in segs:
            if not a.is_processed:
                continue
            thresh = min(min_on_read_length, int(read.length * 0.5))
            keep = a.length_on_read() > thresh
            for b in segs:
                if keep:
                    break
                if b.is_processed:
                    distance = get_distance_on_read(a, b)
                    if b.on_ref_start < a.on_ref_start:
                        distance_ref = max(0, a.on_ref_start - b.on_ref_stop)
                    else:
                        distance_ref = max(0, b.on_ref_start - a.on_ref_stop)
                    max_distance = a.length_on_read()
                    keep = ((distance < max_distance or distance_ref < max_distance)
                            and b.length_on_read() > thresh)
            if not keep:
                a.is_processed = False

        for seg in segs:
            if not seg.is_processed:
                records[seg.id].align.skip = True

        segment_count = 0
        for i in range(len(records)):
            if not records[segs[i].id].align.skip:
                if aligned > 0.95:
                    records[segs[i].id].align.sv_type |= 0x2
                segment_count += 1
                if cfg.stdout_mode == 1:   # AlignmentBuffer.cpp:2272-2289
                    seg = segs[i]
                    if not records[0].reverse:
                        _dot_plot_line(read, seg.on_read_start,
                                       seg.on_read_stop, seg.on_ref_start,
                                       seg.on_ref_stop, seg.score,
                                       seg.is_reverse,
                                       DP_TYPE_RESULT_CONS + seg.id,
                                       DP_STATUS_OK)
                    else:
                        _dot_plot_line(read, seg.on_read_stop,
                                       seg.on_read_start, seg.on_ref_start,
                                       seg.on_ref_stop, seg.score,
                                       seg.is_reverse,
                                       DP_TYPE_RESULT_CONS + seg.id,
                                       DP_STATUS_OK)

        max_splits = cfg.max_segments_for(read.length)
        return mapped and (segment_count - 1) <= max_splits


def _interval_from_align(align: Align, location: int, reverse: bool, idx: int,
                         read_length: int) -> Interval:
    """getIntervalFromAlign (AlignmentBuffer.cpp:2066-2087)."""
    diff_on_ref = align.last_ref_pos - align.first_ref_pos
    seg = Interval()
    seg.id = idx
    seg.on_ref_start = location
    seg.on_ref_stop = location + diff_on_ref
    seg.is_reverse = reverse
    seg.is_processed = False
    seg.score = align.score
    if reverse:
        seg.on_read_start = align.qend
        seg.on_read_stop = read_length - align.qstart - 1
    else:
        seg.on_read_start = align.qstart
        seg.on_read_stop = read_length - align.qend - 1
    return seg


def _satisfies_constraints(align: Align, read_length: int, cfg: Config) -> bool:
    """satisfiesConstraints (AlignmentBuffer.cpp:1778-1787).

    NOTE: minResidues is the hardcoded 50.0f of the reference, NOT the
    config value (the `if (minResidues <= 1.0f)` rescale never fires)."""
    min_residues = 50.0
    return (align.score > 0.0 and align.identity >= cfg.min_identity
            and float(read_length - align.qstart - align.qend) >= min_residues)


def _best_segment_combination(max_length: int, segs: List[Interval],
                              out: List[int]) -> float:
    """getBestSegmentCombination (AlignmentBuffer.cpp:2005-2064).

    Event-based O(n log n) equivalent of the reference's
    O(readLen x nSegs) sweep: best_score is a step function that only
    changes where a segment becomes eligible (its on_read_stop), and each
    segment's candidate value is fixed once it is eligible (its lookup
    position start+50 lies strictly before its own stop). Sequential f32
    rounding and the first-strict-improvement tie-break are preserved.
    Falls back to the literal loop for the self-referential corner (a
    chosen lookup position at the read end — the reference reads its own
    in-progress row there)."""
    import bisect
    max_overlap = 50
    elig = [(max(1, s.on_read_stop), j) for j, s in enumerate(segs)
            if (not s.is_processed and s.on_read_stop <= max_length - 1
                and abs(s.on_read_stop - s.on_read_start) > max_overlap)]
    if any(segs[j].on_read_start + max_overlap >= max_length - 1
           or segs[j].on_read_start + max_overlap >= max(1, segs[j].on_read_stop)
           for _, j in elig):
        return _best_segment_combination_loop(max_length, segs, out)
    elig.sort()

    xs: List[int] = []                   # event positions (ascending)
    states: List[tuple] = []             # (best_val, winner_j, winner_pos)
    cur = (0.0, -1, 0)

    def at(pos: int) -> tuple:
        k = bisect.bisect_right(xs, pos) - 1
        return states[k] if k >= 0 else (0.0, -1, 0)

    for x, j in elig:
        seg = segs[j]
        pos = min(max_length - 1, seg.on_read_start + max_overlap)
        val = float(f32(f32(seg.score) + f32(at(pos)[0])))
        if val > cur[0]:
            cur = (val, j, pos)
        xs.append(x)
        states.append(cur)

    final = at(max_length - 1)
    result = final[0]
    state = final
    while state[1] > -1:
        out.append(state[1])
        state = at(state[2])
    return result


def _best_segment_combination_loop(max_length: int, segs: List[Interval],
                                   out: List[int]) -> float:
    """The literal reference loop (oracle + end-of-read corner case)."""
    max_overlap = 50
    best_score = [0.0] * max_length
    last_best = [0] * max_length
    last_fragment = [-1] * max_length
    for i in range(1, max_length):
        best_score[i] = best_score[i - 1]
        last_fragment[i] = last_fragment[i - 1]
        last_best[i] = last_best[i - 1]
        for j, seg in enumerate(segs):
            if (not seg.is_processed and seg.on_read_stop <= i
                    and abs(seg.on_read_stop - seg.on_read_start) > max_overlap):
                start = min(max_length - 1, seg.on_read_start + max_overlap)
                current = float(f32(f32(seg.score) + f32(best_score[start])))
                if current > best_score[i]:
                    best_score[i] = current
                    last_fragment[i] = j
                    last_best[i] = start
    i = max_length - 1
    result = best_score[i]
    while last_fragment[i] > -1:
        out.append(last_fragment[i])
        i = last_best[i]
    return result


def _sort_read(records: List[AlignmentRecord]):
    """sortRead (AlignmentBuffer.cpp:2311-2332): swap best score to front."""
    highest = 0.0
    hi_idx = 0
    for i, rec in enumerate(records):
        if rec.align.score > highest:
            highest = rec.align.score
            hi_idx = i
    if hi_idx != 0:
        records[0], records[hi_idx] = records[hi_idx], records[0]

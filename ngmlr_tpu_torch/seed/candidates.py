"""Candidate search: diagonal-bin voting over k-mer index hits.

Rebuild of the CS stage (ngmlr src/CS.cpp) without the
open-addressed hash table: the reference's rTable + overflow/fallback
machinery (CS.cpp:98-149, 357-393) exists to bound memory of a per-read
scatter; a vectorized sort/segment-reduce over all (bin, strand) votes of a
whole subread batch computes the same counts with no overflow path at all.

Semantics preserved:

  * one vote per (k-mer occurrence in index) per read k-mer; read-side k-mer
    stream has stride 1 and N-run splitting (CS.cpp:36, CSstatic.cpp:23-73),
  * vote order is per k-mer: forward-bucket positions then
    reverse-complement-bucket positions (PrefixSearch iterates the fwd/rev
    RefEntry chain per prefix, CS.cpp:57-96),
  * fwd vote bin   = (loc - pos) >> bin_size,
    rev vote bin   = (loc - (read_len - (pos + k))) >> bin_size,
  * candidate location = ResolveBin(bin) = (bin << bin_size) + 2^(bin_size-1)
    (CS.h:175-186),
  * candidate ORDER matches the reference's rList emergence order: a bin
    enters the list at the first vote where its per-strand count reaches the
    RUNNING threshold max_count_so_far * sensitivity (float32;
    AddLocationStd, CS.cpp:136-148); the final filter re-applies the final
    threshold, forward strand before reverse per entry
    (CollectResultsStd, CS.cpp:248-263).
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from ..index.kmer_index import KmerIndex, kmer_stream, revcomp_prefix

f32 = np.float32


@dataclass
class SubreadCandidates:
    """Candidates for one subread, in vote-table emergence order."""
    locations: np.ndarray   # int64 — ResolveBin'ed concat positions
    reverse: np.ndarray     # bool
    counts: np.ndarray      # float32 k-mer vote counts
    mq_zero: bool           # >90% of k-mers had zero index hits


def _empty():
    return SubreadCandidates(np.zeros(0, np.int64), np.zeros(0, bool),
                             np.zeros(0, np.float32), False)


def search_batch(index: KmerIndex, seqs: List[bytes], sensitivity: float = 0.8,
                 min_kmer_hits: int = 0, n_units: int = 1,
                 unit_bits: int = 31) -> List[SubreadCandidates]:
    """Vectorized candidate search over a batch of subread sequences.

    n_units > 1 (TableUnit analog, >4.29 Gbp genomes): votes of one k-mer
    emit in the reference's RefEntry-chain order — unit-major, forward
    bucket before reverse per unit (GetRefEntry, PrefixTable.cpp:476-532)
    — instead of the flat fwd-then-rev order."""
    k = index.k
    bin_size = index.bin_size
    sens = f32(sensitivity)

    # --- per-subread k-mer streams: ONE kmer_stream pass over all subreads
    # joined with 'N' separators (N-runs split segments, so no window ever
    # crosses a boundary; read-side stride is 1 so segment anchoring is
    # irrelevant) ------------------------------------------------------------
    total = sum(len(s) for s in seqs)
    concat = np.empty(total + len(seqs), dtype=np.uint8)
    offsets = np.empty(len(seqs) + 1, dtype=np.int64)
    pos = 0
    for si, s in enumerate(seqs):
        offsets[si] = pos
        n = len(s)
        concat[pos:pos + n] = np.frombuffer(s, dtype=np.uint8)
        concat[pos + n] = ord("N")
        pos += n + 1
    offsets[-1] = pos

    prefixes, starts = kmer_stream(concat, k, stride=1)
    if len(starts) == 0:
        return [_empty()] * len(seqs)
    sub_idx = np.searchsorted(offsets, starts, side="right") - 1
    positions = starts - offsets[sub_idx]
    emit_idx = np.arange(len(starts), dtype=np.int64)
    read_lens = np.asarray([len(s) for s in seqs], dtype=np.int64)

    rc = revcomp_prefix(prefixes, k)
    fwd_start, fwd_cnt = index.bucket_of(prefixes)
    rev_start, rev_cnt = index.bucket_of(rc)

    # kCount bookkeeping (CS.cpp:67-69) — dead for MQ (see score_stage) but
    # kept for parity/debugging
    zero_hits = (fwd_cnt + rev_cnt) == 0
    k_count = np.bincount(sub_idx[zero_hits], minlength=len(seqs))
    mq_zero = k_count > ((read_lens - k + 1) * 0.9).astype(np.int64)

    # --- expand hits into votes -------------------------------------------
    def expand(cnt, starts, corr):
        total = int(cnt.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, z, z, z
        rep_sub = np.repeat(sub_idx, cnt)
        rep_emit = np.repeat(emit_idx, cnt)
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        locs = index.positions[np.repeat(starts, cnt) + offs]
        bins = (locs - np.repeat(corr, cnt)) >> bin_size
        units = (locs >> unit_bits) if n_units > 1 else \
            np.zeros(total, np.int64)
        return rep_sub, bins, rep_emit, offs, units

    fwd = expand(fwd_cnt, fwd_start, positions)
    rev_corr = read_lens[sub_idx] - (positions + k)
    rev = expand(rev_cnt, rev_start, rev_corr)

    sub_all = np.concatenate([fwd[0], rev[0]])
    bins_all = np.concatenate([fwd[1], rev[1]])
    emit_all = np.concatenate([fwd[2], rev[2]])
    within = np.concatenate([fwd[3], rev[3]])
    unit_all = np.concatenate([fwd[4], rev[4]])
    strand = np.concatenate([np.zeros(len(fwd[0]), np.int8),
                             np.ones(len(rev[0]), np.int8)])

    # global vote order: (subread, k-mer emission, fwd-before-rev, bucket pos)
    # — packed single-key stable argsort (radix) instead of a 4-key lexsort
    sb = max(int(sub_all.max()) if len(sub_all) else 0, 1).bit_length()
    eb = max(int(emit_all.max()) if len(emit_all) else 0, 1).bit_length()
    wb = max(int(within.max()) if len(within) else 0, 1).bit_length()
    bb = max(int(bins_all.max()) if len(bins_all) else 0, 1).bit_length()
    # the packed radix keys require every component non-negative; bins are
    # only guaranteed >= 0 because the genome's 1000-byte leading pad keeps
    # loc >= 1000 > correction (<= 256). Fail over to lexsort (identical
    # order, slower) rather than silently OR-ing sign bits into the key if
    # that invariant ever breaks.
    ub = max(int(n_units) - 1, 1).bit_length() if n_units > 1 else 0
    nonneg = (len(bins_all) == 0
              or (int(bins_all.min()) >= 0 and int(within.min()) >= 0))
    if nonneg and sb + eb + ub + wb + 1 < 63 and sb + bb + 1 < 63:
        vote_key = ((((sub_all << eb) | emit_all) << ub | unit_all) << 1
                    | strand.astype(np.int64))
        vote_key = (vote_key << wb) | within
        vote_order = np.argsort(vote_key, kind="stable")
    else:
        vote_order = np.lexsort((within, strand, unit_all, emit_all,
                                 sub_all))
    v_sub = sub_all[vote_order]
    v_bin = bins_all[vote_order]
    v_str = strand[vote_order]

    # --- per-(subread,bin,strand) running counts ---------------------------
    if nonneg and sb + eb + wb + 1 < 63 and sb + bb + 1 < 63:
        grp_key = (((v_sub << bb) | v_bin) << 1) | v_str.astype(np.int64)
        grp_sort = np.argsort(grp_key, kind="stable")
    else:
        grp_sort = np.lexsort((np.arange(len(v_sub)), v_str, v_bin, v_sub))
    g_sub = v_sub[grp_sort]
    g_bin = v_bin[grp_sort]
    g_str = v_str[grp_sort]
    new_grp = np.ones(len(g_sub), dtype=bool)
    new_grp[1:] = ((g_sub[1:] != g_sub[:-1]) | (g_bin[1:] != g_bin[:-1])
                   | (g_str[1:] != g_str[:-1]))
    grp_id_sorted = np.cumsum(new_grp) - 1
    first_of_grp = np.nonzero(new_grp)[0]
    cum_in_grp = np.arange(len(g_sub)) - first_of_grp[grp_id_sorted]
    # scatter back to vote order
    grp_id = np.empty(len(v_sub), dtype=np.int64)
    count_after = np.empty(len(v_sub), dtype=np.int64)
    grp_id[grp_sort] = grp_id_sorted
    count_after[grp_sort] = cum_in_grp + 1

    n_groups = int(grp_id_sorted[-1]) + 1 if len(grp_id_sorted) else 0
    grp_sub = np.empty(n_groups, dtype=np.int64)
    grp_bin = np.empty(n_groups, dtype=np.int64)
    grp_strand = np.empty(n_groups, dtype=np.int8)
    grp_total = np.zeros(n_groups, dtype=np.int64)
    grp_sub[grp_id] = v_sub
    grp_bin[grp_id] = v_bin
    grp_strand[grp_id] = v_str
    np.add.at(grp_total, grp_id, 1)

    # --- emergence (rList crossing), fully vectorized ----------------------
    # Per-subread running max of vote counts with per-segment reset: add
    # sub_idx * OFFSET so the accumulate never carries across subreads.
    # In int64, exact for any batch; ngmlr_tpu adds in f64, which rounds
    # the counts once sub_idx * 2^40 passes 2^53 (from the 8,193rd subread
    # of a batch on), so a subread's candidates there depend on its batch.
    resolve_off = (1 << (bin_size - 1)) if bin_size > 0 else 0
    n_seqs = len(seqs)
    sub_bounds = np.searchsorted(v_sub, np.arange(n_seqs + 1))
    counts_f = count_after.astype(np.float32)

    OFF = np.int64(1) << 40
    run_max = (np.maximum.accumulate(count_after + v_sub * OFF)
               - v_sub * OFF).astype(np.float32)
    thresh = run_max * sens                           # f32 (AddLocationStd)
    crossing = counts_f >= thresh
    # final per-subread threshold: max(minKmerHits, f32(final_max * sens))
    final_max = np.zeros(n_seqs, np.float32)
    nonempty = sub_bounds[1:] > sub_bounds[:-1]
    final_max[nonempty] = run_max[sub_bounds[1:][nonempty] - 1]
    final_thresh = np.maximum(f32(min_kmer_hits),
                              (final_max * sens).astype(np.float32))

    # entry (bin) crossing time: first crossing vote of EITHER strand;
    # entries are keyed by bin only (rTable slot), CS.cpp:102-148
    cross = np.nonzero(crossing)[0]
    cs, cb = v_sub[cross], v_bin[cross]
    o = np.lexsort((cross, cb, cs))
    fs, fb, fx = cs[o], cb[o], cross[o]
    first = np.ones(len(fs), dtype=bool)
    first[1:] = (fs[1:] != fs[:-1]) | (fb[1:] != fb[:-1])
    ent_sub, ent_bin, ent_at = fs[first], fb[first], fx[first]
    eo = np.lexsort((ent_at, ent_sub))
    ent_sub, ent_bin = ent_sub[eo], ent_bin[eo]

    # per-(sub, bin, strand) totals: lookup by packed key into the sorted
    # group arrays (grp_* are in (sub, bin, strand) lexicographic order)
    if len(ent_sub) == 0:
        e = _empty()
        return [SubreadCandidates(e.locations, e.reverse, e.counts,
                                  bool(mq_zero[si]))
                for si in range(n_seqs)]
    BMAX = np.int64(1) << 36                           # bins < 2^35
    gkey = (grp_sub * BMAX + grp_bin) * 2 + grp_strand
    ekey = (ent_sub * BMAX + ent_bin) * 2
    fidx = np.searchsorted(gkey, ekey)
    ridx = np.searchsorted(gkey, ekey + 1)
    last = len(gkey) - 1
    has_f = (fidx <= last) & (gkey[np.minimum(fidx, last)] == ekey)
    has_r = (ridx <= last) & (gkey[np.minimum(ridx, last)] == ekey + 1)
    fc = np.where(has_f, grp_total[np.minimum(fidx, last)], 0
                  ).astype(np.float32)
    rc_ = np.where(has_r, grp_total[np.minimum(ridx, last)], 0
                   ).astype(np.float32)
    th = final_thresh[ent_sub]
    keep_f = fc >= th
    keep_r = rc_ >= th

    # interleave fwd-then-rev per entry, drop entries keeping neither
    n_ent = len(ent_sub)
    ent_loc = (ent_bin << bin_size) + resolve_off
    out_sub = np.repeat(ent_sub, 2)
    out_loc = np.repeat(ent_loc, 2)
    out_rev = np.tile(np.array([False, True]), n_ent)
    out_cnt = np.empty(2 * n_ent, np.float32)
    out_cnt[0::2] = fc
    out_cnt[1::2] = rc_
    keep = np.empty(2 * n_ent, bool)
    keep[0::2] = keep_f
    keep[1::2] = keep_r
    out_sub, out_loc = out_sub[keep], out_loc[keep]
    out_rev, out_cnt = out_rev[keep], out_cnt[keep]

    res_bounds = np.searchsorted(out_sub, np.arange(n_seqs + 1))
    out: List[SubreadCandidates] = []
    for si in range(n_seqs):
        lo, hi = int(res_bounds[si]), int(res_bounds[si + 1])
        out.append(SubreadCandidates(out_loc[lo:hi], out_rev[lo:hi],
                                     out_cnt[lo:hi], bool(mq_zero[si])))
    return out

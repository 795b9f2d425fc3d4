"""Device-side candidate search: the CS stage's vote/bin/emergence logic as
tensor programs over the device-resident k-mer index.

At large genome sizes the host search_batch dominates the wall time: vote
expansions, random gathers into a GB-scale position list and two sorts of
all votes. All of it is gather/sort/scan, so this module uploads the index
once (bucket starts + positions, the same arrays the host path uses) and
computes everything else ON DEVICE. The k-mer prefixes themselves are
extracted from the device-resident read-code buffer (the same buffer the
scoring/alignment kernels use), so per batch the host uploads only the
subread descriptors (two int32 per subread) and downloads the per-subread
vote counts plus the compacted candidate lists.

Exactness: identical semantics to ngmlr_tpu_torch.seed.candidates.
search_batch (the host twin — the CPU path and the test oracle), which
replays the reference's rList emergence order (ngmlr src/CS.cpp:57-269):

  * votes are GENERATED in the reference's order — k-mer emission major
    (subread-major, position ascending; N-containing k-mers emit nothing),
    forward bucket before reverse-complement bucket per k-mer, bucket
    position order — so the vote stream needs no sort at all,
  * per-(subread, bin, strand) occurrence ranks come from one stable
    packed-key sort plus its inverse permutation (a scatter),
  * the running per-subread maximum uses the same packed-key cummax trick
    as the host (sub in high bits; subreads are non-decreasing in vote
    order), and the crossing test is the same float32 arithmetic
    (count >= f32(run_max) * f32(sensitivity), AddLocationStd
    CS.cpp:136-148),
  * entries (bins) order by their first crossing vote; the final filter
    re-applies the final threshold, forward before reverse per entry
    (CollectResultsStd CS.cpp:248-263).

This is the port of ngmlr_tpu/seed/device_search.py, function for function:
the XLA programs are plain functions on tensors of one explicit device
("cuda" by default, "cpu" for the tests), and v2's vote expansion is the
hand-written kernel ops.kernels.expand_votes (its plain version on the CPU).
The size classes stay: they decide launch shapes, memory and entry order.

Capacities: subreads run in slices of MAX_SUBS - 2 (bigger batches
self-split); a subread may be at most SL bases long (the Pipeline turns the
search off for longer subreads; an ad-hoc batch past it raises on a card
and returns None on the CPU); every other capacity is met on the device
itself: rows that overflow v2 (more than L_V2_MAX votes, E_CAP entries a
row, NE2 entries a launch, or a group of 2^15 votes) rerun through v1 one
subread at a time, v1 counts in 64-bit keys, and a v1 run with more than
its NE_CAP entries reruns with room for all of them.
"""

import time
from typing import List, Optional

import numpy as np
import torch

from ..index.kmer_index import KmerIndex
from ..ops import kernels as K
from .candidates import SubreadCandidates

f32 = np.float32
I32 = torch.int32
U32_MASK = 0xFFFFFFFF

COUNT_BITS = 16                     # width of one count in v2's packed
# (fwd << 16 | rev) entry payload (a group is one (subread, diagonal-bin,
# strand); a v2 row whose group reaches 2^15 votes reruns through v1)
MAX_SUBS = 1 << 15                  # subread slots per slice; also the
# sub-id sentinel of v1's padding votes
NE_CAP = 1 << 16                    # entry rows a v1 run returns at first
BIN_SENTINEL = 1 << 29              # invalid-vote bin (> any real bin)
SL = 272                            # dense k-mer slots per subread (the
# pipeline's subreads are <= 256 bp, ReadProvider.cpp:60; 272 also covers
# slightly longer ad-hoc probes)


def _pow2(x: int, lo: int) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def _size_class(x: int, lo: int) -> int:
    """Smallest bucket >= x from the {2^n, 1.5*2^n} size classes — halves
    the average padding waste of pure pow2 at a modest shape-count cost."""
    v = lo
    while True:
        if x <= v:
            return v
        if x <= v + v // 2:
            return v + v // 2
        v *= 2


def _rc_dev(p, k: int):
    """Reverse-complement of 2-bit prefixes on device — mirrors
    kmer_index.revcomp_prefix (complement = XOR 0b10 per base is encoded
    there via the 0xAAA.. constant; base order reversed)."""
    mask = (1 << (2 * k)) - 1
    pc = p ^ (0x2AAAAAAA & mask)
    out = torch.zeros_like(p)
    for i in range(k):
        out = out | (((pc >> (2 * i)) & 3) << (2 * (k - 1 - i)))
    return out


def _kmer_mat(codes, starts, lens, k: int):
    """[NS, SL] k-mer prefixes + validity from the device-resident code
    buffer (device code space A=0,T=1,G=2,C=3,N=4). Prefix encoding is
    the reference's (char >> 1) & 3 per base (CSstatic.cpp:22-72), i.e.
    A=0,C=1,T=2,G=3 — km below maps between the two spaces. k-mers
    containing any non-ACGT code are invalid (kseq/kmer_stream N-run
    semantics); position p is valid iff p + k <= len."""
    dev = codes.device
    NS = starts.shape[0]
    WIN = SL + k - 1
    km = torch.tensor([0, 2, 3, 1, 0, 0, 0, 0], dtype=I32, device=dev)
    j = torch.arange(WIN, dtype=torch.int64, device=dev)[None, :]
    # the reference's clipping gathers: index clamped into the buffer
    idx = (starts.long()[:, None] + j).clamp(0, codes.shape[0] - 1)
    win = codes[idx.reshape(-1)].reshape(NS, WIN).to(I32)
    kmc = km[win.clamp(0, 7).long()]
    bad = win >= 4
    pfx = torch.zeros((NS, SL), dtype=I32, device=dev)
    anybad = torch.zeros((NS, SL), dtype=torch.bool, device=dev)
    for jj in range(k):
        pfx = (pfx << 2) | kmc[:, jj:jj + SL]
        anybad = anybad | bad[:, jj:jj + SL]
    pos = torch.arange(SL, dtype=I32, device=dev)[None, :]
    valid = (~anybad) & (pos + k <= lens[:, None])
    return torch.where(valid, pfx, 0), valid


def _count_kernel(bucket_pairs, codes, starts, lens, k: int):
    """Per-subread vote counts (the host uses them to split the batch
    into chunks that fit the largest vote class), zero-hit k-mer counts
    (the CS mappingQlty=0 rule input, CS.cpp:221-226), AND the per-k-mer
    bucket offsets/counts — kept device-resident and consumed by the chunk
    kernels so the k-mer extraction + index gathers run once per batch,
    not once per chunk. bucket_pairs[p] = (start, count) of prefix p's
    bucket: one row gather per strand."""
    pfx, valid = _kmer_mat(codes, starts, lens, k)
    rc = _rc_dev(pfx, k)
    NS = pfx.shape[0]
    fp = bucket_pairs[pfx.reshape(-1).long()].reshape(NS, SL, 2)
    rp = bucket_pairs[rc.reshape(-1).long()].reshape(NS, SL, 2)
    fs = fp[:, :, 0].contiguous()
    fc = torch.where(valid, fp[:, :, 1], 0)
    rs = rp[:, :, 0].contiguous()
    rcnt = torch.where(valid, rp[:, :, 1], 0)
    votes = torch.sum(fc + rcnt, dim=1, dtype=I32)
    kcnt = torch.sum(valid & ((fc + rcnt) == 0), dim=1, dtype=I32)
    return votes, kcnt, fs, fc, rs, rcnt


def _cat1(x, fill):
    """x[1:] with one fill value appended (a shift left by one)."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])


def _search_kernel(positions, fs_all, fc_all, rs_all, rcnt_all, lens,
                   s0m: int, delta: int, n_sub: int,
                   k: int, bin_size: int, NSc: int, NV: int,
                   sens: float, min_kmer_hits: float, ne_cap: int = NE_CAP):
    """One chunk (subreads [s0m + delta, s0m + delta + n_sub)) of a batch.
    fs/fc/rs/rcnt are the count kernel's device-resident per-k-mer bucket
    offsets/counts [NSp, SL]; the slice starts at s0m (clamped so
    s0m + NSc fits — `delta` re-bases the row ids so sub 0 is the chunk's
    first real subread). NV must hold the chunk's votes. Vote expansion,
    ranking, thresholding, and entry compaction run here. Returns the first
    ne_cap entries (sub, p1 = bin << 2 | keep flags, fwd count, rev count)
    and the entry count (an int32 scalar; above ne_cap the caller reruns
    with a larger cap). Counts pack beside the sub id in int64 keys, so no
    group size overflows them."""
    dev = positions.device
    ln = lens[s0m:s0m + NSc]
    fs2 = fs_all[s0m:s0m + NSc]
    fc2 = fc_all[s0m:s0m + NSc]
    rs2 = rs_all[s0m:s0m + NSc]
    rcnt2 = rcnt_all[s0m:s0m + NSc]
    row = torch.arange(NSc, dtype=I32, device=dev)
    in_chunk = (row >= delta) & (row < delta + n_sub)
    fc2 = torch.where(in_chunk[:, None], fc2, 0)
    rcnt2 = torch.where(in_chunk[:, None], rcnt2, 0)

    # --- votes in reference order (emission-major, fwd before rev) -------
    # fwd/rev buckets interleave as even/odd slots of one doubled k-mer
    # table, so the vote stream needs three NV-sized gathers (slot base
    # offsets, slot corrections, positions)
    NK2 = 2 * NSc * SL
    base2 = torch.stack([fs2, rs2], dim=-1).reshape(NK2)
    c2 = torch.stack([fc2, rcnt2], dim=-1).reshape(NK2)
    cum2 = torch.cumsum(c2, 0, dtype=I32)
    total_votes = cum2[NK2 - 1]
    j = torch.arange(NV, dtype=I32, device=dev)
    # jnp.repeat(arange(NK2), c2, total_repeat_length=NV): vote j takes the
    # last slot whose exclusive start is <= j — past the total that is the
    # last slot, and votes beyond NV are cut
    kmer2 = (torch.searchsorted(cum2 - c2, j, right=True) - 1).to(I32)
    v_valid = j < total_votes
    is_rev = kmer2 & 1
    flat_k = kmer2 >> 1
    # sub comes from the flat k-mer id arithmetically (a dense SL-slot
    # layout); the bucket position index folds the slot base and the
    # vote-stream start into a difference table, and the bin correction
    # is per slot too
    sub = torch.div(flat_k, SL, rounding_mode="floor") - delta
    d2t = base2 - (cum2 - c2)
    posk2 = torch.arange(SL, dtype=I32, device=dev)[None, :].expand(NSc, SL)
    ct_r = ln[:, None] - (posk2 + k)
    ct2 = torch.stack([posk2, ct_r], dim=-1).reshape(NK2)
    kl = kmer2.long()
    pos_idx = (j + d2t[kl]).clamp(0, positions.shape[0] - 1)
    loc = positions[pos_idx.long()].long() & U32_MASK
    corr = ct2[kl].long()
    # uint32 (loc - corr) >> bin_size, then reinterpreted as int32
    v_bin = (((loc - corr) & U32_MASK) >> bin_size).to(I32)
    v_sub = torch.where(v_valid, sub, MAX_SUBS - 1)
    v_str = is_rev
    v_bin = torch.where(v_valid, v_bin, BIN_SENTINEL)

    # --- per-(sub, bin, strand) occurrence rank: sort + inverse ----------
    # the reference's 3-key sort (v_sub, g2, arange) as one stable sort of
    # a packed int64 key (the unique arange key is the stability)
    g2 = v_bin * 2 + v_str
    arange_v = torch.arange(NV, dtype=I32, device=dev)
    key = (v_sub.long() << 32) | (g2.long() + (1 << 31))
    _, s_idx = torch.sort(key, stable=True)
    s_sub = v_sub[s_idx]
    s_g2 = g2[s_idx]
    new_grp = torch.ones(NV, dtype=torch.bool, device=dev)
    new_grp[1:] = (s_sub[1:] != s_sub[:-1]) | (s_g2[1:] != s_g2[:-1])
    grp_start = torch.cummax(torch.where(new_grp, arange_v, -1), 0).values
    rank_sorted = arange_v - grp_start              # 0-based within group
    # inverse permutation by scatter; grp_start rides along so the
    # crossing pass can scatter straight from vote space
    count_after = torch.empty_like(rank_sorted)
    count_after[s_idx] = rank_sorted + 1
    grp_of_vote = torch.empty_like(grp_start)
    grp_of_vote[s_idx] = grp_start

    # --- running threshold crossing (f32, AddLocationStd) ----------------
    # sens and min_kmer_hits arrive as float32 values, so the products
    # below round exactly as f32(run_max) * f32(sensitivity). The running
    # max is a cummax of (sub << 32 | count): the sub id resets it
    ckey = (v_sub.long() << 32) | count_after.long()
    run_max = torch.cummax(ckey, 0).values & U32_MASK
    thresh = run_max.to(torch.float32) * sens
    crossing = v_valid & (count_after.to(torch.float32) >= thresh)

    # --- group stats in group-sorted space (groups are contiguous) -------
    # first crossing VOTE INDEX per group: scatter-min of the crossing
    # votes' indices keyed by the group representative (the group's first
    # sorted row — unique per group)
    candv = torch.where(crossing, j, NV)
    seg_min = torch.full((NV,), NV, dtype=I32, device=dev).scatter_reduce(
        0, grp_of_vote.long(), candv, reduce="amin", include_self=True)
    first_cross_sorted = seg_min[grp_start.long()]
    grp_size_sorted = rank_sorted + 1      # running size; last row = size

    # group boundary rows (last row of each group) carry the group's stats
    is_last = _cat1(new_grp, True)
    g_sub = s_sub
    g_bin = s_g2 >> 1
    g_str = s_g2 & 1

    # pair fwd/rev groups of one (sub, bin): their LAST rows are adjacent
    # in the boundary-row subsequence; compact boundary rows by a stable
    # sort of non-boundary rows to the end, preserving group order
    brow_key = torch.where(is_last, arange_v, NV)
    bk, bo = torch.sort(brow_key, stable=True)
    b_sub, b_bin, b_str = g_sub[bo], g_bin[bo], g_str[bo]
    b_size, b_first = grp_size_sorted[bo], first_cross_sorted[bo]
    b_valid = bk < NV
    same_prev = torch.zeros(NV, dtype=torch.bool, device=dev)
    same_prev[1:] = (b_sub[1:] == b_sub[:-1]) & (b_bin[1:] == b_bin[:-1])
    nxt_size = _cat1(b_size, 0)
    nxt_first = _cat1(b_first, NV)
    has_next = _cat1(same_prev, False)
    is_entry = b_valid & (~same_prev) & (b_bin < (BIN_SENTINEL >> 1))
    e_fwd = torch.where(b_str == 0, b_size, 0)
    e_rev = torch.where(b_str == 0, torch.where(has_next, nxt_size, 0),
                        b_size)
    e_first = torch.minimum(b_first, torch.where(has_next, nxt_first, NV))
    # final threshold ON DEVICE before compaction. Per-sub FINAL max group
    # count via forward + reverse packed segmented cummax over the
    # (sub-sorted) boundary rows — the sub id in the high bits resets the
    # running max at each sub boundary, the reverse scan uses the
    # complemented sub id to stay non-decreasing
    bsub_m = torch.where(b_valid, b_sub, MAX_SUBS - 1).long()
    bsz_m = torch.where(b_valid, b_size, 0).long()
    fwd_max = torch.cummax((bsub_m << 32) | bsz_m, 0).values & U32_MASK
    rev_in = (((MAX_SUBS - 1) - bsub_m) << 32) | bsz_m
    rev_max = torch.cummax(rev_in.flip(0), 0).values.flip(0) & U32_MASK
    th = (torch.maximum(fwd_max, rev_max).to(torch.float32) * sens).clamp(
        min=min_kmer_hits)
    keep_f = e_fwd.to(torch.float32) >= th
    keep_r = e_rev.to(torch.float32) >= th
    entry_ok = is_entry & (e_first < NV) & (keep_f | keep_r)

    # --- order kept entries by (sub, first crossing vote); compact -------
    # p1 = bin<<2 | keep_f<<1 | keep_r; the counts travel in full
    p1 = (b_bin << 2) | (keep_f.to(I32) << 1) | keep_r.to(I32)
    k_sub = torch.where(entry_ok, b_sub, MAX_SUBS).long()
    k_first = torch.where(entry_ok, e_first, NV).long()
    _, oo = torch.sort((k_sub << 32) | k_first, stable=True)
    oo = oo[:ne_cap]
    n_entries = torch.sum(entry_ok, dtype=I32)
    return (b_sub[oo], p1[oo], e_fwd[oo], e_rev[oo], n_entries.reshape(1))


# --- v2 row-local chunk kernel ---------------------------------------------
# One subread per ROW of a [B, L] launch (L = vote-count size class):
# row-local indices fit packed int32 scan keys, so every segmented reduction
# (rank-in-group, segment broadcast, first-crossing min) is a row cumsum or
# cummax. The v1 global kernel (above) runs the outlier subreads (> L_V2_MAX
# votes) and the rows that overflow, one subread at a time.
E_CAP = 256                  # entries kept per subread row (a row with
# more reruns through v1); real subreads produce 1-50
NE2 = 1 << 14                # compacted entry rows fetched per launch
BL_MAX = 1 << 22             # B*L budget per launch
L_V2_MAX = 1 << 15           # max vote class: row-local l must fit 15 bits
# for the packed scan keys ((seg_rank << 16) | value etc.)


def _search_kernel_v2(positions, fs_all, fc_all, rs_all, rcnt_all, ln_all,
                      rows, n_real: int,
                      k: int, bin_size: int, B: int, L: int,
                      sens: float, min_kmer_hits: float,
                      ec: int = E_CAP, ne2: int = NE2):
    """Row-local candidate search: row b = subread rows[b], L vote slots.

    Exact same semantics as _search_kernel / the host twin (CS.cpp
    emergence order): emission order within a row is (k-mer slot, fwd
    bucket then rev bucket, bucket position) = ascending l by
    construction; groups are (bin, strand); entries are bins ordered by
    first crossing vote. Returns per-launch compacted entries
    (o_row, o_p1, o_p2) exactly like the v1 kernel's fetch shape, plus
    per-row entry counts (the host re-splits and detects per-row
    overflow: rows with n_ent > E_CAP or entry ranks beyond NE2 rerun
    through v1)."""
    dev = positions.device
    SL2 = 2 * SL
    ln = ln_all[rows]
    fs2 = fs_all[rows]
    fc2 = fc_all[rows]
    rs2 = rs_all[rows]
    rcnt2 = rcnt_all[rows]
    rowi = torch.arange(B, dtype=I32, device=dev)
    live = rowi < n_real
    fc2 = torch.where(live[:, None], fc2, 0)
    rcnt2 = torch.where(live[:, None], rcnt2, 0)

    # --- slot tables (even = fwd, odd = rev, one pad slot at the end) ----
    base2 = torch.stack([fs2, rs2], dim=-1).reshape(B, SL2)
    c2 = torch.stack([fc2, rcnt2], dim=-1).reshape(B, SL2)
    posk = torch.arange(SL, dtype=I32, device=dev)[None, :].expand(B, SL)
    ct2 = torch.stack([posk, ln[:, None] - (posk + k)], dim=-1).reshape(
        B, SL2)
    cum2 = torch.cumsum(c2, 1, dtype=I32)
    zero = torch.zeros((B, 1), dtype=I32, device=dev)
    d2tp = torch.cat([base2 - (cum2 - c2), zero], dim=1)
    ct2p = torch.cat([ct2, zero], dim=1)

    # --- expansion: per-vote slot values (the expand_votes kernel) -------
    slot, d2t, corr = K.expand_votes(cum2, d2tp, ct2p, L)
    cols = torch.arange(L, dtype=I32, device=dev)[None, :].expand(B, L)
    pos_idx = (d2t + cols).clamp(0, positions.shape[0] - 1)
    loc = positions[pos_idx.reshape(-1).long()].reshape(B, L).long() \
        & U32_MASK
    strand = slot & 1
    valid = slot < SL2
    v_bin = torch.where(
        valid, (((loc - corr.long()) & U32_MASK) >> bin_size).to(I32),
        BIN_SENTINEL)

    # --- sort1: group by bin per row (stable: emission order within) ----
    pay = (cols << 1) | strand
    s_bin, o1 = torch.sort(v_bin, dim=1, stable=True)
    s_pay = torch.gather(pay, 1, o1)
    st = s_pay & 1
    l_s = s_pay >> 1
    valid_s = s_bin < BIN_SENTINEL
    new_seg = torch.ones((B, L), dtype=torch.bool, device=dev)
    new_seg[:, 1:] = s_bin[:, 1:] != s_bin[:, :-1]
    seg_rank = torch.cumsum(new_seg, 1, dtype=I32) - 1  # < L

    # --- per-(bin, strand) emission ranks via packed segment broadcasts --
    CM = 0xFFFF
    csum_r = torch.cumsum(st, 1, dtype=I32)            # inclusive rev count
    csum_f = (cols + 1) - csum_r
    r_excl = csum_r - st
    f_excl = csum_f - (1 - st)

    def seg_bcast(x):
        # broadcast x's value at each segment's first column to the whole
        # segment: packed (col << 16 | x) cummax (x <= L <= 2^15 < 2^16)
        p = torch.where(new_seg, (cols << 16) | x, -1)
        return torch.cummax(p, 1).values & CM

    rb = seg_bcast(r_excl)
    fb = seg_bcast(f_excl)
    nr_seg = csum_r - rb
    nf_seg = csum_f - fb
    count_after = torch.where(st == 1, nr_seg, nf_seg)
    ca = torch.where(valid_s, count_after, 0)

    # --- sort2: to emission space (inverse permutation, a scatter); running
    # max + crossing ------------------------------------------------------
    ca_em = torch.empty_like(ca).scatter_(1, l_s.long(), ca)
    run_max = torch.cummax(ca_em, 1).values
    crossing_em = (ca_em.to(torch.float32)
                   >= run_max.to(torch.float32) * sens) & (ca_em > 0)
    row_max = run_max[:, -1]
    th = (row_max.to(torch.float32) * sens).clamp(min=min_kmer_hits)[:, None]

    # --- sort3: crossing back to bin-sorted space (a gather) -------------
    cross_s = torch.gather(crossing_em, 1, l_s.long())

    # first crossing vote (min l) per segment: packed cummax with the
    # segment rank in the high bits (current segment dominates earlier
    # ones) and the complemented l in the low bits (max -> min l)
    BIGV = 0xFFFF
    cl = torch.where(cross_s & valid_s, l_s, BIGV)
    pm = torch.cummax((seg_rank << 16) | (BIGV - cl), 1).values
    fc_val = BIGV - (pm & CM)

    # --- entries at segment-last columns ---------------------------------
    is_last = torch.ones((B, L), dtype=torch.bool, device=dev)
    is_last[:, :-1] = new_seg[:, 1:]
    keep_f = nf_seg.to(torch.float32) >= th
    keep_r = nr_seg.to(torch.float32) >= th
    entry_ok = is_last & valid_s & (fc_val < BIGV) & (keep_f | keep_r)
    p1 = (s_bin << 2) | (keep_f.to(I32) << 1) | keep_r.to(I32)
    p2 = (torch.clamp(nf_seg, max=CM) << 16) | torch.clamp(nr_seg, max=CM)

    # --- sort4: per-row entry order by first crossing vote ---------------
    EC = min(ec, L)
    key4 = torch.where(entry_ok, fc_val, 2 ** 30)
    k4, o4 = torch.sort(key4, dim=1, stable=True)
    o4 = o4[:, :EC]
    k4 = k4[:, :EC]
    n_ent = torch.sum(entry_ok, dim=1, dtype=I32)
    # a group of exactly 2^15 votes would overflow the p2 count packing
    # (nf << 16 wraps the sign bit) — flag the row for a v1 rerun
    n_ent = n_ent | ((row_max >= (1 << 15)).to(I32) << 20)

    # --- cross-row compaction to the v1 fetch shape ----------------------
    flat_ok = (k4 < 2 ** 30).reshape(-1)
    flat_iota = torch.arange(B * EC, dtype=I32, device=dev)
    _, oc = torch.sort(torch.where(flat_ok, flat_iota, 2 ** 30), stable=True)
    oc = oc[:min(ne2, B * EC)]
    rowid = torch.div(oc, EC, rounding_mode="floor").to(I32)
    o_p1 = torch.gather(p1, 1, o4).reshape(-1)[oc]
    o_p2 = torch.gather(p2, 1, o4).reshape(-1)[oc]
    return (rowid, o_p1, o_p2, n_ent)


def _fetch(groups):
    """Device -> host for lists of int32 tensors, in one transfer. Returns
    the same nesting as numpy arrays."""
    flat = [t.reshape(-1) for g in groups for t in g]
    if not flat:
        return [[] for _ in groups]
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for g in groups:
        arrs = []
        for t in g:
            arrs.append(host[off:off + t.numel()].reshape(tuple(t.shape)))
            off += t.numel()
        out.append(arrs)
    return out


class DeviceSearch:
    """Batched candidate search on one device ("cuda" by default, "cpu" on
    request; without a card and without a CPU request it raises).
    On a card every batch it accepts is searched there, start to end. On
    the CPU, search_batch / search_views return None (the caller uses the
    host path) for what the search does not take: a multi-unit genome or a
    subread longer than SL; on a card those raise."""

    def __init__(self, index: KmerIndex, device=None):
        from ..ops.device_engine import resolve_device
        self.index = index
        self.device = resolve_device(device)
        self.available = True
        pos = index.positions
        if len(pos) and pos.dtype.itemsize > 4 and int(pos.max()) >= 2 ** 32:
            # a multi-unit genome (positions past uint32); the Pipeline gates
            # on ref.n_units before constructing a DeviceSearch — this
            # guards ad-hoc callers. The maximum, not the last entry:
            # positions are sorted only within each bucket
            if self.device.type != "cpu":
                raise ValueError("device candidate search: positions past "
                                 "2^32 (a multi-unit genome) need the host "
                                 "search")
            self.available = False
            from ..native import _warn_fallback
            _warn_fallback(
                "multi-unit genome: device candidate search needs per-unit "
                "uint32 tables — falling back to the host search path")
            return
        if index.uniq_prefix is None:
            bucket_start = index.bucket_start.astype(np.int32)
        else:
            # densify a sparse index (tiny genomes): positions are sorted
            # by prefix either way, so the dense starts index the same
            # position array
            n_prefix = 4 ** index.k
            counts = np.zeros(n_prefix, np.int32)
            counts[index.uniq_prefix] = np.diff(index.bucket_start)
            bucket_start = np.zeros(n_prefix + 1, np.int32)
            np.cumsum(counts, out=bucket_start[1:])
        # (start, count) pairs per prefix — the count kernel's row-gather
        # layout (see _count_kernel)
        pairs = np.empty((len(bucket_start) - 1, 2), dtype=np.int32)
        pairs[:, 0] = bucket_start[:-1]
        pairs[:, 1] = bucket_start[1:] - bucket_start[:-1]
        self.bucket_pairs = torch.from_numpy(pairs).to(self.device)
        # uint32 positions as their int32 bit pattern (half the bytes of
        # int64); readers widen with & 0xFFFFFFFF
        self.positions = torch.from_numpy(
            np.ascontiguousarray(pos.astype(np.uint32)).view(np.int32)
        ).to(self.device)

    def _stat(self, key: str, dt):
        """Add to a counter of the active DeviceContext."""
        from ..ops import device_engine
        ctx = device_engine.current()
        if ctx is not None:
            ctx.add(key, dt)

    def _too_long(self):
        """A batch with a subread longer than SL: on the CPU, counted and
        handed back (None) to the host search; on a card an error — the
        Pipeline keeps the search off for such subread lengths."""
        if self.device.type != "cpu":
            raise ValueError("device candidate search: a subread is longer "
                             "than %d bases" % SL)
        self._stat("search_fallback_len", 1)
        return None

    def _run_v2(self, fs_dev, fc_dev, rs_dev, rcnt_dev, ln_dev,
                votes_per_sub, k_counts, lens, n_seqs,
                sensitivity, min_kmer_hits) -> List[SubreadCandidates]:
        """Row-local launch orchestration: bucket subreads into vote-count
        size classes, one [B, L] launch per class slice; outlier subreads
        (> L_V2_MAX votes) and overflow rows go through v1 single-subread
        chunks, and a v1 run with more entries than it returned reruns with
        room for all of them. Stats: search_v2_launches and one
        search_v2_class_<B>x<L> counter per launch shape, search_v1_outliers,
        search_v2_retry (rows rerun through v1), search_v1_launches,
        search_v1_rerun."""
        index = self.index
        k = index.k
        bin_size = index.bin_size
        dev = self.device
        nvs = votes_per_sub.astype(np.int64)
        NSp = int(fs_dev.shape[0])
        classes = {}
        outliers = []
        for si in range(n_seqs):
            if nvs[si] > L_V2_MAX:
                outliers.append(si)
            else:
                classes.setdefault(
                    _size_class(max(int(nvs[si]), 1), 512), []).append(si)
        sens_f = float(f32(sensitivity))
        mink_f = float(f32(min_kmer_hits))

        def v1_single(si, ne_cap=NE_CAP):
            # eager PyTorch compiles nothing per shape, so the vote class
            # starts at 4096 rather than the reference's 2^20
            NSc = min(256, NSp)
            s0m = min(si, NSp - NSc)
            NV = _size_class(max(int(nvs[si]), 1), 1 << 12)
            self._stat("search_v1_launches", 1)
            return (si, ne_cap, _search_kernel(
                self.positions, fs_dev, fc_dev, rs_dev, rcnt_dev, ln_dev,
                s0m, si - s0m, 1,
                k=k, bin_size=bin_size, NSc=NSc, NV=NV,
                sens=sens_f, min_kmer_hits=mink_f, ne_cap=ne_cap))

        pending = []
        for Lc in sorted(classes):
            ids = classes[Lc]
            # power-of-two row budget so padded B always lands on a size
            # class (bounded launch-shape count)
            Bmax = 8
            while Bmax * 2 * Lc <= BL_MAX:
                Bmax *= 2
            for i in range(0, len(ids), Bmax):
                grp = np.asarray(ids[i:i + Bmax], dtype=np.int32)
                # pow2 row padding with a floor: fewer distinct (B, L)
                # launch shapes across batches
                Bp = min(_pow2(len(grp), min(64, Bmax)), Bmax)
                rows = np.zeros(Bp, np.int64)
                rows[:len(grp)] = grp
                out = _search_kernel_v2(
                    self.positions, fs_dev, fc_dev, rs_dev, rcnt_dev,
                    ln_dev, torch.from_numpy(rows).to(dev), len(grp),
                    k=k, bin_size=bin_size, B=Bp, L=Lc,
                    sens=sens_f, min_kmer_hits=mink_f,
                    ec=E_CAP, ne2=NE2)
                self._stat("search_v2_launches", 1)
                self._stat("search_v2_class_%dx%d" % (Bp, Lc), 1)
                pending.append((grp, Lc, out))
        if outliers:
            self._stat("search_v1_outliers", len(outliers))
        v1_pending = [v1_single(si) for si in outliers]

        fetched = _fetch([o for _, _, o in pending]
                         + [o for _, _, o in v1_pending])
        v1_fetched = fetched[len(pending):]
        fetched = fetched[:len(pending)]

        retry = []
        parts = []                     # (subs, p1, fwd counts, rev counts)
        cmask = (1 << COUNT_BITS) - 1
        for (grp, Lc, _), vals in zip(pending, fetched):
            o_row, o_p1, o_p2, n_ent = vals
            over_row = (n_ent[:len(grp)] >> 20) != 0
            n_ent = n_ent[:len(grp)] & ((1 << 20) - 1)
            ECl = min(E_CAP, Lc)
            ne2l = len(o_row)          # launch's effective fetch cap
            cum = np.cumsum(np.minimum(n_ent, ECl))
            fit = int(min(cum[-1], ne2l)) if len(cum) else 0
            bad = over_row | (n_ent > ECl) | (cum > ne2l)
            if bad.any():
                retry.extend(int(s) for s in grp[bad])
            o_row = o_row[:fit]
            keep = ~bad[o_row]
            o_p2 = o_p2[:fit][keep]
            parts.append((grp[o_row[keep]].astype(np.int64),
                          o_p1[:fit][keep], (o_p2 >> COUNT_BITS) & cmask,
                          o_p2 & cmask))
        if retry:
            self._stat("search_v2_retry", len(retry))
            r_pend = [v1_single(si) for si in retry]
            v1_fetched = v1_fetched + _fetch([o for _, _, o in r_pend])
            v1_pending = v1_pending + r_pend
        while v1_pending:
            again = []
            for (si, cap, _), vals in zip(v1_pending, v1_fetched):
                o_sub, o_p1, o_cf, o_cr, n_entries = vals
                n_e = int(n_entries[0])
                if n_e > cap:
                    # more entries than this run returned: rerun with room
                    # for all of them (the count is exact either way)
                    again.append(v1_single(si, _pow2(n_e, cap)))
                    continue
                parts.append((np.full(n_e, si, dtype=np.int64), o_p1[:n_e],
                              o_cf[:n_e], o_cr[:n_e]))
            if again:
                self._stat("search_v1_rerun", len(again))
                v1_fetched = _fetch([o for _, _, o in again])
            v1_pending = again

        # vectorized unpack over ALL entries at once (stable sub-major
        # order: launches emit row-major, per-row entries pre-sorted)
        if parts:
            gsub, p1, cnt_f, cnt_r = (np.concatenate(c) for c in zip(*parts))
        else:
            gsub = np.zeros(0, np.int64)
            p1 = cnt_f = cnt_r = np.zeros(0, np.int32)
        order = np.argsort(gsub, kind="stable")
        res = self._unpack(gsub[order], p1[order], cnt_f[order],
                           cnt_r[order], k_counts, lens, n_seqs)
        return res

    def _unpack(self, gsub, p1, cnt_f, cnt_r, k_counts, lens, n_seqs):
        """Compacted entries (sub-major) -> one SubreadCandidates per
        subread: forward before reverse per entry, each kept by its flag."""
        k = self.index.k
        bin_size = self.index.bin_size
        resolve_off = (1 << (bin_size - 1)) if bin_size > 0 else 0
        n_e = len(p1)
        e_loc = ((p1 >> 2).astype(np.int64) << bin_size) + resolve_off
        out_sub = np.repeat(gsub, 2)
        out_loc = np.repeat(e_loc, 2)
        out_rev = np.tile(np.array([False, True]), n_e)
        out_cnt = np.empty(2 * n_e, np.float32)
        out_cnt[0::2] = cnt_f
        out_cnt[1::2] = cnt_r
        keep2 = np.empty(2 * n_e, bool)
        keep2[0::2] = (p1 & 2) != 0
        keep2[1::2] = (p1 & 1) != 0
        out_sub = out_sub[keep2]
        out_loc = out_loc[keep2]
        out_rev = out_rev[keep2]
        out_cnt = out_cnt[keep2]

        lens64 = np.asarray(lens, dtype=np.int64)
        mq_zero = k_counts > ((lens64 - k + 1) * 0.9).astype(np.int64)
        res_bounds = np.searchsorted(out_sub, np.arange(n_seqs + 1))
        res: List[SubreadCandidates] = []
        for si in range(n_seqs):
            lo, hi = int(res_bounds[si]), int(res_bounds[si + 1])
            res.append(SubreadCandidates(out_loc[lo:hi], out_rev[lo:hi],
                                         out_cnt[lo:hi], bool(mq_zero[si])))
        return res

    def search_batch(self, seqs: List[bytes], sensitivity: float = 0.8,
                     min_kmer_hits: int = 0
                     ) -> Optional[List[SubreadCandidates]]:
        """Bytes-based entry point (tests, ad-hoc callers): encodes the
        sequences into a temporary device code buffer, then runs the
        descriptor path (search_views)."""
        if any(len(s) > SL for s in seqs):
            return self._too_long()
        from ..io.reference import _CHAR2CODE
        total = sum(len(s) for s in seqs)
        concat = np.full(_pow2(total + 8, 4096), 4, dtype=np.uint8)
        starts = np.empty(len(seqs), dtype=np.int32)
        lens = np.empty(len(seqs), dtype=np.int32)
        pos = 0
        for si, s in enumerate(seqs):
            starts[si] = pos
            lens[si] = len(s)
            concat[pos:pos + len(s)] = _CHAR2CODE[
                np.frombuffer(s, dtype=np.uint8)]
            pos += len(s)
        codes_dev = torch.from_numpy(concat).to(self.device)
        return self.search_views(codes_dev, starts, lens, sensitivity,
                                 min_kmer_hits)

    def search_views(self, codes_dev, starts: np.ndarray, lens: np.ndarray,
                     sensitivity: float = 0.8, min_kmer_hits: int = 0
                     ) -> Optional[List[SubreadCandidates]]:
        """Descriptor-based entry point: subread si = codes_dev[starts[si]:
        starts[si] + lens[si]] (device code space). codes_dev is typically
        the batch read buffer already resident for scoring/alignment."""
        index = self.index
        k = index.k
        n_seqs = len(starts)
        if not self.available:
            return None
        if n_seqs == 0:
            return []
        if n_seqs >= MAX_SUBS - 1:
            # subreads are independent: big batches run as consecutive
            # slices (the per-slice cost is one tiny descriptor upload +
            # one counts fetch + the chunk kernels either way)
            res: List[SubreadCandidates] = []
            step = MAX_SUBS - 2
            for lo in range(0, n_seqs, step):
                part = self.search_views(codes_dev, starts[lo:lo + step],
                                         lens[lo:lo + step], sensitivity,
                                         min_kmer_hits)
                if part is None:
                    return None
                res.extend(part)
            return res
        if int(np.max(lens)) > SL:
            return self._too_long()

        dev = self.device
        NSp = _size_class(n_seqs, 256)
        st_pad = np.zeros(NSp, dtype=np.int32)
        ln_pad = np.zeros(NSp, dtype=np.int32)
        st_pad[:n_seqs] = starts
        ln_pad[:n_seqs] = lens
        st_dev = torch.from_numpy(st_pad).to(dev)
        ln_dev = torch.from_numpy(ln_pad).to(dev)
        t0 = time.perf_counter()
        (votes_dev, kcnt_dev, fs_dev, fc_dev, rs_dev,
         rcnt_dev) = _count_kernel(self.bucket_pairs, codes_dev,
                                   st_dev, ln_dev, k=k)
        votes_per_sub, k_counts = _fetch([[votes_dev, kcnt_dev]])[0]
        votes_per_sub = votes_per_sub[:n_seqs]
        k_counts = k_counts[:n_seqs].astype(np.int64)
        self._stat("search_count_s", time.perf_counter() - t0)
        return self._run_v2(fs_dev, fc_dev, rs_dev, rcnt_dev, ln_dev,
                            votes_per_sub, k_counts, lens, n_seqs,
                            sensitivity, min_kmer_hits)

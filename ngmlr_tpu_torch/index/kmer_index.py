"""k-mer prefix index: flat two-array layout, vectorized two-pass build.

Rebuild of CompactPrefixTable (ngmlr src/PrefixTable.cpp) as two
numpy arrays:

  * ``bucket_start``: int64[4^k + 1] — positions for prefix p live at
    ``positions[bucket_start[p]:bucket_start[p+1]]``,
  * ``positions``: int64[n] — concat-genome k-mer start positions in
    chromosome scan order.

Semantics preserved from the reference build
(PrefixTable.cpp:202-330, 372-454):

  * k-mer stream per chromosome: 2-bit rolling encode ((c>>1)&3,
    CSstatic.cpp:17-19) over the *decoded* chromosome (so an odd-length
    chromosome's final base decodes to 'x' → code 0, SequenceProvider.cpp
    DecodeRefSequence quirk), N-runs break the stream, stride
    kmer_skip+1 restarts at each N-free segment (CSstatic.cpp:23-73),
  * consecutive same-prefix emissions falling in the same diagonal bin
    (pos >> bin_size) are dropped — repeat compression
    (PrefixTable.cpp:372-393),
  * frequency cutoff: prefix kept iff fwd freq > 0 AND
    fwd+revcomp freq < max_prefix_freq AND the stored uniqueness weight
    (max_prefix_freq - total)*100/max_prefix_freq truncates to a nonzero
    int8 — i.e. effectively total <= 990 for the default 1000
    (PrefixTable.cpp:296-309 + Index::used(), PrefixTable.h:27-30),
  * the all-ones prefix (4^k - 1, poly-G) is never indexed
    (createRefTableIndex loops i < length-1, PrefixTable.cpp:289),
  * reverse strand is not stored; lookups also return the position list of
    the reverse-complement prefix flagged reverse (PrefixTable.cpp:476-532).

Design deviation (documented): positions live in a single table, not in the
reference's 4-GB TableUnits of uint32 positions (PrefixTable.h:58-75). The
table is uint32 while every concatenated position fits 32 bits (concat_len
< 2^32: the table of ngmlr_tpu, bit for bit) and int64 past that
(positions_dtype); a position is never narrowed into a type that cannot
hold it.
"""

from typing import Iterator, List, Optional, Tuple
import os

import numpy as np

from ..io.reference import ReferenceGenome

INDEX_COOKIE = 0x1701E  # PrefixTable.cpp:21
INDEX_VERSION = 4   # v4: uint32 positions / int32 prefixes (build speed)


def positions_dtype(concat_len: int) -> np.dtype:
    """The positions table's type for a genome of concat_len: uint32 below
    2^32, int64 from there (a uint32 cast would wrap positions past 2^32
    to pos - 2^32)."""
    return np.dtype(np.uint32 if concat_len < 2 ** 32 else np.int64)


def _narrow(pos: np.ndarray, dt: np.dtype) -> np.ndarray:
    """Concatenated positions (int64) as the table's type dt; raises
    rather than wrap a position that dt cannot hold."""
    if len(pos) and int(pos.max()) > np.iinfo(dt).max:
        raise ValueError("index position %d does not fit the %s table"
                         % (int(pos.max()), dt))
    return pos.astype(dt, copy=False)


import functools


@functools.lru_cache(maxsize=4)
def _revcomp_table(k: int) -> np.ndarray:
    """Permutation p -> revcomp(p) over all 4^k prefixes, built by halves.

    For k=13 this composes tables for the high/low halves instead of looping
    13 shift/or passes over a 67M-element array.
    """
    if k <= 8:
        return np.asarray(
            revcomp_prefix(np.arange(4 ** k, dtype=np.int64), k)).astype(np.int32)
    k_hi = k // 2
    k_lo = k - k_hi
    lo_t = _revcomp_table(k_lo).astype(np.int32)
    hi_t = _revcomp_table(k_hi).astype(np.int32)
    # p = hi * 4^k_lo + lo ; rc(p) = rc(lo) * 4^k_hi + rc(hi)
    return ((lo_t[None, :].astype(np.int64) << (2 * k_hi)).astype(np.int32)
            + hi_t[:, None]).reshape(-1)


def _revcomp_loop(prefix, k: int):
    p = np.asarray(prefix, dtype=np.int64) ^ (0xAAAAAAAAAAAAAAA & ((1 << (2 * k)) - 1))
    out = np.zeros_like(p)
    for _ in range(k):
        out = (out << 2) | (p & 3)
        p = p >> 2
    return out


@functools.lru_cache(maxsize=8)
def _rc_half(k_half: int) -> "np.ndarray":
    return np.asarray(_revcomp_loop(np.arange(4 ** k_half, dtype=np.int64),
                                    k_half)).astype(np.int64)


def revcomp_prefix(prefix, k: int):
    """Reverse-complement of 2-bit packed k-mers ((c>>1)&3 encoding).

    Complement = XOR each 2-bit group with 0b10 (PrefixTable.cpp:70-88),
    then reverse the k groups. Works on scalars or numpy arrays; large
    arrays compose two half-k lookup tables instead of looping k shifts,
    staying in int32 with in-place ops (the int64 expression churn cost
    ~20x in fresh-page allocations on the target host).
    """
    p = np.asarray(prefix)
    if p.ndim == 0 or p.size < 4096 or k < 4:
        return _revcomp_loop(np.asarray(prefix, dtype=np.int64), k)
    k_hi = k // 2
    k_lo = k - k_hi
    lo_t = _rc_half(k_lo).astype(np.int32)
    hi_t = _rc_half(k_hi).astype(np.int32)
    # p = hi * 4^k_lo + lo ; rc(p) = rc(lo) * 4^k_hi + rc(hi)
    p32 = p.astype(np.int32, copy=False)
    tmp = np.bitwise_and(p32, np.int32(4 ** k_lo - 1))
    out = lo_t[tmp]
    np.left_shift(out, 2 * k_hi, out=out)
    np.right_shift(p32, np.int32(2 * k_lo), out=tmp)
    np.bitwise_or(out, hi_t[tmp], out=out)
    return out


def kmer_stream(chars: np.ndarray, k: int, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """All (prefix, start_pos) emitted by the reference's PrefixIteration.

    ``chars``: uint8 ASCII array. N-runs split the sequence into segments;
    each segment emits k-mers from its first valid start with the given
    stride (CSstatic.cpp:23-73). Returns (prefixes int64, starts int64).
    """
    n = len(chars)
    if n < k or k > 15:
        if k > 15:
            raise ValueError("kmer_stream supports k <= 15 (int32 prefixes)")
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    not_n = chars != ord("N")

    # maximal N-free runs (the reference's segments, CSstatic.cpp:23-73):
    # run-based generation touches only output-sized arrays — the previous
    # window-sized formulation faulted ~25 bytes per genome base, and fresh
    # pages cost ~30 MB/s on the target host
    run_starts = np.nonzero(not_n[1:] & ~not_n[:-1])[0] + 1
    run_ends = np.nonzero(~not_n[1:] & not_n[:-1])[0] + 1
    if not_n[0]:
        run_starts = np.concatenate([[0], run_starts])
    if not_n[-1]:
        run_ends = np.concatenate([run_ends, [n]])
    lens = run_ends - run_starts
    nw = np.maximum((lens - k) // stride + 1, 0)
    total = int(nw.sum())
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    # int32 coordinates (chromosome-local, < 2^31) + reused gather buffers:
    # the previous int64 expression forms allocated ~25 fresh bytes per
    # genome base, and fresh pages fault at 30 MB/s-2 GB/s on this host
    it = np.int32 if n < 2 ** 31 else np.int64
    rep_start = np.repeat(run_starts.astype(it), nw)
    off = np.arange(total, dtype=it)
    off -= np.repeat((np.cumsum(nw) - nw).astype(it), nw)
    starts = rep_start
    if stride != 1:
        np.multiply(off, it(stride), out=off)
    starts += off

    codes = (chars >> np.uint8(1))
    np.bitwise_and(codes, np.uint8(3), out=codes)
    idx = off            # reuse as the per-pass gather index buffer
    gat = np.empty(total, dtype=np.uint8)
    val = np.zeros(total, dtype=np.int32)
    for j in range(k):
        np.left_shift(val, 2, out=val)
        np.add(starts, it(j), out=idx)
        np.take(codes, idx, out=gat)
        np.bitwise_or(val, gat, out=val)
    return val, starts


def _iter_chr_chunks(ref: ReferenceGenome, offset: int, length: int,
                     k: int, stride: int, bin_size: int,
                     max_emit: Optional[int] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deduped (prefixes int32, pos int64) chunks of one chromosome's
    k-mer stream, concatenating bit-identically to kmer_stream(whole chr)
    + the same-bin dedup — while touching only O(chunk) memory. The
    monolithic path's ~17 B/emission temporaries are ~26 GB for a
    single-chromosome 3 Gbp genome; this iterator is what lets the index
    build stream like the reference's two passes over the encoded
    reference (PrefixTable.cpp:202-231, 404-454).

      * decoded chars come from CODE2CHAR over the code array directly for
        interior ranges (position parity even — chromosome starts are
        even) and from decode_window for the tail, reproducing the
        odd-length 'x' / NUL-fill quirks exactly (decode_window docstring),
      * the same-prefix same-bin dedup (PrefixTable.cpp:372-393) depends
        only on the two previous RAW emissions, carried across chunks.
    """
    if k > 15:
        raise ValueError("index build supports k <= 15 (int32 prefixes)")
    if length < k:
        return
    if max_emit is None:
        max_emit = int(os.environ.get("NGMLR_TPU_INDEX_CHUNK",
                                      str(48 << 20)))
    from ..io.reference import CODE2CHAR
    dec_len = length - 2
    concat_len = ref.concat_len

    def chars_range(a: int, b: int) -> np.ndarray:
        # chromosome-local [a, b); a must be even (decode parity)
        if b > dec_len or offset + b > concat_len:
            dw = ref.decode_window(offset + a, length - a) or b""
            buf = dw + b"\x00" * ((length - a) - len(dw))
            return np.frombuffer(buf, dtype=np.uint8)[: b - a]
        return CODE2CHAR[np.asarray(ref.codes[offset + a: offset + b])]

    # --- N-free segments over the whole chromosome, sliced ----------------
    SL = 128 << 20
    rs_parts: List[np.ndarray] = []
    re_parts: List[np.ndarray] = []
    prev_in = False
    for a in range(0, length, SL):
        b = min(a + SL, length)
        ch = chars_range(a, b)
        nn = ch != ord("N")
        d = np.diff(nn.astype(np.int8))
        starts_l = np.nonzero(d == 1)[0].astype(np.int64) + 1 + a
        ends_l = np.nonzero(d == -1)[0].astype(np.int64) + 1 + a
        if nn[0] and not prev_in:
            starts_l = np.concatenate([[a], starts_l])
        prev_in = bool(nn[-1])
        rs_parts.append(starts_l)
        re_parts.append(ends_l)
    if prev_in:
        re_parts.append(np.asarray([length], dtype=np.int64))
    run_starts = (np.concatenate(rs_parts) if rs_parts
                  else np.zeros(0, np.int64))
    run_ends = (np.concatenate(re_parts) if re_parts
                else np.zeros(0, np.int64))

    lens = run_ends - run_starts
    nw = np.maximum((lens - k) // stride + 1, 0)
    cum = np.cumsum(nw)
    total = int(cum[-1]) if len(cum) else 0

    carry_p = np.zeros(0, np.int32)
    carry_pos = np.zeros(0, np.int64)
    done = 0
    while done < total:
        e0, e1 = done, min(done + max_emit, total)
        s0 = int(np.searchsorted(cum, e0, side="right"))
        s1 = int(np.searchsorted(cum, e1 - 1, side="right"))
        sel = np.arange(s0, s1 + 1)
        base = cum[sel] - nw[sel]
        m_lo = np.maximum(e0 - base, 0)
        m_hi = np.minimum(e1 - base, nw[sel])
        cnt = m_hi - m_lo
        n = int(cnt.sum())
        rep_start = np.repeat(run_starts[sel] + m_lo * stride, cnt)
        off = np.arange(n, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt)
        starts = rep_start + off * stride           # chromosome-local
        del rep_start, off
        a = int(starts[0])
        a -= a & 1
        b = min(int(starts[-1]) + k, length)
        ch = chars_range(a, b)
        codes = (ch >> np.uint8(1)) & np.uint8(3)
        loc = (starts - a).astype(np.int32)
        val = np.zeros(n, dtype=np.int32)
        idx = np.empty(n, dtype=np.int32)
        gat = np.empty(n, dtype=np.uint8)
        for j in range(k):
            np.left_shift(val, 2, out=val)
            np.add(loc, np.int32(j), out=idx)
            np.take(codes, idx, out=gat)
            np.bitwise_or(val, gat, out=val)
        del codes, ch, loc, idx, gat
        pos = starts + offset
        del starts

        nc = len(carry_p)
        if nc:
            p_all = np.concatenate([carry_p, val])
            pos_all = np.concatenate([carry_pos, pos])
        else:
            p_all, pos_all = val, pos
        m = len(p_all)
        keep = np.ones(m, dtype=bool)
        if m > 2:
            bins = pos_all >> bin_size
            same = np.zeros(m, dtype=bool)
            same[1:] = p_all[1:] == p_all[:-1]
            keep[2:] = ~(same[2:] & same[1:-1] & (bins[2:] == bins[1:-1]))
        carry_p = p_all[-2:].copy()
        carry_pos = pos_all[-2:].copy()
        keep[:nc] = False
        yield p_all[keep], pos_all[keep]
        done = e1


class KmerIndex:
    def __init__(self, k: int, bucket_start: np.ndarray, positions: np.ndarray,
                 bin_size: int, kmer_skip: int,
                 uniq_prefix: Optional[np.ndarray] = None):
        self.k = k
        # dense: bucket_start int64 [4^k + 1]; sparse: int64 [u + 1] over
        # the sorted unique prefixes in uniq_prefix
        self.bucket_start = bucket_start
        self.positions = positions        # positions_dtype(concat_len) [n]
        self.bin_size = bin_size
        self.kmer_skip = kmer_skip
        self.uniq_prefix = uniq_prefix

    # -- build -----------------------------------------------------------

    @classmethod
    def build(cls, ref: ReferenceGenome, k: int = 13, kmer_skip: int = 2,
              bin_size: int = 4, max_prefix_freq: int = 1000) -> "KmerIndex":
        """Streaming two-pass build (the reference's own shape:
        PrefixTable.cpp:202-231 count pass, 404-454 fill pass):

          * pass A streams deduped emission chunks per chromosome
            (_iter_chr_chunks, the CountKmer stage) accumulating the
            forward and revcomp frequency histograms; chunks are buffered
            only while the stream still might be tiny (sparse regime),
          * the frequency cutoff (PrefixTable.cpp:296-309: kept iff
            fwd+rc total <= mpf - ceil(mpf/100), poly-G never) yields the
            kept-bucket counts, hence bucket_start by cumsum,
          * pass B re-streams the chunks and scatters kept positions
            directly into their buckets (chunk-local packed-key sort +
            per-bucket write pointers) — within-bucket order is the global
            emission order, bit-identical to a monolithic stable sort.

        Peak memory is O(histograms + final table + one chunk) — ~7 GB at
        3 Gbp vs ~50 GB for the old monolithic concatenate+argsort build.
        """
        n_prefix = 4 ** k
        stride = kmer_skip + 1
        mpf = int(max_prefix_freq)
        pos_dt = positions_dtype(ref.concat_len)
        # used iff total < mpf AND int8 weight != 0, where weight =
        # int((mpf - total) * 100.0 / mpf) — for positive values that is
        # total <= mpf - ceil(mpf / 100), a single integer comparison
        thr = mpf - (mpf + 99) // 100

        def chunks():
            for ci in range(len(ref.names)):
                yield from _iter_chr_chunks(ref, int(ref.ref_start[ci]),
                                            int(ref.ref_len[ci]), k, stride,
                                            bin_size)

        # --- pass A: frequency histograms ------------------------------
        fwd_cnt = None          # allocated lazily (dense regime only)
        rc_sum = None
        n_total = 0
        buffered: Optional[List[Tuple[np.ndarray, np.ndarray]]] = []
        for p_chunk, pos_chunk in chunks():
            n_total += len(p_chunk)
            if buffered is not None and n_total * 16 < n_prefix:
                buffered.append((p_chunk, pos_chunk))
            else:
                if fwd_cnt is None:
                    fwd_cnt = np.zeros(n_prefix, dtype=np.int64)
                    rc_sum = np.zeros(n_prefix, dtype=np.int64)
                    for bp, _ in (buffered or []):
                        fwd_cnt += np.bincount(bp, minlength=n_prefix)
                        rc_sum += np.bincount(revcomp_prefix(bp, k),
                                              minlength=n_prefix)
                    buffered = None
                fwd_cnt += np.bincount(p_chunk, minlength=n_prefix)
                rc_sum += np.bincount(revcomp_prefix(p_chunk, k),
                                      minlength=n_prefix)

        if buffered is not None:
            # sparse regime (tiny genome, n_total * 16 < 4^k): unique-prefix
            # arithmetic on the buffered stream, never a 4^k-sized array
            prefixes = (np.concatenate([p for p, _ in buffered])
                        if buffered else np.zeros(0, np.int64))
            pos = (np.concatenate([q for _, q in buffered])
                   if buffered else np.zeros(0, np.int64))
            uniq, inv, cnt = np.unique(prefixes, return_inverse=True,
                                       return_counts=True)
            rc_u = revcomp_prefix(uniq, k)
            j = np.searchsorted(uniq, rc_u)
            jc = np.clip(j, 0, max(0, len(uniq) - 1))
            found = ((j < len(uniq)) & (uniq[jc] == rc_u) if len(uniq)
                     else np.zeros(0, bool))
            rc_cnt = np.where(found, cnt[jc], 0)
            total = cnt + rc_cnt
            used_u = total <= thr
            used_u &= uniq != (n_prefix - 1)  # poly-G (PrefixTable.cpp:289)
            keep = used_u[inv]

            prefixes = prefixes[keep]
            pos = _narrow(pos[keep], pos_dt)
            # stable sort by prefix via one packed int64 key (prefix <<
            # shift | stream index) — keeps within-bucket stream order
            shift = 63 - 2 * k
            assert len(prefixes) < (1 << shift)
            key = prefixes.astype(np.int64)
            np.left_shift(key, shift, out=key)
            np.bitwise_or(key, np.arange(len(key), dtype=np.int64), out=key)
            key.sort()
            order = np.bitwise_and(key, (1 << shift) - 1)
            positions = pos[order]
            np.right_shift(key, shift, out=key)
            sorted_prefix = key.astype(np.int32)
            del key, order
            if len(sorted_prefix) * 128 >= n_prefix:
                dt = np.int32 if len(sorted_prefix) < 2 ** 31 else np.int64
                bucket_start = np.zeros(n_prefix + 1, dtype=dt)
                np.cumsum(np.bincount(sorted_prefix, minlength=n_prefix),
                          dtype=dt, out=bucket_start[1:])
                return cls(k, bucket_start, positions, bin_size, kmer_skip)
            kept_uniq = np.unique(sorted_prefix)
            bucket_start = np.zeros(len(kept_uniq) + 1, dtype=np.int64)
            bucket_start[1:] = np.searchsorted(sorted_prefix, kept_uniq,
                                               side="right")
            return cls(k, bucket_start, positions, bin_size, kmer_skip,
                       uniq_prefix=kept_uniq)

        # --- dense regime: cutoff from histograms -----------------------
        # rc is a bijection, so bincount(rc(prefixes))[p] == freq[rc(p)]
        total = fwd_cnt + rc_sum
        used_p = total <= thr
        used_p[n_prefix - 1] = False      # poly-G (PrefixTable.cpp:289)
        kept_cnt = np.where(used_p, fwd_cnt, 0)
        del total, fwd_cnt, rc_sum
        total_kept = int(kept_cnt.sum())

        dt = np.int32 if total_kept < 2 ** 31 else np.int64
        bucket_start = np.zeros(n_prefix + 1, dtype=dt)
        np.cumsum(kept_cnt, dtype=dt, out=bucket_start[1:])

        # --- pass B: scatter kept positions into their buckets ----------
        positions = np.empty(total_kept, dtype=pos_dt)
        write_ptr = bucket_start[:-1].astype(np.int64)
        shift = 63 - 2 * k
        for p_chunk, pos_chunk in chunks():
            keep = used_p[p_chunk]
            p2 = p_chunk[keep]
            pos2 = _narrow(pos_chunk[keep], pos_dt)
            n = len(p2)
            if n == 0:
                continue
            # chunk-local stable sort by prefix (stream order within runs)
            key = p2.astype(np.int64)
            np.left_shift(key, shift, out=key)
            np.bitwise_or(key, np.arange(n, dtype=np.int64), out=key)
            key.sort()
            order = np.bitwise_and(key, (1 << shift) - 1)
            np.right_shift(key, shift, out=key)
            sp = key.astype(np.int32)
            ps = pos2[order]
            del key, order
            newrun = np.empty(n, dtype=bool)
            newrun[0] = True
            np.not_equal(sp[1:], sp[:-1], out=newrun[1:])
            run_starts = np.nonzero(newrun)[0]
            run_lens = np.diff(np.append(run_starts, n))
            rank = np.arange(n, dtype=np.int64) - np.repeat(run_starts,
                                                            run_lens)
            uniqp = sp[run_starts]
            dest = write_ptr[sp] + rank
            positions[dest] = ps
            write_ptr[uniqp] += run_lens

        if total_kept * 128 >= n_prefix:
            return cls(k, bucket_start, positions, bin_size, kmer_skip)
        # pathological dense-cutoff/sparse-rep corner (heavy cutoff): keep
        # the old sparse representation contract
        kept_uniq = np.nonzero(kept_cnt)[0].astype(np.int32)
        bs = np.zeros(len(kept_uniq) + 1, dtype=np.int64)
        np.cumsum(kept_cnt[kept_uniq], out=bs[1:])
        return cls(k, bs, positions, bin_size, kmer_skip,
                   uniq_prefix=kept_uniq)

    # -- cache -------------------------------------------------------------

    @classmethod
    def load_or_build(cls, ref: ReferenceGenome, ref_path: str, k: int = 13,
                      kmer_skip: int = 2, bin_size: int = 4,
                      max_prefix_freq: int = 1000, use_cache: bool = True,
                      skip_save: bool = False) -> "KmerIndex":
        cache = f"{ref_path}-ht-{k}-{kmer_skip}.torch.npz"
        if use_cache and os.path.exists(cache):
            idx = cls._load_cache(cache, k, kmer_skip, bin_size,
                                  ref.concat_len)
            if idx is not None:
                return idx
        idx = cls.build(ref, k, kmer_skip, bin_size, max_prefix_freq)
        if use_cache and not skip_save:
            try:
                extra = ({"uniq_prefix": idx.uniq_prefix}
                         if idx.uniq_prefix is not None else {})
                np.savez(cache, cookie=np.int64(INDEX_COOKIE), version=np.int64(INDEX_VERSION),
                         k=np.int64(k), kmer_skip=np.int64(kmer_skip),
                         bucket_start=idx.bucket_start, positions=idx.positions,
                         **extra)
            except OSError:
                pass
        return idx

    @classmethod
    def _load_cache(cls, cache: str, k: int, kmer_skip: int,
                    bin_size: int, concat_len: int) -> Optional["KmerIndex"]:
        """The cached index, or None (rebuild) when its header or its
        positions' type does not match: a uint32 table of a genome past
        2^32 was written by a build that wrapped its positions."""
        try:
            with np.load(cache, allow_pickle=False) as z:
                if (int(z["cookie"]) != INDEX_COOKIE or int(z["version"]) != INDEX_VERSION
                        or int(z["k"]) != k or int(z["kmer_skip"]) != kmer_skip):
                    return None
                positions = z["positions"]
                if positions.dtype != positions_dtype(concat_len):
                    return None
                uniq = z["uniq_prefix"] if "uniq_prefix" in z.files else None
                return cls(k, z["bucket_start"], positions, bin_size,
                           kmer_skip, uniq_prefix=uniq)
        except Exception:
            return None

    # -- lookup ------------------------------------------------------------

    def bucket_of(self, prefixes: np.ndarray):
        """(starts, counts) of each prefix's position bucket (vectorized),
        independent of the dense/sparse representation."""
        if self.uniq_prefix is None:
            starts = self.bucket_start[prefixes]
            counts = self.bucket_start[prefixes + 1] - starts
            return starts, counts
        u = len(self.uniq_prefix)
        i = np.searchsorted(self.uniq_prefix, prefixes)
        ic = np.clip(i, 0, max(0, u - 1))
        found = (i < u) & (self.uniq_prefix[ic] == prefixes) if u else \
            np.zeros(len(prefixes), bool)
        starts = np.where(found, self.bucket_start[ic], 0)
        counts = np.where(found,
                          self.bucket_start[ic + 1] - self.bucket_start[ic], 0)
        return starts, counts

    def lookup(self, prefix: int) -> np.ndarray:
        starts, counts = self.bucket_of(np.asarray([prefix]))
        return self.positions[int(starts[0]):int(starts[0] + counts[0])]

    def counts_for(self, prefixes: np.ndarray) -> np.ndarray:
        return self.bucket_of(prefixes)[1]

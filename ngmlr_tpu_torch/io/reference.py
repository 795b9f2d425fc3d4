"""Reference genome store: encoding, concatenated coordinate space, decoding.

Rebuild of the reference's _SequenceProvider (ngmlr src/SequenceProvider.cpp):

  * base codes A=0,T=1,G=2,C=3,N/other=4 (enc4, SequenceProvider.cpp:76-89),
  * all chromosomes concatenated into ONE coordinate space with a 1000-base
    leading pad and 1000-base N spacers after every chromosome; chromosomes
    with odd length get one extra N pad base (SequenceProvider.cpp:337-374),
  * chromosomes shorter than minRefSeqLen=10 are skipped
    (SequenceProvider.h:79, SequenceProvider.cpp:348),
  * concat length is reported as total_bases - 1 (SequenceProvider.cpp:638-640),
  * convert() maps a concat position back to (ref_id, local_pos) via an
    upper-bound search over chromosome start positions; positions landing in
    the 1000-base spacer before the next chromosome are unmapped
    (SequenceProvider.cpp:180-205),
  * decode windows reproduce the reference's exact output quirks (odd
    position/length handling, 'x' fill past the genome/chromosome end:
    SequenceProvider.cpp:475-625) because downstream scoring/alignment is
    sensitive to them ('x' is scored as mismatch*100 in the convex DP,
    ConvexAlign.cpp:512-513).

Storage here is a flat uint8 code array (one byte per base) in an .npz cache,
replacing the reference's nibble-packed `<ref>-enc.2.ngm` cache
(SequenceProvider.cpp:207-272). The byte layout feeds numpy/JAX directly.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple
import os

import numpy as np

from .fastx import parse_fastx

MIN_REF_SEQ_LEN = 10        # SequenceProvider.h:79
MAX_REF_NAME_LENGTH = 100   # SequenceProvider.h:39
SPACER = 1000               # leading pad / inter-chromosome spacer (bases)
CACHE_COOKIE = 0x74656      # SequenceProvider.cpp:38
CACHE_VERSION = 1

CODE_N = 4
CODE2CHAR = np.frombuffer(b"ATGCN", dtype=np.uint8)

# char -> code (enc4): A=0,T=1,G=2,C=3, everything else 4
_CHAR2CODE = np.full(256, CODE_N, dtype=np.uint8)
for _i, _c in enumerate(b"ATGC"):
    _CHAR2CODE[_c] = _i
    _CHAR2CODE[_c + 32] = _i


@dataclass
class Chromosome:
    """Return value of getChrStart/getChrBorders (SequenceProvider.h)."""
    start: int
    end: int


class ReferenceGenome:
    """Concatenated, encoded reference with the ngmlr coordinate system."""

    def __init__(self, codes: np.ndarray, names: List[bytes],
                 ref_start: np.ndarray, ref_len: np.ndarray):
        self.codes = codes                  # uint8 [total_bases]
        self.names = names                  # per kept chromosome
        self.ref_start = ref_start          # int64 [n_chroms] concat start
        self.ref_len = ref_len              # int64 [n_chroms] unpadded length
        # refStartPos with artificial terminator (SequenceProvider.cpp:415-424)
        self.ref_start_pos = np.concatenate([
            ref_start.astype(np.int64),
            np.asarray([int(ref_start[-1]) + int(ref_len[-1]) + SPACER], dtype=np.int64),
        ])
        # DualStrand doubling: ref ids are even (fwd) (SequenceProvider.cpp:404-405)
        self.ref_count = 2 * len(names)
        # TableUnit analog (>4.29 Gbp genomes; PrefixTable.h:58-75,
        # DIVERGENCES #5): device coordinates are uint32, so a genome whose
        # code array exceeds one 2^UNIT_SLAB_BITS slab is addressed as
        # (unit, local) pairs. Units are fixed-size aligned slabs with a
        # halo overlap of UNIT_HALO, so any decode window of length
        # <= UNIT_HALO starting in slab u = ds >> UNIT_SLAB_BITS lies
        # entirely in that unit's device plane. Slabs are 16-aligned, so
        # diagonal bins decompose as global_bin = local_bin + (base >> 4).
        # NGMLR_TPU_UNIT_SLAB_BITS shrinks slabs for CI-scale unit tests.
        self.unit_bits = int(os.environ.get("NGMLR_TPU_UNIT_SLAB_BITS",
                                            "31"))
        slab = 1 << self.unit_bits
        self.unit_halo = min(1 << 24, max(1 << 20, slab >> 3))
        # units only engage when flat uint32 addressing (2 slabs' worth:
        # 2^32 bases at the default 2^31 slab) no longer covers the
        # genome — a <= 4.29 Gbp genome stays exactly on the flat path
        if len(self.codes) + 16 <= 2 * slab:
            self.n_units = 1
        else:
            self.n_units = -(-len(self.codes) // slab)
        # device plane length (clipped at the genome end for the last unit)
        self.unit_plane_len = min(slab + self.unit_halo, len(self.codes))

    def _unitize_desc(self, ds: int, hi: int, diff: int, W: int):
        """Absolute (ds, hi) -> unit-local RefDesc when multi-unit."""
        from ..ops.device_engine import RefDesc
        if self.n_units <= 1:
            return RefDesc(ds=ds, diff=diff, hi=hi, W=W)
        u = ds >> self.unit_bits
        base = u << self.unit_bits
        assert W < (1 << 28), "window exceeds the unit W packing"
        assert hi - ds <= self.unit_halo, "window exceeds the unit halo"
        return RefDesc(ds=ds - base, diff=diff, hi=hi - base,
                       W=W, unit=int(u))

    # -- construction ---------------------------------------------------

    @classmethod
    def from_fasta(cls, path: str, use_cache: bool = True,
                   skip_save: bool = False) -> "ReferenceGenome":
        cache = path + "-enc.torch.npz"
        if use_cache and os.path.exists(cache):
            ref = cls._load_cache(cache)
            if ref is not None:
                return ref
        ref = cls._encode_fasta(path)
        if use_cache and not skip_save:
            try:
                np.savez(cache, cookie=np.int64(CACHE_COOKIE), version=np.int64(CACHE_VERSION),
                         codes=ref.codes, ref_start=ref.ref_start, ref_len=ref.ref_len,
                         names=np.asarray([n.decode() for n in ref.names]))
            except OSError:
                pass
        return ref

    @classmethod
    def _load_cache(cls, cache: str) -> Optional["ReferenceGenome"]:
        try:
            with np.load(cache, allow_pickle=False) as z:
                if int(z["cookie"]) != CACHE_COOKIE or int(z["version"]) != CACHE_VERSION:
                    return None
                names = [str(n).encode() for n in z["names"]]
                return cls(z["codes"], names, z["ref_start"], z["ref_len"])
        except Exception:
            return None

    @classmethod
    def _encode_fasta(cls, path: str) -> "ReferenceGenome":
        chunks = [np.full(SPACER, CODE_N, dtype=np.uint8)]  # leading pad
        names: List[bytes] = []
        starts: List[int] = []
        lens: List[int] = []
        pos = SPACER
        for rec in parse_fastx(path):
            if len(rec.seq) <= MIN_REF_SEQ_LEN:
                continue
            names.append(rec.name[:MAX_REF_NAME_LENGTH])
            starts.append(pos)
            lens.append(len(rec.seq))
            codes = _CHAR2CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
            chunks.append(codes)
            pos += len(codes)
            pad = (len(codes) & 1) + SPACER   # pad odd chromosome to even + spacer
            chunks.append(np.full(pad, CODE_N, dtype=np.uint8))
            pos += pad
        if not names:
            raise ValueError(f"No usable reference sequences in {path}")
        codes = np.concatenate(chunks)
        assert len(codes) % 2 == 0
        return cls(codes, names,
                   np.asarray(starts, dtype=np.int64), np.asarray(lens, dtype=np.int64))

    # -- coordinate space ------------------------------------------------

    @property
    def concat_len(self) -> int:
        """GetConcatRefLen() == total bases - 1 (SequenceProvider.cpp:638-640)."""
        return len(self.codes) - 1

    def name_of(self, ref_id: int) -> bytes:
        return self.names[ref_id >> 1]

    def len_of(self, ref_id: int) -> int:
        return int(self.ref_len[ref_id >> 1])

    def convert(self, position: int) -> Optional[Tuple[int, int]]:
        """Concat position -> (ref_id, local_pos); None if in a spacer.

        SequenceProvider.cpp:180-205.
        """
        upper = int(np.searchsorted(self.ref_start_pos, position, side="right"))
        if upper >= len(self.ref_start_pos):
            return None
        if int(self.ref_start_pos[upper]) - position < SPACER:
            return None
        start = int(self.ref_start_pos[upper - 1])
        return 2 * (upper - 1), position - start

    def get_chr_start(self, position: int) -> Chromosome:
        """SequenceProvider.cpp:157-178."""
        sp = self.ref_start_pos
        upper = int(np.searchsorted(sp, position, side="right"))
        if upper >= len(sp):
            return Chromosome(int(sp[-1]), self.concat_len)
        if int(sp[upper]) - position < SPACER:
            upper += 1
        if upper >= len(sp):
            return Chromosome(int(sp[-1]), self.concat_len)
        return Chromosome(int(sp[upper - 1]), int(sp[upper]) - SPACER)

    def get_chr_borders(self, start: int, stop: int) -> Chromosome:
        """SequenceProvider.cpp:115-155. Returns (0,0) if spanning chromosomes."""
        if start > stop:
            start, stop = stop, start
        if start < SPACER:
            start = SPACER + 1
            stop = max(SPACER + 2, stop)
        sp = self.ref_start_pos
        upper_start = int(np.searchsorted(sp, start, side="right"))
        if upper_start < len(sp) and int(sp[upper_start]) - start < SPACER:
            upper_start += 1
        upper_stop = int(np.searchsorted(sp, stop, side="right"))
        if upper_start == upper_stop and 0 < upper_start < len(sp):
            return Chromosome(int(sp[upper_start - 1]), int(sp[upper_start]) - SPACER)
        return Chromosome(0, 0)

    # -- decoding ---------------------------------------------------------

    def decode_window(self, position: int, buffer_length: int) -> Optional[bytes]:
        """DecodeRefSequence (SequenceProvider.cpp:567-625), exact quirks:

          * decodes len = buffer_length - 2 bases from `position`,
          * past-the-end bases become 'x',
          * odd `len` truncates the last decoded base to 'x',
          * odd `position` emits one extra leading... (net effect: one extra
            trailing base when len is even) — reproduced via the byte-pair
            arithmetic of the original.
        """
        length = buffer_length - 2
        if position >= self.concat_len or position < 0:
            return None
        end = 0
        if position + length > self.concat_len:
            end = (position + length) - self.concat_len
            length -= end
        out = bytearray()
        p = position
        if p & 1:
            out.append(CODE2CHAR[self.codes[p]])
            first_pair_base = p + 1
        else:
            first_pair_base = p
        npairs = (length + 1) // 2
        hi = first_pair_base + 2 * npairs
        out += CODE2CHAR[self.codes[first_pair_base:hi]].tobytes()
        if length & 1:
            out[-1] = ord("x")
        out += b"x" * end
        return bytes(out)

    # -- device window descriptors (see ngmlr_tpu.ops.device_engine.RefDesc)

    def decode_window_desc(self, position: int, buffer_length: int):
        """Descriptor twin of decode_window: the decoded byte at window
        index i is CODE2CHAR[codes[ds + i]] for i < hi - ds (contiguous
        span), 'x'/absent beyond. Returns None exactly when decode_window
        does."""
        length = buffer_length - 2
        if position >= self.concat_len or position < 0:
            return None
        end = 0
        if position + length > self.concat_len:
            end = (position + length) - self.concat_len
            length -= end
        d = (position & 1) + 2 * ((length + 1) // 2)
        hi = min(position + d, len(self.codes))
        return self._unitize_desc(position, hi, 0, (hi - position) + end)

    def decode_exact_desc(self, start_position: int, sequence_length: int):
        """Descriptor twin of decode_exact (corridor == 0, the only case the
        pipeline uses). Relies on chromosome starts/ends being even (leading
        pad 1000 + even per-chromosome padding), which makes the decoded
        span exactly [ds, hi)."""
        from ..ops.device_engine import RefDesc
        if start_position >= self.concat_len or start_position < 0:
            return None
        W = sequence_length - 1
        chrom = self.get_chr_start(start_position)
        decode_start = start_position
        end_position = start_position + sequence_length
        decode_end = end_position
        if end_position > chrom.end:
            decode_end -= (end_position - chrom.end)
        if decode_start < chrom.start:
            if decode_end > chrom.start:
                diff = chrom.start - decode_start
                ds = chrom.start
            else:
                return RefDesc(ds=0, diff=0, hi=0, W=W)  # fully in spacer
        else:
            diff = 0
            ds = decode_start
        first_pair = ds + 1 if (ds & 1) else ds
        hi = min(first_pair + 2 * ((decode_end - ds + 1) // 2),
                 len(self.codes))
        return self._unitize_desc(ds, hi, diff, W)

    def _decode_span(self, start_pos: int, end_pos: int) -> bytes:
        """decode() (SequenceProvider.cpp:475-490): bases [start, ~end]."""
        out = bytearray()
        p = start_pos
        if p & 1:
            out.append(CODE2CHAR[self.codes[p]])
            first_pair_base = p + 1
        else:
            first_pair_base = p
        npairs = (end_pos - start_pos + 1) // 2
        hi = min(first_pair_base + 2 * npairs, len(self.codes))
        out += CODE2CHAR[self.codes[first_pair_base:hi]].tobytes()
        return bytes(out)

    def decode_exact(self, start_position: int, sequence_length: int,
                     corridor: int = 0) -> Optional[bytes]:
        """DecodeRefSequenceExact (SequenceProvider.cpp:493-565).

        Returns a byte string of length exactly sequence_length - 1 where
        undecoded positions (outside the chromosome) are 'x'.
        """
        if start_position >= self.concat_len or start_position < 0:
            return None
        buf = bytearray(b"x" * sequence_length)
        half = corridor // 2
        chrom = self.get_chr_start(start_position)
        decode_start = start_position - half
        end_position = start_position + sequence_length - half
        decode_end = end_position
        if end_position > chrom.end:
            decode_end -= (end_position - chrom.end)
        if half > start_position:
            decode_start = chrom.start
            diff = half - decode_start + SPACER - (start_position - chrom.start)
            dec = self._decode_span(decode_start, decode_end)
            buf[diff:diff + len(dec)] = dec
        elif decode_start < chrom.start:
            if decode_end > chrom.start:
                diff = chrom.start - decode_start
                dec = self._decode_span(chrom.start, decode_end)
                buf[diff:diff + len(dec)] = dec
            # else: fully in spacer; stays 'x'
        else:
            dec = self._decode_span(decode_start, decode_end)
            buf[: len(dec)] = dec
        return bytes(buf[: sequence_length - 1])

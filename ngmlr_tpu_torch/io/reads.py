"""Read intake: parsing, subread splitting, read-ID assignment.

Rebuild of ReadProvider (ngmlr src/ReadProvider.cpp) and the batch
intake in NGM (ngmlr src/NGM.cpp:190-246):

  * reads longer than read_part_length (256) are split into
    floor(len/256) non-overlapping 256-base subreads taken from the start of
    the read; the < 256-base tail is not covered by any subread
    (ReadProvider.cpp:57-134),
  * reads of length <= 256 go through the short-read path un-split,
  * read IDs advance by idJump=2000 per input read, reserving ID space for
    subreads (NGM.cpp:208-232); subread i gets parent_id + i,
  * empty-sequence records are parsed but silently discarded downstream
    (IParser.h:79-84, GenericReadWriter.h:98-100).
"""

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from .fastx import FastxRecord, parse_fastx, reverse_complement

ID_JUMP = 2000  # NGM.cpp:208


@dataclass
class Read:
    """A full input read (the reference's MappedRead for the full read)."""
    read_id: int
    name: bytes
    seq: bytes
    qual: Optional[bytes]
    empty: bool = False
    buf_offset: int = -1    # absolute offset in the device read-code buffer

    _rev: Optional[bytes] = field(default=None, repr=False)

    @property
    def length(self) -> int:
        return len(self.seq)

    @property
    def rev_seq(self) -> bytes:
        if self._rev is None:
            self._rev = reverse_complement(self.seq)
        return self._rev

    def subread_count(self, part_length: int = 256) -> int:
        """ReadProvider.cpp:60 — floor split; 0 means 'short read path'."""
        if self.length <= part_length:
            return 0
        return self.length // part_length

    def subread_seq(self, i: int, part_length: int = 256) -> bytes:
        return self.seq[i * part_length:(i + 1) * part_length]


@dataclass(frozen=True)
class SeqView:
    """A (slice, revcomp?) view of a read — the only query shape the whole
    pipeline ever aligns or scores (extractReadSeq semantics,
    AlignmentBuffer.cpp:1515-1549). Carries both the host bytes (lazily) and
    the device descriptor (read buffer offset)."""
    read: Read
    start: int
    length: int
    rev: bool

    def __len__(self) -> int:
        return self.length

    def to_bytes(self) -> bytes:
        sub = self.read.seq[self.start:self.start + self.length]
        return reverse_complement(sub) if self.rev else sub

    def sub(self, a: int, b: int) -> "SeqView":
        """View of self[a:b] (b > a)."""
        n = b - a
        if not self.rev:
            return SeqView(self.read, self.start + a, n, False)
        return SeqView(self.read, self.start + self.length - b, n, True)

    def revcomp(self) -> "SeqView":
        return SeqView(self.read, self.start, self.length, not self.rev)

    def desc(self):
        from ..ops.device_engine import QryDesc
        return QryDesc(self.read.buf_offset + self.start, self.length, self.rev)


def read_stream(path: str, start_id: int = 0) -> Iterator[Read]:
    """Read ids replicate _NGM::GetNextReadBatch (NGM.cpp:190-246): each
    intake batch of 10 non-empty reads passes ids m_CurStart + i*idJump
    where i counts ALL parse attempts in the batch (empty records included)
    and m_CurStart grows by the non-empty count — so ids are NOT globally
    monotonic. SAM output never shows them, but the --stdout debug dumps
    do, and byte-parity requires the same numbers."""
    cur_start = start_id
    i_in_batch = 0
    count_in_batch = 0
    for rec in parse_fastx(path):
        rid = cur_start + i_in_batch * ID_JUMP
        yield Read(rid, rec.name, rec.seq, rec.qual, empty=rec.empty)
        i_in_batch += 1
        if not rec.empty:
            count_in_batch += 1
            if count_in_batch == 10:      # cBatchSize (CS.cpp:34)
                cur_start += count_in_batch
                i_in_batch = 0
                count_in_batch = 0


def read_batches(path: str, batch_reads: int, shard: int = 0,
                 n_shards: int = 1) -> Iterator[List[Read]]:
    """Batch intake; with n_shards > 1 only every n_shards-th read (by
    intake order, offset `shard`) is yielded — the multi-host input
    sharding of SURVEY §2.11 (reads are embarrassingly parallel; read ids
    keep their global values so shard outputs merge deterministically)."""
    batch: List[Read] = []
    for i, read in enumerate(read_stream(path)):
        if n_shards > 1 and i % n_shards != shard:
            continue
        batch.append(read)
        if len(batch) >= batch_reads:
            yield batch
            batch = []
    if batch:
        yield batch

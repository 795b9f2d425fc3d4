"""FASTA/FASTQ (optionally gzipped) streaming parser.

Host-side replacement for the reference's vendored kseq.h
(ngmlr src/kseq.h) + IParser (ngmlr src/IParser.h:50-148):

  * record name = text up to the first whitespace, truncated to 249 chars
    (IParser.h:22: MAX_READNAME_LENGTH=250, copyToRead keeps 249 + NUL),
  * sequence uppercased, non-ACGT mapped to 'N' (IParser.h:66-76),
  * quality kept verbatim when present (length must match),
  * empty-sequence records are flagged (IParser.h:79-84 marks them Empty;
    GenericReadWriter.h:98-100 silently discards them).
"""

from dataclasses import dataclass
import gzip
import io
from typing import Iterator, Optional

MAX_READNAME_LENGTH = 250  # IParser.h:22

_COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")

# Translate: uppercase + non-ACGT -> N  (IParser.h:66-76)
_NORM = bytearray(b"N" * 256)
for _b in b"ACGT":
    _NORM[_b] = _b
    _NORM[_b + 32] = _b  # lowercase
_NORM = bytes(_NORM)


def reverse_complement(seq: bytes) -> bytes:
    return seq.translate(_COMPLEMENT)[::-1]


@dataclass
class FastxRecord:
    name: bytes          # truncated read name
    seq: bytes           # normalized sequence (ACGTN)
    qual: Optional[bytes]  # None for FASTA
    empty: bool = False


def _open_maybe_gz(path: str):
    if path == "-" or path == "/dev/stdin":
        import sys
        raw = sys.stdin.buffer
    else:
        raw = open(path, "rb")
    head = raw.peek(2) if hasattr(raw, "peek") else b""
    if not hasattr(raw, "peek"):
        raw = io.BufferedReader(raw)
        head = raw.peek(2)
    if head[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=raw))
    return raw


def parse_fastx(path: str) -> Iterator[FastxRecord]:
    """Yield normalized records from a FASTA/FASTQ file (gz ok, stdin ok)."""
    fh = _open_maybe_gz(path)
    line = fh.readline()
    while line:
        line = line.strip()
        if not line:
            line = fh.readline()
            continue
        if line.startswith(b">"):
            name = line[1:].split(None, 1)[0] if len(line) > 1 else b""
            seq_parts = []
            line = fh.readline()
            while line and not line.startswith(b">") and not line.startswith(b"@"):
                seq_parts.append(line.strip())
                line = fh.readline()
            seq = b"".join(seq_parts).translate(_NORM)
            yield FastxRecord(name[: MAX_READNAME_LENGTH - 1], seq, None, empty=(len(seq) == 0))
        elif line.startswith(b"@"):
            name = line[1:].split(None, 1)[0] if len(line) > 1 else b""
            seq = fh.readline().strip()
            plus = fh.readline()
            qual = fh.readline().strip()
            if plus and not plus.startswith(b"+"):
                raise ValueError("Malformed FASTQ record near %r" % name)
            if len(qual) != len(seq):
                raise ValueError(
                    "Read %s: Length of read not equal length of quality values." % name.decode()
                )
            nseq = seq.translate(_NORM)
            yield FastxRecord(
                name[: MAX_READNAME_LENGTH - 1], nseq, qual if qual else None, empty=(len(nseq) == 0)
            )
            line = fh.readline()
        else:
            raise ValueError("Unrecognized FASTA/FASTQ line: %r" % line[:40])

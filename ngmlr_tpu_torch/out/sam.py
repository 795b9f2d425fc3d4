"""SAM output, byte-compatible with the reference writer.

Rebuild of SAMWriter (ngmlr src/SAMWriter.cpp) and the
GenericReadWriter record loop (GenericReadWriter.h:76-107):

  * flags: 0x10 reverse, 0x800 non-primary, 0x4 unmapped,
  * per-record columns and the exact tag set/order:
    AS NM XI XS XE XR MD SV [SA] QS QE CV,
  * SA:Z: enumerates all other non-skipped alignments of the read,
  * quality strings are reversed in place per reverse-strand record
    (cumulative, as upstream: SAMWriter.cpp:104-110),
  * unmapped reads get a minimal 0x4 record unless suppressed.
"""

from typing import IO, List, Optional

import numpy as np

from .. import __version__
from ..config import Config
from ..io.reads import Read
from ..io.reference import ReferenceGenome
from ..chain.structs import c_round
from ..pipeline.longread import AlignmentRecord

REPORT_OFFSET = 1


class SamWriter:
    def __init__(self, ref: ReferenceGenome, cfg: Config, stream: IO[bytes]):
        self.ref = ref
        self.cfg = cfg
        self.out = stream
        self.lines = 0   # alignment lines written (NGM.GetWrittenReadCount)
        self.supplementary = 0   # of them, records flagged 0x800

    # ------------------------------------------------------------------

    def write_prolog(self):
        w = self.out.write
        w(b"@HD\tVN:1.0\tSO:unsorted\n")
        for i in range(len(self.ref.names)):
            name = self.ref.names[i].decode()
            w(f"@SQ\tSN:{name}\tLN:{int(self.ref.ref_len[i])}\n".encode())
        w(f"@PG\tID:ngmlr\tPN:nextgenmap-lr\tVN:{__version__}\t"
          f"CL:{self.cfg.full_command_line}\n".encode())
        if self.cfg.rg_id:
            parts = [f"@RG\tID:{self.cfg.rg_id}"]
            for key in ("SM", "LB", "PL", "DS", "DT", "PU", "PI", "PG", "CN",
                        "FO", "KS"):
                val = self.cfg.rg_fields.get(key)
                if val:
                    parts.append(f"{key}:{val}")
            w(("\t".join(parts) + "\n").encode())

    # ------------------------------------------------------------------

    def write_read(self, read: Read, records: List[AlignmentRecord],
                   mapped: bool):
        """GenericReadWriter::WriteRead (GenericReadWriter.h:80-107) +
        AlignmentBuffer::WriteRead conversion (AlignmentBuffer.cpp:3470-3484)."""
        if read.empty:
            return
        if mapped:
            for rec in records:
                conv = self.ref.convert(rec.location)
                if conv is None:
                    rec.ref_id, rec.local_pos = 0, rec.location
                    mapped = False
                else:
                    rec.ref_id, rec.local_pos = conv
                    mapped = True
        mapped_once = False
        if mapped:
            for i, rec in enumerate(records):
                if rec.align.skip:
                    continue
                mapped_once = True
                self._write_record(read, records, i)
        if not mapped_once:
            self._write_unmapped(read)

    # ------------------------------------------------------------------

    def _write_record(self, read: Read, records: List[AlignmentRecord],
                      idx: int):
        rec = records[idx]
        a = rec.align
        flags = 0
        if not a.primary:
            flags |= 0x800
            self.supplementary += 1
        readseq = read.seq
        qual: Optional[bytes] = read.qual
        if rec.reverse:
            readseq = read.rev_seq
            if read.qual is not None and len(read.qual) > 0:
                # cumulative in-place reversal, as upstream
                read.qual = read.qual[::-1]
                qual = read.qual
            flags |= 0x10

        refname = self.ref.name_of(rec.ref_id).decode()
        hard = self.cfg.hard_clip
        if hard:
            seq_field = readseq[a.qstart:read.length - a.qend]
        else:
            seq_field = readseq
        if qual is not None:
            qual_field = (qual[a.qstart:read.length - a.qend] if hard else qual)
            qual_str = qual_field.decode()
        else:
            qual_str = "*"

        cigar = a.cigar
        long_cigar = (self.cfg.bam_cigar_fix and not a.skip
                      and a.cigar_op_count >= 0x10000)
        if long_cigar:
            clip_len = (read.length - a.qstart - a.qend) if hard else read.length
            cigar = f"{clip_len}S"

        fields = [
            read.name.decode(),
            str(flags),
            refname,
            str(rec.local_pos + REPORT_OFFSET),
            str(a.mq),
            cigar,
            "*", str(-1 + REPORT_OFFSET), str(0),
            seq_field.decode(),
            qual_str,
        ]
        tags = []
        if self.cfg.rg_id:
            tags.append(f"RG:Z:{self.cfg.rg_id}")
        tags.append(f"AS:i:{int(rec.score)}")
        tags.append(f"NM:i:{a.nm}")
        identity = c_round(a.identity * 10000.0) / 10000.0
        tags.append("XI:f:%g" % identity)
        tags.append("XS:i:0")
        tags.append(f"XE:i:{int(rec.score)}")
        tags.append(f"XR:i:{read.length - a.qstart - a.qend}")
        tags.append(f"MD:Z:{a.md}")
        if a.sv_type > -1:
            tags.append(f"SV:i:{a.sv_type}")
        if len(records) > 1:
            sa_parts = []
            for j, other in enumerate(records):
                if j == idx or other.align.skip:
                    continue
                oname = self.ref.name_of(other.ref_id).decode()
                strand = "-" if other.reverse else "+"
                sa_parts.append(f"{oname},{other.local_pos + REPORT_OFFSET},"
                                f"{strand},{other.align.cigar},"
                                f"{other.align.mq},{other.align.nm};")
            if sa_parts:
                tags.append("SA:Z:" + "".join(sa_parts))
        tags.append(f"QS:i:{a.qstart}")
        tags.append(f"QE:i:{read.length - a.qend}")
        clipped = a.qstart + a.qend
        # float32 arithmetic as upstream (SAMWriter.cpp:198-200)
        covered = np.float32(read.length - clipped) * np.float32(100.0) / np.float32(read.length)
        tags.append("CV:f:%f" % float(covered))
        if long_cigar:
            cg = ["CG:B:I"]
            import re
            for num, op in re.findall(r"(\d+)([MIDNSHP=X])", a.cigar):
                opcode = "MIDNSHP=X".index(op)
                cg.append(",%d" % ((int(num) << 4) | opcode))
            tags.append("".join(cg))

        self.out.write(("\t".join(fields + tags) + "\n").encode())
        self.lines += 1

    def _write_unmapped(self, read: Read, flags: int = 0):
        """DoWriteUnmappedReadGeneric (SAMWriter.cpp:308-362)."""
        if not self.cfg.write_unmapped:
            return
        flags |= 0x4
        qual = read.qual.decode() if read.qual is not None else "*"
        fields = [
            read.name.decode(), str(flags), "*", str(-1 + REPORT_OFFSET),
            "0", "*", "*", str(-1 + REPORT_OFFSET), "0",
            read.seq.decode(), qual,
        ]
        if self.cfg.rg_id:
            fields.append(f"RG:Z:{self.cfg.rg_id}")
        self.out.write(("\t".join(fields) + "\n").encode())
        self.lines += 1

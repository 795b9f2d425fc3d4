"""Configuration for ngmlr_tpu.

Mirrors the tunables (and defaults) of the reference's IConfig
(ngmlr src/IConfig.h:23-97) plus the CLI semantics of
ArgParser (ngmlr src/ArgParser.cpp:200-270):

  * score signs are normalized (match >= 0, mismatch/gap <= 0, decay >= 0),
  * preset "pacbio" is the default; preset "ont" only changes the gap-decay
    default (ArgParser.cpp:257-269 — the other overrides are commented out
    upstream),
  * low-quality split and small-inversion detection default to ON
    (ArgParser.cpp:248-249: flags are "--no-lowqualitysplit"/"--no-smallinv").
"""

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass
class Config:
    # Filters (IConfig.h:23-25)
    min_identity: float = 0.65
    min_residues: float = 0.25
    sensitivity: float = 0.8

    # Seeding (IConfig.h:27-36)
    bin_size: int = 4              # diagonal bin = pos >> bin_size
    kmer_length: int = 13
    kmer_skip: int = 2             # reference-side k-mer stride
    max_prefix_freq: int = 1000    # PrefixTable.cpp:28 (not CLI-exposed)
    min_kmer_hits: int = 0
    max_cmrs: int = 2 ** 31 - 1

    # Long-read split (IConfig.h:40-41)
    read_part_corridor: int = 40
    read_part_length: int = 256

    # Segmentation (IConfig.h:32-38)
    min_inversion_length: int = 70
    max_segment_number_per_kb: int = 1
    max_clis_runs: int = 100

    # Alignment scores (IConfig.h:50-55)
    score_match: float = 2.0
    score_mismatch: float = -5.0
    score_gap_open: float = -5.0
    score_gap_extend_max: float = -5.0
    score_gap_extend_min: float = -1.0
    score_gap_decay: float = 0.15

    inv_score_ratio: float = 1.0   # IConfig.h:49
    max_matrix_size_mb: int = 10000  # IConfig.h:47 (no CLI flag upstream)

    # Behaviour flags (IConfig.h:57-71, ArgParser.cpp:246-255)
    low_quality_split: bool = True
    small_inversion_detection: bool = True
    write_unmapped: bool = True
    hard_clip: bool = False
    skip_save: bool = False
    bam_cigar_fix: bool = False

    # Debug / parity flags (ArgParser.cpp:240-255; vcf/bed-filter/print-all
    # are parsed but consumed nowhere upstream — same here)
    skip_align: bool = False        # AlignmentBuffer.cpp:3398
    stdout_mode: int = 0            # AlignmentBuffer.h:334-340 debug dumps
    print_all: bool = False
    verbose: bool = False
    color: bool = False
    subread_aligner: int = 0        # NGM.cpp:350-362
    vcf: Optional[str] = None
    bed_filter: Optional[str] = None

    # Runtime
    threads: int = 1
    batch_reads: int = 192          # reads per host intake batch
    progress: bool = True

    # Output / read-group
    output_file: Optional[str] = None
    rg_id: Optional[str] = None
    rg_fields: dict = field(default_factory=dict)

    # Record of the command line (for @PG CL:)
    full_command_line: str = "ngmlr-tpu"

    # ------------------------------------------------------------------
    def max_segments_for(self, read_length: int) -> int:
        """IConfig.h:214-218 — max allowed split count for a read."""
        max_segments = int((read_length / 1000.0) * self.max_segment_number_per_kb + 0.5)
        return max(1, max_segments)

    def normalized(self) -> "Config":
        """Sign normalization as in ArgParser.cpp:210-239."""
        cfg = replace(self)
        if cfg.score_match < 0:
            cfg.score_match = -cfg.score_match
        if cfg.score_mismatch > 0:
            cfg.score_mismatch = -cfg.score_mismatch
        if cfg.score_gap_open > 0:
            cfg.score_gap_open = -cfg.score_gap_open
        if cfg.score_gap_extend_max > 0:
            cfg.score_gap_extend_max = -cfg.score_gap_extend_max
        if cfg.score_gap_extend_min > 0:
            cfg.score_gap_extend_min = -cfg.score_gap_extend_min
        if cfg.score_gap_decay < 0:
            cfg.score_gap_decay = -cfg.score_gap_decay
        return cfg


def apply_preset(cfg: Config, preset: str) -> Config:
    """-x pacbio|ont (ArgParser.cpp:256-269)."""
    if preset == "pacbio":
        return cfg
    if preset == "ont":
        # Only the gap-decay default changes (to the same value upstream);
        # kept as an explicit hook for parity with the reference.
        return replace(cfg, score_gap_decay=0.15)
    raise ValueError(f"Preset {preset} not found")

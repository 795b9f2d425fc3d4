"""Command-line interface — flag-compatible with the reference binary.

Rebuild of ArgParser (ngmlr src/ArgParser.cpp:61-290): same flag
names, same defaults, same sign normalization and presets.
"""

import argparse
import sys

from .config import Config, apply_preset
from .pipeline.runner import Pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ngmlr-tpu",
        description="long-read mapper with ngmlr's capabilities "
                    "(PyTorch/CUDA port)")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-q", "--query", default="/dev/stdin")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-x", "--presets", default="pacbio", choices=["pacbio", "ont"])
    p.add_argument("-i", "--min-identity", type=float, default=0.65)
    p.add_argument("-R", "--min-residues", type=float, default=0.25)
    p.add_argument("-s", "--sensitivity", type=float, default=0.8)
    p.add_argument("--match", type=float, default=2.0)
    p.add_argument("--mismatch", type=float, default=-5.0)
    p.add_argument("--gap-open", type=float, default=-5.0)
    p.add_argument("--gap-extend-max", type=float, default=-5.0)
    p.add_argument("--gap-extend-min", type=float, default=-1.0)
    p.add_argument("--gap-decay", type=float, default=0.15)
    p.add_argument("-k", "--kmer-length", type=int, default=13)
    p.add_argument("--kmer-skip", type=int, default=2)
    p.add_argument("--bin-size", type=int, default=4)
    p.add_argument("--max-segments", type=int, default=1)
    p.add_argument("--subread-length", type=int, default=256)
    p.add_argument("--subread-corridor", type=int, default=40)
    p.add_argument("--no-smallinv", action="store_true")
    p.add_argument("--no-lowqualitysplit", action="store_true")
    p.add_argument("--skip-write", action="store_true")
    p.add_argument("--bam-fix", action="store_true")
    p.add_argument("--no-progress", action="store_true")
    p.add_argument("--progress", action="store_true")
    # parity flags (see Config docstrings): vcf/bed-filter/print-all are
    # parsed but unused in the reference as well
    p.add_argument("--vcf", default=None)
    p.add_argument("--bed-filter", default=None)
    p.add_argument("--print-all", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--color", action="store_true")
    p.add_argument("--stdout", type=int, default=0, choices=range(0, 8),
                   help="debug dump mode (reference stdout modes 0-7)")
    p.add_argument("--subread-aligner", type=int, default=0,
                   help="subread scoring method (0 = batched TPU kernel)")
    p.add_argument("--nosse", action="store_true",
                   help="accepted for flag compatibility (the reference's "
                        "scalar-aligner debug switch); the device is chosen "
                        "by NGMLR_TORCH_DEVICE=cuda|cpu")
    p.add_argument("--skip-align", action="store_true",
                   help="skip the alignment step (debug)")
    p.add_argument("--version", action="version",
                   version="ngmlr-tpu 0.1.0 (ngmlr 0.2.7-compatible)")
    p.add_argument("--rg-id", default=None)
    for tag in ("sm", "lb", "pl", "ds", "dt", "pu", "pi", "pg", "cn", "fo", "ks"):
        p.add_argument(f"--rg-{tag}", default=None)
    p.add_argument("--batch-reads", type=int, default=192,
                   help="host intake batch (TPU batching granularity)")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="map only every N-th read starting at I (multi-host "
                        "data parallelism; merge shard outputs with "
                        "scripts/merge_sams.py)")
    return p


def config_from_args(args, argv) -> Config:
    cfg = Config(
        min_identity=args.min_identity,
        min_residues=args.min_residues,
        sensitivity=args.sensitivity,
        bin_size=args.bin_size,
        kmer_length=args.kmer_length,
        kmer_skip=args.kmer_skip,
        read_part_corridor=args.subread_corridor,
        read_part_length=args.subread_length,
        max_segment_number_per_kb=args.max_segments,
        score_match=args.match,
        score_mismatch=args.mismatch,
        score_gap_open=args.gap_open,
        score_gap_extend_max=args.gap_extend_max,
        score_gap_extend_min=args.gap_extend_min,
        score_gap_decay=args.gap_decay,
        low_quality_split=not args.no_lowqualitysplit,
        small_inversion_detection=not args.no_smallinv,
        skip_save=args.skip_write,
        bam_cigar_fix=args.bam_fix,
        skip_align=args.skip_align,
        stdout_mode=args.stdout,
        print_all=args.print_all,
        verbose=args.verbose,
        color=args.color,
        subread_aligner=args.subread_aligner,
        vcf=args.vcf,
        bed_filter=args.bed_filter,
        threads=args.threads,
        batch_reads=args.batch_reads,
        output_file=args.output,
        rg_id=args.rg_id,
        full_command_line=" ".join(["ngmlr-tpu"] + argv),
    ).normalized()
    cfg.rg_fields = {k.upper(): v for k, v in (
        ("SM", args.rg_sm), ("LB", args.rg_lb), ("PL", args.rg_pl),
        ("DS", args.rg_ds), ("DT", args.rg_dt), ("PU", args.rg_pu),
        ("PI", args.rg_pi), ("PG", args.rg_pg), ("CN", args.rg_cn),
        ("FO", args.rg_fo), ("KS", args.rg_ks)) if v}
    return apply_preset(cfg, args.presets)


def _start_quit_listener():
    """The reference's 'Q'x3 keyboard abort (_NGM::InitQuit,
    NGM.cpp:272-287). Upstream it is dead code — InitQuit has no call
    site in the shipped tree — so this honors the intended semantics:
    first 'Q' warns, third aborts. Only armed when stdin is an
    interactive TTY (never when reads are piped in)."""
    if not sys.stdin.isatty():
        return
    import os
    import threading
    from .log import Log

    def listen():
        state = 0
        while True:
            try:
                ch = sys.stdin.read(1)
            except Exception:
                return
            if not ch:
                return
            if ch in "qQ":
                state += 1
                if state == 1:
                    Log.warning("Hit 'Q' two more times to quit program.")
                elif state >= 3:
                    try:
                        Log.error("Terminate by user request")
                    except SystemExit:
                        pass
                    os._exit(1)

    threading.Thread(target=listen, daemon=True).start()


def main(argv=None):
    import os
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    from .log import Log
    Log.configure(color=args.color, verbose=args.verbose)
    if args.query != "/dev/stdin":
        _start_quit_listener()
    # the kernels' device: the CUDA kernels by default, their plain PyTorch
    # versions with NGMLR_TORCH_DEVICE=cpu; no silent fallback between them
    device = os.environ.get("NGMLR_TORCH_DEVICE", "cuda")
    if args.subread_aligner not in (0, 1, 2, 3):
        sys.stderr.write(f"Invalid subread aligner: {args.subread_aligner}\n")
        return 1
    if os.environ.get("NGMLR_TPU_COORDINATOR"):
        raise NotImplementedError(
            "multi-host runs (NGMLR_TPU_COORDINATOR) are not ported yet "
            "(ROADMAP open item 1.4)")
    shard, n_shards = 0, 1
    if args.shard:
        try:
            fields = args.shard.split("/")
            if len(fields) != 2:
                raise ValueError(args.shard)
            shard, n_shards = (int(v) for v in fields)
        except ValueError:
            sys.stderr.write(f"Invalid --shard {args.shard}\n")
            return 1
        if not (0 <= shard < n_shards):
            sys.stderr.write(f"Invalid --shard {args.shard}\n")
            return 1
    cfg = config_from_args(args, argv)
    pipeline = Pipeline(cfg, args.reference, use_cache=not args.skip_write,
                        device=device)
    if args.output and args.output.endswith(".gz"):
        import gzip
        out = gzip.open(args.output, "wb")   # the reference's GZFileWriter
    elif args.output:
        out = open(args.output, "wb")
    else:
        out = sys.stdout.buffer
    try:
        # progress defaults ON like the reference (ArgParser.cpp:113/245:
        # progress = !noprogress); --progress remains as an explicit enable
        stats = pipeline.run(args.query, out,
                             progress=not args.no_progress,
                             shard=shard, n_shards=n_shards)
    finally:
        if args.output:
            out.close()
    # the reference's final summary (main.cpp:109): mapped %, lines
    # written, elapsed minutes, reads/s
    mapped, unmapped = stats["mapped"], stats["unmapped"]
    elapsed = max(stats.get("elapsed_s", 0.0), 1e-9)
    Log.message(
        "Done (%i reads mapped (%.2f%%), %i reads not mapped, "
        "%i lines written)(elapsed: %dm, %d r/s)",
        mapped, mapped * 100.0 / max(1, mapped + unmapped), unmapped,
        stats.get("lines", 0), int(elapsed / 60.0), int(mapped / elapsed))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Align rows that SV realign tries posted in the window (pipeline.ctx.stats
sv_align_rows: native/engine.cpp, pipeline/longread.py), per Mbp of reads
finished in it. None where the program has no such counter."""


def read(run):
    if run.mbp <= 0 or "sv_align_rows" not in run.stats_close:
        return None
    return run.delta("sv_align_rows") / run.mbp

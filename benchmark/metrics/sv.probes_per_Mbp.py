"""Score rows that the SV check posted in the window (pipeline.ctx.stats
sv_probes: checkForSV's probes, native/engine.cpp, pipeline/longread.py),
per Mbp of reads finished in it. None where the program has no such
counter."""


def read(run):
    if run.mbp <= 0 or "sv_probes" not in run.stats_close:
        return None
    return run.delta("sv_probes") / run.mbp

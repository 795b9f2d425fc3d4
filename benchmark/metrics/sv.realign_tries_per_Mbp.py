"""SV realign tries in the window (pipeline.ctx.stats sv_realign_tries:
the realigns around an inversion or a join, native/engine.cpp,
pipeline/longread.py), per Mbp of reads finished in it. None where the
program has no such counter."""


def read(run):
    if run.mbp <= 0 or "sv_realign_tries" not in run.stats_close:
        return None
    return run.delta("sv_realign_tries") / run.mbp

"""Align rows that DIRS_CAP refused in the window (pipeline.ctx.stats
align_rows_refused: a row whose solo launch's direction planes pass the
cap gets no alignment; counted by both wave planners, csrc/wave.cu and
ops/device_engine.py), per Mbp of reads finished in it. None where the
program has no such counter."""


def read(run):
    if run.mbp <= 0 or "align_rows_refused" not in run.stats_close:
        return None
    return run.delta("align_rows_refused") / run.mbp

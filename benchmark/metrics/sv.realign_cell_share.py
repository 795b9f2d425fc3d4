"""The split path's share of the fill in the window: 100 *
Δcells_sv_useful / Δcells_align_useful (pipeline.ctx.stats: the useful
cells, qlen * min(width, W), that SV realign tries asked for as they
posted their align rows (native/engine.cpp, pipeline/longread.py), over
those of every align row the wave planners took). The two are counted
apart: a realign row that DIRS_CAP refuses counts in the first alone,
and a lane-bound retry's rows count twice in the second; the window's
align_rows_refused and lane_bound_retries say when that happened. None
where the program has no such counter or planned no align row."""


def read(run):
    if "cells_sv_useful" not in run.stats_close:
        return None
    cells = run.delta("cells_align_useful")
    if cells <= 0:
        return None
    return 100.0 * run.delta("cells_sv_useful") / cells

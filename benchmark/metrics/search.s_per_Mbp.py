"""Seconds of the candidate search (seed/device_search.py, seed/candidates.py) in the window
(pipeline.ctx.stats prep_search_s, host clock, summed over threads), per Mbp
of reads finished in the window."""


def read(run):
    if run.mbp <= 0:
        return None
    return run.delta("prep_search_s") / run.mbp

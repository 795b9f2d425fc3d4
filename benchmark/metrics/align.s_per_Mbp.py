"""Seconds of the device engine's align calls in the window
(pipeline.ctx.stats align_s + align_fetch_s, host clock, summed over
threads), per Mbp of reads finished in the window."""


def read(run):
    if run.mbp <= 0:
        return None
    return run.delta("align_s", "align_fetch_s") / run.mbp

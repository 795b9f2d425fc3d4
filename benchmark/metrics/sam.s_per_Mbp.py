"""Seconds of SAM emission (out/sam.py, Pipeline._emit) in the window
(pipeline.ctx.stats emit_s, host clock, summed over threads), per Mbp
of reads finished in the window."""


def read(run):
    if run.mbp <= 0:
        return None
    return run.delta("emit_s") / run.mbp

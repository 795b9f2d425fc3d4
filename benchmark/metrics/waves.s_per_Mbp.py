"""Seconds of the waves (pipeline/native_engine.py, native/engine.cpp, pipeline/batcher.py), align calls included in the window
(pipeline.ctx.stats waves_wall_s, host clock, summed over threads), per Mbp
of reads finished in the window."""


def read(run):
    if run.mbp <= 0:
        return None
    return run.delta("waves_wall_s") / run.mbp

"""Seconds the wave threads spent blocked in the native engine's
engine_wait_wave while its workers ran the reads' host work (the
`ngmlr.waves.engine` span of pipeline/native_engine.py; pipeline.ctx.stats
engine_wait_s, host clock, summed over threads) in the window, per Mbp of
reads finished in it. None where the program has no such counter."""


def read(run):
    if run.mbp <= 0 or "engine_wait_s" not in run.stats_close:
        return None
    return run.delta("engine_wait_s") / run.mbp

"""CPU seconds of the native engine's worker threads (native/engine.cpp,
their thread CPU clocks, read before and after each batch;
pipeline.ctx.stats engine_cpu_s) in the window, per Mbp of reads finished
in it. None where the program has no such counter."""


def read(run):
    if run.mbp <= 0 or "engine_cpu_s" not in run.stats_close:
        return None
    return run.delta("engine_cpu_s") / run.mbp

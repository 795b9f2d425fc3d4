"""Seconds the main thread spent taking in read batches (io/reads.py
read_batches, the `ngmlr.intake` span of pipeline/runner.py) in the window
(pipeline.ctx.stats intake_s, host clock), per Mbp of reads finished in it.
None where the program has no such counter."""


def read(run):
    if run.mbp <= 0 or "intake_s" not in run.stats_close:
        return None
    return run.delta("intake_s") / run.mbp

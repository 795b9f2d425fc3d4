"""Mean seconds a batch emitted in the window waited between its waves'
end and its emission (pipeline.ctx.stats batch_wait_emit_s over batches,
host clock): behind an older batch still in its waves, or behind the main
thread's wait on prep, which it takes first whenever a wave slot is free.
None where no batch was counted."""


def read(run):
    n = run.delta("batches")
    if n <= 0:
        return None
    return run.delta("batch_wait_emit_s") / n

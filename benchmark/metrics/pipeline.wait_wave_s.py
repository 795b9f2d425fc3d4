"""Mean seconds a batch emitted in the window waited, once prepared, for a
wave slot (pipeline.ctx.stats batch_wait_wave_s over batches, host clock).
None where no batch was counted."""


def read(run):
    n = run.delta("batches")
    if n <= 0:
        return None
    return run.delta("batch_wait_wave_s") / n

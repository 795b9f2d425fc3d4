"""The main thread's share of the window spent blocked on the prep thread
with a wave slot free (pipeline.ctx.stats main_wait_prep_s, host clock):
how far the one prep thread sets the pace. None where the program has no
such counter."""


def read(run):
    if run.seconds <= 0 or "main_wait_prep_s" not in run.stats_close:
        return None
    return 100.0 * run.delta("main_wait_prep_s") / run.seconds

"""The prep thread's busy share of the window: its encode, candidate-search
and score-stage seconds (pipeline.ctx.stats, host clock) over the window.
It is one thread, so near 100% means it sets the pace."""

KEYS = ("prep_enc_s", "prep_search_s", "prep_score_stage_s")


def read(run):
    if run.seconds <= 0:
        return None
    return 100.0 * run.delta(*KEYS) / run.seconds

"""Seconds of the score stage (pipeline/score_stage.py) in the window
(pipeline.ctx.stats prep_score_stage_s, host clock, summed over threads), per Mbp
of reads finished in the window."""


def read(run):
    if run.mbp <= 0:
        return None
    return run.delta("prep_score_stage_s") / run.mbp

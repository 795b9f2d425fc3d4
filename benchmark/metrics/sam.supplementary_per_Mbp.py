"""Supplementary records (flag 0x800, the split records that SA tags
join) written in the window (pipeline.ctx.stats records_supplementary:
out/sam.py, Pipeline._emit), per Mbp of reads finished in it. None where
the program has no such counter."""


def read(run):
    if run.mbp <= 0 or "records_supplementary" not in run.stats_close:
        return None
    return run.delta("records_supplementary") / run.mbp

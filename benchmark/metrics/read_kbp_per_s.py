"""Kilobases of read sequence whose SAM records the program finished writing
inside the window, over the window's seconds (host clock)."""


def read(run):
    if run.seconds <= 0:
        return None
    return float(run.bases.sum()) / 1e3 / run.seconds

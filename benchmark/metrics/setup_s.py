"""Seconds from the process's start to the window's opening: genome and
caches, the Pipeline's tables on the card, the read pool and the warm-up
reads (host clock)."""


def read(run):
    return run.setup_s

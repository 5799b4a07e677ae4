"""Queries answered in the window over the window's wall time (host clock)."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 and run.queries else None

"""Process start (run.py's first statement) to the start of the window."""


def read(run):
    return run.setup_s

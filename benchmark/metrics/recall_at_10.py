"""The reference's recall@10 rule over every query of the window, on the
distances the reference recomputed for the returned ids."""


def read(run):
    return run.numbers.get("recall")

"""Share of (card x wall time) of the traced stretch with no operation on
the device (torch.profiler), in %."""


def read(run):
    t = run.trace
    if t is None or not t.cards or t.busy_mean_s() <= 0:
        return None
    return 100.0 * sum(t.idle_share(c) for c in t.cards) / len(t.cards)

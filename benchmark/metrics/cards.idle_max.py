"""The highest idle share of one card over the traced stretch, in %: the card
the others wait for least (torch.profiler). Several cards only."""


def read(run):
    t = run.trace
    if t is None or len(t.cards) < 2 or t.busy_mean_s() <= 0:
        return None
    return 100.0 * max(t.idle_share(c) for c in t.cards)

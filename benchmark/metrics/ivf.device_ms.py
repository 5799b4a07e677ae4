"""Device busy ms per 1,000 queries over the traced stretch (torch.profiler),
the IVF probe mode only."""


def read(run):
    t = run.trace
    if t is None or not t.queries or t.busy_mean_s() <= 0 or run.cell.traffic["mode"] not in ("dense", "auto"):
        return None
    return 1e3 * t.busy_mean_s() / (t.queries / 1e3)

"""The bound of the fused scan's problem (2*Q*N*d FLOP at the bf16 peak, or
its bytes at the HBM peak, whichever is longer) over the device busy time
of the traced scan calls, in %."""

from benchmark.roofline import scan_bound_s


def read(run):
    t = run.trace
    if t is None or run.cell.traffic["mode"] != "scan-pallas" or not t.batches:
        return None
    busy = t.busy_mean_s() * len(t.cards)
    if busy <= 0:
        return None
    cfg = run.cell.config
    q = t.queries // t.batches  # every batch of a pool has the same size
    bound = t.batches * scan_bound_s(q, int(cfg["rows"]), int(cfg["dims"]), int(cfg["k"]))[0]
    return 100.0 * bound / busy

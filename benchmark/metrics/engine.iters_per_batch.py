"""Loop-body iterations per δ-engine loop over the traced stretch (the
program's LoopStats, counted into its tracer while the profiler runs; on
several cards each shard's loop counts as one). The delta engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    if stats is None or run.cell.traffic["mode"] != "lsh":
        return None
    return stats.iterations / stats.batches

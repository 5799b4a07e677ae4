"""Host reads per δ-engine loop over the traced stretch: the stop-flag
reads (one per SYNC_EVERY = 4 iterations and the last) and the map-sizing
read (the program's LoopStats; on several cards a loop per shard, whose
map is sized without a read). The delta engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    if stats is None or run.cell.traffic["mode"] != "lsh":
        return None
    return stats.syncs / stats.batches

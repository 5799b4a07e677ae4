"""δ-engine loop bodies run as a replay of a captured CUDA graph, per
loop iteration, over the traced stretch (the program's
LoopStats.graph_replays): 1 where every body of the batched engine on one
card was a replay, 0 where each was issued op by op. None where the
program counts no replays. The delta engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    replays = getattr(stats, "graph_replays", None)
    if stats is None or replays is None or not stats.iterations \
            or run.cell.traffic["mode"] != "lsh":
        return None
    return replays / stats.iterations

"""Share of the δ engine's loop-body iterations over the traced stretch
whose window was derived in the loop (`derived_window`), because a live
cursor ran past the batch's stream map (the program's LoopStats
`unmapped_iterations` over `iterations`). None where the program counts no
such iterations. The delta engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    unmapped = getattr(stats, "unmapped_iterations", None)
    if stats is None or unmapped is None or not stats.iterations \
            or run.cell.traffic["mode"] != "lsh":
        return None
    return unmapped / stats.iterations

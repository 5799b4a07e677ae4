"""Valid window lanes the δ engine's filter examined per query over the
traced stretch (the program's LoopStats `lanes`, the sum of
SearchStats.candidates, over the stretch's queries): each lane is one
16-byte record the window filter reads. None where the program counts no
lanes. The delta engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    lanes = getattr(stats, "lanes", None)
    if stats is None or lanes is None or not run.trace.queries \
            or run.cell.traffic["mode"] != "lsh":
        return None
    return lanes / run.trace.queries

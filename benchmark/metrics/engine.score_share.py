"""Score-and-merge launches per δ-engine loop iteration over the traced
stretch (the program's LoopStats.score_launches; the wrapper counts each
launch of csrc/score_merge.cu into the LoopStats of the loop that made
it, and each graph replay counts the launch it replays): 1 where every
body of the cosine global engine scored its candidates through the
kernel, less where bodies ran without it (its plain version, on CPU
tensors). None where the program counts no such launches. The delta
engines only."""

from benchmark.program_trace import loop


def read(run):
    stats = loop(run)
    launches = getattr(stats, "score_launches", None)
    if stats is None or launches is None or not stats.iterations \
            or run.cell.traffic["mode"] != "lsh":
        return None
    return launches / stats.iterations

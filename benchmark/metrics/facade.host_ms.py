"""Host ms per 1,000 queries in the facade's numpy boundary over the traced
stretch: the program's `search/to_device` (the caller's numpy to a card
tensor) and `search/to_numpy` (the host tail after the results' pull)
spans, work a closed loop's card cannot overlap. One card's facade only."""

from benchmark.program_trace import seconds


def read(run):
    if run.cell.config["build"] != "facade":
        return None
    parts = [seconds(run, "search/to_device"), seconds(run, "search/to_numpy")]
    if all(p is None for p in parts) or not run.trace.queries:
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / (run.trace.queries / 1e3)

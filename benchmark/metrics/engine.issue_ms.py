"""Host ms in the δ engine's loop bodies (the program's `engine/body`
spans, one per iteration) per loop over the traced stretch: the time the
host takes to issue a loop's body, which a captured graph would cut. The
delta engine on one card only."""

from benchmark.program_trace import loop, seconds


def read(run):
    stats = loop(run)
    body = seconds(run, "engine/body")
    cell = run.cell
    if stats is None or body is None or cell.traffic["mode"] != "lsh" \
            or cell.config["build"] != "facade":
        return None
    return 1e3 * body / stats.batches

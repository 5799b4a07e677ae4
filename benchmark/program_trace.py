"""What the program's own tracer (``clann_tpu_torch.metrics.trace.TRACER``)
recorded in a traced run. The tracer is active exactly while a profiler
runs on the calling thread, so what it holds covers the traced stretch
(one traced run per process, as run.py makes). Every function returns
None where the run was not traced, the program has no such tracer or
counter, or it recorded nothing."""

from __future__ import annotations

from typing import Optional


def _tracer(run):
    if run.trace is None:
        return None
    try:
        from clann_tpu_torch.metrics import trace
    except ImportError:
        return None
    return getattr(trace, "TRACER", None)


def loop(run):
    """The δ engines' LoopStats over the traced stretch (a loop per shard
    on several cards), or None."""
    stats = getattr(_tracer(run), "loop", None)
    return stats if stats is not None and stats.batches > 0 else None


def seconds(run, name: str) -> Optional[float]:
    """Host seconds in the spans named `name` (at any depth, from any
    thread), or None where no such span closed."""
    named = getattr(_tracer(run), "named", None)
    if named is None:
        return None
    total, _, calls = named(name)
    return total if calls else None

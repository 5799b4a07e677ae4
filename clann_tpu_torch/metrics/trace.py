"""Nested named spans and loop counters over the port's search path.

Equivalent of PUFFINN's `g_performance_metrics` timer hierarchy
(reference: performance.hpp:15-27,117-131, compile-time gated and OFF by
default). Here a tracer is *active* while someone is looking: when it is
enabled (`enabled`, or CLANN_TPU_TRACE=1 at import), while a
`torch.profiler` runs on the calling thread, or on a thread that
`marked()` marks (the shard runner marks its card workers, which the
profiler does not reach). Inactive, a span costs one `active()` check: no
profiler range, no lock, no sync.

Active, a span accumulates per path (the names of the open spans of its
thread, joined by "/") its host seconds, its self seconds (less its
children's) and its calls, and, under a profiler, opens a host range of
its name in the profiler's trace, on the device trace's clock (`_RANGE`).
Device work is asynchronous, so a span that should time device work is
given `block_on` (tensors or devices): while the tracer is enabled, it
synchronizes their CUDA devices before it closes. Under a profiler alone
it does not, so that looking does not change the device timeline: the
device time then comes from the profiler's trace. The tracer also owns one LoopStats (`loop`), which the
search entries count into when their caller passes none and the tracer
is active. Span names (`build/gmm`, `search/hashing`, ...) follow the JAX
package's where it has them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Optional, Tuple

import torch

_ENABLED = os.environ.get("CLANN_TPU_TRACE", "") not in ("", "0", "false")
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


@dataclasses.dataclass
class LoopStats:
    """What the adaptive loops of a search did (accumulated over calls):
    batches run, outer steps (the walk's (group, window) steps; the
    continuous global driver's lane steps; 0 for the batched global
    engine), loop-body iterations, host syncs (stop-flag, map-sizing,
    descend and lane done-flag pulls; the results pull of each batch is
    not counted), and the window-filter kernel's launches (the cosine
    global engine's bodies on a card, one an iteration; ops/window_filter).
    `graph_replays` counts the bodies run as a replay of a captured CUDA
    graph (the batched cosine global engine on one card, whose replays
    also count their window-filter launches; ops/global_query._BodyGraphs).
    `score_launches` counts the score-and-merge kernel's launches as
    `filter_launches` counts the window filter's (ops/score_merge; one an
    iteration of the cosine global engine's bodies on a card, replays
    included).
    The global and Jaccard engines also count the iterations whose window
    was derived in the loop (`derived_window`: a live cursor past the
    batch's stream map, or no map), and the global engines the valid
    window lanes their filter examined (the sum of SearchStats.candidates,
    added where a batch's stats reach the host). The sharded engine counts
    each shard's loop as a batch."""

    batches: int = 0
    outer_steps: int = 0
    iterations: int = 0
    syncs: int = 0
    filter_launches: int = 0
    unmapped_iterations: int = 0
    lanes: int = 0
    graph_replays: int = 0
    score_launches: int = 0

    def add(self, other: "LoopStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


# The profiler's host range. `torch.profiler.record_function` opens a user
# range, which the profiler mirrors on the device as an annotation from the
# range's first kernel to its last, idle time included: a reduction of the
# device timeline would count that idle as busy. A function range is
# recorded on the host alone, and costs ~2 us against ~14 (H100 host,
# torch 2.11).
_RANGE = torch._C._profiler._RecordFunctionFast


def _synchronize(block_on) -> None:
    for x in block_on if isinstance(block_on, (list, tuple)) else (block_on,):
        dev = x if isinstance(x, torch.device) else x.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class _Span:
    __slots__ = ("tracer", "name", "block_on", "path", "host", "t0", "children")

    def __init__(self, tracer: "Tracer", name: str, block_on):
        self.tracer, self.name, self.block_on = tracer, name, block_on

    def __enter__(self):
        stack = self.tracer._stack()
        self.path = f"{stack[-1].path}/{self.name}" if stack else self.name
        self.host = None
        if _profiling():
            self.host = _RANGE(self.name)
            self.host.__enter__()
        self.children = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None and self.block_on is not None and self.tracer.enabled:
                _synchronize(self.block_on)
        finally:
            el = time.perf_counter() - self.t0
            stack = self.tracer._stack()
            stack.pop()
            if stack:
                stack[-1].children += el
            self.tracer._add(self.path, el, el - self.children)
            if self.host is not None:
                self.host.__exit__(None, None, None)
        return False


class Tracer:
    """Nested named spans accumulating, per path, host seconds (`totals`),
    self seconds (`self_totals`) and calls (`counts`), from any thread."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = _ENABLED if enabled is None else enabled
        self.totals: Dict[str, float] = {}
        self.self_totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.loop = LoopStats()
        self._local = threading.local()  # .stack: open spans; .marked
        self._lock = threading.Lock()

    def active(self) -> bool:
        return self.enabled or _profiling() or getattr(self._local, "marked", False)

    def span(self, name: str, block_on=None):
        """A context timing a phase while the tracer is active. `block_on`:
        tensor(s) or device(s) whose CUDA devices are synchronized before
        the span closes while the tracer is enabled, so device work is
        attributed to it."""
        return _Span(self, name, block_on) if self.active() else _OFF

    @contextlib.contextmanager
    def marked(self, on: bool = True):
        """Within this block the calling thread counts as traced when `on`
        (the shard runner's workers, for the bodies of a traced call)."""
        prev = getattr(self._local, "marked", False)
        self._local.marked = on
        try:
            yield
        finally:
            self._local.marked = prev

    def loop_stats(self, loop_stats: Optional[LoopStats]) -> Optional[LoopStats]:
        """The caller's LoopStats, else the tracer's own while it is active."""
        if loop_stats is None and self.active():
            return self.loop
        return loop_stats

    def named(self, name: str) -> Tuple[float, float, int]:
        """(seconds, self seconds, calls) of every path ending in `name`."""
        with self._lock:
            paths = [p for p in self.totals if p == name or p.endswith("/" + name)]
            return (sum(self.totals[p] for p in paths),
                    sum(self.self_totals[p] for p in paths),
                    sum(self.counts[p] for p in paths))

    def clear(self) -> None:
        with self._lock:
            self.totals.clear()
            self.self_totals.clear()
            self.counts.clear()
            self.loop = LoopStats()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, path: str, seconds: float, self_seconds: float) -> None:
        with self._lock:
            self.totals[path] = self.totals.get(path, 0.0) + seconds
            self.self_totals[path] = self.self_totals.get(path, 0.0) + self_seconds
            self.counts[path] = self.counts.get(path, 0) + 1


TRACER = Tracer()

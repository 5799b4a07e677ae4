"""Hierarchical phase timers — the reference's timer tree (PyTorch port).

Equivalent of PUFFINN's `g_performance_metrics` timer hierarchy
(reference: performance.hpp:15-27,117-131 — 11 nested computation nodes,
compile-time gated by PUFFINN_PERFORMANCE_TIME and OFF by default). Here
the gate is the env var CLANN_TPU_TRACE=1 (read once at import); when off,
`span` is a no-op context manager with ~zero overhead. Span names
(`build/gmm`, ...) are the JAX package's.

Device work is asynchronous, so a span that should measure device time is
given `block_on` (a tensor or tensors); the span synchronizes their CUDA
device before it closes. Otherwise spans measure host-side orchestration
only. Unlike the reference's global mutable singleton (documented as
non-thread-safe, collection.hpp:106-112), tracers are instances; the
module-level `TRACER` is a convenience default.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

_ENABLED = os.environ.get("CLANN_TPU_TRACE", "") not in ("", "0", "false")


class Tracer:
    """Nested named spans accumulating (total seconds, call count)."""

    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = _ENABLED if enabled is None else enabled
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._stack: List[str] = []

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        """Time a phase. `block_on`: optional tensor(s) whose CUDA device
        is synchronized before the span closes, so device work is
        attributed to it."""
        if not self.enabled:
            yield
            return
        self._stack.append(name)
        path = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
            if block_on is not None:
                import torch

                probes = (block_on if isinstance(block_on, (list, tuple))
                          else (block_on,))
                for t in probes:
                    if t.is_cuda:
                        torch.cuda.synchronize(t.device)
        finally:
            el = time.perf_counter() - t0
            self.totals[path] = self.totals.get(path, 0.0) + el
            self.counts[path] = self.counts.get(path, 0) + 1
            self._stack.pop()

    def report(self) -> str:
        """Indented tree, reference-style (performance.hpp print shape)."""
        lines = []
        for path in sorted(self.totals):
            depth = path.count("/")
            name = path.rsplit("/", 1)[-1]
            lines.append(
                f"{'  ' * depth}{name}: {self.totals[path]*1e3:.1f} ms "
                f"(x{self.counts[path]})"
            )
        return "\n".join(lines)

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._stack.clear()


TRACER = Tracer()

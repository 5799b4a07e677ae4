"""Reduce a torch.profiler trace of a stretch of the window to the device's
busy time per card, the top device operations and the idle gaps by what the
host was doing. No trace file is written."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class TraceSummary:
    window_s: float  # host clock over the traced stretch
    busy_s: Dict[int, float]  # card index -> seconds with an operation running
    device_ops: List[Tuple[str, float]]  # top operations by summed seconds
    idle_gaps: List[Tuple[str, float]]  # summed idle seconds by host activity
    batches: int = 0
    queries: int = 0
    cards: List[int] = field(default_factory=list)

    def busy_mean_s(self) -> float:
        return sum(self.busy_s.get(c, 0.0) for c in self.cards) / max(1, len(self.cards))

    def idle_share(self, card: int) -> float:
        return 1.0 - self.busy_s.get(card, 0.0) / self.window_s


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(cpu: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """Name of the latest-starting host event that covers time t (nested
    events start inside their parents, so that is the innermost)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 256), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "python (no traced op)"


def summarize(events, window_s: float, cards: List[int], top: int = 10) -> TraceSummary:
    """`events`: the profiler's kineto events (name(), device_type(),
    device_index(), start_ns(), duration_ns())."""
    dev: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    op_s: Dict[str, float] = defaultdict(float)
    cpu: List[Tuple[int, int, str]] = []
    for e in events:
        s, dur = e.start_ns(), e.duration_ns()
        if "CUDA" in str(e.device_type()):
            dev[e.device_index()].append((s, s + dur))
            op_s[e.name()] += dur * 1e-9
        elif dur > 0:
            cpu.append((s, s + dur, e.name()))
    cpu.sort()
    starts = [c[0] for c in cpu]
    busy, gaps = {}, defaultdict(float)
    for c, iv in dev.items():
        u = _union(iv)
        busy[c] = sum(e - s for s, e in u) * 1e-9
        for (_, e0), (s1, _) in zip(u, u[1:]):
            gaps[_innermost(cpu, starts, (e0 + s1) // 2)] += (s1 - e0) * 1e-9
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return TraceSummary(window_s=window_s, busy_s=busy, device_ops=rank(op_s),
                        idle_gaps=rank(gaps), cards=list(cards))

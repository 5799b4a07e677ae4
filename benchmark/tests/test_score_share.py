"""The reader of `engine.score_share` (score-and-merge launches per
δ-engine loop iteration, the program's LoopStats): its value from a
synthetic tracer in the two cells it is listed for, None outside them, in
an untraced run, where the tracer recorded no loop, and where the
program's LoopStats has no such counter (the parent of the commit that
added it)."""

import dataclasses

import pytest

from benchmark import harness, spec
from benchmark.trace import TraceSummary

LISTED = ("glove100-lsh.global-b256", "deep96-10m.global-b256")
CELLS = LISTED + ("glove100-ivf.auto-b2048", "glove100-lsh.scan-b10000")
NAME = "engine.score_share"


def _run(cell, traced: bool = True) -> harness.Run:
    run = harness.Run(cell=spec.load_cell(cell, harness.ROOT))
    if traced:
        run.trace = TraceSummary(window_s=2.0, busy_s={}, device_ops=[], idle_gaps=[],
                                 batches=8, queries=2048)
    return run


@pytest.fixture
def tracer(monkeypatch):
    from clann_tpu_torch.metrics import trace

    t = trace.Tracer(enabled=False)
    t.loop = trace.LoopStats(batches=8, iterations=200, syncs=58, filter_launches=200,
                             graph_replays=200, score_launches=150)
    monkeypatch.setattr(trace, "TRACER", t)
    return t


@pytest.mark.parametrize("cell", CELLS)
def test_reads_launches_per_iteration_in_its_cells_only(tracer, cell):
    listed = NAME in {m["name"] for m in spec.load_cell(cell, harness.ROOT).per_layer}
    assert listed == (cell in LISTED)
    value = spec.reader(NAME)(_run(cell))
    assert value == (pytest.approx(0.75) if listed else None)
    assert spec.reader(NAME)(_run(cell, traced=False)) is None


@pytest.mark.parametrize("launches,want", [(200, 1.0), (0, 0.0)])
def test_reads_the_card_and_the_cpu(tracer, launches, want):
    tracer.loop.score_launches = launches
    assert spec.reader(NAME)(_run(LISTED[0])) == pytest.approx(want)


def test_finds_nothing_to_read(monkeypatch, tracer):
    from clann_tpu_torch.metrics import trace

    read = spec.reader(NAME)
    tracer.clear()  # no loop ran
    assert read(_run(LISTED[0])) is None

    @dataclasses.dataclass
    class ParentLoopStats:  # the counters before score_launches
        batches: int = 8
        outer_steps: int = 0
        iterations: int = 200
        syncs: int = 58
        filter_launches: int = 200
        unmapped_iterations: int = 0
        lanes: int = 0
        graph_replays: int = 200

    tracer.loop = ParentLoopStats()
    assert read(_run(LISTED[0])) is None
    monkeypatch.setattr(trace, "TRACER", object())  # a tracer without counters
    assert read(_run(LISTED[0])) is None

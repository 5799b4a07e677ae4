"""The readers of the δ engine's scale counters (`engine.unmapped_share`,
`engine.lanes_per_query`, from the program's LoopStats): the ratio on a
synthetic tracer in the cell they are listed for, None outside it, in an
untraced run, on a mode other than lsh, where the tracer recorded no loop,
and where the program's LoopStats has no such counter (the parent of the
commit that added them)."""

import dataclasses

import pytest

from benchmark import harness, spec
from benchmark.trace import TraceSummary

CELL = "deep96-10m.global-b256"
OTHERS = ("glove100-lsh.global-b256", "glove100-ivf.auto-b2048", "glove100-lsh.scan-b10000")
WANT = {"engine.unmapped_share": 30 / 200, "engine.lanes_per_query": 5_120_000 / 2048}


def _run(cell, traced: bool = True, mode: str = None) -> harness.Run:
    run = harness.Run(cell=spec.load_cell(cell, harness.ROOT))
    if mode is not None:
        run.cell.traffic = {**run.cell.traffic, "mode": mode}
    if traced:
        run.trace = TraceSummary(window_s=2.0, busy_s={}, device_ops=[], idle_gaps=[],
                                 batches=8, queries=2048)
    return run


@pytest.fixture
def tracer(monkeypatch):
    from clann_tpu_torch.metrics import trace

    t = trace.Tracer(enabled=False)
    t.loop = trace.LoopStats(batches=8, iterations=200, syncs=58, filter_launches=200,
                             unmapped_iterations=30, lanes=5_120_000)
    monkeypatch.setattr(trace, "TRACER", t)
    return t


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_the_ratio_in_its_cell_only(tracer, name):
    assert name in {m["name"] for m in spec.load_cell(CELL, harness.ROOT).per_layer}
    assert spec.reader(name)(_run(CELL)) == pytest.approx(WANT[name])
    for cell in OTHERS:
        assert name not in {m["name"] for m in spec.load_cell(cell, harness.ROOT).per_layer}


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_untraced_and_off_the_engine(tracer, name):
    read = spec.reader(name)
    assert read(_run(CELL, traced=False)) is None
    assert read(_run(CELL, mode="scan-pallas")) is None
    tracer.clear()  # no loop ran
    assert read(_run(CELL)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_where_the_program_has_no_such_counter(monkeypatch, tracer, name):
    from clann_tpu_torch.metrics import trace

    @dataclasses.dataclass
    class ParentLoopStats:  # the counters before unmapped_iterations and lanes
        batches: int = 8
        outer_steps: int = 0
        iterations: int = 200
        syncs: int = 58
        filter_launches: int = 200

    tracer.loop = ParentLoopStats()
    assert spec.reader(name)(_run(CELL)) is None
    monkeypatch.setattr(trace, "TRACER", object())  # a tracer without counters
    assert spec.reader(name)(_run(CELL)) is None


def test_the_one_card_deep96_cell_is_found():
    """deep96-10m.global-b256 by name: the whole 9.99M x 96 collection on
    one card, the δ engine's traffic, its limits and its two counters."""
    cell = spec.load_cell(CELL, harness.ROOT)
    assert cell.chips == 1 and cell.traffic == spec.load_cell(OTHERS[0], harness.ROOT).traffic
    assert (cell.config["rows"], cell.config["dims"], cell.config["build"]) == (
        9_990_000, 96, "facade")
    assert cell.config["reduced"] == [] and cell.config["index"]["num_tables"] == 128
    assert {"recall", "dist_err", "bad_rows"} == set(cell.limits)
    names = {m["name"] for m in cell.per_layer}
    assert set(WANT) | {"build_s", "device_idle"} <= names

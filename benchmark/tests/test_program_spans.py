"""The readers of the program's own tracer: each gives its value from a
synthetic tracer in the cells it is listed for, and None outside them, in
an untraced run, or where the program has no such tracer (the parent of
the commit that added them). `shards.turn_wait_share` has no entry yet
(the four-card cell it reads is not in BENCHMARK.json): it is checked on
that cell made from its files."""

import pytest

from benchmark import harness, spec
from benchmark.trace import TraceSummary

CELLS = ("glove100-lsh.global-b256", "glove100-ivf.auto-b2048", "glove100-lsh.scan-b10000")
READERS = ("engine.iters_per_batch", "engine.syncs_per_batch", "engine.issue_ms",
           "facade.host_ms")


def _run(cell, traced: bool = True) -> harness.Run:
    run = harness.Run(cell=spec.load_cell(cell, harness.ROOT) if isinstance(cell, str) else cell)
    if traced:
        run.trace = TraceSummary(window_s=2.0, busy_s={}, device_ops=[], idle_gaps=[],
                                 batches=8, queries=2048)
    return run


@pytest.fixture
def tracer(monkeypatch):
    from clann_tpu_torch.metrics import trace

    t = trace.Tracer(enabled=False)
    t.loop = trace.LoopStats(batches=8, iterations=200, syncs=58)
    t.totals = {"search/to_device": 0.01, "engine/body": 0.4,
                "engine/body/engine/fetch": 0.1, "search/to_numpy": 0.002,
                "other/search/to_numpy": 0.002, "shards/body": 2.0,
                "shards/body/shards/turn_wait": 1.5}
    t.self_totals = dict(t.totals)
    t.counts = {p: 1 for p in t.totals}
    monkeypatch.setattr(trace, "TRACER", t)
    return t


WANT = {
    "engine.iters_per_batch": 25.0,
    "engine.syncs_per_batch": 7.25,
    "engine.issue_ms": 50.0,
    "facade.host_ms": 1e3 * 0.014 / 2.048,
}


@pytest.mark.parametrize("cell", CELLS)
def test_readers_in_and_outside_their_cells(tracer, cell):
    listed = {m["name"] for m in spec.load_cell(cell, harness.ROOT).per_layer}
    for name in READERS:
        value = spec.reader(name)(_run(cell))
        if name in listed:
            assert value == pytest.approx(WANT[name]), (name, cell)
        else:
            assert value is None, (name, cell)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_to_read(monkeypatch, tracer, name):
    from clann_tpu_torch.metrics import trace

    read = spec.reader(name)
    cells = [c for c in CELLS
             if name in {m["name"] for m in spec.load_cell(c, harness.ROOT).per_layer}]
    assert cells and all(read(_run(c)) is not None for c in cells)
    assert all(read(_run(c, traced=False)) is None for c in cells)
    tracer.clear()
    assert all(read(_run(c)) is None for c in cells)
    monkeypatch.setattr(trace, "TRACER", object())  # a tracer without counters
    assert all(read(_run(c)) is None for c in cells)


def test_turn_wait_share_reads_several_cards_only(monkeypatch, tracer):
    from clann_tpu_torch.metrics import trace

    read = spec.reader("shards.turn_wait_share")
    four = spec.cell_from_files("deep96-20m.global-b256", "deep96-20m", "global-b256", 4, [], [])
    assert read(_run(four)) == pytest.approx(75.0)
    assert read(_run(four, traced=False)) is None
    assert all(read(_run(c)) is None for c in CELLS)
    tracer.clear()
    assert read(_run(four)) is None
    monkeypatch.setattr(trace, "TRACER", object())
    assert read(_run(four)) is None

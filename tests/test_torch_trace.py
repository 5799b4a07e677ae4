"""The port's tracer (clann_tpu_torch/metrics/trace.py) on the CPU.

- Off (not enabled, no profiler, thread unmarked) a span records nothing,
  opens no profiler range and synchronizes nothing; `block_on` syncs only
  while the tracer is enabled, not under a profiler or on a marked worker.
- Under torch.profiler the spans lie among the profiler's host events by
  name, and per path the self seconds add up to the outermost span's.
- The nesting stacks are per thread.
- The loop counters reach the caller through the facade, the global
  engine, the walk, the continuous driver and the sharded engine (each
  shard's loop counted and added by the controller), and into the
  tracer's own counters while a profiler runs; tracing changes no answer.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import clann_tpu_torch
from clann_tpu_torch.config import Config
from clann_tpu_torch.data.synthetic import clustered_unit_vectors
from clann_tpu_torch.metrics import trace
from clann_tpu_torch.metrics.trace import LoopStats, Tracer
from clann_tpu_torch.ops import global_query as tgq
from clann_tpu_torch.ops import query as tq
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

CPU_CARDS = [torch.device("cpu", i) for i in range(4)]


class CountingRange:
    opened = 0

    def __init__(self, name):
        CountingRange.opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def ranges(monkeypatch):
    CountingRange.opened = 0
    monkeypatch.setattr(trace, "_RANGE", CountingRange)
    synced = []
    monkeypatch.setattr(trace, "_synchronize", synced.append)
    return synced


def test_off_records_nothing(ranges):
    t = Tracer(enabled=False)
    assert not t.active()
    with t.span("a", block_on=torch.zeros(1)):
        with t.span("b"):
            pass
    assert t.totals == t.self_totals == t.counts == {}
    assert CountingRange.opened == 0 and ranges == []
    assert t.loop_stats(None) is None
    # enabled, no profiler: totals and syncs, but no profiler range
    t.enabled = True
    with t.span("a", block_on=torch.zeros(1)):
        pass
    assert t.counts == {"a": 1} and len(ranges) == 1 and CountingRange.opened == 0
    assert t.loop_stats(None) is t.loop


def test_block_on_synchronizes_only_when_enabled(ranges):
    """Under a profiler, or on a marked worker, a span stays host-only: the
    profiler's trace gives the device time, and a sync would change it."""
    t = Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        with t.span("build/x", block_on=torch.zeros(1)):
            pass
    with t.marked():
        with t.span("build/x", block_on=torch.zeros(1)):
            pass
    assert t.counts == {"build/x": 2} and ranges == []
    t.enabled = True
    with t.span("build/x", block_on=torch.zeros(1)):
        pass
    assert t.counts == {"build/x": 3} and len(ranges) == 1


def test_spans_reach_the_profiler_and_self_times_add_up():
    t = Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert t.active()
        with t.span("outer/x"):
            for _ in range(3):
                with t.span("inner"):
                    torch.ones(64).sum()
            with t.span("other"):
                with t.span("inner"):
                    pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer/x") == 1 and names.count("inner") == 4
    assert names.count("other") == 1
    assert set(t.totals) == {"outer/x", "outer/x/inner", "outer/x/other",
                             "outer/x/other/inner"}
    assert t.counts["outer/x/inner"] == 3
    assert sum(t.self_totals.values()) == pytest.approx(t.totals["outer/x"], rel=1e-9)
    assert t.self_totals["outer/x/other"] == pytest.approx(
        t.totals["outer/x/other"] - t.totals["outer/x/other/inner"], abs=1e-12)
    total, own, calls = t.named("inner")
    assert calls == 4 and own == total
    assert total == pytest.approx(t.totals["outer/x/inner"] + t.totals["outer/x/other/inner"])
    assert not t.active()
    t.clear()
    assert t.totals == {} and t.named("inner") == (0.0, 0.0, 0)


def test_stacks_are_per_thread():
    t = Tracer(enabled=True)
    opened = threading.Barrier(2, timeout=10)

    def work(name):
        with t.span(name):
            opened.wait()  # both outer spans open at once
            with t.span("inner"):
                pass
            opened.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert set(t.totals) == {"a", "b", "a/inner", "b/inner"}


def test_marked_threads_are_active():
    t = Tracer(enabled=False)
    seen = []

    def work():
        seen.append(t.active())
        with t.marked(True):
            seen.append(t.active())
            with t.span("w"):
                pass
        seen.append(t.active())

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=10)
    assert seen == [False, True, False] and t.counts == {"w": 1}


def test_loop_stats_add():
    a, b = LoopStats(1, 2, 3, 4, 5, 6, 7, 8, 9), LoopStats(10, 20, 30, 40, 50, 60, 70, 80, 90)
    a.add(b)
    assert a == LoopStats(11, 22, 33, 44, 55, 66, 77, 88, 99) and tq.LoopStats is LoopStats
    assert (a.filter_launches, a.unmapped_iterations, a.lanes, a.graph_replays,
            a.score_launches) == (55, 66, 77, 88, 99)


@pytest.fixture(scope="module")
def world():
    x = clustered_unit_vectors(3000, 16, n_modes=12, seed=0)
    q = clustered_unit_vectors(40, 16, n_modes=12, seed=1)
    cfg = Config(num_tables=8, num_clusters_factor=0.5, k=5, delta=0.9, seed=0,
                 hash_family="simhash", gather_block=8, candidate_chunk=64, filter_expand=4,
                 lsh_engine="both", dense_layout=False)
    h = clann_tpu_torch.init_with_config(x, cfg, device="cpu").build()
    return {"handle": h, "q": q}


def _same(a, b):
    assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("mode", ["lsh-global", "lsh-clustered"])
def test_search_batch_passes_loop_stats_down(world, mode, monkeypatch):
    h, q = world["handle"], world["q"]
    entry = (lambda **kw: tgq.global_search(h.index, q, **kw)) if mode == "lsh-global" \
        else (lambda **kw: tq.search(h.index, q, **kw))
    direct = LoopStats()
    want = entry(loop_stats=direct)
    facade = LoopStats()
    _same(h.search_batch(q, mode=mode, loop_stats=facade), want)
    assert facade == direct and direct.batches == 1 and direct.iterations > 0
    # under a profiler the counts go to the tracer's own; answers unchanged
    tracer = Tracer(enabled=False)
    for mod in (trace, tgq, tq):
        monkeypatch.setattr(mod, "TRACER", tracer)
    monkeypatch.setattr("clann_tpu_torch.api.TRACER", tracer)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = h.search_batch(q, mode=mode)
    _same(traced, want)
    assert tracer.loop == direct
    assert tracer.named("search/to_device")[2] == 1 and tracer.named("search/pull")[2] == 1
    if mode == "lsh-global":
        assert tracer.named("engine/body")[2] == direct.iterations
        # a read per SYNC_EVERY iterations and the last, besides the map's
        assert tracer.named("engine/read")[2] == direct.syncs - 1
        assert tracer.named("engine/prepare")[2] == tracer.named("engine/finalize")[2] == 1


def test_continuous_driver_is_counted_like_the_batched(world, monkeypatch):
    """More queries than lanes: the continuous driver counts its loop into
    the tracer's own LoopStats under a profiler, opens the batched
    driver's engine/hash and engine/prepare spans for each slab, and
    returns global_search's distances bit for bit."""
    h, q = world["handle"], world["q"]
    kw = dict(lanes=16, step_iters=3, prepare_batch=16)
    direct = LoopStats()
    want = tgq.global_search_continuous(h.index, q, loop_stats=direct, **kw)
    assert direct.batches == 1 and direct.outer_steps > 0 and direct.iterations > 0
    tracer = Tracer(enabled=False)
    for mod in (trace, tgq, tq):
        monkeypatch.setattr(mod, "TRACER", tracer)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = tgq.global_search_continuous(h.index, q, **kw)
    _same(traced, want)
    assert tracer.loop == direct
    slabs = -(-len(q) // kw["prepare_batch"])
    assert tracer.named("engine/hash")[2] == tracer.named("engine/prepare")[2] == slabs
    assert tracer.named("engine/body")[2] == direct.iterations
    batched = tgq.global_search(h.index, q)
    assert traced[0].dtype == batched[0].dtype
    assert np.array_equal(traced[0], batched[0]) and np.array_equal(traced[1], batched[1])


def test_sharded_engine_sums_its_shards(world, monkeypatch):
    h, q = world["handle"], world["q"]
    mesh = tmesh.make_mesh(4, devices=CPU_CARDS)
    sharded = tsh.shard_index(h.index, 4, mesh=mesh)
    per_shard = []
    impl = tgq.global_search_batch_impl

    def counted(*a, loop_stats=None, **kw):
        out = impl(*a, loop_stats=loop_stats, **kw)
        per_shard.append(loop_stats)
        return out

    monkeypatch.setattr(tgq, "global_search_batch_impl", counted)
    total = LoopStats()
    want = tsh.sharded_global_search(sharded, q, mesh=mesh, loop_stats=total)
    assert len(per_shard) == 4 and len({id(s) for s in per_shard}) == 4
    # the shards' loops; the lanes once, from the merged stats on the host
    summed = LoopStats(lanes=int(want[2].candidates.sum()))
    for s in per_shard:
        summed.add(s)
    assert total == summed and total.batches == 4 and total.iterations > 0
    assert total.lanes > 0
    # under a profiler, into the tracer's own counters; the workers' spans too
    tracer = Tracer(enabled=False)
    for mod in (trace, tgq, tsh, tmesh):
        monkeypatch.setattr(mod, "TRACER", tracer)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = tsh.sharded_global_search(sharded, q, mesh=mesh)
    _same(traced, want)
    assert tracer.loop == total
    assert tracer.named("shards/body")[2] == 4 and tracer.named("shards/turn_wait")[2] > 0
    assert tracer.named("engine/body")[2] == total.iterations

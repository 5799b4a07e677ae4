"""The global δ engine's loop body replayed from CUDA graphs
(ops/global_query._BodyGraphs, global_search_batch_graphed).

On the CPU: the stream map written into a deeper buffer, a slice of rows
at a time, equals stream_block_map's own array bit for bit; CPU tensors
run the eager body (no graph, no replay) through global_search's batch
route (the JAX comparison of that route is in test_torch_global_query.py);
LoopStats.add carries graph_replays (test_torch_trace.py).

On the card (marked `card`, skipped elsewhere): global_search with its
bodies replayed equals the eager body (global_search_batch_mapped, by
which the tests replace the graphed route) bit for bit, in distances, ids,
SearchStats and the loop's counters (one window-filter and one
score-and-merge launch a body, replays included), with both body forms (a map capped
below the deepest cursors), with int8 rescoring, across batches of new
data through one capture, and after insert and rebuild, which capture
anew. The card machine has no jax, so it runs without tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_body_graphs.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import clann_tpu_torch
from clann_tpu_torch.config import Config
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.data.synthetic import clustered_unit_vectors
from clann_tpu_torch.metrics.trace import LoopStats
from clann_tpu_torch.ops import global_query as tgq
from clann_tpu_torch.ops import score_merge as tsm
from clann_tpu_torch.ops import window_filter as twf
from clann_tpu_torch.ops.prefixmap import stream_block_map

torch.set_num_threads(1)

# test_torch_global_query.py's shape: G 8, WB = 512 * 8 / 8 = 512 blocks
CFG = dict(num_tables=10, num_clusters_factor=0.4, k=10, delta=0.975, seed=0, gather_block=8,
           candidate_chunk=512, filter_expand=8, lsh_engine="global", dense_layout=False)
X = dict(n=4000, d=32, n_modes=16)


def _data(n, seed):
    return clustered_unit_vectors(n, X["d"], n_modes=X["n_modes"], seed=seed)


def _build(device, **cfg):
    return clann_tpu_torch.init_with_config(_data(X["n"], 0), Config(**{**CFG, **cfg}),
                                            device=device).build().index


def _with(index, **cfg):
    return dataclasses.replace(index, config=index.config.replace(**cfg))


@pytest.fixture(scope="module")
def cpu_index():
    return _build("cpu")


@pytest.mark.parametrize("below,slice_bytes", [
    (1, tgq._MAP_SLICE_BYTES),  # the buffer's depth, one slice
    (4, tgq._MAP_SLICE_BYTES),  # a quarter of it
    (4, 12 * 1024 * 5),  # five rows a slice: a ragged last slice
])
def test_map_written_into_a_buffer_equals_its_own(cpu_index, monkeypatch, below, slice_bytes):
    idx = cpu_index
    q = torch.from_numpy(_data(48, 1))
    source, filterer = idx.rebuild_objects()
    streams = tgq._prepare_streams(idx, q, source.hash(q), filterer.sketch(q), min_depth=1)
    depth, L, g = 4096, idx.g_sorted_hash.shape[0], 3
    tb = depth // below
    want = stream_block_map(streams["fc"], streams["bstarts"], streams["starts"],
                            streams["sizes"], g, L, tb)

    out = torch.full((48, depth, 3), 7, dtype=torch.int32)
    got = stream_block_map(streams["fc"], streams["bstarts"], streams["starts"],
                           streams["sizes"], g, L, tb, out=out[:, :tb])
    assert torch.equal(got, want) and torch.equal(out[:, :tb], want)
    assert bool((out[:, tb:] == 7).all())  # nothing past tb is written

    monkeypatch.setattr(tgq, "_MAP_SLICE_BYTES", slice_bytes)
    graphs = tgq._BodyGraphs(key=())
    graphs.load(idx, streams, depth, 0.975, k=10, chunk=512, min_depth=1,
                filter_type="default", filter_expand=8)
    assert torch.equal(graphs.write_map(tb, g=g, L=L), want)
    assert torch.equal(graphs.streams["smap"][:, :tb], want)
    assert not graphs.graphs and graphs.captures == 0  # loading captures nothing


@pytest.mark.parametrize("knob", [{}, dict(stream_map_blocks=1)])
def test_cpu_tensors_run_the_eager_body(cpu_index, knob):
    idx = _with(cpu_index, **knob)
    ls = LoopStats()
    launches, scores = twf.FILTER_LAUNCHES, tsm.SCORE_LAUNCHES
    tgq.global_search(idx, _data(48, 1), batch_size=16, loop_stats=ls)
    assert ls.iterations > 0 and ls.graph_replays == 0 and ls.filter_launches == 0
    assert ls.score_launches == 0 and tsm.SCORE_LAUNCHES == scores
    assert twf.FILTER_LAUNCHES == launches and idx.body_graphs is None


# --- on the card --------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop body's graphs are captured on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_index(card):
    return _build(card)


def _search(index, queries, *, graphed: bool, batch_size=16):
    """global_search's (distances, ids, stats) and LoopStats, its bodies
    replayed from graphs or run eagerly."""
    route = tgq.global_search_batch_graphed
    if not graphed:
        tgq.global_search_batch_graphed = tgq.global_search_batch_mapped
    try:
        ls = LoopStats()
        out = tgq.global_search(index, queries, batch_size=batch_size, loop_stats=ls)
        torch.cuda.synchronize()
        return out, ls
    finally:
        tgq.global_search_batch_graphed = route


def _assert_bit_identical(got, want):
    (gd, gi, gst), gls = got
    (wd, wi, wst), wls = want
    assert np.array_equal(gd, wd) and np.array_equal(gi, wi)
    for f in wst._fields:
        assert np.array_equal(getattr(gst, f), getattr(wst, f)), f
    assert gls.graph_replays == gls.iterations > 0 and wls.graph_replays == 0
    assert dataclasses.replace(gls, graph_replays=0) == wls
    assert gls.filter_launches == gls.iterations
    # a replay counts its score-and-merge launch, as the eager body launches one
    assert gls.score_launches == gls.graph_replays == wls.score_launches


@pytest.mark.card
@pytest.mark.parametrize("case", ["mapped", "capped", "unmapped", "int8"])
def test_replays_equal_the_eager_body(card_index, case):
    """Both body forms where the map is capped below the deepest cursors
    (some iterations derive their window, as in test_torch_global_query's
    test_capped_map_takes_the_fallback); only the derived form without a
    map; the int8 body's 2k buffer."""
    idx = {"mapped": lambda i: _with(i),
           "capped": lambda i: _with(i, stream_map_blocks=1),
           "unmapped": lambda i: _with(i, stream_map=False),
           "int8": lambda i: tindex.with_rescore_dtype(i, "int8")}[case](card_index)
    q = _data(48, 1)
    want = _search(idx, q, graphed=False)
    got = _search(idx, q, graphed=True)
    _assert_bit_identical(got, want)
    graphs = idx.body_graphs
    forms = {"capped": 2, "unmapped": 1}.get(case, 2)
    assert graphs is not None and graphs.captures == forms == len(graphs.graphs)
    unmapped = got[1].unmapped_iterations
    if case == "capped":
        assert 0 < unmapped < got[1].iterations
    else:
        assert unmapped == (got[1].iterations if case == "unmapped" else 0)


@pytest.mark.card
def test_one_capture_serves_batches_of_new_data(card_index):
    idx = _with(card_index)
    graphs = None
    for seed in (1, 2, 3):
        q = _data(48, seed)  # three batches of 16 a search, each new data
        _assert_bit_identical(_search(idx, q, graphed=True), _search(idx, q, graphed=False))
        graphs = graphs or idx.body_graphs
        assert idx.body_graphs is graphs and graphs.captures == 2
    # another batch shape is another key: captured anew, the old graphs dropped
    _assert_bit_identical(_search(idx, q, graphed=True, batch_size=48),
                          _search(idx, q, graphed=False, batch_size=48))
    assert idx.body_graphs is not graphs and idx.body_graphs.captures == 2


@pytest.mark.card
def test_insert_and_rebuild_capture_anew(card_index):
    idx = _with(card_index)
    q = _data(48, 4)
    _search(idx, q, graphed=True)
    old = idx.body_graphs
    assert old is not None
    ins = tindex.insert(idx, _data(300, 5))
    assert idx.body_graphs is None and ins.body_graphs is None
    _assert_bit_identical(_search(ins, q, graphed=True), _search(ins, q, graphed=False))
    assert ins.body_graphs is not old and ins.body_graphs.captures == 2
    reb = tindex.rebuild(ins)
    assert ins.body_graphs is None and reb.body_graphs is None
    _assert_bit_identical(_search(reb, q, graphed=True), _search(reb, q, graphed=False))
    assert reb.body_graphs.captures == 2

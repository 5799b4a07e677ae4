"""The global delta engine (ops/global_query.py) against the JAX package's
on the CPU, at the shape of tests/test_stream_map.py (4,000 x 32, L = 10,
gather_block 8, chunk 512, filter_expand 8).

Both packages search ONE index: the JAX-built index is carried across
whole (tables, records, directories, hash and sketch parameters) with
index_from_arrays, and the engine is fed JAX's normalized queries, query
hashes and sketches. Tolerances: similarities within 1e-5 (f32 dots summed
in another order), ids per query as sets up to boundary ties
(testing.assert_topk_match), and distance_computations, candidates and
clusters_visited identical per query.

JAX's results do not depend on stream_map, dead_block_routing, the map's
length or the batch size (tests/test_stream_map.py pins that), so the
port's runs with those knobs changed are held against one JAX run; the
filter type and delta change results and get their own JAX runs.

The continuous-batching driver (global_search_continuous) runs 70 queries
through 16 lanes (a ragged last refill) and is held both to JAX's driver
and to the port's own global_search. The int8 rescore runs on the carried
index plus JAX's int8 shadow (quantize_q8). The entry-cap and tensored-
source knobs each get their own JAX run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clann_tpu
from clann_tpu.config import Config as JConfig
from clann_tpu.core.index import build_index as jbuild
from clann_tpu.core.index import quantize_q8 as jquantize_q8
from clann_tpu.data.synthetic import make_synthetic_dataset
from clann_tpu.ops import global_query as jgq

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import index_from_arrays
from clann_tpu_torch.metrics.recall import recall_values
from clann_tpu_torch.ops import gather as tg
from clann_tpu_torch.ops import global_query as tgq
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=10, num_clusters_factor=0.4, k=10, delta=0.9,
           lsh_engine="global", dense_layout=False, gather_block=8)
KW = dict(k=10, chunk=512, filter_expand=8)


@pytest.fixture(scope="module")
def world():
    ds = make_synthetic_dataset(n=4000, d=32, n_queries=48, k_gt=15, seed=3)
    cfg = dict(CFG, dataset_name=ds.name)
    jidx = jbuild(ds.train, JConfig(**cfg))
    tidx = index_from_arrays(index_arrays(jidx), TConfig(**cfg), device="cpu")
    source, filterer = jidx.rebuild_objects()
    qn = jnp.asarray(ds.test / np.linalg.norm(ds.test, axis=1, keepdims=True), jnp.float32)
    qh, qs = source.hash(qn), filterer.sketch(qn)
    tq = (torch.from_numpy(np.array(qn)), torch.from_numpy(np.array(qh).view(np.int32)),
          torch.from_numpy(np.array(qs).view(np.int32)))
    return dict(ds=ds, cfg=cfg, jidx=jidx, tidx=tidx, jq=(qn, qh, qs), tq=tq, ref={})


def _jax_ref(world, delta=0.9, filter_type="default"):
    """JAX's global_search_batch_mapped on the whole query batch (cached)."""
    key = (delta, filter_type)
    if key not in world["ref"]:
        s, i, st = jgq.global_search_batch_mapped(world["jidx"], *world["jq"], delta,
                                                  filter_type=filter_type, **KW)
        world["ref"][key] = (np.asarray(s), np.asarray(i),
                             {f: np.asarray(getattr(st, f)) for f in st._fields})
    return world["ref"][key]


def _assert_same(ref, sims, ids, stats):
    js, ji, jst = ref
    sims = sims.numpy() if isinstance(sims, torch.Tensor) else sims
    ids = ids.numpy() if isinstance(ids, torch.Tensor) else ids
    assert_topk_match(ji, js, ids, sims, atol=1e-5)
    for f, want in jst.items():
        got = getattr(stats, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(got, want, err_msg=f)


def _with(tidx, **cfg):
    return dataclasses.replace(tidx, config=tidx.config.replace(**cfg))


@pytest.mark.parametrize("delta", [0.9, 0.975])
@pytest.mark.parametrize("filter_type", ["default", "none"])
def test_engine_matches_jax(world, delta, filter_type):
    ls = tgq.LoopStats()
    launches = tg.ROWS_LAUNCHES
    out = tgq.global_search_batch_mapped(world["tidx"], *world["tq"], delta,
                                         filter_type=filter_type, loop_stats=ls, **KW)
    _assert_same(_jax_ref(world, delta, filter_type), *out)
    assert tg.ROWS_LAUNCHES == launches  # CPU tensors: K7's plain version
    assert ls.batches == 1 and ls.iterations >= 1
    # one stream-map sizing pull + one stop-flag pull per SYNC_EVERY steps
    assert ls.syncs == 1 + 1 + -(-ls.iterations // tgq.SYNC_EVERY)


@pytest.mark.parametrize("knob", [
    dict(stream_map=False),
    dict(dead_block_routing=False),
    dict(stream_map_blocks=1),  # a 1,024-block map: deep cursors take the fallback
    dict(window_index_dense=True),
])
def test_engine_knobs_do_not_change_results(world, knob):
    delta = 0.975
    out = tgq.global_search_batch_mapped(_with(world["tidx"], **knob), *world["tq"], delta,
                                         **KW)
    _assert_same(_jax_ref(world, delta), *out)


def test_capped_map_takes_the_fallback(world):
    """With a 1,024-position map the deepest live cursors overrun it, so
    some iterations take the in-loop derivation (and results still match)."""
    tidx = _with(world["tidx"], stream_map_blocks=1)
    qn, qh, qs = world["tq"]
    streams = tgq._prepare_streams(tidx, qn, qh, qs, min_depth=1)
    streams = tgq._attach_stream_map(streams, g=3, L=10, tb=1024)
    cond, body = tgq._loop_pieces(tidx, streams, 0.975, k=10, chunk=512, min_depth=1,
                                  filter_type="default", filter_expand=8)
    state = tgq._init_state(48, 10, streams["total"])
    mapped = fallback = 0
    while bool(cond(state)):
        live_max = int(torch.max(torch.where(state[2], 0, state[3])))
        use_map = live_max + 512 <= 1024  # WB = chunk * filter_expand / G = 512
        mapped, fallback = mapped + use_map, fallback + (not use_map)
        state = body(state, use_map)
    assert mapped and fallback
    assert int(state[3].max()) > 1024
    _assert_same(_jax_ref(world, 0.975), *tgq._finalize(tidx, streams, state, k=10))


def test_engine_is_batch_invariant(world):
    """Batches of 16 and one batch of 48 give the same per-query results."""
    ref = _jax_ref(world)
    parts = [tgq.global_search_batch_mapped(world["tidx"], *(t[s:s + 16] for t in world["tq"]),
                                            0.9, **KW) for s in range(0, 48, 16)]
    sims = torch.cat([p[0] for p in parts])
    ids = torch.cat([p[1] for p in parts])
    stats = tgq.SearchStats(*(torch.cat([p[2][f] for p in parts]) for f in range(3)))
    _assert_same(ref, sims, ids, stats)


def test_static_map_impl_matches(world):
    out = tgq.global_search_batch_impl(world["tidx"], *world["tq"], 0.9, static_map_tb=2048,
                                       **KW)
    _assert_same(_jax_ref(world), *out)


@pytest.fixture(scope="module")
def jax_search(world):
    """JAX's global_search (its own normalization and hashing), 48 queries."""
    return jgq.global_search(world["jidx"], world["ds"].test, k=10, delta=0.9)


@pytest.mark.parametrize("batch_size,sort", [(48, False), (16, False), (16, True)])
def test_global_search_matches_jax(world, jax_search, batch_size, sort):
    """The full driver: normalize, hash, sketch, batch (16 vs 48, with
    difficulty sorting), search, distances."""
    jd, ji, jst = jax_search
    ls = tgq.LoopStats()
    td, ti, tst = tgq.global_search(world["tidx"], world["ds"].test, k=10, delta=0.9,
                                    batch_size=batch_size, sort_by_difficulty=sort,
                                    loop_stats=ls)
    assert td.shape == (48, 10) and ti.dtype == np.int32
    _assert_same((jd, ji, {f: np.asarray(getattr(jst, f)) for f in jst._fields}), td, ti, tst)
    assert ls.batches == 48 // batch_size


def test_facade_lsh_modes(world, jax_search):
    """"lsh" resolves to "lsh-global" on an index with global tables and
    "auto" to "lsh" without the dense layout (clann_tpu/api.py:126-132);
    delta and filter_type reach the engine."""
    ds, cfg = world["ds"], world["cfg"]
    h = clann_tpu_torch.init_with_config(ds.train, TConfig(**cfg), device="cpu")
    h.index = world["tidx"]
    jd, ji, jst = jax_search
    for mode in ("lsh", "lsh-global", "auto", None):
        d, i, st = h.search_batch(ds.test, mode=mode)
        _assert_same((jd, ji, {f: np.asarray(getattr(jst, f)) for f in jst._fields}), d, i, st)
    j = clann_tpu.init_with_config(ds.train, JConfig(**cfg))
    j.index = world["jidx"]
    jd2, ji2, jst2 = j.search_batch(ds.test, mode="lsh", delta=0.975, filter_type="none")
    d, i, st = h.search_batch(ds.test, mode="lsh", delta=0.975, filter_type="none")
    _assert_same((jd2, ji2, {f: np.asarray(getattr(jst2, f)) for f in jst2._fields}), d, i, st)
    assert len(h.search(ds.test[0])) == 10


def _facades_with_layout_configured(world):
    """Port and JAX handles whose config sets dense_layout on an index
    built without the layout."""
    ds = world["ds"]
    cfg = {**world["cfg"], "dense_layout": True}
    h = clann_tpu_torch.init_with_config(ds.train, TConfig(**cfg), device="cpu")
    h.index = world["tidx"]
    j = clann_tpu.init_with_config(ds.train, JConfig(**cfg))
    j.index = world["jidx"]
    return h, j


def test_facade_auto_with_dense_layout_raises(world):
    """dense_layout set in the config but no layout built: "dense", the mode
    "auto" would take from the config alone, raises."""
    h, _ = _facades_with_layout_configured(world)
    with pytest.raises(ValueError, match="dense layout"):
        h.search_batch(world["ds"].test, mode="dense")


def test_facade_auto_resolves_on_the_index(world):
    """"auto" resolves on the built index, not on the config (as JAX's
    facade does): with dense_layout set but no layout built it is "lsh",
    the global engine; and "lsh" on an index without global tables is the
    clustered walk (here without slot records, G = 1)."""
    ds = world["ds"]
    h, j = _facades_with_layout_configured(world)
    d, i, st = h.search_batch(ds.test, mode="auto")
    jd, ji, jst = j.search_batch(ds.test, mode="auto")
    _assert_same((jd, ji, {f: np.asarray(getattr(jst, f)) for f in jst._fields}), d, i, st)
    h.index = dataclasses.replace(world["tidx"], g_records=None)
    j.index = world["jidx"].replace(g_records=None)
    d, i, st = h.search_batch(ds.test, mode="lsh")
    jd, ji, jst = j.search_batch(ds.test, mode="lsh")
    _assert_same((jd, ji, {f: np.asarray(getattr(jst, f)) for f in jst._fields}), d, i, st)


def test_recall_on_the_carried_index(world):
    """The carried JAX index through the port at delta 0.9: recall@10 >=
    0.8 * delta (ROADMAP item 8) and far fewer distance computations than n."""
    ds = world["ds"]
    d, _, st = tgq.global_search(world["tidx"], ds.test, k=10, delta=0.9)
    assert recall_values(ds.distances, d, 10)[0] >= 0.72
    assert st.distance_computations.mean() < 0.5 * ds.train.shape[0]


def test_search_without_global_tables_raises(world):
    from clann_tpu_torch.errors import DataError

    with pytest.raises(DataError, match="global"):
        tgq.global_search(dataclasses.replace(world["tidx"], g_records=None),
                          world["ds"].test[:2])


# ---------------------------------------------------------------------------
# the continuous-batching driver


def _stats_dict(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


@pytest.fixture(scope="module")
def queries70(world):
    """70 queries: the 48 test queries and 22 indexed points."""
    ds = world["ds"]
    return np.concatenate([ds.test, ds.train[:22]]).astype(np.float32)


@pytest.mark.parametrize("lanes,step_iters", [(16, 2), (16, 3), (128, 8)])
def test_continuous_matches_jax_and_global_search(world, queries70, lanes, step_iters):
    """70 queries through 16 lanes, 2 or 3 iterations per step (with a
    ragged last refill), and through 128 lanes (Q <= lanes: one batch of
    global_search): ids, sims and every counter as JAX's continuous driver
    and as the port's batched global_search."""
    jd, ji, jst = jgq.global_search_continuous(world["jidx"], queries70, lanes=lanes,
                                               step_iters=step_iters)
    ls = tgq.LoopStats()
    td, ti, tst = tgq.global_search_continuous(world["tidx"], queries70, lanes=lanes,
                                               step_iters=step_iters, loop_stats=ls)
    assert td.shape == (70, 10) and ti.dtype == np.int32
    _assert_same((jd, ji, _stats_dict(jst)), td, ti, tst)
    gd, gi, gst = tgq.global_search(world["tidx"], queries70)
    _assert_same((gd, gi, _stats_dict(gst)), td, ti, tst)
    assert ls.batches == 1
    if lanes < 70:  # steps of at most step_iters iterations, each ending in a done-flag pull
        assert ls.outer_steps >= 70 // lanes and ls.iterations <= step_iters * ls.outer_steps
        assert ls.syncs >= 1 + 2 * ls.outer_steps
    else:
        assert ls.outer_steps == 0


def test_continuous_without_stream_map(world, queries70):
    """The continuous driver on the in-loop derivation (no stream map)."""
    jd, ji, jst = jgq.global_search_continuous(world["jidx"], queries70, lanes=16,
                                               step_iters=3)
    td, ti, tst = tgq.global_search_continuous(_with(world["tidx"], stream_map=False),
                                               queries70, lanes=16, step_iters=3)
    _assert_same((jd, ji, _stats_dict(jst)), td, ti, tst)


def test_continuous_write_back_keeps_other_rows(world):
    """One packed step touches only the active rows of the full state."""
    tidx = world["tidx"]
    qn, qh, qs = world["tq"]
    streams = tgq._prepare_streams(tidx, qn, qh, qs, min_depth=1)
    state = tgq._init_state(48, 10, streams["total"])
    before = tuple(t.clone() for t in state)
    active = torch.tensor([5, 0, 17, 40])
    state, done = tgq._global_step_packed(tidx, streams, state, active, 0.9, max_iters=2,
                                          min_depth=1, filter_type="default", **KW)
    assert done.shape == (4,)
    rest = torch.ones(48, dtype=torch.bool)
    rest[active] = False
    for b, a in zip(before, state):
        assert torch.equal(b[rest], a[rest])
    assert (state[3][active] > 0).all()  # every active cursor moved


# ---------------------------------------------------------------------------
# the int8 rescore


@pytest.fixture(scope="module")
def int8_world(world):
    """The carried index with the int8 shadow on both sides."""
    j = world["jidx"].replace(config=world["jidx"].config.replace(rescore_dtype="int8"),
                              vectors_q8=jquantize_q8(world["jidx"].vectors))
    cfg = dict(world["cfg"], rescore_dtype="int8")
    t = index_from_arrays(index_arrays(j), TConfig(**cfg), device="cpu")
    assert t.vectors_q8.dtype == torch.int8
    return j, t


@pytest.mark.parametrize("filter_type", ["default", "none"])
def test_engine_int8_matches_jax(world, int8_world, filter_type):
    """The int8 engine: 2k buffer of int8 dots, the k-th lowered by
    sqrt(d)/127, the buffer re-scored in f32."""
    j, t = int8_world
    s, i, st = jgq.global_search_batch_mapped(j, *world["jq"], 0.9, filter_type=filter_type,
                                              **KW)
    out = tgq.global_search_batch_mapped(t, *world["tq"], 0.9, filter_type=filter_type, **KW)
    _assert_same((np.asarray(s), np.asarray(i), _stats_dict(st)), *out)
    f32 = _jax_ref(world, 0.9, filter_type)
    assert not np.array_equal(f32[2]["distance_computations"], np.asarray(st[0]))


def test_continuous_int8_matches_jax(world, int8_world, queries70):
    j, t = int8_world
    jd, ji, jst = jgq.global_search_continuous(j, queries70, lanes=16, step_iters=3)
    td, ti, tst = tgq.global_search_continuous(t, queries70, lanes=16, step_iters=3)
    _assert_same((jd, ji, _stats_dict(jst)), td, ti, tst)


# ---------------------------------------------------------------------------
# knobs of the global engine


@pytest.mark.parametrize("cap,sort", [(8, False), (12, False), (8, True)])
def test_global_entry_cap_matches_jax(world, cap, sort):
    """config.global_entry_cap enters the stream at a shallower depth, in
    the engine and in the difficulty sort."""
    j = world["jidx"].replace(config=world["jidx"].config.replace(global_entry_cap=cap))
    t = _with(world["tidx"], global_entry_cap=cap)
    assert tgq._entry_depth(t, 1) == cap
    q = world["ds"].test
    jd, ji, jst = jgq.global_search(j, q, k=10, delta=0.9, batch_size=16,
                                    sort_by_difficulty=sort)
    td, ti, tst = tgq.global_search(t, q, k=10, delta=0.9, batch_size=16,
                                    sort_by_difficulty=sort)
    _assert_same((jd, ji, _stats_dict(jst)), td, ti, tst)


def test_tensored_source_matches_jax(world):
    """hash_source="tensor": the tensored tables and their effective
    collision table, built by JAX and carried across."""
    ds = world["ds"]
    cfg = dict(world["cfg"], hash_source="tensor")
    jidx = jbuild(ds.train, JConfig(**cfg))
    tidx = index_from_arrays(index_arrays(jidx), TConfig(**cfg), device="cpu")
    jd, ji, jst = jgq.global_search(jidx, ds.test, k=10, delta=0.9)
    td, ti, tst = tgq.global_search(tidx, ds.test, k=10, delta=0.9)
    _assert_same((jd, ji, _stats_dict(jst)), td, ti, tst)

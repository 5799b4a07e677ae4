"""The clustered delta walk (ops/query.search_batch_impl, search,
search_by_id) and its prefix-map pieces (ops/prefixmap.revealed_range,
chunk_stream_direct) against the JAX package's on the CPU.

Both packages search ONE index: a JAX-built clustered-engine index
(3,000 x 32, 21 clusters, L = 8 simhash tables, slot records in blocks of
G = 16) is carried across whole with index_from_arrays, and the walk is fed
JAX's normalized queries, query hashes and sketches. Tolerances: the
prefix-map pieces bit for bit; similarities within 1e-5 (f32 dots summed in
another order); ids per query as sets up to boundary ties
(testing.assert_topk_match); distance_computations, candidates and
clusters_visited identical per query. A knob variant changes the carried
index on both sides (records dropped, lsh_level_chunk) or the walk's
arguments (group_ranks, filter_type, delta), and gets its own JAX run.
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
from clann_tpu.ops import prefixmap as jpm
from clann_tpu.ops import query as jq

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import index_from_arrays, with_rescore_dtype
from clann_tpu_torch.metrics.recall import recall_values
from clann_tpu_torch.ops import gather as tg
from clann_tpu_torch.ops import prefixmap as tpm
from clann_tpu_torch.ops import query as tq
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=8, num_clusters_factor=0.4, k=10, delta=0.9, hash_family="simhash",
           candidate_chunk=128, lsh_engine="clustered", dense_layout=False, seed=0)
KW = dict(k=10, chunk=128, filter_expand=8)


def _carry(jidx, cfg):
    return index_from_arrays(index_arrays(jidx), TConfig(**cfg), device="cpu")


def _hashed(jidx, queries):
    source, filterer = jidx.rebuild_objects()
    qn = jnp.asarray(queries / np.linalg.norm(queries, axis=1, keepdims=True), jnp.float32)
    qh, qs = source.hash(qn), filterer.sketch(qn)
    return (qn, qh, qs), _t(qn, qh, qs)


def _t(qn, qh, qs):
    return (torch.from_numpy(np.array(qn)), torch.from_numpy(np.array(qh).view(np.int32)),
            torch.from_numpy(np.array(qs).view(np.int32)))


@pytest.fixture(scope="module")
def world():
    ds = make_synthetic_dataset(n=3000, d=32, n_queries=40, k_gt=10, seed=11)
    cfg = dict(CFG, dataset_name=ds.name)
    jidx = jbuild(ds.train, JConfig(**cfg))
    assert jidx.slot_records is not None and jidx.dir_bits > 0
    jqs, tqs = _hashed(jidx, ds.test)
    return dict(ds=ds, cfg=cfg, jidx=jidx, tidx=_carry(jidx, cfg), jq=jqs, tq=tqs, ref={})


def _variant(world, records=True, level_chunk=0, entry_cap=True, directory=True,
             int8=False):
    """(JAX index, port index) with the knobs changed on both sides:
    lsh_level_chunk and lsh_entry_cap in the config, the slot records or
    the prefix directory (prefix_dir_bits=0) dropped, or the int8 shadow
    added (JAX's quantize_q8 on its side, the port's with_rescore_dtype on
    its own)."""
    j, t = world["jidx"], world["tidx"]
    knobs = {}
    if level_chunk:
        knobs["lsh_level_chunk"] = level_chunk
    if not entry_cap:
        knobs["lsh_entry_cap"] = False
    if not directory:
        knobs["prefix_dir_bits"] = 0
    if knobs:
        j = j.replace(config=j.config.replace(**knobs))
        t = dataclasses.replace(t, config=t.config.replace(**knobs))
    if not records:
        j, t = j.replace(slot_records=None), dataclasses.replace(t, slot_records=None)
    if not directory:  # what a build with prefix_dir_bits=0 makes
        j = j.replace(prefix_dir=None, dir_bits=0, dir_iters=0)
        t = dataclasses.replace(t, prefix_dir=None, dir_bits=0, dir_iters=0)
    if int8:
        j = j.replace(config=j.config.replace(rescore_dtype="int8"),
                      vectors_q8=jquantize_q8(j.vectors))
        t = with_rescore_dtype(t, "int8")
        np.testing.assert_array_equal(t.vectors_q8.numpy(), np.asarray(j.vectors_q8))
    return j, t


def _assert_same(ref, sims, ids, stats):
    js, ji, jst = ref
    sims = sims.numpy() if isinstance(sims, torch.Tensor) else sims
    ids = ids.numpy() if isinstance(ids, torch.Tensor) else ids
    assert_topk_match(ji, js, ids, sims, atol=1e-5)
    for f in jst._fields:
        got = getattr(stats, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(got, np.asarray(getattr(jst, f)), err_msg=f)


# ---------------------------------------------------------------------------
# prefix-map pieces of the walk


def test_revealed_range_matches_jax(world):
    j = world["jidx"]
    qn, qh, _ = world["jq"]
    Q, D = qh.shape[0], j.config.max_hashbits
    starts = np.asarray(j.cluster_starts)
    members = np.asarray(jnp.argmin(1.0 - qn @ j.centers.T, axis=1))
    seg_lo, seg_hi = jnp.asarray(starts[members]), jnp.asarray(starts[members + 1])
    lo, hi = jpm.depth_bounds(j.sorted_hash, qh, seg_lo, seg_hi, D, 14)
    rng = np.random.default_rng(0)
    for depth in (rng.integers(1, D + 1, Q), np.full(Q, D), np.ones(Q, np.int64)):
        js, jz = jpm.revealed_range(lo, hi, qh, jnp.asarray(depth, jnp.int32), D)
        ts, tz = tpm.revealed_range(torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)),
                                    world["tq"][1], torch.from_numpy(depth), D)
        assert ts.dtype == tz.dtype == torch.int32
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("lc,d_top,entry", [(1, 10, True), (2, 10, True), (2, 7, False),
                                            (3, 2, False), (4, 10, True)])
def test_chunk_stream_direct_matches_jax(world, lc, d_top, entry):
    """Both JAX variants (directory gather and MXU one-hot) against the
    port's gather, including windows reaching below min_depth."""
    j = world["jidx"]
    qn, qh, _ = world["jq"]
    D, bits = j.config.max_hashbits, j.dir_bits
    members = jnp.argsort(1.0 - qn @ j.centers.T, axis=1)[:, :3].reshape(-1)
    qh3 = jnp.repeat(qh, 3, axis=0)
    args = (lc, D, bits, 1, bits)
    want = jpm.chunk_stream_direct(qh3, jnp.int32(d_top), jnp.bool_(entry), *args,
                                   cdir=j.prefix_dir[:, members, :])
    want_oh = jpm.chunk_stream_direct(
        qh3, jnp.int32(d_top), jnp.bool_(entry), *args,
        cdir_oh=jpm._dir_rows_onehot(j.prefix_dir.astype(jnp.float32), members))
    t = world["tidx"]
    got = tpm.chunk_stream_direct(
        torch.from_numpy(np.array(qh3).view(np.int32)), d_top, entry, *args,
        cdir=t.prefix_dir.index_select(1, torch.from_numpy(np.array(members)).long()))
    for w in (want, want_oh):
        for a, b in zip(got, w):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("lc,d_top,entry", [(1, 10, True), (2, 7, False), (4, 10, True)])
def test_chunk_stream_direct_takes_the_one_hot_rows(world, lc, d_top, entry):
    """cdir_oh, the directory rows as JAX's one-hot path hands them over
    (f32, prefixmap._dir_rows_onehot), gives JAX's ranges and those of the
    cdir it encodes; exactly one of the two must be given, as in JAX."""
    j, t = world["jidx"], world["tidx"]
    qn, qh, _ = world["jq"]
    D, bits = j.config.max_hashbits, j.dir_bits
    members = jnp.argsort(1.0 - qn @ j.centers.T, axis=1)[:, :3].reshape(-1)
    qh3 = jnp.repeat(qh, 3, axis=0)
    args = (lc, D, bits, 1, bits)
    oh = jpm._dir_rows_onehot(j.prefix_dir.astype(jnp.float32), members)
    want = jpm.chunk_stream_direct(qh3, jnp.int32(d_top), jnp.bool_(entry), *args, cdir_oh=oh)
    tq3 = torch.from_numpy(np.array(qh3).view(np.int32))
    cdir = t.prefix_dir.index_select(1, torch.from_numpy(np.array(members)).long())
    got_oh = tpm.chunk_stream_direct(tq3, d_top, entry, *args,
                                     cdir_oh=torch.from_numpy(np.array(oh)))
    got = tpm.chunk_stream_direct(tq3, d_top, entry, *args, cdir=cdir)
    for a, b, w in zip(got_oh, got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        assert torch.equal(a, b)
    for both in ({}, {"cdir": cdir, "cdir_oh": cdir.to(torch.float32)}):
        with pytest.raises(ValueError, match="exactly one of cdir_oh and cdir"):
            tpm.chunk_stream_direct(tq3, d_top, entry, *args, **both)


# ---------------------------------------------------------------------------
# the walk


def _walk(world, *, records=True, level_chunk=0, group_ranks=1, delta=0.9,
          filter_type="default", queries=None, entry_cap=True, directory=True, int8=False):
    """(JAX result, port result, port LoopStats) of one knob variant."""
    j, t = _variant(world, records, level_chunk, entry_cap, directory, int8)
    jqs, tqs = (world["jq"], world["tq"]) if queries is None else queries
    kw = dict(KW, group_ranks=group_ranks, filter_type=filter_type)
    js, ji, jst = jq.search_batch_jit(j, *jqs, jnp.float32(delta), **kw)
    ls = tq.LoopStats()
    out = tq.search_batch_impl(t, *tqs, delta, loop_stats=ls, **kw)
    return (np.asarray(js), np.asarray(ji), jst), out, ls


_WALKS = {
    "default": {},
    "no-records": dict(records=False),
    "group-ranks-4": dict(group_ranks=4),
    "no-records-group-ranks-4": dict(records=False, group_ranks=4),
    "level-chunk-1": dict(level_chunk=1),
    "level-chunk-2": dict(level_chunk=2),
    "level-chunk-2-group-ranks-4": dict(level_chunk=2, group_ranks=4),
    "level-chunk-1-no-records": dict(level_chunk=1, records=False),
    "filter-none": dict(filter_type="none"),
    "filter-none-level-chunk-2": dict(filter_type="none", level_chunk=2),
    "delta-0.5": dict(delta=0.5),
    "delta-0.99": dict(delta=0.99),
    "delta-0.99-group-ranks-4-level-chunk-1": dict(delta=0.99, group_ranks=4, level_chunk=1),
    "no-entry-cap": dict(entry_cap=False),
    "no-entry-cap-level-chunk-2": dict(entry_cap=False, level_chunk=2),
    "no-directory": dict(directory=False),
    "int8": dict(int8=True),
    "int8-level-chunk-2-group-ranks-4": dict(int8=True, level_chunk=2, group_ranks=4),
}


@pytest.mark.parametrize("case", list(_WALKS))
def test_walk_matches_jax(world, case):
    ref, out, ls = _walk(world, **_WALKS[case])
    _assert_same(ref, *out)
    assert out[1].dtype == torch.int32 and out[0].shape == (world["ds"].test.shape[0], 10)
    # the loop accounting: the stop flag is read before every iteration and
    # once more at the end of each outer step, plus at most one descend read
    assert ls.batches == 1 and ls.outer_steps >= 1
    assert 0 <= ls.syncs - ls.iterations - ls.outer_steps <= ls.outer_steps


def test_walk_record_gather_uses_k7_only_on_cuda(world):
    """CPU tensors take K7's plain version: no launch is counted."""
    before = tg.ROWS_LAUNCHES
    _, (s, i, _), _ = _walk(world)
    assert tg.ROWS_LAUNCHES == before and (i >= 0).all()


def test_walk_lazy_windows_descend(world):
    """lsh_level_chunk 1 runs the walk a level at a time: some group
    descends past its entry window, so there are more outer steps than
    groups, and the eager walk takes one step per group."""
    C = world["jidx"].centers.shape[0]
    _, _, eager = _walk(world)
    _, _, lazy = _walk(world, level_chunk=1, delta=0.99)
    assert eager.outer_steps <= C
    assert lazy.outer_steps > C or lazy.outer_steps > eager.outer_steps


def test_walk_all_brute_force():
    """Every segment under 100 points: each member is one brute range."""
    ds = make_synthetic_dataset(n=600, d=16, n_queries=24, k_gt=10, seed=2)
    cfg = dict(CFG, dataset_name=ds.name, num_clusters_factor=2.0)
    jidx = jbuild(ds.train, JConfig(**cfg))
    assert (np.diff(np.asarray(jidx.cluster_starts)) < 100).all()
    w = dict(jidx=jidx, tidx=_carry(jidx, cfg))
    jqs, tqs = _hashed(jidx, ds.test)
    for gr in (1, 3):
        ref, out, _ = _walk(w, group_ranks=gr, queries=(jqs, tqs))
        _assert_same(ref, *out)
    # brute force over the visited clusters is exact for what it visits
    assert (out[2].distance_computations > 0).all()


def test_walk_per_cluster_hashes(world):
    """(Q, C, L) / (Q, C, S, W) query hashes: each rank takes its cluster's
    row (the per-cluster functions of a faithful import). Here cluster c
    hashes and sketches the queries rolled by c, so rows differ."""
    j = world["jidx"]
    C = j.centers.shape[0]
    qn, qh, qs = world["jq"]
    qh_pc = jnp.stack([jnp.roll(qh, c, axis=0) for c in range(C)], axis=1)
    qs_pc = jnp.stack([jnp.roll(qs, c, axis=0) for c in range(C)], axis=1)
    for gr in (1, 4):
        ref, out, _ = _walk(world, group_ranks=gr,
                            queries=((qn, qh_pc, qs_pc), _t(qn, qh_pc, qs_pc)))
        _assert_same(ref, *out)
    # the per-cluster walk differs from the shared-hash one
    _, plain, _ = _walk(world)
    assert not torch.equal(out[2].candidates, plain[2].candidates)


def test_walk_rejects_uint_words(world):
    qn, qh, qs = world["tq"]
    with pytest.raises(ValueError, match="int32"):
        tq.search_batch_impl(world["tidx"], qn, qh.to(torch.int64), qs, 0.9, **KW,
                             group_ranks=1)


# ---------------------------------------------------------------------------
# search, search_by_id and the facade


@pytest.mark.parametrize("batch_size,delta,filter_type", [
    (256, 0.9, "default"), (16, 0.9, "default"), (16, 0.95, "none")])
def test_search_matches_jax(world, batch_size, delta, filter_type):
    """search hashes and sketches itself; batch 16 pads the last of three
    batches by repeating its last query."""
    q = world["ds"].test * 3.0  # off the unit sphere: both normalize
    jd, ji, jst = jq.search(world["jidx"], q, k=10, delta=delta, batch_size=batch_size,
                            filter_type=filter_type)
    ls = tq.LoopStats()
    td, ti, tst = tq.search(world["tidx"], q, k=10, delta=delta, batch_size=batch_size,
                            filter_type=filter_type, loop_stats=ls)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    for f in jst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)), err_msg=f)
    assert ls.batches == -(-len(q) // batch_size)
    assert np.isinf(td[ti < 0]).all() and td.dtype == np.float32


@pytest.mark.parametrize("exclude_self", [True, False])
def test_search_by_id_matches_jax(world, exclude_self):
    ids = np.arange(0, 3000, 97)
    jd, ji, _ = jq.search_by_id(world["jidx"], ids, k=10, exclude_self=exclude_self)
    td, ti, _ = tq.search_by_id(world["tidx"], ids, k=10, exclude_self=exclude_self)
    assert ti.shape == (len(ids), 10)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    if exclude_self:
        assert not (ti == ids[:, None]).any()
        # the same as search on those vectors at k + 1, self removed
        sd, si, _ = tq.search(world["tidx"], world["tidx"].vectors[ids], k=11)
        for r in range(len(ids)):
            keep = si[r] != ids[r]
            np.testing.assert_array_equal(ti[r], si[r][keep][:10])
            np.testing.assert_array_equal(td[r], sd[r][keep][:10])
    else:
        assert (ti[:, 0] == ids).all()


def test_search_per_cluster_params_raise(world):
    """search on an index with per-cluster functions (a faithful import's)
    hashes and sketches the queries with each cluster's own, as JAX's does:
    here cluster c's planes are the shared ones with the function axis
    rolled by c. Once refused as unported; now held to JAX. Per-cluster
    hash functions without per-cluster sketch functions are refused."""
    j, t = world["jidx"], world["tidx"]
    C = j.centers.shape[0]
    pc = {name: {"dirs": np.stack([np.roll(np.asarray(p["dirs"]), c, axis=0)
                                   for c in range(C)])}
          for name, p in (("pc_hash_params", j.hash_params),
                          ("pc_sketch_params", j.sketch_params))}
    jpc = j.replace(**{k: {"dirs": jnp.asarray(v["dirs"])} for k, v in pc.items()})
    tpc = dataclasses.replace(t, **{k: {"dirs": torch.from_numpy(v["dirs"])}
                                    for k, v in pc.items()})
    q = world["ds"].test
    jd, ji, jst = jq.search(jpc, q, k=10, delta=0.9)
    td, ti, tst = tq.search(tpc, q, k=10, delta=0.9)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    for f in jst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)), err_msg=f)
    _, _, plain = tq.search(t, q, k=10, delta=0.9)
    assert not np.array_equal(tst.candidates, plain.candidates)
    with pytest.raises(ValueError, match="pc_sketch_params"):
        tq.search(dataclasses.replace(tpc, pc_sketch_params=None), q[:2])


@pytest.fixture(scope="module")
def facades(world):
    ds = world["ds"]
    jh = clann_tpu.init_with_config(ds.train, JConfig(**world["cfg"]))
    jh.index = world["jidx"]
    th = clann_tpu_torch.init_with_config(ds.train, TConfig(**world["cfg"]), device="cpu")
    th.index = world["tidx"]
    return jh, th


@pytest.mark.parametrize("mode", ["lsh", "lsh-clustered", "auto", None])
def test_facade_lsh_resolves_to_the_walk(world, facades, mode):
    """With lsh_engine="clustered" there are no global tables: "lsh" (and
    "auto" without the dense layout) is the walk (clann_tpu/api.py:126-132)."""
    jh, th = facades
    q = world["ds"].test
    jd, ji, jst = jh.search_batch(q, mode=mode, delta=0.9)
    td, ti, tst = th.search_batch(q, mode=mode, delta=0.9)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    for f in jst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)), err_msg=f)
    assert len(th.search(q[0])) == 10


def test_facade_search_by_id(world, facades):
    jh, th = facades
    ids = [5, 17, 2999]
    jd, ji, _ = jh.search_by_id(ids)
    td, ti, _ = th.search_by_id(ids)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    assert not (ti == np.asarray(ids)[:, None]).any()


def test_walk_meets_the_delta_contract(world):
    """The carried index through the port's walk: recall@10 >= 0.8 * delta
    (the PUFFINN contract) with fewer distance computations than n."""
    ds = world["ds"]
    d, _, st = tq.search(world["tidx"], ds.test, k=10, delta=0.9)
    assert recall_values(ds.distances, d, 10)[0] >= 0.72
    assert st.distance_computations.mean() < ds.train.shape[0]


def test_own_build_walk(world):
    """The port's own clustered build (its own random draws) searched by the
    walk, records and directory included."""
    ds = world["ds"]
    h = clann_tpu_torch.init_with_config(ds.train, TConfig(**world["cfg"]),
                                         device="cpu").build()
    assert h.index.slot_records is not None and h.index.g_records is None
    d, i, st = h.search_batch(ds.test, mode="lsh")
    assert recall_values(ds.distances, d, 10)[0] >= 0.72
    assert (st.clusters_visited >= 1).all() and (i >= 0).all()

"""Incremental insert / rebuild and the C = 1 index of the port
(core/index.insert, rebuild, build_lsh_index, num_pending; the facade's
insert / rebuild) against the JAX package on the CPU, at the shapes of
tests/test_insert_rebuild.py (1,000 x 24, L = 10 SimHash tables).

JAX builds the index and it is carried across with index_from_arrays, so
both packages insert into and rebuild the same index. Tolerances:

- insert: the old rows of `vectors` bit-identical, the new rows within
  1e-6 (one normalization, summed in another order); assignment,
  n_indexed and the int8 shadow exact; radii within 1e-6;
- rebuild: hash tables, sketches, global records, slot records, prefix
  directories and cluster bookkeeping bit-identical;
- on the port's own draws (JAX's invariants): insert + rebuild equals a
  fresh build_lsh_index of all points, over one and two rounds, bit for bit.
"""

import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.data.synthetic import clustered_unit_vectors, random_unit_vectors

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.ops.global_query import global_search
from clann_tpu_torch.ops.ivf import scan_search
from clann_tpu_torch.ops.query import search as walk_search
from clann_tpu_torch.testing import index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=10, k=5, delta=0.9, hash_family="simhash", candidate_chunk=128,
           seed=7, lsh_engine="both")
# flat (C = 1, build_lsh_index) and clustered (GMM) indexes; the clustered
# one with the int8 shadow, so insert extends vectors_q8
KINDS = {
    "flat": dict(),
    "clustered": dict(num_clusters_factor=0.3, brute_force_threshold=20,
                      rescore_dtype="int8"),
}
N_OLD = 700


def _build_jax(kind, data):
    cfg = JConfig(**CFG, **KINDS[kind])
    if kind == "flat":
        return jindex.build_lsh_index(data, cfg)
    return jindex.build_index(data, cfg)


@pytest.fixture(scope="module")
def data():
    return clustered_unit_vectors(1000, 24, n_modes=8, seed=5)


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request, data):
    """(kind, JAX index on the first N_OLD points, the same index in the port)."""
    kind = request.param
    jidx = _build_jax(kind, data[:N_OLD])
    tidx = tindex.index_from_arrays(index_arrays(jidx), TConfig(**CFG, **KINDS[kind]),
                                    device="cpu")
    return kind, jidx, tidx


def _np(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_insert_matches_jax(pair, data):
    kind, jidx, tidx = pair
    j, t = jindex.insert(jidx, data[N_OLD:]), tindex.insert(tidx, data[N_OLD:])
    assert t.num_pending == j.num_pending == 1000 - N_OLD
    assert t.n_indexed == j.n_indexed == N_OLD and t.n == j.n == 1000
    tv, jv = t.vectors.numpy(), np.asarray(j.vectors)
    np.testing.assert_array_equal(tv[:N_OLD], jv[:N_OLD])
    np.testing.assert_allclose(tv[N_OLD:], jv[N_OLD:], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(t.assignment), _np(j.assignment))
    np.testing.assert_allclose(t.radii.numpy(), np.asarray(j.radii), rtol=0, atol=1e-6)
    if kind == "clustered":
        assert t.vectors_q8.shape == (1000, 24)
        np.testing.assert_array_equal(t.vectors_q8.numpy(), np.asarray(j.vectors_q8))
        assert (t.radii >= tidx.radii).all()
    else:
        assert t.vectors_q8 is None and j.vectors_q8 is None
    # the tables are untouched until rebuild
    for f in ("sorted_hash", "sorted_idx", "sketches", "g_records"):
        assert getattr(t, f) is getattr(tidx, f)


_REBUILT = ("sorted_hash", "sorted_idx", "sketches", "g_sorted_hash", "g_records",
            "slot_records", "prefix_dir", "g_dir", "cluster_starts", "brute",
            "assignment", "center_ids", "vectors_q8")


def test_rebuild_matches_jax(pair, data):
    kind, jidx, tidx = pair
    j = jindex.rebuild(jindex.insert(jidx, data[N_OLD:]))
    t = tindex.rebuild(tindex.insert(tidx, data[N_OLD:]))
    assert t.num_pending == j.num_pending == 0
    for f in _REBUILT:
        jf, tf = getattr(j, f), getattr(t, f)
        assert (jf is None) == (tf is None), f
        if jf is not None:
            np.testing.assert_array_equal(_np(tf), _np(jf), err_msg=f)
    assert (t.max_seg_len, t.dir_bits, t.dir_iters, t.g_dir_iters) == (
        j.max_seg_len, j.dir_bits, j.dir_iters, j.g_dir_iters)
    np.testing.assert_allclose(t.radii.numpy(), np.asarray(j.radii), rtol=0, atol=1e-6)
    assert t.memory_usage() == j.memory_usage()


def _table_pairs(idx):
    return idx.sorted_hash.numpy().astype(np.int64) * (1 << 32) + idx.sorted_idx.numpy()


def _same_build(a, b):
    np.testing.assert_array_equal(_table_pairs(a), _table_pairs(b))
    for f in ("sketches", "g_records", "slot_records", "prefix_dir", "vectors"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    torch.testing.assert_close(a.radii, b.radii, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope"])
def test_incremental_equals_fresh_build(family):
    """JAX's invariant on the port's own draws: the stored hash functions
    are reused, so insert + rebuild equals building on all points."""
    data = random_unit_vectors(1000, 24, seed=0)
    cfg = TConfig(**{**CFG, "hash_family": family})
    fresh = tindex.build_lsh_index(data, cfg, device="cpu")
    inc = tindex.insert(tindex.build_lsh_index(data[:700], cfg, device="cpu"), data[700:])
    assert inc.num_pending == 300
    inc = tindex.rebuild(inc)
    assert inc.num_pending == 0 and inc.n == 1000 and inc.n_clusters == 1
    _same_build(inc, fresh)


def test_two_rounds_of_insertion():
    data = random_unit_vectors(900, 16, seed=2)
    cfg = TConfig(**{**CFG, "num_tables": 6})
    idx = tindex.build_lsh_index(data[:300], cfg, device="cpu")
    idx = tindex.rebuild(tindex.insert(idx, data[300:600]))
    idx = tindex.rebuild(tindex.insert(idx, data[600:]))
    _same_build(idx, tindex.build_lsh_index(data, cfg, device="cpu"))


def test_rebuild_without_pending_is_identity():
    idx = tindex.build_lsh_index(random_unit_vectors(200, 8, seed=0), TConfig(**CFG),
                                 device="cpu")
    assert idx.num_pending == 0 and tindex.rebuild(idx) is idx


@pytest.mark.parametrize("engine", ["lsh-global", "lsh-clustered"])
def test_pending_invisible_until_rebuild(engine):
    """The LSH engines read the tables only; the dense scan reads
    `vectors` and sees pending points (JAX's contract)."""
    data = random_unit_vectors(500, 16, seed=3)
    extra = random_unit_vectors(40, 16, seed=4)
    cfg = TConfig(**{**CFG, "num_tables": 6})
    idx = tindex.insert(tindex.build_lsh_index(data, cfg, device="cpu"), extra)
    search = global_search if engine == "lsh-global" else walk_search
    _, ids, _ = search(idx, extra[:8], k=5, delta=0.9)
    assert ids.max() < 500
    d_scan, i_scan, _ = scan_search(idx, extra[:8], k=5)
    np.testing.assert_array_equal(i_scan[:, 0], 500 + np.arange(8))
    assert (d_scan[:, 0] < 1e-5).all()
    dists, ids, _ = search(tindex.rebuild(idx), extra[:8], k=5, delta=0.9)
    np.testing.assert_array_equal(ids[:, 0], 500 + np.arange(8))
    assert (dists[:, 0] < 1e-5).all()


def test_clustered_insert_grows_balls():
    """Every new point lies inside its (possibly grown) ball, no radius
    shrinks, and after rebuild the walk finds the new points (JAX's bar)."""
    data = clustered_unit_vectors(2000, 16, n_modes=8, seed=5)
    extra = clustered_unit_vectors(100, 16, n_modes=8, seed=6)
    cfg = TConfig(**{**CFG, "num_clusters_factor": 0.3, "brute_force_threshold": 20})
    idx = tindex.build_index(data, cfg, device="cpu")
    idx2 = tindex.insert(idx, extra)
    cd = 1.0 - idx2.vectors[2000:] @ idx2.centers.T
    a = idx2.assignment[2000:].long()
    assert (cd[torch.arange(100), a] <= idx2.radii[a] + 1e-5).all()
    assert (idx2.radii >= idx.radii).all()
    dists, ids, _ = walk_search(tindex.rebuild(idx2), extra[:16], k=5, delta=0.9)
    found = (ids[:, 0] >= 2000) & (dists[:, 0] < 1e-5)
    assert found.mean() >= 0.9


@pytest.mark.parametrize("points, match", [
    (np.zeros((0, 8), np.float32), "non-empty"),
    (np.zeros((3, 9), np.float32), "dimension"),
    (np.zeros((2, 2, 8), np.float32), "non-empty"),
])
def test_insert_errors(points, match):
    idx = tindex.build_lsh_index(random_unit_vectors(200, 8, seed=0), TConfig(**CFG),
                                 device="cpu")
    with pytest.raises(DataError, match=match):
        tindex.insert(idx, points)


def test_insert_one_point_and_tensor_input():
    data = random_unit_vectors(300, 8, seed=1)
    idx = tindex.build_lsh_index(data[:299], TConfig(**CFG), device="cpu")
    a = tindex.insert(idx, data[299])
    b = tindex.insert(idx, torch.from_numpy(data[299:]))
    assert a.num_pending == b.num_pending == 1
    assert torch.equal(a.vectors, b.vectors) and torch.equal(a.radii, b.radii)


def _table_multisets(idx):
    """Per-table (hash, id) pairs lexsorted: equal for two indexes whose
    tables hold the same hashes, whatever their cluster segments."""
    return np.sort(_table_pairs(idx), axis=1)


def test_facade_insert_rebuild(data):
    """clann_tpu_torch.insert / rebuild on a handle: the handle's data is
    re-made from the index, and the rebuilt tables hold the hashes of a
    fresh C = 1 build over the handle's vectors (JAX's
    test_api_roundtrip_matches)."""
    cfg = TConfig(**{**CFG, "num_tables": 6, "lsh_engine": "global"})
    h = clann_tpu_torch.init_with_config(data[:400], cfg, device="cpu")
    clann_tpu_torch.build(h)
    assert h.index.n_clusters > 1
    assert clann_tpu_torch.insert(h, data[400:450]) is h
    assert h.index.num_pending == 50 and h.data.num_points() == 450
    np.testing.assert_array_equal(h.data.raw, h.index.vectors.numpy())
    assert clann_tpu_torch.rebuild(h) is h and h.index.num_pending == 0
    fresh = tindex.build_lsh_index(h.index.vectors, cfg, device="cpu")
    np.testing.assert_array_equal(_table_multisets(h.index), _table_multisets(fresh))
    _, ids, _ = h.search_batch(data[420:428], mode="lsh")
    np.testing.assert_array_equal(ids[:, 0], 420 + np.arange(8))
    with pytest.raises(DataError):
        clann_tpu_torch.init_with_config(data[:10], cfg, device="cpu").insert(data[:2])


def test_flat_facade_rebuild_equals_build_lsh_index(data):
    cfg = TConfig(**{**CFG, "num_tables": 6, "lsh_engine": "global"})
    h = clann_tpu_torch.init_with_config(data[:400], cfg, device="cpu")
    h.index = tindex.build_lsh_index(data[:400], cfg, device="cpu")
    h.insert(data[400:]).rebuild()
    _same_build(h.index, tindex.build_lsh_index(data, cfg, device="cpu"))


def test_insert_gives_fresh_caches():
    """dataclasses.replace would share the cache dicts: the new index has
    its own, and the old index keeps its entries."""
    data = random_unit_vectors(600, 16, seed=8)
    idx = tindex.build_lsh_index(data[:500], TConfig(**CFG), device="cpu")
    scan_search(idx, data[:4], k=5, use_pallas=True, pallas_auto_route=False)
    assert idx.pallas_base_cache
    old = dict(idx.pallas_base_cache)
    new = tindex.insert(idx, data[500:])
    assert new.pallas_base_cache == {} and new.block_layout_cache == {}
    assert new.pallas_base_cache is not idx.pallas_base_cache
    assert new.block_layout_cache is not idx.block_layout_cache
    d, i, _ = scan_search(new, data[500:504], k=5, use_pallas=True, pallas_auto_route=False)
    np.testing.assert_array_equal(i[:, 0], 500 + np.arange(4))
    assert idx.pallas_base_cache.keys() == old.keys()

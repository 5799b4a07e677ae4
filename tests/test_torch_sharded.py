"""The port's sharded search (parallel/mesh, parallel/sharded) against the
JAX package's, live, on the conftest's 8-device virtual CPU mesh.

The JAX index of tests/test_sharded.py's setup (2,000 x 16 clustered
points, L = 8, SimHash, the default global engine) is carried into the port
with `index_from_arrays`, and both packages shard it over D = 4 and 8
shards (the port's on ["cpu"] * D). Parity:

- partition_clusters, assert_balanced and shard_report: equal;
- shard arrays: byte for byte as uint32, the pad hash mapped (the port's
  0x7FFFFFFF for JAX's 0xFFFFFFFF, parallel/sharded.PAD_HASH); the global
  engine's per-shard records compared in (hash, id) order, as the sorts
  may order equal hashes differently (tests/test_torch_lsh_build.py);
- sharded_search and sharded_scan_search (exact,
  approximate, use_pallas through K1's plain version against JAX's
  interpreted kernel): distances within 1e-5, ids per query as sets up to
  boundary ties, distance computations equal.

The global engine's sharded search is in test_torch_sharded_global.py, the
walk over per-shard slot records at D = 4 and 8 in test_torch_sharded_walk.py.
"""

import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core.index import build_index as jbuild
from clann_tpu.data.synthetic import clustered_unit_vectors, random_unit_vectors
from clann_tpu.parallel import mesh as jmesh
from clann_tpu.parallel import sharded as jsh

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import index_from_arrays
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=8, num_clusters_factor=0.5, k=5, delta=0.9, hash_family="simhash",
           candidate_chunk=128, brute_force_threshold=20, seed=4)
DS = (4, 8)


@pytest.fixture(scope="module")
def setup():
    train = clustered_unit_vectors(2000, 16, n_modes=24, seed=2)
    jidx = jbuild(train, JConfig(**CFG))
    tidx = index_from_arrays(index_arrays(jidx), TConfig(**CFG), device="cpu")
    queries = random_unit_vectors(24, 16, seed=3)
    return jidx, tidx, queries


@pytest.fixture(scope="module")
def shards(setup):
    """{D: (JAX ShardedIndex, port ShardedIndex, port mesh)}"""
    jidx, tidx, _ = setup
    out = {}
    for D in DS:
        mesh = tmesh.make_mesh(D, devices=["cpu"] * D)
        out[D] = (jsh.shard_index(jidx, D), tsh.shard_index(tidx, D, mesh=mesh), mesh)
    return out


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _unpad(t_hash):
    """The port's pad hash as JAX's."""
    h = _u32(t_hash).copy()
    h[h == tsh.PAD_HASH] = 0xFFFFFFFF
    return h


def test_partition_clusters_matches_jax():
    rng = np.random.default_rng(7)
    for m in (1, 2, 4, 8, 16):
        for _ in range(10):
            sizes = rng.integers(1, 500, size=rng.integers(1, 60))
            want = jsh.partition_clusters(sizes, m)
            got = tsh.partition_clusters(sizes, m)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("D", DS)
def test_shard_arrays_match_jax(shards, D):
    js, ts, _ = shards[D]
    assert ts.n_devices == js.n_devices == D
    for f in tsh.SHARD_FIELDS:
        want, got = _u32(getattr(js, f)), ts.stacked(f)
        got = _unpad(got) if f == "sorted_hash" else _u32(got)
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ts.g_dir_iters == js.g_dir_iters
    np.testing.assert_array_equal(ts.stacked("g_dir"), np.asarray(js.g_dir))
    jh, th = np.asarray(js.g_sorted_hash), _unpad(ts.stacked("g_sorted_hash"))
    np.testing.assert_array_equal(th, jh)
    jrec, trec = np.asarray(js.g_records), _u32(ts.stacked("g_records"))
    assert trec.shape == jrec.shape
    n_max = jh.shape[2]
    for s in range(D):
        for t in range(jh.shape[1]):
            # records are functions of their id: compare in (hash, id) order
            jo = np.lexsort((jrec[s, t, :n_max, 0], jh[s, t]))
            np.testing.assert_array_equal(trec[s, t, :n_max], jrec[s, t, jo])
    np.testing.assert_array_equal(trec[:, :, n_max:], jrec[:, :, n_max:])
    assert ts.slot_records is None  # the source index has none (engine "global")
    assert ts.shard_points == tuple(int(v) for v in (np.asarray(js.global_ids) >= 0).sum(1))


@pytest.mark.parametrize("D", DS)
def test_balance_and_report_match_jax(setup, shards, D):
    jidx = setup[0]
    js, ts, _ = shards[D]
    sizes = np.diff(np.asarray(jidx.cluster_starts))
    assert tsh.assert_balanced(ts, sizes) == jsh.assert_balanced(js, sizes)
    assert tsh.shard_report(ts, Q=24, k=5) == jsh.shard_report(js, Q=24, k=5)


def _assert_search_match(got, want):
    (td, ti, tst), (jd, ji, jst) = got, want
    assert_topk_match(ti, td, np.asarray(ji), np.asarray(jd), atol=1e-5)
    for f in ("distance_computations", "candidates", "clusters_visited"):
        np.testing.assert_array_equal(np.asarray(getattr(tst, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)


@pytest.mark.parametrize("D", DS)
def test_sharded_walk_matches_jax(setup, shards, D):
    queries = setup[2]
    js, ts, mesh = shards[D]
    want = jsh.sharded_search(js, queries, mesh=jmesh.make_mesh(D))
    got = tsh.sharded_search(ts, queries, mesh=mesh)
    _assert_search_match(got, want)
    assert np.asarray(got[2].distance_computations).sum() > 0


@pytest.mark.parametrize("D,kw", [
    (4, {"exact": True}), (8, {"exact": True}),
    (4, {"recall_target": 0.95}), (8, {"recall_target": 0.95}),
    (4, {"use_pallas": True}),
], ids=["exact-4", "exact-8", "approx-4", "approx-8", "pallas-4"])
def test_sharded_scan_search_matches_jax(setup, shards, D, kw):
    queries = setup[2]
    js, ts, mesh = shards[D]
    jd, ji, jst = jsh.sharded_scan_search(js, queries, k=5, mesh=jmesh.make_mesh(D), **kw)
    td, ti, tst = tsh.sharded_scan_search(ts, queries, k=5, mesh=mesh, **kw)
    assert_topk_match(ti, td, np.asarray(ji), np.asarray(jd), atol=1e-5)
    for f in tst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)))


def test_pallas_base_is_cached_once(shards):
    _, ts4, _ = shards[4]
    _, ts8, _ = shards[8]
    a = tsh._shard_pallas_base(ts4, 256, [torch.device("cpu")] * 4)
    assert tsh._shard_pallas_base(ts4, 256, [torch.device("cpu")] * 4)[0][0] is a[0][0]
    # the same shards placed on other devices are rebuilt there
    other = tsh._shard_pallas_base(ts4, 256, [torch.device("cpu")] * 2 + [None] * 2)
    assert other[0][0] is not a[0][0] and other[0][2] is None
    a = tsh._shard_pallas_base(ts4, 256, [torch.device("cpu")] * 4)
    tsh._shard_pallas_base(ts8, 256, [torch.device("cpu")] * 8)
    assert len(tsh._SHARD_BASE_CACHE) == 1  # one shard set held, as JAX's
    # real rows biased, pad rows not; rows permuted by default_rng(0)
    for s in range(4):
        bp, gp = a[0][s], a[2][s]
        np.testing.assert_array_equal(bp[:, 16].float().numpy()[: gp.shape[0]],
                                      (gp >= 0).float().numpy())


def test_2d_mesh_matches_1d(setup, shards):
    """(query, cluster) mesh: the batch split over the query axis gives the
    1-D result (31 queries: the pad-and-slice path)."""
    queries = setup[2][:23]
    _, ts, mesh = shards[4]
    d1, i1, s1 = tsh.sharded_search(ts, queries, mesh=mesh)
    mesh2 = tmesh.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    assert mesh2.shape == {"query": 2, "cluster": 4}
    d2, i2, s2 = tsh.sharded_search(ts, queries, mesh=mesh2)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(d2, d1)
    for a, b in zip(s1, s2):
        np.testing.assert_array_equal(a, b)


def test_check_mesh_errors(setup, shards):
    queries = setup[2]
    _, ts, _ = shards[4]
    with pytest.raises(ValueError, match="cluster shards"):
        tsh.sharded_search(ts, queries, mesh=tmesh.make_mesh(8, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="'cluster' axis"):
        tsh.sharded_search(ts, queries, mesh=tmesh.make_mesh(
            4, axis_name="shard", devices=["cpu"] * 4))
    mesh2 = tmesh.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    qn = torch.nn.functional.normalize(torch.as_tensor(queries[:3]), dim=1)
    with pytest.raises(ValueError, match="does not divide"):
        tsh.sharded_search_batch(ts, qn, torch.zeros((3, 8), dtype=torch.int32),
                                 torch.zeros((3, 32, 2), dtype=torch.int32), 0.9, k=5,
                                 mesh=mesh2)


def test_make_mesh_counts_devices():
    with pytest.raises(ValueError, match="requested 5 devices, only 4"):
        tmesh.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh_2d(2, 3, devices=["cpu"] * 4)
    m = tmesh.make_mesh(devices=["cpu"] * 3)
    assert m.shape == {"cluster": 3} and m.size == 3 and not m.multiprocess
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 available"):
            tmesh.make_mesh(1)  # the default devices are the visible CUDA ones


def test_dryrun_runs(capsys):
    tsh.dryrun(4, devices=["cpu"] * 4)
    assert "SHARD_REPORT " in capsys.readouterr().out


def test_walk_records_on_one_shard_equal_the_single_device_walk(setup):
    """With slot records (config.pack_slot_records and the clustered
    engine), each shard walks through the blocked record gather (kernel
    K7 on a card). On one shard the local layout is the index's own, so
    the sharded walk equals the single-device walk without a directory."""
    import dataclasses

    from clann_tpu_torch.core.index import build_index

    _, _, queries = setup
    train = clustered_unit_vectors(2000, 16, n_modes=24, seed=2)
    cfg = TConfig(**{**CFG, "lsh_engine": "clustered", "gather_block": 8})
    idx = build_index(train, cfg, device="cpu")
    assert idx.slot_records is not None
    mesh = tmesh.make_mesh(1, devices=["cpu"])
    ts = tsh.shard_index(idx, 1, mesh=mesh)
    assert ts.slot_records is not None
    d1, i1, s1 = tsh.sharded_search(ts, queries, mesh=mesh)
    flat = dataclasses.replace(idx, prefix_dir=None, dir_bits=0, dir_iters=0)
    d0, i0, s0 = _walk_like_shard(flat, queries)
    assert_topk_match(i1, d1, i0, d0, atol=1e-6)
    np.testing.assert_array_equal(s1.distance_computations, s0.distance_computations)


def _walk_like_shard(index, queries):
    """ops.query.search with the shard body's knobs (the JAX package's
    sharded walk passes only k, chunk and min_depth)."""
    from clann_tpu_torch.ops.distances import l2_normalize
    from clann_tpu_torch.ops.query import search_batch_impl

    cfg = index.config
    source, filterer = index.rebuild_objects()
    qn = l2_normalize(torch.as_tensor(queries))
    sims, ids, st = search_batch_impl(index, qn, source.hash(qn), filterer.sketch(qn),
                                      cfg.delta, k=cfg.k, chunk=cfg.candidate_chunk,
                                      min_depth=cfg.min_depth)
    ids = ids.numpy()
    return (np.where(ids < 0, np.inf, 2.0 * (1.0 - sims.numpy())), ids,
            type(st)(*(f.numpy() for f in st)))

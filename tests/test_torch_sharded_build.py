"""The port's sharded build and join (parallel/gmm, core.index.build_index
with gmm_mesh, parallel/sharded.build_sharded, parallel/join) against the
JAX package's, live, on the conftest's 8-device virtual CPU mesh, and
against the port's own single-device paths.

- sharded_gmm: centers and assignment equal to JAX's sharded_gmm and to the
  port's ops.gmm; radii bit-identical to ops.gmm and within 1e-6 of JAX's
  (f32 products summed in another order);
- build_index(gmm_mesh=) equals build_index field for field;
- build_sharded equals shard_index(build_index) on every real slot and in
  its search results (the draws are the port's own, so this is held
  within the port, as JAX's tests hold JAX's);
- sharded_closest_pairs equals the port's unsharded join exactly, and
  JAX's sharded join up to the pinned wrapped-slot difference (ROADMAP
  section 3: the port can keep a pair that JAX drops, never the reverse).
"""

import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core.index import build_lsh_index as jbuild_lsh
from clann_tpu.data.synthetic import clustered_unit_vectors, random_unit_vectors
from clann_tpu.parallel import gmm as jgmm
from clann_tpu.parallel import join as jpjoin
from clann_tpu.parallel import mesh as jmesh

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.ops import gmm as tgmm
from clann_tpu_torch.ops import join as tjoin
from clann_tpu_torch.parallel import gmm as tpgmm
from clann_tpu_torch.parallel import join as tpjoin
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh
from clann_tpu_torch.testing import sharded_real_slot_mismatches

torch.set_num_threads(1)


def _cpu_mesh(D):
    return tmesh.make_mesh(D, devices=["cpu"] * D)


@pytest.mark.parametrize("D", (4, 8))
def test_sharded_gmm_matches_jax_and_ops_gmm(D):
    x = clustered_unit_vectors(2003, 16, n_modes=24, seed=2)
    k = 26
    jc, ja, jr = jgmm.sharded_gmm(x, k, mesh=jmesh.make_mesh(D))
    tc, ta, tr = tpgmm.sharded_gmm(x, k, mesh=_cpu_mesh(D))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-6)
    oc, oa, orad = tgmm.greedy_minimum_maximum(torch.as_tensor(x), k)
    assert torch.equal(tc, oc) and torch.equal(ta, oa) and torch.equal(tr, orad)
    # degenerate n <= k: every point its own center
    c, a, r = tpgmm.sharded_gmm(x[:5], 8, mesh=_cpu_mesh(D))
    assert c.tolist() == a.tolist() == list(range(5)) and float(r.sum()) == 0.0
    with pytest.raises(ValueError, match="angular"):
        tpgmm.sharded_gmm(x, k, mesh=_cpu_mesh(D), metric="euclidean")


BUILD_CFG = dict(num_tables=6, num_clusters_factor=1.0, k=5, delta=0.85,
                 hash_family="simhash", candidate_chunk=64, brute_force_threshold=8,
                 seed=3, lsh_engine="both", dense_layout=False, gather_block=8)


@pytest.fixture(scope="module")
def built():
    train = clustered_unit_vectors(700, 16, n_modes=24, seed=0)
    cfg = TConfig(**BUILD_CFG)
    mesh = _cpu_mesh(8)
    idx = tindex.build_index(train, cfg, device="cpu")
    idx_mesh = tindex.build_index(train, cfg, device="cpu", gmm_mesh=mesh)
    return train, cfg, mesh, idx, idx_mesh


def test_build_index_with_gmm_mesh_equals_build_index(built):
    _, _, _, idx, idx_mesh = built
    for f in tindex.GEOMETRY_FIELDS + tuple(tindex.LSH_FIELDS):
        a, b = getattr(idx, f), getattr(idx_mesh, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    for p in ("hash_params", "sketch_params"):
        for k_, v in getattr(idx, p).items():
            assert torch.equal(v, getattr(idx_mesh, p)[k_])


def test_build_sharded_equals_shard_of_built_index(built):
    train, cfg, mesh, _, idx_mesh = built
    queries = random_unit_vectors(40, 16, seed=1)
    via_single = tsh.shard_index(idx_mesh, 8, mesh=mesh)
    direct = tsh.build_sharded(train, cfg, mesh=mesh)
    assert direct.n_max % cfg.gather_block == 0
    # every real slot equal (build_sharded rounds n_max up to a
    # gather_block multiple, so the pad lengths may differ, as in JAX)
    assert via_single.slot_records is not None and direct.g_records is not None
    assert sharded_real_slot_mismatches(via_single, direct) == []
    for s in range(8):
        n_loc = via_single.shard_points[s]
        assert (direct.global_ids[s][n_loc:] < 0).all()
        assert (direct.sorted_hash[s][:, n_loc:] == tsh.PAD_HASH).all()
    for fn in (tsh.sharded_search, tsh.sharded_global_search):
        d1, i1, s1 = fn(via_single, queries, mesh=mesh)
        d2, i2, s2 = fn(direct, queries, mesh=mesh)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        np.testing.assert_array_equal(s1.distance_computations, s2.distance_computations)
    # the exact scan over the direct build is the brute-force oracle
    d, _, _ = tsh.sharded_scan_search(direct, queries, k=5, exact=True, mesh=mesh)
    tn = train / np.linalg.norm(train, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    np.testing.assert_allclose(d, np.sort(1.0 - qn @ tn.T, axis=1)[:, :5], atol=1e-5)


def test_build_sharded_rejects_bad_input():
    from clann_tpu_torch.errors import DataError, IndexCreationError

    with pytest.raises(DataError):
        tsh.build_sharded(np.zeros((0, 4), np.float32), TConfig(), mesh=_cpu_mesh(2))
    with pytest.raises(IndexCreationError):
        tsh.build_sharded(np.ones((8, 4), np.float32), TConfig(), mesh=_cpu_mesh(2),
                          metric="euclidean")


@pytest.fixture(scope="module")
def join_pair(small_angular_dataset):
    from clann_tpu_torch.testing import index_arrays

    x = small_angular_dataset.train
    kw = dict(num_tables=12, k=10, hash_family="simhash", candidate_chunk=128, seed=3)
    jidx = jbuild_lsh(x, JConfig(**kw))
    return jidx, tindex.index_from_arrays(index_arrays(jidx), TConfig(**kw), device="cpu")


@pytest.mark.parametrize("D", (4, 8))
def test_sharded_join_matches(join_pair, D):
    jidx, tidx = join_pair
    mesh = _cpu_mesh(D)
    tp, ts = tpjoin.sharded_closest_pairs(tidx, k=10, delta=0.8, mesh=mesh)
    up, us = tjoin.closest_pairs(tidx, k=10, delta=0.8)
    np.testing.assert_array_equal(tp, up)
    np.testing.assert_array_equal(ts, us)
    jp, js = jpjoin.sharded_closest_pairs(jidx, k=10, delta=0.8, mesh=jmesh.make_mesh(D))
    jp, js = np.asarray(jp), np.asarray(js)
    if np.array_equal(tp, jp):
        np.testing.assert_allclose(ts, js, atol=1e-6)
    else:
        # the wrapped-slot difference: the port only ever finds more
        assert np.all(ts >= js - 1e-6)
        above = js > ts[-1] + 1e-6
        assert {tuple(p) for p in jp[above]} <= {tuple(p) for p in tp}


def test_facade_join_over_a_mesh(join_pair):
    _, tidx = join_pair
    h = clann_tpu_torch.init_with_config(tidx.vectors.numpy(), tidx.config, device="cpu")
    h.index = tidx
    mesh = _cpu_mesh(4)
    p, s = h.closest_pairs(k=10, mesh=mesh)
    p2, s2 = tpjoin.sharded_closest_pairs(tidx, 10, delta=tidx.config.delta, mesh=mesh)
    np.testing.assert_array_equal(p, p2)
    np.testing.assert_array_equal(s, s2)


def test_dryrun_large_runs(capsys):
    """The non-toy dryrun at 20,000 points on 4 CPU shards: balance >= 0.9
    and the global engine's recall against brute force, both asserted
    inside."""
    tsh.dryrun_large(4, n=20000, devices=["cpu"] * 4)
    assert "SHARD_REPORT_LARGE " in capsys.readouterr().out

"""The port's sharded global engine (parallel/sharded.sharded_global_search)
against the JAX package's, live, on the conftest's 8-device virtual CPU
mesh, at tests/test_torch_sharded.py's setup (its JAX index carried into
the port, sharded over D = 4 and 8 shards, the port's on ["cpu"] * D).
Distances within 1e-5, ids per query as sets up to boundary ties, distance
computations equal; the 2-D (query, cluster) mesh equal to the 1-D one.
"""

import dataclasses

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


@pytest.fixture(scope="module")
def setup():
    train = clustered_unit_vectors(2000, 16, n_modes=24, seed=2)
    jidx = jbuild(train, JConfig(**CFG))
    tidx = index_from_arrays(index_arrays(jidx), TConfig(**CFG), device="cpu")
    queries = random_unit_vectors(24, 16, seed=3)
    return jidx, tidx, queries


@pytest.mark.parametrize("D", (4, 8))
def test_sharded_global_search_matches_jax(setup, D):
    jidx, tidx, queries = setup
    mesh = tmesh.make_mesh(D, devices=["cpu"] * D)
    jd, ji, jst = jsh.sharded_global_search(jsh.shard_index(jidx, D), queries,
                                            mesh=jmesh.make_mesh(D))
    td, ti, tst = tsh.sharded_global_search(tsh.shard_index(tidx, D, mesh=mesh), queries,
                                            mesh=mesh)
    assert_topk_match(ti, td, np.asarray(ji), np.asarray(jd), atol=1e-5)
    for f in tst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.distance_computations.sum() > 0


def test_2d_mesh_matches_1d(setup):
    _, tidx, queries = setup
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    ts = tsh.shard_index(tidx, 4, mesh=mesh)
    g1 = tsh.sharded_global_search(ts, queries[:23], mesh=mesh)
    g2 = tsh.sharded_global_search(ts, queries[:23],
                                   mesh=tmesh.make_mesh_2d(2, 4, devices=["cpu"] * 8))
    np.testing.assert_array_equal(g1[1], g2[1])
    np.testing.assert_array_equal(g1[0], g2[0])
    for a, b in zip(g1[2], g2[2]):
        np.testing.assert_array_equal(a, b)


def test_global_search_needs_global_tables(setup):
    _, tidx, queries = setup
    flat = dataclasses.replace(tidx, g_records=None, g_sorted_hash=None, g_dir=None)
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    ts = tsh.shard_index(flat, 4, mesh=mesh)
    with pytest.raises(ValueError, match="global-engine"):
        tsh.sharded_global_search(ts, queries, mesh=mesh)

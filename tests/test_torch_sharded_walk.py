"""The port's sharded walk over per-shard slot records against the JAX
package's walk, live, at D = 4 and 8 shards.

A JAX index built with the clustered engine (config.pack_slot_records, so
it has slot records) is carried into the port with `index_from_arrays`,
and the port's shard_index keeps the records: each of its shards walks
through the blocked record gather (kernel K7 on a card). The JAX
package's shard_index drops them, and its shards walk the plain tables one
slot at a time (G = 1), which visits a different number of candidates
than the blocked walk (G = gather_block) by design: the JAX package's own
single-device walk counts differently with and without records too.

So the reference is JAX's shard body with the records kept: for each of
JAX's shards, its `_local_index` given `make_slot_records` of the shard's
tables, through `search_batch_jit` with the body's knobs (k, chunk,
min_depth), local ids mapped to global ids, the (D, Q, k) results merged
by `lax.top_k` and the stats summed, as `sharded_search_batch` does.
Parity: distances within 1e-5, ids per query as sets up to boundary ties,
distance computations, candidates and clusters visited equal. The JAX
package's sharded walk itself (G = 1) is held to the port's with the
records stripped, at the same D.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core.index import build_index as jbuild
from clann_tpu.core.index import make_slot_records as jmake_slot_records
from clann_tpu.data.synthetic import clustered_unit_vectors, random_unit_vectors
from clann_tpu.ops.distances import l2_normalize as jl2_normalize
from clann_tpu.ops.query import search_batch_jit
from clann_tpu.parallel import mesh as jmesh
from clann_tpu.parallel import sharded as jsh

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import index_from_arrays
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=8, num_clusters_factor=0.5, k=5, delta=0.9, hash_family="simhash",
           candidate_chunk=128, brute_force_threshold=20, seed=4, lsh_engine="clustered",
           gather_block=8)
DS = (4, 8)
STAT_FIELDS = ("distance_computations", "candidates", "clusters_visited")


@pytest.fixture(scope="module")
def setup():
    train = clustered_unit_vectors(2000, 16, n_modes=24, seed=2)
    jidx = jbuild(train, JConfig(**CFG))
    assert jidx.slot_records is not None
    tidx = index_from_arrays(index_arrays(jidx), TConfig(**CFG), device="cpu")
    assert tidx.slot_records is not None
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


def _jax_walk_with_records(js, queries):
    """JAX's sharded walk body on each shard with the shard's slot records
    kept, merged as sharded_search_batch merges (module docstring)."""
    cfg = js.config
    source, filterer = jsh.ShardedIndex.rebuild_objects(js)
    qn = jl2_normalize(jnp.asarray(np.asarray(queries, np.float32)))
    qh, qs = source.hash(qn), filterer.sketch(qn)
    repl = {f: getattr(js, f)
            for f in ("hash_params", "sketch_params", "probs_table", "maxdiff_table")}
    sims, ids, stats = [], [], []
    for s in range(js.n_devices):
        arrays = {f: getattr(js, f)[s:s + 1] for f in (
            "vectors", "sorted_hash", "sorted_idx", "sketches", "cluster_starts", "centers",
            "center_ids", "radii", "brute", "assignment")}
        local = jsh._local_index(js, arrays, repl)
        local = dataclasses.replace(local, slot_records=jmake_slot_records(
            local.sorted_idx, local.sketches, pad_to=cfg.gather_block))
        si, ii, st = search_batch_jit(local, qn, qh, qs, jnp.float32(cfg.delta), k=cfg.k,
                                      chunk=cfg.candidate_chunk, min_depth=cfg.min_depth)
        gids = js.global_ids[s]
        sims.append(si)
        ids.append(jnp.where(ii >= 0, gids[jnp.clip(ii, 0, None)], -1))
        stats.append(st)
    Q, k, D = qn.shape[0], cfg.k, js.n_devices
    flat_sims = jnp.transpose(jnp.stack(sims), (1, 0, 2)).reshape(Q, D * k)
    flat_ids = jnp.transpose(jnp.stack(ids), (1, 0, 2)).reshape(Q, D * k)
    top_sims, sel = jax.lax.top_k(flat_sims, k)
    top_ids = np.asarray(jnp.take_along_axis(flat_ids, sel, axis=1))
    dists = np.where(top_ids < 0, np.inf, 2.0 * (1.0 - np.asarray(top_sims)))
    summed = {f: sum(np.asarray(getattr(st, f)) for st in stats) for f in STAT_FIELDS}
    return dists, top_ids, summed


@pytest.mark.parametrize("D", DS)
def test_sharded_walk_over_slot_records_matches_jax(setup, shards, D):
    queries = setup[2]
    js, ts, mesh = shards[D]
    assert ts.slot_records is not None and len(ts.slot_records) == D
    jd, ji, jst = _jax_walk_with_records(js, queries)
    td, ti, tst = tsh.sharded_search(ts, queries, mesh=mesh)
    assert_topk_match(ti, td, ji, jd, atol=1e-5)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tst, f)), jst[f], err_msg=f)
    assert np.asarray(tst.distance_computations).sum() > 0


@pytest.mark.parametrize("D", DS)
def test_sharded_walk_without_records_matches_jax(setup, shards, D):
    queries = setup[2]
    js, ts, mesh = shards[D]
    jd, ji, jst = jsh.sharded_search(js, queries, mesh=jmesh.make_mesh(D))
    td, ti, tst = tsh.sharded_search(dataclasses.replace(ts, slot_records=None), queries,
                                     mesh=mesh)
    assert_topk_match(ti, td, np.asarray(ji), np.asarray(jd), atol=1e-5)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tst, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)

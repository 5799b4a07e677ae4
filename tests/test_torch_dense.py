"""The dense IVF layout and probing (core/index.build_dense_layout,
ops/ivf.dense_search / adaptive_dense_search) against the JAX package's on
the CPU.

Both packages search ONE index: a JAX-built index (3,000 x 24, 21 clusters)
is carried across whole with index_from_arrays, its layout included. The
layout at dense_seg_cap 64 splits clusters into several rows; at 4,096 no
cluster is split; at 5 a row holds fewer points than k. Tolerances: the
layout bit for bit; similarities within 1e-5 (f32 dots summed in another
order); ids per query as sets up to boundary ties
(testing.assert_topk_match); every counter exact. Where a row's slots
overflow, JAX's unstable sort decides which probes drop, so there only
dropped_probes (which does not depend on that order) and the port's own
invariants are compared. The adaptive search's row order ties exactly for
the rows of a split cluster (JAX's argsort is a quicksort there, the
port's stable), so its counters are compared exactly where no cluster is
split, and its results as sets where clusters are split.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clann_tpu
from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.data.synthetic import make_synthetic_dataset
from clann_tpu.ops import ivf as jivf

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.ops import ivf as tivf
from clann_tpu_torch.ops.distances import brute_force_topk
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

CFG = dict(num_tables=2, num_clusters_factor=0.4, k=10, delta=0.9, hash_family="simhash",
           seed=5, dense_layout=True)
SEG_CAPS = (64, 4096, 5)


@pytest.fixture(scope="module")
def world():
    ds = make_synthetic_dataset(n=3000, d=24, n_queries=50, k_gt=10, seed=9)
    cfg = dict(CFG, dataset_name=ds.name)
    jbase = jindex.build_index(ds.train, JConfig(**cfg, dense_seg_cap=4096))
    starts = np.asarray(jbase.cluster_starts)
    jidx, tidx = {}, {}
    for cap in SEG_CAPS:
        layout = jindex.build_dense_layout(
            jbase.vectors, np.asarray(jbase.sorted_idx[0]), starts,
            jbase.centers, np.asarray(jbase.radii), cap)
        jidx[cap] = jbase.replace(config=jbase.config.replace(dense_seg_cap=cap), **layout)
        tidx[cap] = tindex.index_from_arrays(index_arrays(jidx[cap]),
                                             TConfig(**cfg, dense_seg_cap=cap), device="cpu")
    # queries off the unit sphere: both packages normalize them
    queries = ds.test * np.linspace(0.5, 3.0, len(ds.test))[:, None].astype(np.float32)
    return dict(ds=ds, cfg=cfg, jidx=jidx, tidx=tidx, queries=queries)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_stats(jst, tst, fields=None):
    for f in fields or jst._fields:
        j, t = getattr(jst, f), getattr(tst, f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=f)


@pytest.mark.parametrize("cap", SEG_CAPS)
def test_build_dense_layout_matches_jax(world, cap):
    """The port's build_dense_layout on JAX's inputs gives JAX's layout bit
    for bit."""
    j = world["jidx"][cap]
    got = tindex.build_dense_layout(
        torch.from_numpy(np.array(j.vectors)), torch.from_numpy(np.array(j.sorted_idx[0])),
        np.asarray(j.cluster_starts), torch.from_numpy(np.array(j.centers)),
        np.asarray(j.radii), cap)
    assert sorted(got) == sorted(tindex.DENSE_FIELDS)
    for f, dt in tindex.DENSE_FIELDS.items():
        assert got[f].dtype == dt, f
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(getattr(j, f)), err_msg=f)
    if cap == 64:  # clusters split into several rows
        assert len(got["seg_sizes"]) > j.n_clusters


def test_carried_layout_is_jax(world):
    j, t = world["jidx"][64], world["tidx"][64]
    for f in tindex.DENSE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


def test_own_build_covers_every_point(world):
    """The port's own build: every point in exactly one row, zero padding,
    rows inheriting their owner's center and radius, in table 0's order;
    and the layout stays out of memory_usage, as in JAX."""
    ds = world["ds"]
    own = tindex.build_index(ds.train, TConfig(**world["cfg"], dense_seg_cap=64), device="cpu")
    ids, sizes = own.seg_ids.numpy(), own.seg_sizes.numpy()
    real = ids[ids >= 0]
    assert len(real) == len(np.unique(real)) == ds.train.shape[0]
    np.testing.assert_array_equal(real, own.sorted_idx[0].numpy())
    assert (sizes <= 64).all() and (sizes == (ids >= 0).sum(1)).all()
    assert np.all(own.seg_vectors.numpy()[ids < 0] == 0.0)
    np.testing.assert_array_equal(own.seg_vectors.numpy()[ids >= 0],
                                  own.vectors.numpy()[real])
    owner = own.seg_cluster.numpy()
    np.testing.assert_array_equal(own.seg_centers.numpy(), own.centers.numpy()[owner])
    np.testing.assert_array_equal(own.seg_radii.numpy(), own.radii.numpy()[owner])
    no_layout = dataclasses.replace(own, **{f: None for f in tindex.DENSE_FIELDS})
    assert own.memory_usage() == no_layout.memory_usage()
    assert own.array_bytes()["seg_vectors"] == own.seg_vectors.numel() * 4


@pytest.mark.parametrize("layout", [True, False])
def test_memory_usage_matches_jax(world, layout):
    """A carried JAX index reports JAX's bytes, with and without the dense
    layout: collision tables and the layout are not counted."""
    j = world["jidx"][64]
    arrays = index_arrays(j)
    if not layout:
        j = j.replace(**{f: None for f in tindex.DENSE_FIELDS})
        arrays = {f: v for f, v in arrays.items() if f not in tindex.DENSE_FIELDS}
    t = tindex.index_from_arrays(arrays, TConfig(**world["cfg"]), device="cpu")
    assert (t.seg_vectors is not None) == layout
    assert t.memory_usage() == j.memory_usage()
    stripped = dataclasses.replace(t, probs_table=None, maxdiff_table=None,
                                   **{f: None for f in tindex.DENSE_FIELDS})
    assert stripped.memory_usage() == t.memory_usage()
    nbytes = t.array_bytes()
    assert sum(nbytes.values()) - t.memory_usage() == (
        nbytes["probs_table"] + nbytes["maxdiff_table"]
        + sum(nbytes.get(f, 0) for f in tindex.DENSE_FIELDS))


def test_memory_usage_of_the_walk_entry_index():
    """The walk's entry configuration (simhash, L = 8, 2,000 x 32): JAX
    counts 2,332,897 bytes; the carried index counts the same."""
    from clann_tpu.data.synthetic import clustered_unit_vectors

    cfg = dict(num_tables=8, num_clusters_factor=0.4, k=10, delta=0.9, hash_family="simhash",
               candidate_chunk=128, seed=0)
    j = jindex.build_index(clustered_unit_vectors(2000, 32, n_modes=16, seed=0), JConfig(**cfg))
    t = tindex.index_from_arrays(index_arrays(j), TConfig(**cfg), device="cpu")
    assert j.memory_usage() == t.memory_usage() == 2_332_897


# (seg_cap, dense_search keyword arguments)
_DENSE_CASES = {
    "auto-n-probe": (64, {}),
    "every-row": (64, {"n_probe": "R"}),
    "ragged-batches": (64, {"batch_size": 16}),
    "unsplit": (4096, {"n_probe": 3}),
    "rows-below-k": (5, {}),
}


@pytest.mark.parametrize("case", list(_DENSE_CASES))
def test_dense_search_matches_jax(world, case):
    cap, kw = _DENSE_CASES[case]
    j, t = world["jidx"][cap], world["tidx"][cap]
    if kw.get("n_probe") == "R":
        kw = dict(kw, n_probe=int(j.seg_centers.shape[0]))
    q = world["queries"]
    jd, ji, jst = jivf.dense_search(j, q, k=10, **kw)
    td, ti, tst = tivf.dense_search(t, q, k=10, **kw)
    assert int(jst.dropped_probes) == 0 and int(tst.dropped_probes) == 0
    assert td.shape == (len(q), 10) and ti.dtype == np.int32
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    _assert_stats(jst, tst)
    if case == "rows-below-k":
        assert int(t.seg_sizes.max()) < 10  # the per-row top-k pads to k
    if case == "every-row":  # an exhaustive probe is an exact search
        gd, gi = brute_force_topk(world["ds"].train, q, k=10, device="cpu")
        assert_topk_match(gi.numpy(), gd.numpy(), ti, td, atol=1e-4)
        assert (tst.uncertified == 0).all()
        assert (tst.distance_computations == world["ds"].train.shape[0]).all()


def test_dropped_probes_match_jax(world):
    """probe_cap 8 overflows rows: dropped_probes equals JAX's; what the
    port returns is consistent with what it probed."""
    j, t = world["jidx"][64], world["tidx"][64]
    q = world["queries"]
    _, _, jst = jivf.dense_search(j, q, k=10, n_probe=12, probe_cap=8)
    td, ti, tst = tivf.dense_search(t, q, k=10, n_probe=12, probe_cap=8)
    assert int(tst.dropped_probes) == int(jst.dropped_probes) > 0
    P = tst.probed_clusters.shape[1]
    assert (P - tst.clusters_visited).sum() == int(tst.dropped_probes)
    np.testing.assert_array_equal(tst.distance_computations, tst.probed_counts.sum(1))
    np.testing.assert_array_equal(tst.probed_clusters, _np(jst.probed_clusters))
    # every returned id lies in a row the query probed, at its exact distance
    vec, qn = t.vectors.numpy(), q / np.linalg.norm(q, axis=1, keepdims=True)
    owner = t.assignment.numpy()
    for r in range(len(q)):
        ok = ti[r] >= 0
        probed = tst.probed_clusters[r][tst.probed_counts[r] > 0]
        assert set(owner[ti[r][ok]]) <= set(probed.tolist())
        np.testing.assert_allclose(td[r][ok], 1.0 - vec[ti[r][ok]] @ qn[r], atol=1e-5)


def test_dense_search_single_query_and_errors(world):
    t = world["tidx"][64]
    d1, i1, _ = tivf.dense_search(t, world["queries"][7], k=10)
    d, i, _ = tivf.dense_search(t, world["queries"], k=10)
    assert_topk_match(i[7:8], d[7:8], i1, d1)
    with pytest.raises(ValueError, match="dense layout"):
        tivf.dense_search(dataclasses.replace(t, seg_vectors=None), world["queries"])
    assert tivf.auto_n_probe(3) == 3 and tivf.auto_n_probe(400) == 30
    for args in ((50, 12, 60), (2048, 653, 653), (1, 1, 1)):
        assert tivf.auto_probe_cap(*args) == jivf.auto_probe_cap(*args)
    for R in (1, 8, 60, 435, 700):
        assert tivf.auto_n_probe(R) == jivf.auto_n_probe(R)


def test_dedup_topk_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.random((30, 40)).astype(np.float32)
    i = rng.integers(-1, 25, (30, 40)).astype(np.int32)
    s[:, 5] = s[:, 6]  # a tie
    for a, b in zip(tivf._dedup_topk_np(s, i, 10), jivf._dedup_topk_np(s, i, 10)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["unsplit", "unsplit-cap-retry", "split"])
def test_adaptive_matches_jax(world, case):
    cap = 64 if case == "split" else 4096
    kw = dict(probe_cap=8, wave=2) if case == "unsplit-cap-retry" else {}
    j, t = world["jidx"][cap], world["tidx"][cap]
    q = world["queries"]
    jd, ji, jst = jivf.adaptive_dense_search(j, q, k=10, **kw)
    td, ti, tst = tivf.adaptive_dense_search(t, q, k=10, **kw)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    if case == "split":
        np.testing.assert_array_equal(tst.uncertified, 0)
        return
    _assert_stats(jst, tst)
    if kw:  # the capacity retries leave the results of the default capacity
        d0, i0, st0 = tivf.adaptive_dense_search(t, q, k=10, wave=2)
        assert_topk_match(i0, d0, ti, td)
        np.testing.assert_array_equal(st0.distance_computations, tst.distance_computations)


def test_adaptive_is_exact_when_run_to_completion(world):
    """max_waves = every row: the certificate retires each query; the
    result is the exact one on this data (the non-metric caveat aside)."""
    t = world["tidx"][64]
    q = world["queries"]
    td, ti, tst = tivf.adaptive_dense_search(t, q, k=10)
    gd, gi = brute_force_topk(world["ds"].train, q, k=10, device="cpu")
    assert_topk_match(gi.numpy(), gd.numpy(), ti, td, atol=1e-4)
    n = world["ds"].train.shape[0]
    assert (tst.distance_computations <= n).all() and (tst.distance_computations < n).any()


@pytest.fixture(scope="module")
def facades(world):
    ds = world["ds"]
    jh = clann_tpu.init_with_config(ds.train, JConfig(**world["cfg"], dense_seg_cap=64))
    jh.index = world["jidx"][64]
    th = clann_tpu_torch.init_with_config(ds.train, TConfig(**world["cfg"], dense_seg_cap=64),
                                          device="cpu")
    th.index = world["tidx"][64]
    return jh, th


@pytest.mark.parametrize("mode,n_probe", [
    ("dense", None), ("dense", 20), ("adaptive", None), ("auto", None), (None, None)])
def test_facade_modes_match_jax(world, facades, mode, n_probe):
    """"auto" (and the default mode) resolve to "dense" on an index with
    the layout (clann_tpu/api.py:126-127); n_probe reaches the prober."""
    jh, th = facades
    q = world["queries"]
    jd, ji, jst = jh.search_batch(q, mode=mode, n_probe=n_probe)
    td, ti, tst = th.search_batch(q, mode=mode, n_probe=n_probe)
    assert_topk_match(ji, jd, ti, td, atol=1e-5)
    if mode != "adaptive":
        _assert_stats(jst, tst)
    else:
        assert (tst.clusters_visited > 0).all()
    assert len(th.search(q[0])) == 10


def test_default_config_init_build_search():
    """init -> build -> search with the default Config (dense layout, "auto"
    -> "dense"): the reference's entry sequence (lib.rs:76-189)."""
    ds = make_synthetic_dataset(n=1500, d=16, n_queries=8, k_gt=10, seed=4)
    h = clann_tpu_torch.build(clann_tpu_torch.init(ds.train, device="cpu"))
    assert h.index.seg_vectors is not None and h.config == TConfig()
    res = clann_tpu_torch.search(h, ds.test[0])
    assert len(res) == 10 and all(a[0] <= b[0] for a, b in zip(res, res[1:]))
    d, i, st = tivf.dense_search(h.index, ds.test[:1])
    assert [r[1] for r in res] == i[0].tolist()
    np.testing.assert_allclose([r[0] for r in res], d[0], rtol=0, atol=0)
    assert int(st.clusters_visited[0]) == tivf.auto_n_probe(h.index.seg_centers.shape[0])

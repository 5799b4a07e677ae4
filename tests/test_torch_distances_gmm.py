"""Parity of the PyTorch port's distances, dense scans, GMM, generators,
config and recall against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: similarities/distances within 1e-5 (f32 sums taken in another
order), ids compared per query as sets up to boundary ties
(clann_tpu_torch.testing.assert_topk_match), certified counts equal, GMM
centers and assignment exactly equal on data without near-ties, radii within
1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clann_tpu.config import Config as JConfig
from clann_tpu.data import synthetic as jsyn
from clann_tpu.metrics import recall as jrecall
from clann_tpu.ops import distances as jd
from clann_tpu.ops import gmm as jgmm

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.data import synthetic as tsyn
from clann_tpu_torch.metrics import recall as trecall
from clann_tpu_torch.ops import distances as td
from clann_tpu_torch.ops import gmm as tgmm
from clann_tpu_torch.testing import assert_topk_match

torch.set_num_threads(1)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tgmm(x, k, metric="angular", assume_normalized=False):
    """The port's GMM with the JAX function's numpy return contract."""
    c, a, r = tgmm.greedy_minimum_maximum(x, k, metric,
                                          assume_normalized=assume_normalized)
    return c.numpy().astype(np.int32), a.numpy().astype(np.int32), r.numpy()


@pytest.fixture(scope="module")
def data():
    base = tsyn.clustered_unit_vectors(1500, 20, n_modes=12, seed=5)
    queries = tsyn.random_unit_vectors(40, 20, seed=6)
    return base, queries


@pytest.mark.parametrize("metric", ["angular", "euclidean"])
def test_brute_force_topk(data, metric):
    base, queries = data
    if metric == "euclidean":
        base = base * 1.7  # non-unit rows
    jdist, jids = jd.brute_force_topk(base, queries, k=10, metric=metric,
                                      block_q=16)
    tdist, tids = td.brute_force_topk(base, queries, k=10, metric=metric,
                                      block_q=16, device="cpu")
    assert_topk_match(np.asarray(jids), np.asarray(jdist), tids.numpy(),
                      tdist.numpy())


def test_distance_blocks_and_maps(data):
    base, queries = data
    bt, qt = torch.from_numpy(base), torch.from_numpy(queries)
    for jf, tf in ((jd.cosine_distance_block, td.cosine_distance_block),
                   (jd.l2_distance_block, td.l2_distance_block),
                   (jd.cosine_similarity_block, td.cosine_similarity_block)):
        np.testing.assert_allclose(
            tf(bt, qt).numpy(), np.asarray(jf(jnp.asarray(base), jnp.asarray(queries))),
            atol=1e-5,
        )
    dist = np.linspace(0, 2, 9, dtype=np.float32)
    np.testing.assert_allclose(td.cosine_to_similarity(torch.from_numpy(dist)).numpy(),
                               np.asarray(jd.cosine_to_similarity(jnp.asarray(dist))))
    np.testing.assert_allclose(td.similarity_to_cosine(torch.from_numpy(dist / 2)).numpy(),
                               np.asarray(jd.similarity_to_cosine(jnp.asarray(dist / 2))))
    raw = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    raw[3] = 0.0  # zero rows stay zero
    np.testing.assert_allclose(td.l2_normalize(torch.from_numpy(raw)).numpy(),
                               np.asarray(jd.l2_normalize(jnp.asarray(raw))),
                               atol=1e-7)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("block_points", [256, 1500])
def test_dense_scan(data, exact, block_points):
    base, queries = data
    kw = dict(k=10, block_points=block_points, recall_target=0.95,
              exact=exact, normalize_queries=True)
    js, ji = jd._dense_scan_jit(jnp.asarray(base), jnp.asarray(queries * 2.0), **kw)
    ts, ti = td._dense_scan_impl(torch.from_numpy(base),
                                 torch.from_numpy(queries * 2.0), **kw)
    assert_topk_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy())


def test_certified_scan_counts(data):
    base, queries = data
    kw = dict(k=10, block_points=512, recall_target=0.95, eps=1e-6,
              normalize_queries=True)
    js, ji, jc = jd._certified_scan_jit(jnp.asarray(base), jnp.asarray(queries), **kw)
    ts, ti, tc = td._certified_scan_impl(torch.from_numpy(base),
                                         torch.from_numpy(queries), **kw)
    assert_topk_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_dense_scan_topk_wrapper(data):
    base, queries = data
    js, ji = jd.dense_scan_topk(base, queries, k=7, block_points=400, batch_q=16)
    ts, ti = td.dense_scan_topk(base, queries, k=7, block_points=400, batch_q=16,
                                device="cpu")
    assert ti.dtype == np.int32 and ts.dtype == np.float32
    assert_topk_match(ji, js, ti, ts)


def test_scan_k_above_n_raises_like_jax():
    base = _unit(6, 8, 0)
    with pytest.raises(ValueError):
        jd._dense_scan_jit(jnp.asarray(base), jnp.asarray(base[:2]), k=9,
                           block_points=6, recall_target=0.9, exact=True)
    with pytest.raises(ValueError):
        td._dense_scan_impl(torch.from_numpy(base), torch.from_numpy(base[:2]),
                            k=9, block_points=6, recall_target=0.9, exact=True)


@pytest.mark.parametrize("k", [1, 7, 25])
def test_gmm_matches_jax_and_reference(k):
    x = tsyn.clustered_unit_vectors(900, 16, n_modes=10, spread=0.5, seed=k)
    jc, ja, jr = jgmm.greedy_minimum_maximum(x, k)
    rc, ra, rr = jgmm.greedy_minimum_maximum_reference(x, k)
    tc, ta, tr = _tgmm(x, k)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tr, np.asarray(jr), atol=1e-5)
    np.testing.assert_array_equal(tc, rc)
    np.testing.assert_array_equal(ta, ra)
    np.testing.assert_allclose(tr, rr, atol=1e-5)


def test_gmm_assume_normalized_and_euclidean():
    x = tsyn.clustered_unit_vectors(600, 12, n_modes=6, seed=2)
    jc, ja, jr = jgmm.greedy_minimum_maximum(x, 9, assume_normalized=True)
    tc, ta, tr = _tgmm(x, 9, assume_normalized=True)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tr, np.asarray(jr), atol=1e-5)
    xe = x * np.linspace(0.5, 2.0, 600, dtype=np.float32)[:, None]
    jc, ja, jr = jgmm.greedy_minimum_maximum(xe, 9, metric="euclidean")
    tc, ta, tr = _tgmm(xe, 9, metric="euclidean")
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(tr, np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("n", [4, 9])
def test_gmm_degenerate(n):
    x = _unit(n, 5, 1)
    jc, ja, jr = jgmm.greedy_minimum_maximum(x, 9)
    tc, ta, tr = _tgmm(x, 9)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tr, np.asarray(jr))


@pytest.mark.parametrize("gen,kw", [
    ("random_unit_vectors", {}),
    ("clustered_unit_vectors", dict(n_modes=17, spread=0.7)),
    ("hierarchical_unit_vectors", dict(n_super=4, subs_per_super=3)),
])
def test_generators_byte_identical(gen, kw):
    for seed in (0, 11):
        a = getattr(jsyn, gen)(333, 21, seed=seed, **kw)
        b = getattr(tsyn, gen)(333, 21, seed=seed, **kw)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_make_synthetic_dataset():
    j = jsyn.make_synthetic_dataset(n=800, d=12, n_queries=20, k_gt=15, seed=4)
    t = tsyn.make_synthetic_dataset(n=800, d=12, n_queries=20, k_gt=15, seed=4, device="cpu")
    assert j.name == t.name
    assert j.train.tobytes() == t.train.tobytes()
    assert j.test.tobytes() == t.test.tobytes()
    assert t.neighbors.dtype == np.int32 and t.distances.dtype == np.float32
    assert_topk_match(j.neighbors, j.distances, t.neighbors, t.distances)


def test_make_synthetic_dataset_defaults_to_the_card(monkeypatch):
    """The ground truth runs on the card unless the caller names the CPU:
    with no CUDA device the default raises (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.make_synthetic_dataset(n=50, d=4, n_queries=3, k_gt=5)
    t = tsyn.make_synthetic_dataset(n=50, d=4, n_queries=3, k_gt=5, device="cpu")
    assert t.neighbors.shape == (3, 5)


def test_config_round_trips_between_packages():
    j = JConfig(num_tables=7, k=4, delta=0.8, dataset_name="x", seed=3,
                search_mode="scan-pallas", metrics_output="None")
    t = TConfig.from_dict(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert JConfig.from_json(t.to_json()) == j
    assert TConfig().to_dict() == JConfig().to_dict()
    from clann_tpu_torch.errors import ConfigError

    with pytest.raises(ConfigError):
        TConfig(delta=1.5)


def test_recall_functions():
    rng = np.random.default_rng(9)
    gt = np.sort(rng.random((30, 12)).astype(np.float32), axis=1)
    run = np.sort(gt[:, :10] + rng.normal(scale=2e-3, size=(30, 10)).astype(np.float32), axis=1)
    assert jrecall.recall_values(gt, run, 10)[:2] == trecall.recall_values(gt, run, 10)[:2]
    gi = rng.integers(0, 50, size=(30, 10))
    ri = rng.integers(0, 50, size=(30, 10))
    assert jrecall.recall_by_ids(gi, ri, 10) == trecall.recall_by_ids(gi, ri, 10)

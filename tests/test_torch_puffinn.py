"""The upstream PUFFINN surface of the port (clann_tpu_torch.puffinn.Index)
against the JAX package's (clann_tpu.puffinn) on the CPU.

- The table count derived from the byte budget and the derived Config are
  JAX's, for several budgets and both metrics (the same byte model,
  parallel/capacity.py).
- Every error case of tests/test_puffinn_compat.py raises the same error.
- Searches run on JAX's tables carried across into the port's handle, so
  both surfaces search one index: ids equal up to boundary ties.
- On the port's own build: `search` equals the port's global_search,
  `search_from_index` drops the point itself, pickling (with a pending
  insert) restores the same results, `get` and `len` as upstream.
"""

import pickle

import numpy as np
import pytest
import torch

from clann_tpu import puffinn as jpuffinn
from clann_tpu.data.synthetic import clustered_sets, clustered_unit_vectors
from clann_tpu.errors import IndexCreationError as JIndexCreationError

from clann_tpu_torch import puffinn as tpuffinn
from clann_tpu_torch.core.index import index_from_arrays
from clann_tpu_torch.core.jaccard import jaccard_index_from_arrays, jaccard_search
from clann_tpu_torch.errors import DataError, IndexCreationError
from clann_tpu_torch.ops.global_query import global_search
from clann_tpu_torch.ops.join import closest_pairs
from clann_tpu_torch.testing import index_arrays, jaccard_index_arrays

torch.set_num_threads(1)

MEM = 256 * 1024 * 1024
CPU = dict(device="cpu")


def unit_vectors(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _fill(index, values):
    for v in values:
        index.insert(v)
    return index


@pytest.mark.parametrize("metric, dims, kw", [
    ("angular", 16, dict(hash_function="simhash")),
    ("angular", 16, dict()),
    ("angular", 100, dict(hash_source="pool", source_args={"pool_size": 7})),
    ("jaccard", 500, dict()),
])
@pytest.mark.parametrize("memory", [300_000, 2 * 1024**2, 64 * 1024**2, 5_335_185_152])
def test_derived_tables_match_jax(metric, dims, kw, memory):
    """Same budget, same points: the same L (or the same refusal) and the
    same derived Config."""
    if metric == "angular":
        values = clustered_unit_vectors(300, dims, n_modes=5, seed=2)
    else:
        values = clustered_sets(300, dims, avg_size=14, n_modes=10, seed=5)
    j = _fill(jpuffinn.Index(metric, dims, memory, **kw), values)
    t = _fill(tpuffinn.Index(metric, dims, memory, **kw, **CPU), values)
    try:
        want = j._derive_num_tables(len(values))
    except JIndexCreationError as e:
        assert "insufficient memory" in str(e)
        with pytest.raises(IndexCreationError, match="insufficient memory"):
            t._derive_num_tables(len(values))
        return
    assert t._derive_num_tables(len(values)) == want
    assert t._config(want).to_dict() == j._config(want).to_dict()


def test_glove_budget_derives_128_tables():
    """The byte model at 1,183,514 x 100: 1,088,035,072 B fixed plus
    33,180,860 B per table, so 5,335,185,152 B buys L = 128 (both packages,
    from the model alone: no points are needed beyond the count)."""
    from clann_tpu.parallel.capacity import plan_capacity as jplan
    from clann_tpu_torch.parallel.capacity import plan_capacity as tplan

    t = tpuffinn.Index("angular", 100, 5_335_185_152, **CPU)
    j = jpuffinn.Index("angular", 100, 5_335_185_152)
    n = 1_183_514
    for plan, idx in ((tplan, t), (jplan, j)):
        t1 = plan(n, 100, idx._config(1)).total_bytes
        t2 = plan(n, 100, idx._config(2)).total_bytes
        assert (t2 - t1, 2 * t1 - t2) == (33_180_860, 1_088_035_072)
        assert (5_335_185_152 - (2 * t1 - t2)) // (t2 - t1) == 128


def _error_cases():
    return [
        ("bad metric", lambda: tpuffinn.Index("euclidean", 10, MEM, **CPU), ValueError),
        ("angular minhash", lambda: tpuffinn.Index("angular", 10, MEM, hash_function="minhash",
                                                   **CPU), ValueError),
        ("jaccard simhash", lambda: tpuffinn.Index("jaccard", 10, MEM, hash_function="simhash",
                                                   **CPU), ValueError),
        ("bad source", lambda: tpuffinn.Index("angular", 10, MEM, hash_source="bogus", **CPU),
         ValueError),
        ("unknown kwarg", lambda: tpuffinn.Index("angular", 10, MEM, bogus_arg=1, **CPU),
         TypeError),
        ("unknown hash_args", lambda: tpuffinn.Index("angular", 10, MEM,
                                                     hash_args={"bogus": 1}, **CPU), TypeError),
        ("unknown source_args", lambda: tpuffinn.Index("angular", 10, MEM,
                                                       source_args={"bogus": 1}, **CPU),
         TypeError),
        ("insufficient memory", lambda: _fill(tpuffinn.Index("angular", 16, 10_000, **CPU),
                                              unit_vectors(200, 16)).rebuild(),
         IndexCreationError),
        ("dimension", lambda: tpuffinn.Index("angular", 8, MEM, **CPU).insert([1.0, 2.0]),
         ValueError),
        ("universe", lambda: tpuffinn.Index("jaccard", 10, MEM, **CPU).insert([3, 11]),
         DataError),
        ("empty rebuild", lambda: tpuffinn.Index("angular", 8, MEM, **CPU).rebuild(), DataError),
        ("jaccard pool", lambda: tpuffinn.Index("jaccard", 100, MEM, hash_source="pool", **CPU),
         NotImplementedError),
        ("bad dimensions", lambda: tpuffinn.Index("angular", 0, MEM, **CPU), ValueError),
        ("bad memory", lambda: tpuffinn.Index("angular", 8, 0, **CPU), ValueError),
    ]


@pytest.mark.parametrize("case", _error_cases(), ids=lambda c: c[0])
def test_error_cases(case):
    _, call, err = case
    with pytest.raises(err):
        call()


def test_device_keyword():
    """`device` is the port's one extra keyword; JAX refuses it, and every
    other unknown keyword still raises."""
    assert tpuffinn.Index("angular", 8, MEM, device="cpu").device == "cpu"
    with pytest.raises(TypeError):
        jpuffinn.Index("angular", 8, MEM, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpuffinn.Index("angular", 8, MEM)


@pytest.fixture(scope="module")
def angular():
    """JAX's surface and the port's over the same points, the port holding
    JAX's tables (carried across) so both search one index."""
    x = unit_vectors(600, 24, seed=7)
    j = _fill(jpuffinn.Index("angular", 24, MEM, hash_function="simhash", seed=3), x)
    j.rebuild()
    t = _fill(tpuffinn.Index("angular", 24, MEM, hash_function="simhash", seed=3, **CPU), x)
    t._index = index_from_arrays(index_arrays(j._index), t._config(j._index.num_tables),
                                 device="cpu")
    t._built_count = len(x)
    return j, t, x


def test_angular_searches_match_jax(angular):
    j, t, x = angular
    rng = np.random.default_rng(11)
    queries = rng.normal(size=(12, 24)).astype(np.float32)
    sims = queries @ x.T / np.linalg.norm(queries, axis=1, keepdims=True)
    for qi, q in enumerate(queries):
        for k, recall, ft in ((5, 0.8, "default"), (10, 0.9, "none"), (3, 0.95, "simple")):
            a, b = t.search(q, k, recall, filter_type=ft), j.search(q, k, recall, filter_type=ft)
            assert len(a) == len(b) == k
            kth = min(sims[qi, a].min(), sims[qi, b].min())
            assert all(abs(sims[qi, i] - kth) <= 1e-6 for i in set(a) ^ set(b)), (a, b)
    for i in (0, 17, 599):
        assert t.search_from_index(i, 5, 0.8) == j.search_from_index(i, 5, 0.8)
    assert t.closest_pairs(10, 0.8) == j.closest_pairs(10, 0.8)
    assert t.get(5) == pytest.approx(j.get(5), abs=1e-7) and len(t) == len(j) == 600
    with pytest.raises(ValueError):
        t.search(x[0], 5, 0.8, filter_type="bogus")
    with pytest.raises(IndexError):
        t.search_from_index(600, 5, 0.8)


@pytest.fixture(scope="module")
def own():
    x = unit_vectors(600, 24, seed=7)
    t = _fill(tpuffinn.Index("angular", 24, MEM, hash_function="simhash", seed=3, **CPU), x)
    t.rebuild()
    return t, x


def test_search_is_global_search(own):
    """search(q, k, recall) is global_search on the C = 1 index at
    delta = recall, its valid ids in order; the index is the flat global
    engine of the derived table count."""
    t, x = own
    idx = t._index
    assert idx.n_clusters == 1 and idx.g_records is not None and idx.seg_vectors is None
    assert idx.num_tables == t._derive_num_tables(600)
    rng = np.random.default_rng(3)
    queries = rng.normal(size=(8, 24)).astype(np.float32)
    _, ids, _ = global_search(idx, queries, k=5, delta=0.8)
    for q, row in zip(queries, ids):
        assert t.search(q, 5, 0.8) == [int(i) for i in row if i >= 0]
    pairs, _ = closest_pairs(idx, k=10, delta=0.8)
    assert t.closest_pairs(10, 0.8) == [tuple(p) for p in pairs.tolist()]


def test_recall_contract(own):
    """collection_test.hpp:87-176: correct >= 0.8 * recall * k * samples."""
    t, x = own
    rng = np.random.default_rng(11)
    queries = rng.normal(size=(40, 24)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    sims = queries @ x.T
    correct = 0
    for qi, q in enumerate(queries):
        gt_kth = np.sort(sims[qi])[::-1][4]
        res = t.search(q, 5, 0.8)
        assert len(res) == 5
        correct += sum(sims[qi, r] >= gt_kth - 1e-6 for r in res)
    assert correct >= 0.8 * 0.8 * 5 * len(queries)


def test_search_from_index_get_len(own):
    t, x = own
    for i in (0, 17, 599):
        res = t.search_from_index(i, 5, 0.8)
        assert i not in res and len(res) == 5
    np.testing.assert_allclose(t.get(5), x[5] / np.linalg.norm(x[5]), rtol=1e-6)
    assert len(t) == 600
    with pytest.raises(IndexError):
        t.get(600)


def test_pickle_with_a_pending_insert():
    """The pickled state carries the device and the built count: the
    restored handle rebuilds the same tables lazily, and a point inserted
    after the rebuild stays pending."""
    x = unit_vectors(300, 16, seed=4)
    t = _fill(tpuffinn.Index("angular", 16, MEM, hash_function="simhash", seed=2, **CPU), x)
    t.rebuild()
    t.insert(np.roll(x[0], 1))
    assert len(t) == 301
    res = t.search(x[0], 5, 0.9)
    assert all(r < 300 for r in res)
    t2 = pickle.loads(pickle.dumps(t))
    assert t2.device == "cpu" and t2._index is None
    assert t2.search(x[0], 5, 0.9) == res
    assert t2._built_count == 300 and len(t2) == 301
    for qi in (1, 250):
        assert t2.search(x[qi], 5, 0.9) == t.search(x[qi], 5, 0.9)
    t2.rebuild()
    assert t2._index.n == 301


@pytest.fixture(scope="module")
def sets_pair():
    sets = clustered_sets(400, 500, avg_size=14, n_modes=10, core_share=0.9,
                          pool_factor=1.2, seed=5)
    j = _fill(jpuffinn.Index("jaccard", 500, MEM, seed=1), sets)
    j.rebuild()
    t = _fill(tpuffinn.Index("jaccard", 500, MEM, seed=1, **CPU), sets)
    t._index = jaccard_index_from_arrays(jaccard_index_arrays(j._index),
                                         t._config(j._index.sorted_hash.shape[0]), device="cpu")
    t._built_count = len(sets)
    return j, t, sets


def _jaccard(a, b):
    a, b = set(a), set(b)
    return len(a & b) / len(a | b)


def test_jaccard_surface_matches_jax(sets_pair):
    """Same ids up to boundary ties (exact Jaccard of a differing id equal
    to the k-th); search is jaccard_search's valid ids."""
    j, t, sets = sets_pair
    for qi in range(0, 400, 40):
        a, b = t.search(sets[qi], 3, 0.8), j.search(sets[qi], 3, 0.8)
        sims, ids, _ = jaccard_search(t._index, [sets[qi]], k=3, delta=0.8)
        assert a == [int(i) for i in ids[0] if i >= 0]
        assert all(abs(_jaccard(sets[qi], sets[i]) - sims[0, -1]) <= 1e-6
                   for i in set(a) ^ set(b))
    assert t.search_from_index(4, 3, 0.8) == j.search_from_index(4, 3, 0.8)
    assert t.closest_pairs(10, 0.8) == j.closest_pairs(10, 0.8)
    assert t.get(7) == j.get(7) == sorted(set(sets[7]))


def test_jaccard_own_build(sets_pair):
    """The port's own MinHash build: self-queries find themselves, and
    pickling restores identical results."""
    _, _, sets = sets_pair
    t = _fill(tpuffinn.Index("jaccard", 500, MEM, seed=1, **CPU), sets)
    t.rebuild()
    assert t.search(sets[2], 1, 0.9) == [2]
    t2 = pickle.loads(pickle.dumps(t))
    assert t.search(sets[2], 3, 0.9) == t2.search(sets[2], 3, 0.9)
    res = t.search_from_index(4, 3, 0.8)
    assert 4 not in res and len(res) == 3

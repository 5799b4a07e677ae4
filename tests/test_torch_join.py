"""The closest-pairs joins of the port (ops/join: table_pairs,
dedup_topk_pairs, window_sweep, closest_pairs, global_bf_join and the
Jaccard pair) and Clann.closest_pairs, against the JAX package on the CPU,
at the shapes of tests/test_jaccard_join.py (a few hundred points).

JAX builds each index and it is carried across whole (index_from_arrays,
jaccard_index_from_arrays), so both packages join the same tables.
Tolerances: pair similarities within 1e-6 (row-wise f32 sums in another
order); pairs equal as sets except where a similarity ties the k-th
within 1e-6; the final window of the sweep equal. The port joins its
tables in chunks under a byte budget; a join of one table per chunk
equals a join of all tables in one chunk, bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.core import jaccard as jjac
from clann_tpu.data.setdata import JaccardData as JData
from clann_tpu.data.synthetic import clustered_sets, clustered_unit_vectors
from clann_tpu.ops import join as jjoin

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.core import jaccard as tjac
from clann_tpu_torch.data.setdata import JaccardData as TData
from clann_tpu_torch.ops import join as tjoin
from clann_tpu_torch.testing import index_arrays, jaccard_index_arrays

torch.set_num_threads(1)

# C = 1 and clustered (GMM) indexes; L = 2 makes the sweep grow its window
KINDS = {
    "flat": dict(num_tables=8, k=10, hash_family="simhash", seed=4),
    "clustered": dict(num_tables=8, k=10, seed=4, num_clusters_factor=0.5),
    "flat-L2": dict(num_tables=2, k=10, hash_family="simhash", seed=5),
}


@pytest.fixture(scope="module")
def points():
    return clustered_unit_vectors(400, 16, n_modes=6, seed=1)


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX index of KINDS[kind] on the points, the same index in the port)."""
    kw = KINDS[kind]
    points = clustered_unit_vectors(400, 16, n_modes=6, seed=1)
    if "num_clusters_factor" in kw:
        jidx = jindex.build_index(points, JConfig(**kw))
    else:
        jidx = jindex.build_lsh_index(points, JConfig(**kw))
    return jidx, tindex.index_from_arrays(index_arrays(jidx), TConfig(**kw), device="cpu")


@pytest.fixture(params=list(KINDS))
def pair(request):
    return _pair(request.param)


def _windows(monkeypatch, module, name="_windowed_pairs"):
    """Record the windows a sweep evaluates (the last one is final)."""
    seen = []
    inner = getattr(module, name)

    def spy(*args, window, **kw):
        seen.append(window)
        return inner(*args, window=window, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


def assert_pairs_match(pairs_a, sims_a, pairs_b, sims_b, tol=1e-6):
    """Sims within tol; pair sets equal except where a sim ties the k-th."""
    np.testing.assert_allclose(sims_a, sims_b, rtol=0, atol=tol)
    a = {tuple(p): s for p, s in zip(np.asarray(pairs_a).tolist(), sims_a)}
    b = {tuple(p): s for p, s in zip(np.asarray(pairs_b).tolist(), sims_b)}
    kth = min(sims_a[-1], sims_b[-1])
    only = [a[p] for p in a.keys() - b.keys()] + [b[p] for p in b.keys() - a.keys()]
    assert all(abs(s - kth) <= 2 * tol for s in only), only


@pytest.mark.parametrize("k, delta", [(10, 0.8), (25, 0.95), (60, 0.999)])
def test_closest_pairs_matches_jax(pair, k, delta, monkeypatch):
    jidx, tidx = pair
    jw, tw = _windows(monkeypatch, jjoin), _windows(monkeypatch, tjoin)
    jp, js = jjoin.closest_pairs(jidx, k=k, delta=delta)
    tp, ts = tjoin.closest_pairs(tidx, k=k, delta=delta)
    assert tw == jw and tw[-1] >= 4
    assert tp.shape == (k, 2) and tp.dtype == np.int32 and ts.shape == (k,)
    assert_pairs_match(tp, ts, jp, js)


def test_sweep_reaches_max_window(monkeypatch):
    """L = 2 tables fail the delta rule at every window: the sweep doubles
    to max_window in both packages."""
    jidx, tidx = _pair("flat-L2")
    jw, tw = _windows(monkeypatch, jjoin), _windows(monkeypatch, tjoin)
    jp, js = jjoin.closest_pairs(jidx, k=30, delta=0.999, max_window=32)
    tp, ts = tjoin.closest_pairs(tidx, k=30, delta=0.999, max_window=32)
    assert tw == jw == [4, 8, 16, 32]
    assert_pairs_match(tp, ts, jp, js)


def test_closest_pairs_against_the_oracle(points):
    """JAX's invariants on the port's own build: canonical, unique pairs,
    sims non-increasing and equal to the exact f32 (x_i . x_j + 1) / 2, and
    recall of the true top-10 >= 0.6."""
    cfg = TConfig(num_tables=12, k=10, hash_family="simhash", candidate_chunk=128, seed=3)
    idx = tindex.build_lsh_index(points, cfg, device="cpu")
    pairs, sims = tjoin.closest_pairs(idx, k=20, delta=0.8)
    assert (pairs[:, 0] < pairs[:, 1]).all()
    assert len({tuple(p) for p in pairs.tolist()}) == 20
    assert np.all(np.diff(sims) <= 1e-6)
    xn = idx.vectors.numpy().astype(np.float64)
    true = (np.sum(xn[pairs[:, 0]] * xn[pairs[:, 1]], axis=1) + 1) / 2
    np.testing.assert_allclose(sims, true, rtol=0, atol=1e-5)
    bf_pairs, _ = tjoin.global_bf_join(idx, k=10)
    found = {tuple(p) for p in pairs[:10].tolist()}
    assert len(found & {tuple(p) for p in bf_pairs.tolist()}) / 10 >= 0.6


def test_global_bf_join_matches_jax(pair):
    jidx, tidx = pair
    jp, js = jjoin.global_bf_join(jidx, k=15)
    tp, ts = tjoin.global_bf_join(tidx, k=15)
    assert_pairs_match(tp, ts, jp, js)


@pytest.mark.parametrize("kind", ["flat", "clustered"])
def test_table_chunks_do_not_change_the_join(kind, points):
    """One table per chunk (a budget below one table) equals every table
    in one chunk: sims, lo and hi bit for bit."""
    kw = KINDS[kind]
    if "num_clusters_factor" in kw:
        idx = tindex.build_index(points, TConfig(**kw), device="cpu")
    else:
        idx = tindex.build_lsh_index(points, TConfig(**kw), device="cpu")
    one = tjoin.table_pairs(idx.vectors, idx.sorted_idx, k=10, window=8, budget_bytes=1)
    every = tjoin.table_pairs(idx.vectors, idx.sorted_idx, k=10, window=8,
                              budget_bytes=1 << 40)
    for a, b in zip(one, every):
        assert a.shape == (8, 40)
        assert torch.equal(a, b)
    assert torch.equal(tjoin.dedup_topk_pairs(*(x.reshape(-1) for x in one), k=10)[1],
                       tjoin.dedup_topk_pairs(*(x.reshape(-1) for x in every), k=10)[1])


def test_table_pairs_matches_jax(pair):
    """Per table, the same 4k best (sims, pair) candidates as JAX's vmap."""
    jidx, tidx = pair
    js, jlo, jhi = jjoin.table_pairs(jidx.vectors, jidx.sorted_idx, k=5, window=4)
    ts, tlo, thi = tjoin.table_pairs(tidx.vectors, tidx.sorted_idx, k=5, window=4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    for t in range(ts.shape[0]):
        assert_pairs_match(np.stack([tlo[t].numpy(), thi[t].numpy()], 1), ts[t].numpy(),
                           np.stack([np.asarray(jlo[t]), np.asarray(jhi[t])], 1),
                           np.asarray(js[t]))


def test_dedup_large_ids_no_overflow():
    """JAX's case: ids above 46k (where a packed int32 key would wrap)
    rank and dedup exactly."""
    lo = [70_000, 70_000, 1_000_000, 5, 70_000]
    hi = [90_000, 90_000, 2_000_000, 9, 90_001]
    sims = [0.9, 0.9, 0.8, 0.7, 0.6]
    top_s, pairs = tjoin.dedup_topk_pairs(torch.tensor(sims), torch.tensor(lo, dtype=torch.int32),
                                          torch.tensor(hi, dtype=torch.int32), k=4)
    want = [[70_000, 90_000], [1_000_000, 2_000_000], [5, 9], [70_000, 90_001]]
    assert pairs.tolist() == want
    np.testing.assert_allclose(top_s.numpy(), [0.9, 0.8, 0.7, 0.6])
    j_s, j_pairs = jjoin.dedup_topk_pairs(jnp.asarray(sims, jnp.float32),
                                          jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32),
                                          k=4)
    assert np.asarray(j_pairs).tolist() == want
    np.testing.assert_array_equal(top_s.numpy(), np.asarray(j_s))


def test_dedup_underfull_masks_missing():
    """JAX's case: fewer distinct pairs than k leave -1 pairs."""
    top_s, pairs = tjoin.dedup_topk_pairs(torch.tensor([0.5, 0.5]),
                                          torch.tensor([1, 1], dtype=torch.int32),
                                          torch.tensor([2, 2], dtype=torch.int32), k=2)
    assert pairs.tolist() == [[1, 2], [-1, -1]]
    assert top_s.tolist() == [0.5, -1.0]


def test_dedup_ties_go_to_the_lower_pair():
    """Equal sims: the lower (lo, hi) first, as lax.top_k over JAX's
    key-sorted order."""
    lo, hi = [9, 3, 3, 1], [12, 8, 4, 20]
    sims = [0.5, 0.5, 0.5, 0.5]
    _, pairs = tjoin.dedup_topk_pairs(torch.tensor(sims), torch.tensor(lo, dtype=torch.int32),
                                      torch.tensor(hi, dtype=torch.int32), k=3)
    _, j_pairs = jjoin.dedup_topk_pairs(jnp.asarray(sims, jnp.float32), jnp.asarray(lo, jnp.int32),
                                        jnp.asarray(hi, jnp.int32), k=3)
    assert pairs.tolist() == np.asarray(j_pairs).tolist() == [[1, 20], [3, 4], [3, 8]]


@pytest.fixture(scope="module")
def set_pair():
    sets = clustered_sets(300, 500, avg_size=14, n_modes=10, core_share=0.9,
                          pool_factor=1.2, seed=5)
    kw = dict(num_tables=8, k=5, delta=0.8, candidate_chunk=32, max_hashbits=16, seed=1)
    jidx = jjac.build_jaccard_index(JData(sets, 500), JConfig(**kw))
    tidx = tjac.jaccard_index_from_arrays(jaccard_index_arrays(jidx), TConfig(**kw),
                                          device="cpu")
    return sets, jidx, tidx


@pytest.mark.parametrize("k, delta", [(10, 0.8), (30, 0.95)])
def test_jaccard_closest_pairs_matches_jax(set_pair, k, delta, monkeypatch):
    _, jidx, tidx = set_pair
    jw = _windows(monkeypatch, jjoin, "_jaccard_windowed_pairs")
    tw = _windows(monkeypatch, tjoin)
    jp, js = jjoin.jaccard_closest_pairs(jidx, k=k, delta=delta)
    tp, ts = tjoin.jaccard_closest_pairs(tidx, k=k, delta=delta)
    assert tw == jw and tw
    assert_pairs_match(tp, ts, jp, js)


def test_jaccard_bf_join_matches_jax(set_pair):
    sets = set_pair[0]
    jp, js = jjoin.jaccard_bf_join(JData(sets, 500), k=12)
    tp, ts = tjoin.jaccard_bf_join(TData(sets, 500), k=12, device="cpu")
    assert_pairs_match(tp, ts, jp, js)
    assert ts.dtype == np.float32


def test_facade_closest_pairs(pair):
    """Clann.closest_pairs is ops.join.closest_pairs at config.delta; a
    mesh raises (the sharded join is not ported)."""
    jidx, tidx = pair
    h = clann_tpu_torch.init_with_config(tidx.vectors.numpy(), tidx.config, device="cpu")
    h.index = tidx
    p, s = h.closest_pairs(k=10)
    p2, s2 = tjoin.closest_pairs(tidx, k=10, delta=tidx.config.delta)
    np.testing.assert_array_equal(p, p2)
    np.testing.assert_array_equal(s, s2)
    with pytest.raises(NotImplementedError, match="slice 15"):
        h.closest_pairs(k=10, mesh=object())
    with pytest.raises(clann_tpu_torch.DataError):
        clann_tpu_torch.init_with_config(tidx.vectors.numpy(), tidx.config,
                                         device="cpu").closest_pairs(k=3)


def _top_pairs(x: torch.Tensor, k: int, rows: int = 1024):
    """Exact top-k pairs i < j of the unit rows x: f32 products in blocks
    of rows against the rows after them, each block's pairs above the
    running k-th merged into the running best k. Returns numpy (pairs
    (k, 2), sims (k,) descending)."""
    n = x.shape[0]
    best_s, best_p = torch.zeros(0), torch.zeros((0, 2), dtype=torch.int64)
    for r0 in range(0, n - 1, rows):
        b, m = min(n, r0 + rows) - r0, n - r0
        dots = x[r0:r0 + b] @ x[r0:].T  # column c is row r0 + c
        dots[:, :b].masked_fill_(torch.ones(b, b, dtype=torch.bool).tril(), -2.0)
        floor = best_s[-1] if best_s.numel() == k else -2.0
        flat = torch.nonzero(dots.reshape(-1) > floor).flatten()
        vals = dots.reshape(-1)[flat]
        pairs = torch.stack([flat // m + r0, flat % m + r0], dim=1)
        best_s, sel = torch.topk(torch.cat([best_s, vals]), min(k, best_s.numel() + vals.numel()))
        best_p = torch.cat([best_p, pairs])[sel]
    return best_p.numpy(), ((best_s + 1.0) * 0.5).numpy()


def test_window_rule_stops_short_on_one_dense_mode(monkeypatch):
    """A trap of the reference's window model, pinned in both packages: on
    12,000 points of one mode (100 wide, C = 1, L = 64) the delta rule
    accepts window 4 for the 100th pair, taking a window of w for a shared
    prefix of log2(n / w) bits, but an 11-bit bucket of one dense mode
    holds far more than 4 points, so the true close pairs sit within 4
    positions in few tables. JAX's closest_pairs and the port's stop at the
    same window with the same pairs, and fewer than half of those reach the
    true 100th similarity (the compat test's bar, met at 600 points)."""
    k, delta = 100, 0.9
    x = clustered_unit_vectors(12_000, 100, n_modes=1, spread=0.7, seed=0)
    kw = dict(num_tables=64, k=10, seed=0)
    jidx = jindex.build_lsh_index(x, JConfig(**kw))
    tidx = tindex.index_from_arrays(index_arrays(jidx), TConfig(**kw), device="cpu")
    jw, tw = _windows(monkeypatch, jjoin), _windows(monkeypatch, tjoin)
    jp, js = jjoin.closest_pairs(jidx, k=k, delta=delta)
    tp, ts = tjoin.closest_pairs(tidx, k=k, delta=delta)
    assert tw == jw == [4]
    assert_pairs_match(tp, ts, jp, js)

    true_p, true_s = _top_pairs(tidx.vectors, k)
    j_share = float(np.mean(np.asarray(js) >= true_s[-1] - 1e-6))
    t_share = float(np.mean(ts >= true_s[-1] - 1e-6))
    # how often a true pair sits within the window, against the model's
    # probability of a shared prefix at the depth the rule assumed
    pos = torch.argsort(tidx.sorted_idx.to(torch.int64), dim=1).numpy()  # (L, n) slot of each id
    near = np.abs(pos[:, true_p[:, 0]] - pos[:, true_p[:, 1]]) <= tw[-1]
    depth = int(np.clip(np.log2(12_000 / tw[-1]), 1, tidx.config.max_hashbits))
    p_model = float(tidx.probs_table[depth, int(true_s[-1] / tidx.sim_eps)])
    print(f"window {tw[-1]}; share >= true {k}th: JAX {j_share:.2f}, port {t_share:.2f}; "
          f"a true pair within the window in {near.mean():.3f} of the tables, model "
          f"{p_model:.3f} at depth {depth}")
    assert j_share == t_share < 0.5
    assert near.mean() < p_model


def test_wrapped_slots_keep_a_pair_that_jax_drops():
    """A JAX-side loss, pinned as a witness of the port's answer: JAX's
    table_pairs gives a position past a table's end the wrapped neighbour
    (a real pair of ids) at sim -1, and when kk = min(4k, n * window)
    reaches those slots, dedup_topk_pairs can keep that -1 copy first and
    mask a valid copy of the same pair from a later table. The port gives
    those slots the pair (-1, -1), so it keeps the pair. On 6 unit vectors
    with k = 6 and window 1, JAX drops (0, 5), the second-best pair
    (sim 0.8112); the port returns it second."""
    x = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    sorted_idx = np.asarray([[0, 1, 2, 3, 4, 5], [1, 2, 5, 0, 3, 4]], np.int32)
    kw = dict(k=6, window=1)

    js, jlo, jhi = jjoin.table_pairs(jnp.asarray(x), jnp.asarray(sorted_idx), **kw)
    j_sims, j_pairs = jjoin.dedup_topk_pairs(
        js.reshape(-1), jlo.reshape(-1), jhi.reshape(-1), k=6)
    ts, tlo, thi = tjoin.table_pairs(torch.as_tensor(x), torch.as_tensor(sorted_idx), **kw)
    t_sims, t_pairs = tjoin.dedup_topk_pairs(
        ts.reshape(-1), tlo.reshape(-1), thi.reshape(-1), k=6)

    # the slot past table 0's end (id 5): JAX pairs it with the wrapped
    # neighbour, id 0, at sim -1; the port gives it (-1, -1). Table 1
    # holds (0, 5) as real neighbours (5 then 0)
    assert float(js[0, -1]) == float(ts[0, -1]) == -1.0
    assert (int(jlo[0, -1]), int(jhi[0, -1])) == (0, 5)
    assert (int(tlo[0, -1]), int(thi[0, -1])) == (-1, -1)

    truth = float((x[0] @ x[5] + 1.0) * 0.5)
    assert abs(truth - 0.8112) < 1e-4
    j_list = np.asarray(j_pairs).tolist()
    assert [0, 5] not in j_list
    assert j_list == [[4, 5], [1, 2], [2, 5], [2, 3], [0, 1], [3, 4]]
    t_list = t_pairs.numpy().tolist()
    assert t_list[1] == [0, 5]
    assert abs(float(t_sims[1]) - truth) < 1e-6
    # every other pair the port returns is one JAX returns too, at its sim
    j_by = {tuple(p): float(s) for p, s in zip(j_list, np.asarray(j_sims))}
    for p, s in zip(t_list, t_sims.numpy()):
        if tuple(p) != (0, 5) and tuple(p) in j_by:
            assert abs(j_by[tuple(p)] - float(s)) < 1e-6

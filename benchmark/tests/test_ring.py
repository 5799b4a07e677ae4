"""The window's batches: every replay of the pool holds each query once,
no batch repeats another, and the seed alone sets the order."""

import numpy as np
import pytest

from benchmark.harness import Ring


def _pool(n=96, d=4):
    return np.arange(n * d, dtype=np.float32).reshape(n, d)


def test_each_replay_holds_every_query_once_and_views_the_pool():
    pool = _pool()
    ring = Ring(pool, 16, seed=2**33 + 5)
    for replay in range(3):
        rows = np.concatenate([ring(replay * 6 + j)[0] for j in range(6)])
        assert sorted(rows.tolist()) == list(range(96))
    rows, q = ring(4)
    assert np.shares_memory(q, ring.queries) and (q == pool[rows]).all()


def test_no_batch_repeats_another_while_replays_are_fewer_than_a_batch():
    ring = Ring(_pool(), 16, seed=7)
    seen = {ring(i)[1].tobytes() for i in range(6 * 16)}
    assert len(seen) == 6 * 16


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_the_seed_sets_the_order(seed):
    a, b, c = Ring(_pool(), 16, seed), Ring(_pool(), 16, seed), Ring(_pool(), 16, seed + 1)
    assert all((a(i)[0] == b(i)[0]).all() for i in range(12))
    assert any((a(i)[0] != c(i)[0]).any() for i in range(12))

"""The reference's exact k-NN, its distance recomputation and the recall
rule, on tiny data against numpy."""

import numpy as np
import torch

from benchmark.reference import knn


def _data(n=500, d=12, q=7, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((q, d)).astype(np.float32))


def _numpy_knn(x, q, k):
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    dist = 1.0 - qn.astype(np.float64) @ xn.T.astype(np.float64)
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, ids, 1), ids


def test_exact_knn_matches_numpy_across_row_and_query_blocks():
    x, q = _data()
    d_np, i_np = _numpy_knn(x, q, 10)
    d, i = knn.exact_knn(torch.from_numpy(x), torch.from_numpy(q), 10, block_q=3, block_n=64)
    assert (i.numpy() == i_np).all()
    np.testing.assert_allclose(d.numpy(), d_np, atol=1e-6)


def test_distances_of_recomputes_and_marks_non_rows():
    x, q = _data()
    ids = torch.tensor([[0, 5, -1], [499, 500, 2]] + [[1, 2, 3]] * 5)
    d = knn.distances_of(torch.from_numpy(x), torch.from_numpy(q), ids).numpy()
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert np.isinf(d[0, 2]) and np.isinf(d[1, 1])
    np.testing.assert_allclose(d[1, 0], 1 - xn[499] @ qn[1], atol=1e-6)
    np.testing.assert_allclose(d[0, 1], 1 - xn[5] @ qn[0], atol=1e-6)


def test_recall_rule_counts_distances_within_the_true_kth_plus_epsilon():
    true = np.array([[0.1, 0.2, 0.3], [0.0, 0.5, 0.9]], np.float32)
    run = np.array([[0.1, 0.3009, 0.302], [0.0, 0.5, 2.0]], np.float32)
    assert knn.recall_matches(true, run, 3).tolist() == [2, 2]
    assert knn.recall_matches(true, run, 2).tolist() == [1, 2]


def test_recall_uses_recomputed_distances_not_the_returned_ones():
    """A stand-in that returns the true distances beside wrong ids reads a
    recall near zero once the reference recomputes the distances."""
    x, q = _data(n=2000)
    k = 10
    true_d, _ = knn.exact_knn(torch.from_numpy(x), torch.from_numpy(q), k)
    far = torch.from_numpy(_numpy_knn(-x, q, k)[1])  # the k farthest rows
    rec = knn.distances_of(torch.from_numpy(x), torch.from_numpy(q), far).numpy()
    assert knn.recall_matches(true_d.numpy(), true_d.numpy(), k).mean() == k
    assert knn.recall_matches(true_d.numpy(), rec, k).mean() == 0

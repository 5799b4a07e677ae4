"""Recall computation against ann-benchmarks ground truth.

TPU-native equivalent of the reference recall utilities
(reference: src/utils/mod.rs:59-95): per-query recall = number of returned
distances <= (ground-truth k-th distance + 1e-3), averaged over queries.
Implemented vectorized over the whole query batch instead of the reference's
per-query loop.
"""

from __future__ import annotations

import numpy as np

EPSILON = 1e-3  # reference: src/utils/mod.rs:76 threshold(.., 1e-3)


def recall_values(
    ground_truth_distances: np.ndarray,
    run_distances: np.ndarray,
    count: int,
    epsilon: float = EPSILON,
):
    """(mean_recall, std_recall, per_query_match_counts).

    Mirrors get_recall_values (src/utils/mod.rs:66-95):
    - threshold_i = sorted(gt_i)[count-1] + epsilon
    - recall_i = #{ first `count` returned distances <= threshold_i }
    - mean = sum(recall_i) / (nq * count)
    - std  = std(recall_i) / count   (population std, as the reference)
    """
    gt = np.asarray(ground_truth_distances, dtype=np.float32)
    run = np.asarray(run_distances, dtype=np.float32)
    if gt.shape[1] < count:
        raise ValueError(
            f"ground truth has {gt.shape[1]} neighbors, need >= {count}"
        )
    thresholds = np.sort(gt, axis=1)[:, count - 1] + epsilon  # (nq,)
    matches = (run[:, :count] <= thresholds[:, None]).sum(axis=1).astype(np.float32)
    mean_recall = float(matches.sum() / (matches.shape[0] * count))
    std_recall = float(matches.std() / count)
    return mean_recall, std_recall, matches


def recall_by_ids(ground_truth_ids: np.ndarray, run_ids: np.ndarray, count: int) -> float:
    """Strict id-level recall@count (not in the reference; stronger check)."""
    gt = np.asarray(ground_truth_ids)[:, :count]
    run = np.asarray(run_ids)[:, :count]
    hits = 0
    for i in range(gt.shape[0]):
        hits += len(set(gt[i].tolist()) & set(run[i].tolist()))
    return hits / (gt.shape[0] * count)

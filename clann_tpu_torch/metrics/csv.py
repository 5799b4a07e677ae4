"""CSV metrics sink (copy of ``clann_tpu.metrics.csv``).

Equivalent of the reference's CSV writer (reference:
src/utils/metrics/csv.rs — an orphan module there, never wired into the
module tree; here it is a functional alternative to the SQLite sink for
quick spreadsheet-style analysis).
"""

from __future__ import annotations

import csv
import os

from clann_tpu_torch.metrics.run import RunMetrics, git_commit_hash


def save_build_metrics_csv(metrics: RunMetrics, path: str) -> None:
    """Append one build-metrics row (same columns as build_metrics)."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(
                [
                    "num_clusters", "num_tables", "dataset",
                    "git_commit_hash", "dataset_len", "memory_used_bytes",
                    "build_time_s",
                ]
            )
        w.writerow(
            [
                metrics.build.num_clusters,
                metrics.config.num_tables,
                metrics.config.dataset_name or "unknown",
                git_commit_hash(),
                metrics.dataset_len,
                metrics.build.memory_used_bytes,
                metrics.build.build_time_s,
            ]
        )


def save_search_metrics_csv(metrics: RunMetrics, path: str) -> None:
    """Append one search-metrics row (same columns as search_metrics)."""
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(
                [
                    "num_clusters", "num_tables", "k", "delta", "dataset",
                    "git_commit_hash", "search_time_ms",
                    "queries_per_second", "recall_mean", "recall_std",
                ]
            )
        w.writerow(
            [
                metrics.build.num_clusters,
                metrics.config.num_tables,
                metrics.config.k,
                metrics.config.delta,
                metrics.config.dataset_name or "unknown",
                git_commit_hash(),
                int(metrics.total_search_time_s * 1000),
                metrics.queries_per_second,
                metrics.recall_mean,
                metrics.recall_std,
            ]
        )

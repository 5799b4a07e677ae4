"""Run metrics accumulation and SQLite persistence (port of
``clann_tpu.metrics.run``; it imports no framework).

The reference metrics stack:
- QueryMetrics / RunMetrics accumulation (reference: src/utils/metrics/
  mod.rs:14-34,116-150,247-263)
- transactional SQLite writers per granularity (reference:
  src/utils/metrics/sqlite.rs:10-287), same tables (metrics/schema.py)
- git-hash stamping (reference: sqlite.rs:40 via compile-time env;
  here resolved at runtime, default 'NO_COMMIT')
- UNIQUE-violation tolerated as "already recorded" (sqlite.rs:50-61)

The reference accumulates per-query state imperatively during its serial
query loop; here the whole batch's counters arrive at once as SearchStats
arrays, so RunMetrics ingests vectors. The one change from JAX: index
fields are device tensors, which `_host` brings to numpy (`.cpu()`) where
JAX calls np.asarray.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import sqlite3
import subprocess
from typing import Optional

import numpy as np

from clann_tpu_torch.config import Config, MetricsGranularity
from clann_tpu_torch.errors import MetricsError, ResultDBError
from clann_tpu_torch.metrics.recall import recall_values
from clann_tpu_torch.metrics.schema import create_schema

log = logging.getLogger("clann_tpu_torch")


def _host(a) -> np.ndarray:
    """A numpy array from a numpy array, a scalar or a tensor on any device."""
    if hasattr(a, "cpu"):
        a = a.cpu()
    return np.asarray(a)


@functools.lru_cache(maxsize=1)
def git_commit_hash() -> str:
    """Current commit hash (reference: build.rs:4-16 embeds it at compile)."""
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                capture_output=True,
                text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                timeout=5,
            ).stdout.strip()
            or "NO_COMMIT"
        )
    except Exception:
        return "NO_COMMIT"


def db_exists(path: str) -> bool:
    """reference: src/utils/mod.rs:98-100."""
    return os.path.exists(path)


@dataclasses.dataclass
class BuildMetrics:
    """Per-build stats (reference: sqlite.rs build_metrics writer)."""

    dataset_len: int = 0
    num_clusters: int = 0
    build_time_s: float = 0.0
    memory_used_bytes: int = 0
    # per-cluster rows (reference: build_metrics_cluster)
    cluster_center_idx: Optional[np.ndarray] = None
    cluster_brute: Optional[np.ndarray] = None
    cluster_radius: Optional[np.ndarray] = None
    cluster_num_points: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunMetrics:
    """Accumulates build + search metrics for one run
    (reference: utils/metrics/mod.rs:22-34)."""

    config: Config
    dataset_len: int
    build: BuildMetrics = dataclasses.field(default_factory=BuildMetrics)
    # per-query arrays (set by ingest_search)
    query_time_ms: Optional[np.ndarray] = None
    distance_computations: Optional[np.ndarray] = None
    candidates: Optional[np.ndarray] = None
    clusters_visited: Optional[np.ndarray] = None
    probed_clusters: Optional[np.ndarray] = None  # (Q, P) cluster per probe
    probed_counts: Optional[np.ndarray] = None  # (Q, P) candidates per probe
    total_search_time_s: float = 0.0
    recall_mean: float = 0.0
    recall_std: float = 0.0
    # how query_time_ms rows were produced (see schema.clann_timing_mode):
    # stays "single-query" only while every ingested batch holds ONE query
    timing_mode: Optional[str] = None

    def log_index_building_time(self, seconds: float) -> None:
        """reference: index.rs:284-286."""
        self.build.build_time_s = seconds

    def ingest_build(self, index) -> None:
        self.build.dataset_len = index.n
        self.build.num_clusters = index.n_clusters
        self.build.memory_used_bytes = index.memory_usage()
        self.build.cluster_center_idx = _host(index.center_ids)
        self.build.cluster_brute = _host(index.brute)
        self.build.cluster_radius = _host(index.radii)
        self.build.cluster_num_points = np.diff(_host(index.cluster_starts))

    def ingest_search(self, stats, total_time_s: float) -> None:
        """Ingest a SearchStats batch (the batched analog of the reference's
        per-query new_query/log_* accumulation, mod.rs:36-114).

        ACCUMULATES across calls like the reference run loop — a run made
        of several search_batch calls records every query, not just the
        last batch. reset_search() starts a fresh run.
        """
        dc = _host(stats.distance_computations)
        cand = _host(stats.candidates)
        cv = _host(stats.clusters_visited)
        # scalar fields (e.g. DenseSearchStats.dropped_probes) broadcast
        nq = len(dc)
        cand = np.broadcast_to(np.atleast_1d(cand), (nq,))
        cv = np.broadcast_to(np.atleast_1d(cv), (nq,))
        qt = np.full(nq, 1000.0 * total_time_s / max(nq, 1))

        def cat(prev, new):
            return new if prev is None else np.concatenate([prev, new])

        self.distance_computations = cat(self.distance_computations, dc)
        self.candidates = cat(self.candidates, cand)
        self.clusters_visited = cat(self.clusters_visited, cv)
        # batch execution has no per-query wall time; attribute evenly
        # and label the run accordingly (schema.clann_timing_mode)
        self.query_time_ms = cat(self.query_time_ms, qt)
        mode = "single-query" if nq <= 1 else "batched-amortized"
        if self.timing_mode is None:
            self.timing_mode = mode
        elif self.timing_mode != mode:
            self.timing_mode = "batched-amortized"
        self.total_search_time_s += total_time_s
        # per-probe detail only concatenates across same-shape batches
        # (same engine, same probe count); otherwise keep the last batch
        pc = getattr(stats, "probed_clusters", None)
        pn = getattr(stats, "probed_counts", None)
        pc = None if pc is None else _host(pc)
        pn = None if pn is None else _host(pn)
        if (
            pc is not None
            and self.probed_clusters is not None
            and self.probed_clusters.shape[1:] == pc.shape[1:]
        ):
            self.probed_clusters = np.concatenate([self.probed_clusters, pc])
            self.probed_counts = np.concatenate([self.probed_counts, pn])
        else:
            self.probed_clusters = pc
            self.probed_counts = pn

    def reset_search(self) -> None:
        """Drop accumulated search state (start a new measured run)."""
        self.query_time_ms = None
        self.distance_computations = None
        self.candidates = None
        self.clusters_visited = None
        self.probed_clusters = None
        self.probed_counts = None
        self.total_search_time_s = 0.0
        self.recall_mean = 0.0
        self.recall_std = 0.0
        self.timing_mode = None

    def compute_run_statistics(self, ground_truth_distances, run_distances) -> None:
        """Recall + QPS (reference: mod.rs:247-263)."""
        count = self.config.k
        self.recall_mean, self.recall_std, _ = recall_values(
            ground_truth_distances, run_distances, count
        )

    @property
    def queries_per_second(self) -> float:
        nq = 0 if self.query_time_ms is None else len(self.query_time_ms)
        if self.total_search_time_s <= 0:
            return 0.0
        return nq / self.total_search_time_s

    # ------------------------------------------------------------------
    # SQLite persistence (reference: mod.rs:116-150 save_metrics)
    # ------------------------------------------------------------------

    def save_metrics(
        self,
        db_path: str,
        granularity: MetricsGranularity = MetricsGranularity.RUN,
        create: bool = True,
    ) -> None:
        if not isinstance(granularity, MetricsGranularity):
            # an ndarray here (e.g. ground truth passed positionally)
            # otherwise dies later with an opaque "truth value of an
            # array is ambiguous"
            raise TypeError(
                "granularity must be a MetricsGranularity (got "
                f"{type(granularity).__name__}); pass ground-truth arrays "
                "by keyword: save_metrics(db, ground_truth_distances=...)"
            )
        if not create and not db_exists(db_path):
            raise ResultDBError(f"metrics database {db_path} does not exist")
        conn = sqlite3.connect(db_path)
        try:
            create_schema(conn)
            cur = conn.cursor()
            cur.execute("BEGIN TRANSACTION")
            self._save_build(cur)
            self._save_search(cur)
            if granularity in (MetricsGranularity.QUERY, MetricsGranularity.CLUSTER):
                self._save_queries(cur)
            if granularity == MetricsGranularity.CLUSTER:
                self._save_clusters(cur)
            conn.commit()
        except sqlite3.IntegrityError as e:
            # UNIQUE violation == config already recorded (sqlite.rs:50-61)
            conn.rollback()
            log.info("metrics already recorded for this config: %s", e)
        except sqlite3.Error as e:
            conn.rollback()
            raise MetricsError(str(e)) from e
        finally:
            conn.close()

    def _key(self):
        c = self.config
        return (
            self.build.num_clusters or 1,
            c.num_tables,
            c.dataset_name or "unknown",
            git_commit_hash(),
        )

    def _save_build(self, cur) -> None:
        nc, L, ds, gh = self._key()
        cur.execute(
            """INSERT INTO build_metrics
               (num_clusters, num_tables, dataset, git_commit_hash, dataset_len,
                total_num_clusters, greedy_num_clusters, memory_used_bytes,
                build_time_s)
               VALUES (?,?,?,?,?,?,?,?,?)""",
            (
                nc,
                L,
                ds,
                gh,
                self.dataset_len,
                nc,
                int(np.sum(~self.build.cluster_brute))
                if self.build.cluster_brute is not None
                else nc,
                self.build.memory_used_bytes,
                int(self.build.build_time_s),
            ),
        )
        if self.build.cluster_center_idx is not None:
            rows = [
                (
                    nc,
                    L,
                    ds,
                    gh,
                    int(i),
                    int(self.build.cluster_center_idx[i]),
                    int(not self.build.cluster_brute[i]),
                    float(self.build.cluster_radius[i]),
                    int(self.build.cluster_num_points[i]),
                    0,
                )
                for i in range(len(self.build.cluster_center_idx))
            ]
            cur.executemany(
                """INSERT INTO build_metrics_cluster
                   (num_clusters, num_tables, dataset, git_commit_hash,
                    cluster_idx, center_idx, greedy_flag, radius, num_points,
                    memory_used_bytes)
                   VALUES (?,?,?,?,?,?,?,?,?,?)""",
                rows,
            )

    def _save_search(self, cur) -> None:
        nc, L, ds, gh = self._key()
        c = self.config
        cur.execute(
            """INSERT INTO search_metrics
               (num_clusters, num_tables, k, delta, dataset, git_commit_hash,
                search_time_ms, queries_per_second, recall_mean, recall_std)
               VALUES (?,?,?,?,?,?,?,?,?,?)""",
            (
                nc,
                L,
                c.k,
                c.delta,
                ds,
                gh,
                int(self.total_search_time_s * 1000),
                self.queries_per_second,
                float(np.clip(self.recall_mean, 0, 1)),
                float(max(self.recall_std, 0)),
            ),
        )
        cur.execute(
            """INSERT OR REPLACE INTO clann_timing_mode
               (num_clusters, num_tables, k, delta, dataset,
                git_commit_hash, timing_mode)
               VALUES (?,?,?,?,?,?,?)""",
            (nc, L, c.k, c.delta, ds, gh,
             self.timing_mode or "batched-amortized"),
        )

    def _save_queries(self, cur) -> None:
        nc, L, ds, gh = self._key()
        c = self.config
        if self.distance_computations is None:
            return
        rows = [
            (
                nc,
                L,
                c.k,
                c.delta,
                ds,
                gh,
                int(qi),
                int(self.query_time_ms[qi]),
                int(self.distance_computations[qi]),
            )
            for qi in range(len(self.distance_computations))
        ]
        cur.executemany(
            """INSERT INTO search_metrics_query
               (num_clusters, num_tables, k, delta, dataset, git_commit_hash,
                query_idx, query_time_ms, distance_computations)
               VALUES (?,?,?,?,?,?,?,?,?)""",
            rows,
        )

    def _save_clusters(self, cur) -> None:
        """Per-(query, cluster) rows (reference: sqlite.rs search_metrics_
        cluster writer). Available for the dense probing path, whose stats
        carry per-probe cluster ids and candidate counts; probes of the
        same cluster (row-chunked segments) are merged."""
        if self.probed_clusters is None or self.probed_counts is None:
            return
        nc, L, ds, gh = self._key()
        c = self.config
        rows = []
        for qi in range(self.probed_clusters.shape[0]):
            agg = {}
            for cl, cnt in zip(self.probed_clusters[qi], self.probed_counts[qi]):
                cl = int(cl)
                if cl >= 0:
                    agg[cl] = agg.get(cl, 0) + int(cnt)
            for cl, cnt in agg.items():
                rows.append(
                    (nc, L, c.k, c.delta, ds, gh, int(qi), cl, cnt, 0, cnt)
                )
        cur.executemany(
            """INSERT INTO search_metrics_cluster
               (num_clusters, num_tables, k, delta, dataset, git_commit_hash,
                query_idx, cluster_idx, n_candidates, cluster_time_ms,
                cluster_distance_computations)
               VALUES (?,?,?,?,?,?,?,?,?,?,?)""",
            rows,
        )


def save_puffinn_baseline(
    db_path: str,
    config: Config,
    dataset_len: int,
    memory_used_bytes: int,
    total_time_s: float,
    recall_mean: float,
    recall_std: float,
    distance_computations: Optional[np.ndarray] = None,
) -> None:
    """Record a flat single-index run into puffinn_results{,_query}
    (reference: benches/distance_benches.rs:93-203)."""
    conn = sqlite3.connect(db_path)
    try:
        create_schema(conn)
        cur = conn.cursor()
        nq = 0 if distance_computations is None else len(distance_computations)
        qps = nq / total_time_s if total_time_s > 0 else 0.0
        cur.execute("BEGIN TRANSACTION")
        cur.execute(
            """INSERT INTO puffinn_results
               (num_tables, k, delta, dataset, dataset_len, memory_used_bytes,
                total_time_ms, queries_per_second, recall_mean, recall_std)
               VALUES (?,?,?,?,?,?,?,?,?,?)""",
            (
                config.num_tables,
                config.k,
                config.delta,
                config.dataset_name or "unknown",
                dataset_len,
                memory_used_bytes,
                int(total_time_s * 1000),
                qps,
                float(np.clip(recall_mean, 0, 1)),
                float(max(recall_std, 0)),
            ),
        )
        if distance_computations is not None:
            per_q = 1000.0 * total_time_s / max(nq, 1)
            cur.executemany(
                """INSERT INTO puffinn_results_query
                   (num_tables, k, delta, dataset, query_idx, query_time_ms,
                    distance_computations)
                   VALUES (?,?,?,?,?,?,?)""",
                [
                    (
                        config.num_tables,
                        config.k,
                        config.delta,
                        config.dataset_name or "unknown",
                        int(i),
                        int(per_q),
                        int(distance_computations[i]),
                    )
                    for i in range(nq)
                ],
            )
        conn.commit()
    except sqlite3.IntegrityError:
        conn.rollback()
    finally:
        conn.close()

"""Benchmark harness: clustered-vs-flat comparison sweeps (PyTorch port of
``clann_tpu.bench.harness``).

The reference's benchmark drivers:
- the distance-computation comparison (benches/distance_benches.rs:205-280):
  for each config, the clustered index AND a flat single-index ("puffinn")
  baseline over the whole query set, recording distance computations and
  recall into the shared SQLite schema (metrics/schema.py); configs already
  in the DB are skipped (benches/utils/db_utils.rs:14-102);
- the wall-clock comparison (benches/time_benches.rs:57-89): repeated timed
  runs of clustered vs flat on sampled queries;
- configs in the format of benches/configs.json (a JSON list of reference
  Config objects).

Indexes are cached in the native h5 format (io/h5.py) under the
__index_cache__/ load-or-build logic of the reference drivers
(distance_benches.rs:36-52). Every search returns host numpy, so each clock
is read after the results reached the host. `device` places the indexes:
the card unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sqlite3
import time
from typing import List, Optional

import numpy as np
import torch

from clann_tpu_torch.config import Config, MetricsGranularity, MetricsOutput
from clann_tpu_torch.data.hdf5 import AnnDataset
from clann_tpu_torch.metrics.recall import recall_values
from clann_tpu_torch.metrics.run import git_commit_hash, save_puffinn_baseline
from clann_tpu_torch.metrics.schema import create_schema

log = logging.getLogger("clann_tpu_torch.bench")


def load_configs(path: str) -> List[Config]:
    """Parse a benches/configs.json-shaped file
    (reference: benches/utils/mod.rs:8-14)."""
    with open(path) as f:
        raw = json.load(f)
    return [Config.from_dict(d) for d in raw]


def default_sweep_configs(dataset_name: str) -> List[Config]:
    """The reference sweep matrix: L=50, k=10, delta=0.9,
    factor in {0.05 .. 0.70 step 0.05} (reference: benches/configs.json)."""
    return [
        Config(
            num_tables=50,
            num_clusters_factor=round(0.05 * i, 2),
            k=10,
            delta=0.9,
            dataset_name=dataset_name,
        )
        for i in range(1, 15)
    ]


def config_already_recorded(db_path: str, cfg: Config, n_clusters: int) -> bool:
    """Skip configs already in the DB
    (reference: benches/utils/db_utils.rs:14-60)."""
    if not os.path.exists(db_path):
        return False
    conn = sqlite3.connect(db_path)
    try:
        create_schema(conn)
        row = conn.execute(
            "SELECT 1 FROM search_metrics WHERE num_clusters=? AND "
            "num_tables=? AND k=? AND delta=? AND dataset=? AND "
            "git_commit_hash=?",
            (
                n_clusters,
                cfg.num_tables,
                cfg.k,
                cfg.delta,
                cfg.dataset_name or "unknown",
                git_commit_hash(),
            ),
        ).fetchone()
        return row is not None
    finally:
        conn.close()


def _wait(index) -> None:
    """Wait for the build's queued device work, so its clock covers it."""
    if index.device.type == "cuda":
        torch.cuda.synchronize(index.device)


@dataclasses.dataclass
class BenchResult:
    config: Config
    recall: float
    qps: float
    distance_computations: float
    build_seconds: float
    mode: str


def run_benchmark_config_clann(
    cfg: Config,
    ds: AnnDataset,
    db_path: Optional[str] = None,
    cache_dir: str = "__index_cache__",
    mode: str = "lsh",
    device="cuda",
) -> BenchResult:
    """Clustered run for one config
    (reference: distance_benches.rs:29-91 run_benchmark_config_clann).
    The index is loaded from `cache_dir` or built and cached there (h5py)."""
    import clann_tpu_torch
    from clann_tpu_torch.io.h5 import index_file_name

    cfg = cfg.replace(
        metrics_output=MetricsOutput.DB if db_path else MetricsOutput.NONE
    )
    cache_path = os.path.join(cache_dir, index_file_name(cfg))
    build_s = 0.0
    if os.path.exists(cache_path):
        handle = clann_tpu_torch.init_from_file(ds.train, cache_path, device=device)
        handle.config = cfg
        if handle.metrics is not None:
            handle.metrics.ingest_build(handle.index)
    else:
        handle = clann_tpu_torch.init_with_config(ds.train, cfg, device=device)
        t0 = time.perf_counter()
        clann_tpu_torch.build(handle)
        _wait(handle.index)
        build_s = time.perf_counter() - t0
        os.makedirs(cache_dir, exist_ok=True)
        clann_tpu_torch.serialize(handle, cache_dir)

    t0 = time.perf_counter()
    dists, ids, stats = handle.search_batch(ds.test, mode=mode)
    elapsed = time.perf_counter() - t0
    recall = 0.0
    if ds.distances is not None:
        recall, _, _ = recall_values(ds.distances, dists, count=cfg.k)
    if db_path and handle.metrics is not None:
        handle.metrics.compute_run_statistics(ds.distances, dists)
        handle.metrics.save_metrics(db_path, MetricsGranularity.QUERY)
    return BenchResult(
        config=cfg,
        recall=recall,
        qps=len(ds.test) / elapsed,
        distance_computations=float(np.mean(stats.distance_computations)),
        build_seconds=build_s,
        mode=mode,
    )


def run_benchmark_config_puffinn(
    cfg: Config,
    ds: AnnDataset,
    db_path: Optional[str] = None,
    device="cuda",
) -> BenchResult:
    """Flat single-index baseline over the whole dataset
    (reference: distance_benches.rs:93-203 run_benchmark_config_puffinn)."""
    from clann_tpu_torch.core.index import build_lsh_index
    from clann_tpu_torch.ops.query import search

    t0 = time.perf_counter()
    index = build_lsh_index(ds.train, cfg, device=device)
    _wait(index)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dists, ids, stats = search(index, ds.test, k=cfg.k, delta=cfg.delta)
    elapsed = time.perf_counter() - t0
    recall = recall_std = 0.0
    if ds.distances is not None:
        recall, recall_std, _ = recall_values(ds.distances, dists, count=cfg.k)
    if db_path:
        save_puffinn_baseline(
            db_path,
            cfg,
            dataset_len=ds.train.shape[0],
            memory_used_bytes=index.memory_usage(),
            total_time_s=elapsed,
            recall_mean=recall,
            recall_std=recall_std,
            distance_computations=np.asarray(stats.distance_computations),
        )
    return BenchResult(
        config=cfg,
        recall=recall,
        qps=len(ds.test) / elapsed,
        distance_computations=float(np.mean(stats.distance_computations)),
        build_seconds=build_s,
        mode="flat-lsh",
    )


def compare_implementations_distance(
    configs: List[Config],
    ds: AnnDataset,
    db_path: str,
    cache_dir: str = "__index_cache__",
    device="cuda",
) -> List[BenchResult]:
    """The full sweep (reference: distance_benches.rs:205-280): for each
    config run clustered + flat, skipping configs already recorded."""
    results = []
    for cfg in configs:
        n_clusters = cfg.num_clusters(ds.train.shape[0])
        if config_already_recorded(db_path, cfg, n_clusters):
            log.info("skipping recorded config factor=%.2f", cfg.num_clusters_factor)
            continue
        log.info("running clann config factor=%.2f", cfg.num_clusters_factor)
        results.append(run_benchmark_config_clann(cfg, ds, db_path, cache_dir, device=device))
        log.info("running flat baseline L=%d", cfg.num_tables)
        results.append(run_benchmark_config_puffinn(cfg, ds, db_path, device=device))
    return results


def compare_implementations_time(
    cfg: Config,
    ds: AnnDataset,
    sample_queries: int = 10,
    repetitions: int = 15,
    device="cuda",
) -> dict:
    """Wall-clock comparison on sampled queries
    (reference: time_benches.rs:57-89: 10 random queries, sample_size 15)."""
    import clann_tpu_torch
    from clann_tpu_torch.core.index import build_lsh_index
    from clann_tpu_torch.ops.query import search

    rng = np.random.default_rng(0)
    sel = rng.choice(len(ds.test), size=min(sample_queries, len(ds.test)),
                     replace=False)
    queries = ds.test[sel]

    handle = clann_tpu_torch.init_with_config(ds.train, cfg, device=device)
    clann_tpu_torch.build(handle)
    flat = build_lsh_index(ds.train, cfg, device=device)

    def timed(fn):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(repetitions):
            fn()
        return (time.perf_counter() - t0) / repetitions

    t_clustered = timed(lambda: handle.search_batch(queries, mode="lsh"))
    t_flat = timed(lambda: search(flat, queries, k=cfg.k, delta=cfg.delta))
    return {
        "clustered_s": t_clustered,
        "base_puffinn_s": t_flat,
        "speedup": t_flat / t_clustered if t_clustered > 0 else 0.0,
    }


def minibench(
    ds: AnnDataset,
    db_path: str = ".minibench.db",
    cfg: Optional[Config] = None,
    device="cuda",
) -> dict:
    """Regression harness: index points/sec + QPS into a tiny DB
    (reference: libpuffinn/scripts/minibench.py:22-99)."""
    import clann_tpu_torch

    cfg = cfg or Config(
        num_tables=50, num_clusters_factor=0.4, k=10, delta=0.9,
        dataset_name=ds.name,
    )
    handle = clann_tpu_torch.init_with_config(ds.train, cfg, device=device)
    t0 = time.perf_counter()
    clann_tpu_torch.build(handle)
    _wait(handle.index)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dists, _, _ = handle.search_batch(ds.test)
    qps = len(ds.test) / (time.perf_counter() - t0)
    recall = 0.0
    if ds.distances is not None:
        recall, _, _ = recall_values(ds.distances, dists, count=cfg.k)

    conn = sqlite3.connect(db_path)
    try:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS minibench ("
            "commit_hash TEXT, dataset TEXT, index_points_per_sec REAL, "
            "qps REAL, recall REAL, created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP)"
        )
        row = {
            "commit_hash": git_commit_hash(),
            "dataset": ds.name,
            "index_points_per_sec": ds.train.shape[0] / build_s,
            "qps": qps,
            "recall": recall,
        }
        conn.execute(
            "INSERT INTO minibench (commit_hash, dataset, index_points_per_sec,"
            " qps, recall) VALUES (?,?,?,?,?)",
            tuple(row.values()),
        )
        conn.commit()
    finally:
        conn.close()
    return row


"""Public API facade (PyTorch port of ``clann_tpu.api``).

`init` / `init_with_config` / `init_from_file` / `build` / `search` /
`insert` / `rebuild` / `serialize` / `save_metrics`, `Clann.search_batch`,
`Clann.search_by_id`, `Clann.closest_pairs` and the metrics run (`reset_metrics`, with
`Config(metrics_output=DB)`), with an explicit `device`. The reference's
facade is src/lib.rs:41-264.

Search modes, every mode of the JAX facade (clann_tpu/api.py:134-166):
"dense" (IVF probing of the dense layout), "adaptive" (dense probing in
waves until the ball certificate retires each query), "scan" (full dense
scan), "scan-pallas" (the fused scan whose candidate stage is the CUDA
kernel K1 on a CUDA device), "scan-block" (block-probed fused scan, kernel
K3; n_probe = blocks per query), "scan-block-adaptive" (doubling probe
budget until the block certificate holds; n_probe = starting budget),
"lsh-global" (the global delta engine), "lsh-clustered" (the
reference-faithful clustered walk), "lsh" (the global engine where the
build made its tables, else the walk; both gather records with kernel K7)
and "auto" (config.search_mode's default: "dense" when the built index has
the dense layout, else "lsh"). No mode falls back to another.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.config import Config, MetricsGranularity, MetricsOutput
from clann_tpu_torch.data.metricdata import MetricData, make_metric_data
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.metrics.run import RunMetrics
from clann_tpu_torch.ops.distances import resolve_device

log = logging.getLogger("clann_tpu_torch")


class Clann:
    """Stateful handle pairing a dataset, a config, a device and a built
    index (the reference's ClusteredIndex lifecycle: construct, `build()`,
    then search)."""

    def __init__(self, data, config: Config, metric: str = "angular",
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(data, MetricData):
            self.data = data
        else:
            self.data = make_metric_data(data, metric)
        if self.data.num_points() == 0:
            raise DataError("empty dataset")  # reference: index.rs:74-76
        self.config = config
        self.index = None
        self.metrics: Optional[RunMetrics] = (
            RunMetrics(config, self.data.num_points())
            if config.metrics_output == MetricsOutput.DB
            else None
        )
        self._last_dists = None

    def build(self) -> "Clann":
        """Build the index: GMM geometry, LSH tables, sketches, prefix
        directories, the slot records or the global engine's tables
        (config.lsh_engine) and the dense IVF layout (config.dense_layout)
        (core/index.py)."""
        from clann_tpu_torch.core.index import build_index

        t0 = time.perf_counter()
        self.index = build_index(
            self.data.raw, self.config, metric=self.data.metric,
            device=self.device,
        )
        elapsed = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.log_index_building_time(elapsed)
            self.metrics.ingest_build(self.index)
        log.info("build completed in %.2fs", elapsed)
        return self

    def _require_built(self):
        if self.index is None:
            raise DataError("index not built; call build() first")
        return self.index

    def search(self, query) -> List[Tuple[float, int]]:
        """k-NN of one query: [(distance, index)] ascending, in the
        configured search mode (reference: src/lib.rs:183-189)."""
        dists, ids, _ = self.search_batch(np.asarray(query)[None, :])
        return [
            (float(d), int(i)) for d, i in zip(dists[0], ids[0]) if i >= 0
        ]

    def search_batch(
        self,
        queries,
        k: Optional[int] = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
        n_probe: Optional[int] = None,
        filter_type: str = "default",
    ):
        """Batched k-NN. Returns (distances (Q, k) ascending, ids (Q, k),
        stats) as numpy arrays.

        mode: "dense", "adaptive", "scan", "scan-pallas", "scan-block",
        "scan-block-adaptive", "lsh" / "lsh-global" / "lsh-clustered" (the
        delta engines, with `delta` and `filter_type`) or "auto" (default:
        config.search_mode; "dense" when the built index has the dense
        layout, else "lsh"). `n_probe`: segment rows per query ("dense"),
        blocks per query ("scan-block") or the starting budget
        ("scan-block-adaptive").
        """
        from clann_tpu_torch.ops.ivf import adaptive_dense_search, dense_search, scan_search

        index = self._require_built()
        mode = mode or self.config.search_mode
        if mode == "auto":
            mode = "dense" if index.seg_vectors is not None else "lsh"
        if mode == "lsh":
            mode = "lsh-global" if index.g_records is not None else "lsh-clustered"
        t0 = time.perf_counter()
        if mode == "dense":
            dists, ids, stats = dense_search(index, queries, k=k, n_probe=n_probe)
        elif mode == "scan":
            dists, ids, stats = scan_search(index, queries, k=k)
        elif mode == "scan-pallas":
            dists, ids, stats = scan_search(index, queries, k=k,
                                            use_pallas=True)
        elif mode == "scan-block":
            from clann_tpu_torch.ops.block_scan import block_scan_search

            dists, ids, stats = block_scan_search(index, queries, k=k,
                                                  n_probe=n_probe)
        elif mode == "scan-block-adaptive":
            from clann_tpu_torch.ops.block_scan import block_scan_search_adaptive

            dists, ids, stats = block_scan_search_adaptive(
                index, queries, k=k, n_probe0=n_probe)
        elif mode == "adaptive":
            dists, ids, stats = adaptive_dense_search(index, queries, k=k)
        elif mode == "lsh-global":
            from clann_tpu_torch.ops.global_query import global_search

            dists, ids, stats = global_search(index, queries, k=k, delta=delta,
                                              filter_type=filter_type)
        elif mode == "lsh-clustered":
            from clann_tpu_torch.ops.query import search as walk_search

            dists, ids, stats = walk_search(index, queries, k=k, delta=delta,
                                            filter_type=filter_type)
        else:
            raise DataError(f"unknown search mode {mode!r}")
        elapsed = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.ingest_search(stats, elapsed)
        self._last_dists = dists
        return dists, ids, stats

    def search_by_id(self, point_ids, k: Optional[int] = None,
                     exclude_self: bool = True):
        """k-NN of already-indexed points through the clustered walk
        (collection.hpp:341-356 search_from_index). Returns (distances,
        ids, stats)."""
        from clann_tpu_torch.ops.query import search_by_id

        return search_by_id(self._require_built(), point_ids, k=k,
                            exclude_self=exclude_self)

    def closest_pairs(self, k: int, delta: Optional[float] = None, mesh=None):
        """k most similar indexed pairs (collection.hpp:390-504; the
        upstream python wrapper's Index.closest_pairs) on the index's
        device. Returns numpy (pairs (k, 2) int32 with i < j, sims
        descending). Pass a mesh (parallel/mesh.py) to split the join's
        tables across its shards (parallel/join.py; the same pairs)."""
        from clann_tpu_torch.ops.join import closest_pairs
        from clann_tpu_torch.parallel.join import sharded_closest_pairs

        index = self._require_built()
        delta = self.config.delta if delta is None else delta
        if mesh is not None:
            return sharded_closest_pairs(index, k, delta=delta, mesh=mesh)
        return closest_pairs(index, k, delta=delta)

    # -- incremental updates -------------------------------------------

    def insert(self, points) -> "Clann":
        """Append points; searchable through the tables after rebuild()
        (collection.hpp:218-222; see core.index.insert). `self.data` is
        re-made from the index's vectors, as in JAX: a copy of the whole
        normalized dataset from the device to the host per call."""
        from clann_tpu_torch.core.index import insert

        self.index = insert(self._require_built(), points)
        self.data = make_metric_data(self.index.vectors.cpu().numpy(), self.index.metric)
        return self

    def rebuild(self) -> "Clann":
        """Index the pending points (collection.hpp:241-306)."""
        from clann_tpu_torch.core.index import rebuild

        t0 = time.perf_counter()
        self.index = rebuild(self._require_built())
        log.info("rebuild completed in %.2fs", time.perf_counter() - t0)
        return self

    # -- persistence ----------------------------------------------------

    def serialize(self, directory: str) -> str:
        """Write the index in the native h5 format (io/h5.py; reference:
        src/lib.rs:255-264). Returns the file written."""
        from clann_tpu_torch.io.h5 import save_index

        return save_index(self._require_built(), directory)

    @classmethod
    def from_file(cls, data, path: str, metric: str = "angular",
                  device="cuda") -> "Clann":
        """A handle on an index loaded from a native h5 file onto `device`
        (reference: src/lib.rs:41-47); `data` is the dataset it was built
        on."""
        from clann_tpu_torch.io.h5 import load_index

        index = load_index(np.asarray(data, np.float32), path, device=device)
        handle = cls(data, index.config, metric=metric, device=device)
        handle.index = index
        return handle

    # -- metrics --------------------------------------------------------

    def reset_metrics(self) -> None:
        """Start a new measured run: drop the per-query metrics that
        search_batch calls have accumulated (mod.rs:22-34)."""
        if self.metrics is not None:
            self.metrics.reset_search()

    def save_metrics(
        self,
        db_path: str,
        granularity: MetricsGranularity = MetricsGranularity.RUN,
        ground_truth_distances=None,
        run_distances=None,
        total_search_time_s: Optional[float] = None,
    ) -> None:
        """Persist run metrics to SQLite (reference: src/lib.rs:214-233)."""
        if self.metrics is None:
            raise DataError(
                "metrics collection disabled (config.metrics_output != DB)"
            )
        if ground_truth_distances is not None:
            rd = run_distances if run_distances is not None else self._last_dists
            self.metrics.compute_run_statistics(ground_truth_distances, rd)
        if total_search_time_s is not None:
            self.metrics.total_search_time_s = total_search_time_s
        self.metrics.save_metrics(db_path, granularity)


def init(data, metric: str = "angular", device="cuda") -> Clann:
    """A handle with the default Config (reference: lib.rs:76-112)."""
    return Clann(data, Config(), metric=metric, device=device)


def init_with_config(data, config: Config, metric: str = "angular",
                     device="cuda") -> Clann:
    """reference: lib.rs:118-124."""
    return Clann(data, config, metric=metric, device=device)


def init_from_file(data, file_path: str, metric: str = "angular",
                   device="cuda") -> Clann:
    """reference: lib.rs:41-47."""
    return Clann.from_file(data, file_path, metric=metric, device=device)


def build(handle: Clann) -> Clann:
    """reference: lib.rs:142-148."""
    return handle.build()


def search(handle: Clann, query) -> List[Tuple[float, int]]:
    """reference: lib.rs:183-189."""
    return handle.search(query)


def insert(handle: Clann, points) -> Clann:
    """Append points (searchable after rebuild); see Clann.insert."""
    return handle.insert(points)


def rebuild(handle: Clann) -> Clann:
    """Index pending points; see Clann.rebuild."""
    return handle.rebuild()


def serialize(handle: Clann, directory: str) -> str:
    """reference: lib.rs:255-264."""
    return handle.serialize(directory)


def save_metrics(
    handle: Clann,
    db_path: str,
    granularity: MetricsGranularity = MetricsGranularity.RUN,
    ground_truth_distances=None,
    run_distances=None,
    total_search_time_s: Optional[float] = None,
) -> None:
    """reference: lib.rs:214-233."""
    handle.save_metrics(
        db_path, granularity, ground_truth_distances, run_distances,
        total_search_time_s,
    )

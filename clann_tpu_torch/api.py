"""Public API facade (PyTorch port of ``clann_tpu.api``).

`init` / `init_with_config` / `build` / `search`, `Clann.search_batch` and
`Clann.search_by_id`, with an explicit `device`. The reference's facade is
src/lib.rs:41-264.

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

from clann_tpu_torch.config import Config, MetricsOutput
from clann_tpu_torch.data.metricdata import MetricData, make_metric_data
from clann_tpu_torch.errors import DataError
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
        if config.metrics_output == MetricsOutput.DB:
            raise NotImplementedError(
                "metrics_output=DB: the SQLite metrics sink comes with "
                "ROADMAP.md slice 14 (interop, h5 and CLI)"
            )
        self.config = config
        self.index = None

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
        log.info("build completed in %.2fs", time.perf_counter() - t0)
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
        return dists, ids, stats

    def search_by_id(self, point_ids, k: Optional[int] = None,
                     exclude_self: bool = True):
        """k-NN of already-indexed points through the clustered walk
        (collection.hpp:341-356 search_from_index). Returns (distances,
        ids, stats)."""
        from clann_tpu_torch.ops.query import search_by_id

        return search_by_id(self._require_built(), point_ids, k=k,
                            exclude_self=exclude_self)


def init(data, metric: str = "angular", device="cuda") -> Clann:
    """A handle with the default Config (reference: lib.rs:76-112)."""
    return Clann(data, Config(), metric=metric, device=device)


def init_with_config(data, config: Config, metric: str = "angular",
                     device="cuda") -> Clann:
    """reference: lib.rs:118-124."""
    return Clann(data, config, metric=metric, device=device)


def build(handle: Clann) -> Clann:
    """reference: lib.rs:142-148."""
    return handle.build()


def search(handle: Clann, query) -> List[Tuple[float, int]]:
    """reference: lib.rs:183-189."""
    return handle.search(query)

"""ann-benchmarks adapter (PyTorch port of ``clann_tpu.bench.ann_adapter``).

The reference's datasets, ground truth and recall protocol come from
ann-benchmarks (train/test/distances HDF5 layout, src/utils/mod.rs:25-57).
This module exposes the index as an ann-benchmarks algorithm: a duck-typed
``BaseANN`` class (the harness needs fit / query / batch_query /
get_batch_results and the done() hook), so a definition entry like

    clann_tpu_torch:
      constructor: ClannTPU
      module: clann_tpu_torch.bench.ann_adapter
      run_groups:
        lsh:
          args: [[angular], [50], [0.4]]
          query_args: [[0.8, 0.9, 0.95]]

runs the port under the standard harness. The ann_benchmarks package is
not imported; the class is self-contained.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from clann_tpu_torch.config import Config


class ClannTPU:
    """ann-benchmarks algorithm wrapper over the clustered index.

    Args mirror the reference demo defaults (src/main.rs:22-29): metric
    "angular" (ann-benchmarks names cosine data "angular" too), num_tables
    = L, num_clusters_factor, and the search mode (any
    api.Clann.search_batch mode; "auto" picks the dense IVF path when its
    layout exists, LSH otherwise). `device`: where the index lives, the
    card unless the caller names the CPU (as `puffinn.Index`).
    """

    def __init__(
        self,
        metric: str = "angular",
        num_tables: int = 50,
        num_clusters_factor: float = 0.4,
        mode: str = "auto",
        hash_family: str = "fht_cross_polytope",
        lsh_engine: str = "global",
        device="cuda",
    ):
        if metric not in ("angular", "cosine"):
            raise NotImplementedError(
                "clann_tpu_torch indexes the angular metric (as the reference: "
                "EuclideanData is not wired to PUFFINN)"
            )
        self._cfg_kwargs = dict(
            num_tables=num_tables,
            num_clusters_factor=num_clusters_factor,
            hash_family=hash_family,
            lsh_engine=lsh_engine,
        )
        self._mode = mode
        self._device = device
        self._delta = 0.9
        self._handle = None
        self._batch_ids: Optional[np.ndarray] = None
        self.name = (
            f"clann_tpu(L={num_tables}, factor={num_clusters_factor}, "
            f"mode={mode})"
        )

    # -- harness surface ---------------------------------------------------

    def fit(self, X: np.ndarray) -> None:
        import clann_tpu_torch

        cfg = Config(dataset_name="ann-benchmarks", **self._cfg_kwargs)
        self._handle = clann_tpu_torch.init_with_config(
            np.asarray(X, np.float32), cfg, device=self._device)
        clann_tpu_torch.build(self._handle)

    def set_query_arguments(self, delta: float = 0.9) -> None:
        """Per-run recall target (the reference's delta, lib.rs search docs)."""
        self._delta = float(delta)

    def query(self, v: np.ndarray, n: int) -> np.ndarray:
        _, ids, _ = self._handle.search_batch(
            np.asarray(v, np.float32)[None, :], k=n, delta=self._delta, mode=self._mode)
        return ids[0][ids[0] >= 0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        """One batched search for all queries (the per-query loop in
        `query` leaves the device mostly idle)."""
        _, ids, _ = self._handle.search_batch(
            np.asarray(X, np.float32), k=n, delta=self._delta, mode=self._mode)
        self._batch_ids = np.asarray(ids)

    def get_batch_results(self):
        return [row[row >= 0] for row in self._batch_ids]

    def get_memory_usage(self) -> int:
        """kB, as the harness expects (it otherwise reads the process RSS,
        which misses device memory): the index's `memory_usage()`."""
        if self._handle is None or self._handle.index is None:
            return 0
        return int(self._handle.index.memory_usage() // 1024)

    def done(self) -> None:
        self._handle = None
        self._batch_ids = None

    def __str__(self) -> str:
        return self.name

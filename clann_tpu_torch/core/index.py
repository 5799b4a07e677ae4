"""The clustered index: cluster geometry and its builder (PyTorch port).

Port of the geometry part of ``clann_tpu.core.index``: GMM clustering
(reference: src/core/index.rs:177-289) and the per-cluster bookkeeping of
``_assemble_index`` — sizes, segment starts, radii and brute-force flags for
clusters with fewer than max(brute_force_threshold, k) points
(index.rs:204-205).

Not built yet (later items of ROADMAP.md): the LSH hash tables, sketches
and prefix directories, the global tables, and the dense IVF layout. The
dense scan modes read only `vectors` (and `n_clusters` for their stats), and
the block scan `vectors` and `assignment`, so they are complete with this
index.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.errors import DataError, IndexCreationError
from clann_tpu_torch.ops.distances import as_device_f32, l2_normalize
from clann_tpu_torch.ops.gmm import greedy_minimum_maximum

log = logging.getLogger("clann_tpu_torch")

GEOMETRY_FIELDS = (
    "vectors", "cluster_starts", "centers", "center_ids", "radii", "brute",
    "assignment",
)


@dataclasses.dataclass(eq=False)
class ClusteredIndex:
    """Device-resident cluster geometry of the clustered index."""

    vectors: torch.Tensor  # (n, d) f32, L2-normalized for angular
    cluster_starts: torch.Tensor  # (C+1,) int32 segment boundaries
    centers: torch.Tensor  # (C, d) f32 center vectors (normalized)
    center_ids: torch.Tensor  # (C,) int32 center point ids
    radii: torch.Tensor  # (C,) f32 cluster radii
    brute: torch.Tensor  # (C,) bool brute-force flag (index.rs:204-205)
    assignment: torch.Tensor  # (n,) int32 cluster of each point
    config: Config = None
    metric: str = "angular"
    # ops/ivf._pallas_base's padded bf16 copy of `vectors` (derived)
    pallas_base_cache: Dict = dataclasses.field(default_factory=dict, repr=False)
    # ops/block_scan.get_block_layout's BlockLayouts, by block_n (derived)
    block_layout_cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dims(self) -> int:
        return self.vectors.shape[1]

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def memory_usage(self) -> int:
        """Index bytes: dataset + geometry (derived caches excluded)."""
        return int(sum(
            getattr(self, f).numel() * getattr(self, f).element_size()
            for f in GEOMETRY_FIELDS
        ))


def _geometry(xn: torch.Tensor, assignment: np.ndarray, centers_idx: np.ndarray,
              radii, config: Config, metric: str) -> ClusteredIndex:
    """Sizes, starts and brute flags exactly as _assemble_index computes
    them (clann_tpu/core/index.py:567-572)."""
    dev = xn.device
    n_clusters = len(centers_idx)
    sizes = np.bincount(assignment, minlength=n_clusters)
    starts = np.zeros(n_clusters + 1, dtype=np.int32)
    np.cumsum(sizes, out=starts[1:])
    brute = sizes < max(config.brute_force_threshold, config.k)
    cid = torch.as_tensor(centers_idx.astype(np.int64), device=dev)
    return ClusteredIndex(
        vectors=xn,
        cluster_starts=torch.as_tensor(starts, device=dev),
        centers=xn[cid],
        center_ids=cid.to(torch.int32),
        radii=as_device_f32(radii, dev),
        brute=torch.as_tensor(brute, device=dev),
        assignment=torch.as_tensor(assignment.astype(np.int32), device=dev),
        config=config,
        metric=metric,
    )


def build_index(
    data,
    config: Config,
    metric: str = "angular",
    n_clusters: Optional[int] = None,
    device="cuda",
) -> ClusteredIndex:
    """Build the cluster geometry on `device`.

    Normalizes once (one host->device transfer), runs GMM with
    assume_normalized, then the _assemble_index bookkeeping.
    """
    if isinstance(data, torch.Tensor):
        x = data
    else:
        x = np.asarray(data, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        raise DataError("empty or non-2D dataset")
    n, d = x.shape
    if n_clusters is None:
        n_clusters = config.num_clusters(n)
    log.info("build: n=%d d=%d clusters=%d", n, d, n_clusters)
    if metric != "angular":
        raise IndexCreationError(
            f"the clustered index supports the angular metric (got {metric!r}); "
            "euclidean data is brute-force only, as in the reference"
        )
    xn = l2_normalize(as_device_f32(x, device))

    from clann_tpu_torch.metrics.trace import TRACER

    with TRACER.span("build/gmm"):
        centers_idx, assignment, radii = greedy_minimum_maximum(
            xn, n_clusters, metric, assume_normalized=True
        )
    # one host sync for the integer bookkeeping
    return _geometry(xn, assignment.cpu().numpy(), centers_idx.cpu().numpy(),
                     radii, config, metric)


def index_from_arrays(arrays: Dict[str, np.ndarray], config: Config,
                      device="cuda", metric: str = "angular") -> ClusteredIndex:
    """A ClusteredIndex on `device` from the geometry fields as numpy arrays.

    `arrays` holds GEOMETRY_FIELDS, e.g. taken from an index built by the
    JAX package (`{f: np.asarray(getattr(jidx, f)) for f in
    GEOMETRY_FIELDS}`), so both packages can search the same index.
    """
    missing = [f for f in GEOMETRY_FIELDS if f not in arrays]
    if missing:
        raise DataError(f"index arrays missing {missing}")

    def t(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]).astype(dtype), device=device)

    return ClusteredIndex(
        vectors=t("vectors", np.float32),
        cluster_starts=t("cluster_starts", np.int32),
        centers=t("centers", np.float32),
        center_ids=t("center_ids", np.int32),
        radii=t("radii", np.float32),
        brute=t("brute", np.bool_),
        assignment=t("assignment", np.int32),
        config=config,
        metric=metric,
    )

"""Metric dataset abstraction (numpy; a copy of ``clann_tpu.data.metricdata``
without its unused jax import).

Equivalent of the reference trait layer
(reference: src/metricdata/mod.rs:4-18 — ``MetricData`` with
``distance``/``all_distances``/``num_points``/``dimensions``/``get_point``/
``distance_point`` and ``Subset::subset``).

Unlike the reference's scalar per-pair methods, the primary interface here is
*batched*: ``distances_to(points)`` returns a full (n, q) distance block
computed as one matmul. The scalar-shaped methods exist for API parity and
tests.
"""

from __future__ import annotations

import numpy as np


def _as_f32(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"expected 2D (n, d) array, got shape {a.shape}")
    return a


class MetricData:
    """Base batched dataset. Subclasses define the metric."""

    raw: np.ndarray  # (n, d) float32

    def num_points(self) -> int:
        """reference: src/metricdata/mod.rs num_points()."""
        return self.raw.shape[0]

    def dimensions(self) -> int:
        """reference: src/metricdata/mod.rs dimensions()."""
        return self.raw.shape[1]

    def get_point(self, i: int) -> np.ndarray:
        """reference: src/metricdata/mod.rs get_point()."""
        return self.raw[i]

    # --- metric interface ---

    def distance(self, i: int, j: int) -> float:
        """Pairwise distance (reference: metricdata/mod.rs distance(i,j))."""
        return float(self.distances_between(np.array([i]), np.array([j]))[0, 0])

    def distance_point(self, i: int, point: np.ndarray) -> float:
        """Distance from stored point i to an external point
        (reference: metricdata/mod.rs distance_point)."""
        q = np.asarray(point, dtype=np.float32)[None, :]
        return float(np.asarray(self.distances_to(q))[i, 0])

    def all_distances(self, j: int) -> np.ndarray:
        """Distances from point j to every stored point, shape (n,)
        (reference: metricdata/mod.rs all_distances; angulardata.rs:38-43)."""
        return np.asarray(self.distances_to(self.raw[j][None, :]))[:, 0]

    def distances_to(self, queries: np.ndarray) -> np.ndarray:
        """Batched distances, shape (n, q). The batched primitive."""
        raise NotImplementedError

    def distances_between(self, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
        return self.distances_to(self.raw[np.asarray(jj)])[np.asarray(ii), :]

    def subset(self, indices) -> "MetricData":
        """Owned row-subset (reference: metricdata/mod.rs:15-18 Subset)."""
        raise NotImplementedError


class AngularData(MetricData):
    """Cosine-distance dataset: dist = 1 - <a,b>/(|a||b|).

    Reference: src/metricdata/angulardata.rs:12-35 (precomputed norms; the
    distance is clamped to >= 0 implicitly by float math there — we clamp
    explicitly). Vectors are L2-normalized once at construction so every
    distance block is a single matmul ``1 - Xn @ Qn^T``.
    """

    metric = "angular"

    def __init__(self, data):
        self.raw = _as_f32(data)
        norms = np.linalg.norm(self.raw, axis=1)
        norms = np.where(norms == 0.0, 1.0, norms)
        self.norms = norms.astype(np.float32)
        self.normalized = self.raw / self.norms[:, None]

    def distances_to(self, queries: np.ndarray) -> np.ndarray:
        q = _as_f32(queries)
        qn = np.linalg.norm(q, axis=1)
        qn = np.where(qn == 0.0, 1.0, qn)
        q = q / qn[:, None]
        dots = self.normalized @ q.T
        return np.clip(1.0 - dots, 0.0, 2.0)

    def subset(self, indices) -> "AngularData":
        # reference: angulardata.rs:58-63 subset via ndarray::select.
        return AngularData(self.raw[np.asarray(indices)])


class EuclideanData(MetricData):
    """L2-distance dataset via the squared-norm identity.

    Reference: src/metricdata/euclideandata.rs:24-45
    (||a-b||^2 = ||a||^2 + ||b||^2 - 2<a,b>). Note the reference never wires
    Euclidean data into PUFFINN (no IndexableSimilarity impl, SURVEY §2.1);
    here it is fully usable with brute-force search and clustering.
    """

    metric = "euclidean"

    def __init__(self, data):
        self.raw = _as_f32(data)
        self.sq_norms = np.sum(self.raw * self.raw, axis=1).astype(np.float32)

    def distances_to(self, queries: np.ndarray) -> np.ndarray:
        q = _as_f32(queries)
        q_sq = np.sum(q * q, axis=1)
        dots = self.raw @ q.T
        d2 = self.sq_norms[:, None] + q_sq[None, :] - 2.0 * dots
        return np.sqrt(np.clip(d2, 0.0, None))

    def subset(self, indices) -> "EuclideanData":
        return EuclideanData(self.raw[np.asarray(indices)])


def make_metric_data(data, metric: str = "angular") -> MetricData:
    if metric in ("angular", "cosine"):
        return AngularData(data)
    if metric in ("euclidean", "l2"):
        return EuclideanData(data)
    raise ValueError(f"unknown metric {metric!r}")

"""Synthetic dataset generation with exact ground truth (PyTorch port).

The numpy generators are byte-for-byte those of ``clann_tpu.data.synthetic``
(same seed, same arrays); ground truth comes from the port's
``ops.distances.brute_force_topk`` on the device the caller names. The
reference's random-unit-vector generator is src/utils/mod.rs:101-114; the
clustered mixtures mimic the strongly clustered real embedding datasets
(glove etc.) that the clustering stage is built for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class AnnDataset:
    """An ann-benchmarks dataset triple (reference: src/utils/mod.rs:18-23)."""

    train: np.ndarray  # (n, d) float32
    test: np.ndarray  # (q, d) float32
    distances: Optional[np.ndarray]  # (q, k_gt) float32 ground-truth distances
    neighbors: Optional[np.ndarray]  # (q, k_gt) int32 ground-truth ids (extra)
    name: str = ""


def random_unit_vectors(n: int, d: int, seed: int = 0) -> np.ndarray:
    """L2-normalized Gaussian vectors (reference: src/utils/mod.rs:101-114)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(norms == 0, 1, norms)).astype(np.float32)


def clustered_unit_vectors(
    n: int,
    d: int,
    n_modes: int = 64,
    spread: float = 0.35,
    seed: int = 0,
) -> np.ndarray:
    """Mixture-of-von-Mises-Fisher-ish unit vectors.

    Each point is a random mode direction plus Gaussian noise of relative
    scale ``spread``, re-normalized; mode popularity is Zipf-like so
    cluster sizes are ragged like real data.
    """
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((n_modes, d)).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    weights = 1.0 / np.arange(1, n_modes + 1) ** 0.7
    weights /= weights.sum()
    which = rng.choice(n_modes, size=n, p=weights)
    # noise NORM ~spread regardless of dimensionality
    sigma = spread / np.sqrt(d)
    x = modes[which] + sigma * rng.standard_normal((n, d)).astype(np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(norms == 0, 1, norms)).astype(np.float32)


def hierarchical_unit_vectors(
    n: int,
    d: int,
    n_super: int = 32,
    subs_per_super: int = 32,
    super_spread: float = 0.6,
    sub_spread: float = 0.15,
    seed: int = 0,
) -> np.ndarray:
    """Two-level (super-cluster -> sub-mode) mixture of unit vectors: the
    multi-scale regime where the GMM ball bound prunes most clusters."""
    rng = np.random.default_rng(seed)
    supers = rng.standard_normal((n_super, d)).astype(np.float32)
    supers /= np.linalg.norm(supers, axis=1, keepdims=True)
    n_subs = n_super * subs_per_super
    sup_of_sub = np.repeat(np.arange(n_super), subs_per_super)
    subs = supers[sup_of_sub] + (
        super_spread / np.sqrt(d)
    ) * rng.standard_normal((n_subs, d)).astype(np.float32)
    subs /= np.linalg.norm(subs, axis=1, keepdims=True)
    weights = 1.0 / np.arange(1, n_subs + 1) ** 0.7
    weights /= weights.sum()
    which = rng.choice(n_subs, size=n, p=weights)
    x = subs[which] + (sub_spread / np.sqrt(d)) * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(norms == 0, 1, norms)).astype(np.float32)


def make_synthetic_dataset(
    n: int = 20000,
    d: int = 25,
    n_queries: int = 200,
    k_gt: int = 100,
    metric: str = "angular",
    clustered: bool = True,
    seed: int = 0,
    name: str = "",
    kind: str = "",
    device="cpu",
) -> AnnDataset:
    """Build a full ann-benchmarks-shaped dataset with exact ground truth.

    kind: "uniform", "clustered" or "hierarchical"; defaults from the
    legacy `clustered` flag when empty. `device`: where the brute-force
    ground truth runs.
    """
    from clann_tpu_torch.ops.distances import brute_force_topk

    if not kind:
        kind = "clustered" if clustered else "uniform"
    gen = {
        "uniform": random_unit_vectors,
        "clustered": clustered_unit_vectors,
        "hierarchical": hierarchical_unit_vectors,
    }[kind]
    train = gen(n, d, seed=seed)
    test = gen(n_queries, d, seed=seed + 1)

    dists, ids = brute_force_topk(train, test, k=k_gt, metric=metric,
                                  device=device)
    if not name:
        name = f"synthetic-{kind}-{n}x{d}-{metric}"
    return AnnDataset(
        train=train,
        test=test,
        distances=dists.cpu().numpy().astype(np.float32),
        neighbors=ids.cpu().numpy().astype(np.int32),
        name=name,
    )

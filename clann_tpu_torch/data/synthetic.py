"""Synthetic dataset generation with exact ground truth (PyTorch port).

The numpy generators are byte-for-byte those of ``clann_tpu.data.synthetic``
(same seed, same arrays); ground truth comes from the port's
``ops.distances.brute_force_topk`` on the card, or on the device the caller
names. The
reference's random-unit-vector generator is src/utils/mod.rs:101-114; the
clustered mixtures mimic the strongly clustered real embedding datasets
(glove etc.) that the clustering stage is built for.
"""

from __future__ import annotations

import numpy as np

from clann_tpu_torch.data.hdf5 import AnnDataset


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


def clustered_sets(
    n: int,
    universe: int,
    avg_size: int = 12,
    n_modes: int = 16,
    core_share: float = 0.75,
    pool_factor: float = 1.25,
    hub_tokens: int = 0,
    seed: int = 0,
):
    """Token sets drawn around n_modes core vocabularies.

    Each mode owns a random core vocabulary of ~pool_factor*avg_size
    tokens; a member takes ~core_share of its tokens from its mode's core
    and the rest from the whole universe. Two same-mode members then share
    E ~ (core_share^2/pool_factor)*avg_size tokens — keep pool_factor
    close to 1 for high within-mode Jaccard (tight, ball-prunable
    clusters); larger pools spread the mode out.

    hub_tokens > 0 additionally puts that many UNIVERSAL tokens (the
    first hub_tokens ids) in every set — the stop-word regime where
    MinHash collides across modes (the long-tail collisions the
    reference's clustering exists to cut, src/lib.rs:3-4): cross-mode
    pairs then have J ~ hub/(2*size) > 0 yet are never true neighbors.
    Returns a list of unique-token lists.
    """
    rng = np.random.default_rng(seed)
    hub = list(range(hub_tokens))
    pool = min(max(2, round(pool_factor * avg_size)), universe - hub_tokens)
    cores = [
        hub_tokens + rng.choice(
            universe - hub_tokens, size=pool, replace=False
        )
        for _ in range(n_modes)
    ]
    sets = []
    for i in range(n):
        core = cores[int(rng.integers(n_modes))]
        size = max(2, int(rng.poisson(avg_size)))
        n_core = min(len(core), max(1, int(round(size * core_share))))
        toks = set(rng.choice(core, size=n_core, replace=False).tolist())
        while len(toks) < size:
            toks.add(int(rng.integers(hub_tokens, universe)))
        toks.update(hub)
        sets.append(sorted(toks))
    return sets


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
    device="cuda",
) -> AnnDataset:
    """Build a full ann-benchmarks-shaped dataset with exact ground truth.

    kind: "uniform", "clustered" or "hierarchical"; defaults from the
    legacy `clustered` flag when empty. `device`: where the brute-force
    ground truth runs, the card unless the caller names the CPU (a missing
    CUDA device raises; nothing falls back).
    """
    from clann_tpu_torch.ops.distances import brute_force_topk, resolve_device

    device = resolve_device(device)

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

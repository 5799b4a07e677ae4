"""Collision-probability machinery for the delta-recall guarantee (PyTorch port).

Port of ``clann_tpu.ops.collision``:
- CrossPolytopeCollisionEstimates — Monte-Carlo tabulation of cross-polytope
  collision probabilities per (used_bits, similarity bucket)
  (reference: libpuffinn/include/puffinn/hash/crosspolytope.hpp:10-119).
  The tabulation is the JAX package's numpy code with its own seed, so the
  two packages' tables are bit-identical.
- concatenated_collision_probability — P(d bits collide) =
  p(bpf)^(d // bpf) * p(d % bpf) (reference: hash_source/hash_source.hpp:48-57).
- failure_probability for the independent hash source —
  (1 - P(depth))^tables * (1 - P(depth+1))^(max_tables - tables)
  (reference: hash_source/independent.hpp:108-119).

Tables are cached in-process and on disk under ``$CLANN_CACHE_DIR``
(default ``build/cache`` at the repository root, git-ignored). The file is
written to a temporary name and renamed, so concurrent processes never read
a partial table.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from clann_tpu_torch.ops.hashing import ceil_log2

_CACHE: Dict[Tuple, np.ndarray] = {}


def _cache_dir() -> str:
    d = os.environ.get(
        "CLANN_CACHE_DIR",
        str(Path(__file__).resolve().parent.parent.parent / "build" / "cache"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def cross_polytope_estimates(
    padded_dim: int,
    num_repetitions: int = 1000,
    eps: float = 5e-3,
    seed: int = 12345,
) -> np.ndarray:
    """Tabulate CP collision probabilities; shape (log_dim+2, n_buckets).

    Mirrors CrossPolytopeCollisionEstimates (crosspolytope.hpp:16-89): for
    each similarity bucket (alpha = 2*sim - 1 from -1 to 1), draw
    `num_repetitions` pairs x=(1,0,..), y=(alpha, sqrt(1-alpha^2),0,..) under
    a random Gaussian rotation, encode the closest axis, and count prefix
    collisions for every used_bits in [0, log_dim+1]. Buckets are indexed by
    floor(sim / eps) (crosspolytope.hpp:117-119).
    """
    log_dim = ceil_log2(padded_dim)
    key = (padded_dim, num_repetitions, eps, seed)
    if key in _CACHE:
        return _CACHE[key]
    path = os.path.join(
        _cache_dir(), f"cp_est_d{padded_dim}_r{num_repetitions}_e{eps}_s{seed}.npy"
    )
    if os.path.exists(path):
        table = np.load(path)
        _CACHE[key] = table
        return table

    n_bits = log_dim + 2
    # linspace keeps both endpoints exactly (the reference's accumulated
    # `alpha += 2*eps` can lose the sim=1.0 bucket to float error)
    n_buckets = int(round(1.0 / eps)) + 1
    alphas = np.linspace(-1.0, 1.0, n_buckets)

    if num_repetitions == 0:
        table = np.ones((n_bits, n_buckets), dtype=np.float32)
    else:
        rng = np.random.default_rng(seed)
        table = np.empty((n_bits, n_buckets), dtype=np.float32)
        # chunk over alpha buckets to bound the (chunk, reps, dim) tensors
        chunk = max(1, int(2e7 / (num_repetitions * padded_dim)))
        for start in range(0, n_buckets, chunk):
            al = alphas[start : start + chunk][:, None, None]  # (A,1,1)
            shape = (al.shape[0], num_repetitions, padded_dim)
            z1 = rng.standard_normal(shape)
            z2 = rng.standard_normal(shape)
            y = al * z1 + np.sqrt(np.clip(1.0 - al * al, 0.0, None)) * z2

            def encode(v):
                j = np.argmax(np.abs(v), axis=-1)
                sign = np.take_along_axis(v, j[..., None], axis=-1)[..., 0] < 0
                return j.astype(np.uint32) | (
                    sign.astype(np.uint32) << np.uint32(log_dim)
                )

            hx = encode(z1)
            hy = encode(y)
            for used_bits in range(n_bits):
                shift = np.uint32(log_dim + 1 - used_bits)
                coll = (hx >> shift) == (hy >> shift)
                table[used_bits, start : start + al.shape[0]] = coll.mean(axis=1)

    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, table)
    os.replace(tmp, path)
    _CACHE[key] = table
    return table


class HashSourceProbs:
    """Collision/failure probabilities for a hash source.

    Precomputes P(d bits | sim bucket) for d in [0, max_bits+1] on a dense
    similarity grid, so the query loop's termination check is gathers and
    powers.
    """

    def __init__(self, family, max_bits: int, sim_eps: float = 5e-3):
        self.family = family
        self.max_bits = max_bits
        self.sim_eps = sim_eps
        bpf = family.bits_per_function
        n_buckets = int(1.0 / sim_eps) + 1
        sims = np.arange(n_buckets, dtype=np.float32) * sim_eps
        # per-function collision probability at each (bits, sim), bits in [0, bpf]
        pf = np.zeros((bpf + 1, n_buckets), dtype=np.float32)
        for b in range(bpf + 1):
            pf[b] = np.asarray(family.collision_probability(sims, b))
        # concatenated P(d, sim) for d in [0, max_bits+1] (hash_source.hpp:48-57)
        d = np.arange(max_bits + 2)
        whole = d // bpf
        rem = d % bpf
        self.table = (pf[bpf][None, :] ** whole[:, None]) * pf[rem]  # (D+2, S)
        self.table = self.table.astype(np.float32)

    def bucket(self, sim: torch.Tensor) -> torch.Tensor:
        return torch.clamp((sim.float() / self.sim_eps).to(torch.int64), 0,
                           self.table.shape[1] - 1)

    def concatenated(self, num_bits, sim: torch.Tensor) -> torch.Tensor:
        """P(num_bits-bit hash collides at sim); both may be tensors."""
        t = torch.as_tensor(self.table, device=sim.device)
        nb = torch.clamp(torch.as_tensor(num_bits, device=sim.device).long(), 0,
                         t.shape[0] - 1)
        return t[nb, self.bucket(sim)]

    def failure_probability(self, depth, tables, max_tables, sim) -> torch.Tensor:
        """(1-P(depth))^tables * (1-P(depth+1))^(max_tables-tables)
        (reference: hash_source/independent.hpp:108-119)."""
        depth = torch.as_tensor(depth, device=sim.device)
        p_d = self.concatenated(depth, sim)
        p_d1 = self.concatenated(depth + 1, sim)
        tables = torch.as_tensor(tables, dtype=torch.float32, device=sim.device)
        max_tables = torch.as_tensor(max_tables, dtype=torch.float32, device=sim.device)
        rest = torch.clamp(max_tables - tables, min=0.0)
        return torch.pow(1.0 - p_d, tables) * torch.pow(1.0 - p_d1, rest)


def tensored_effective_table(table: np.ndarray, num_tables: int) -> np.ndarray:
    """Effective per-depth collision probabilities for a TENSORED source.

    Tensored tables are built from ~2*sqrt(L) half-hashes and are strongly
    correlated; the reference's per-depth failure core
    F_d = 1 - A_d * B_d, A_d = 1-(1-P(ceil(d/2)))^m, B_d = 1-(1-P(floor(d/2)))^m,
    m = floor(sqrt(L)) (hash_source/tensor.hpp:127-163) is folded into an
    effective per-table probability p_eff(d) = 1 - F_d^(1/L), so every
    consumer's (1-p_d)^t (1-p_{d+1})^(L-t) check computes
    F_d^(t/L) F_{d+1}^(1-t/L) — conservative between depth boundaries.
    """
    num_tables = max(1, int(num_tables))
    m = max(1, int(np.floor(np.sqrt(num_tables))))
    d = np.arange(table.shape[0])
    left = table[(d + 1) // 2]  # (D+2, B)
    right = table[d // 2]
    a = 1.0 - (1.0 - left) ** m
    b = 1.0 - (1.0 - right) ** m
    f = np.clip(1.0 - a * b, 1e-30, 1.0)
    return (1.0 - f ** (1.0 / num_tables)).astype(np.float32)

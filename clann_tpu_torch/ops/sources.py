"""Hash sources: combine family functions into L table hashes (PyTorch port).

Port of ``clann_tpu.ops.sources``:
- Independent (reference: hash_source/independent.hpp:19-119): L tables x
  `functions_per_hasher` iid functions, bits concatenated then cut to
  `num_bits`. The default source (collection.hpp:130-131).
- Pooled (reference: hash_source/pool.hpp:24-183): a shared pool of
  functions; each table samples indices into the pool.
- Tensored (reference: hash_source/tensor.hpp:19-163): two half-length hash
  sets of size ~sqrt(T) combined pairwise by bit interleaving.

All sources expose ``hash(x: (n, d)) -> (n, L) int32`` and ``probs``;
`hash_per_cluster` hashes with per-cluster functions (a faithful reference
import's, leading C axis) into (n, C, L) through their `hash_clusters`. The
JAX package computes in uint32, whose shifts wrap at 32 bits; torch has no
uint32 shifts, so the bit arithmetic runs in int64 masked to 32 bits after
every left shift, which keeps the wrap (with bpf * fph > 32 the top bits
are lost before the final cut, exactly as in uint32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clann_tpu_torch.ops.collision import HashSourceProbs
from clann_tpu_torch.ops.hashing import family_hash_clusters

_U32 = 0xFFFFFFFF


def _check_bits(num_bits: int) -> None:
    # the port carries hashes as int32: 31 bits at most (the JAX package's
    # max_hashbits default is 24)
    if not 0 < num_bits <= 31:
        raise ValueError(f"num_bits={num_bits} must be in [1, 31]")


def _combine_bits(h: torch.Tensor, fph: int, bpf: int, bits_to_cut: int) -> torch.Tensor:
    """Concatenate fph per-function hashes (bpf bits each) along the last axis.

    h: (..., fph) int -> (...) int32, the accumulate-shift loop of
    independent.hpp:73-85 (res = (res << bpf) | h_i; res >>= cut) in uint32
    arithmetic.
    """
    res = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    for i in range(fph):
        res = ((res << bpf) & _U32) | h[..., i].to(torch.int64)
    return (res >> bits_to_cut).to(torch.int32)


@dataclasses.dataclass
class IndependentHashSource:
    """iid functions per table (reference: hash_source/independent.hpp)."""

    family: object
    num_hashers: int
    num_bits: int

    def __post_init__(self):
        _check_bits(self.num_bits)
        bpf = self.family.bits_per_function
        self.functions_per_hasher = (self.num_bits + bpf - 1) // bpf
        self.bits_to_cut = bpf * self.functions_per_hasher - self.num_bits
        self.params = None
        self.probs = HashSourceProbs(self.family, self.num_bits)

    def init(self, gen: torch.Generator, device="cpu") -> "IndependentHashSource":
        self.params = self.family.sample(
            gen, self.num_hashers * self.functions_per_hasher, device
        )
        return self

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        """(n, L) int32 concatenated hashes (independent.hpp:70-87)."""
        return self.hash_with(self.params, x)

    def hash_with(self, params, x: torch.Tensor) -> torch.Tensor:
        return self._combine(self.family.hash(params, x))

    def hash_clusters(self, pc_params, x: torch.Tensor) -> torch.Tensor:
        """(n, Cc, L): hash_with under each of Cc clusters' parameters."""
        return self._combine(family_hash_clusters(self.family, pc_params, x))

    def _combine(self, h: torch.Tensor) -> torch.Tensor:
        """(..., L * fph) function hashes -> (..., L) table hashes."""
        h = h.reshape(*h.shape[:-1], self.num_hashers, self.functions_per_hasher)
        return _combine_bits(
            h, self.functions_per_hasher, self.family.bits_per_function, self.bits_to_cut
        )


@dataclasses.dataclass
class PooledHashSource:
    """Pool of functions shared between tables (reference: hash_source/pool.hpp).

    Each table's hash is assembled from `functions_per_hasher` randomly
    chosen pool members (pool.hpp:134-157); the failure probability is
    approximated as if independent (pool.hpp:170-183). The pool indices
    live inside `params`, as in the JAX package, so every restore path
    carries them.
    """

    family: object
    num_hashers: int
    num_bits: int
    pool_size: int = 0  # 0 -> default 3 * sqrt(L * fph) heuristic

    def __post_init__(self):
        _check_bits(self.num_bits)
        bpf = self.family.bits_per_function
        self.functions_per_hasher = (self.num_bits + bpf - 1) // bpf
        self.bits_to_cut = bpf * self.functions_per_hasher - self.num_bits
        if self.pool_size == 0:
            need = self.num_hashers * self.functions_per_hasher
            self.pool_size = max(self.functions_per_hasher, int(3 * np.sqrt(need)) + 1)
        self.params = None
        self.probs = HashSourceProbs(self.family, self.num_bits)

    def init(self, gen: torch.Generator, device="cpu") -> "PooledHashSource":
        self.params = dict(self.family.sample(gen, self.pool_size, device))
        self.params["pool_indices"] = torch.randint(
            0, self.pool_size, (self.num_hashers, self.functions_per_hasher),
            generator=gen, dtype=torch.int32,
        ).to(device)
        return self

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        return self.hash_with(self.params, x)

    def hash_with(self, params, x: torch.Tensor) -> torch.Tensor:
        """hash() with explicit parameters (must include "pool_indices")."""
        pool = self.family.hash(params, x)  # (n, pool_size)
        h = pool[:, params["pool_indices"].long()]  # (n, L, fph)
        return _combine_bits(
            h, self.functions_per_hasher, self.family.bits_per_function, self.bits_to_cut
        )

    def hash_clusters(self, pc_params, x: torch.Tensor) -> torch.Tensor:
        """(n, Cc, L): hash_with under each of Cc clusters' parameters."""
        idx = pc_params["pool_indices"].long()  # (Cc, L, fph)
        fam = {k: v for k, v in pc_params.items() if k != "pool_indices"}
        pool = family_hash_clusters(self.family, fam, x)  # (n, Cc, pool_size)
        c = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        return _combine_bits(
            pool[:, c, idx], self.functions_per_hasher, self.family.bits_per_function,
            self.bits_to_cut,
        )


def _intersperse_zero(v: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Spread the low `num_bits` of v so bit i lands at position 2i
    (reference: hash_source/tensor.hpp:6-17); int64 in, int64 out."""
    res = torch.zeros_like(v)
    for i in range(num_bits):
        res = res | (((v >> i) & 1) << (2 * i))
    return res & _U32


def minimal_index_pairs(num_hashers: int) -> np.ndarray:
    """The reference's pair enumeration (tensor.hpp:20-33): (0,0) (0,1)
    (1,0) (1,1) (0,2) (2,0) ... Returns (T, 2) int32 (left, right)."""
    pairs = []
    for idx in range(num_hashers):
        s = int(np.sqrt(idx))
        if idx == s * s + 2 * s:
            pairs.append((s, s))
        elif idx >= s * s + s:
            pairs.append((s, idx - (s * s + s)))
        else:
            pairs.append((idx - s * s, s))
    return np.asarray(pairs, dtype=np.int32)


@dataclasses.dataclass
class TensoredHashSource:
    """sqrt-trick source (reference: hash_source/tensor.hpp:19-118).

    Builds 2*ceil(sqrt(T)) half-length hashes; table rep combines left half
    i and right half j (tensor.hpp:20-33) by bit interleaving: for even
    num_bits the LEFT halves shift up one (tensor.hpp:100-104), for odd the
    RIGHT halves shift down one (:105-109); the table hash is left | right.
    """

    family: object
    num_hashers: int
    num_bits: int

    def __post_init__(self):
        _check_bits(self.num_bits)
        self.num_halves = 2 * int(np.ceil(np.sqrt(self.num_hashers)))
        self.half_bits = (self.num_bits + 1) // 2
        bpf = self.family.bits_per_function
        self.fph = (self.half_bits + bpf - 1) // bpf
        self.bits_to_cut = bpf * self.fph - self.half_bits
        self.pair_idx = minimal_index_pairs(self.num_hashers)
        self.params = None
        self.probs = HashSourceProbs(self.family, self.num_bits)

    def init(self, gen: torch.Generator, device="cpu") -> "TensoredHashSource":
        self.params = self.family.sample(gen, self.num_halves * self.fph, device)
        return self

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        return self.hash_with(self.params, x)

    def hash_with(self, params, x: torch.Tensor) -> torch.Tensor:
        return self._combine(self.family.hash(params, x))

    def hash_clusters(self, pc_params, x: torch.Tensor) -> torch.Tensor:
        """(n, Cc, T): hash_with under each of Cc clusters' parameters."""
        return self._combine(family_hash_clusters(self.family, pc_params, x))

    def _combine(self, h: torch.Tensor) -> torch.Tensor:
        """(..., halves * fph) function hashes -> (..., T) table hashes."""
        h = h.reshape(*h.shape[:-1], self.num_halves, self.fph)
        halves = _combine_bits(
            h, self.fph, self.family.bits_per_function, self.bits_to_cut
        ).to(torch.int64)  # (..., halves), half_bits bits each
        inter = _intersperse_zero(halves, self.half_bits)
        right_start = self.num_halves // 2
        if self.num_bits % 2 == 0:
            left = (inter[..., :right_start] << 1) & _U32
            right = inter[..., right_start:]
        else:
            left = inter[..., :right_start]
            right = inter[..., right_start:] >> 1
        pl = torch.as_tensor(self.pair_idx[:, 0], dtype=torch.int64, device=h.device)
        pr = torch.as_tensor(self.pair_idx[:, 1], dtype=torch.int64, device=h.device)
        return (left[..., pl] | right[..., pr]).to(torch.int32)


def hash_per_cluster(source, pc_params, x: torch.Tensor, cluster_block: int = 16):
    """(n, C, L) int32 hashes of x under each cluster's own functions, or
    with the SketchFilterer as `source` (n, C, S, W) sketches
    (`pc_params`: its parameter dict with a leading C axis on every leaf,
    a faithful reference import's). The JAX package vmaps hash_with /
    sketch_with over C; here blocks of `cluster_block` clusters are one
    batched family product each, which bounds the (functions, n, padded
    dims) floats of cross-polytope hashing."""
    C = next(iter(pc_params.values())).shape[0]
    return torch.cat([
        source.hash_clusters({k: v[c : c + cluster_block] for k, v in pc_params.items()}, x)
        for c in range(0, C, cluster_block)
    ], dim=1)


def make_hash_source(
    name: str, family, num_hashers: int, num_bits: int, pool_size: int = 0
):
    if name == "independent":
        return IndependentHashSource(family, num_hashers, num_bits)
    if name == "pool":
        return PooledHashSource(family, num_hashers, num_bits, pool_size)
    if name == "tensor":
        return TensoredHashSource(family, num_hashers, num_bits)
    raise ValueError(f"unknown hash source {name!r}")

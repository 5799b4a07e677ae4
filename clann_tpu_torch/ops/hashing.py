"""LSH hash families as batched matmuls (PyTorch port of ``clann_tpu.ops.hashing``).

- SimHash (reference: libpuffinn/include/puffinn/hash/simhash.hpp:41-45,
  96-102): sign of a dot with a random unit vector; one (n, d) @ (d, F)
  matmul + sign for all F functions at once.
- FHT cross-polytope (reference: hash/crosspolytope.hpp:121-311): 3 rounds
  of (+-1 diagonal x Hadamard transform) pseudo-rotation, hash = index of
  the max-|coordinate| axis with a sign bit. Each Hadamard pass is one f32
  matmul with the (d_pad, d_pad) Sylvester matrix, as in the JAX package;
  it is full f32 while ``torch.backends.cuda.matmul.allow_tf32`` is False
  (PyTorch's default, see ops/distances.py).
- Vanilla cross-polytope (reference: hash/crosspolytope.hpp:313-469): same
  encoding after one Gaussian random rotation.

Hash values are int32 tensors with `bits_per_function` significant bits
(the JAX package stores uint32; every value is below 2^31). `sample()`
draws from a ``torch.Generator``: the port's draws are its own, and parity
with the JAX package comes from carrying the JAX parameters across
(core/index.index_from_arrays), never from matching the RNG.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def ceil_log2(x: int) -> int:
    """Smallest l with 2^l >= x (reference: math.hpp:105-113 ceil_log)."""
    l = 0
    while (1 << l) < x:
        l += 1
    return l


def hadamard_matrix(log_n: int) -> np.ndarray:
    """Unnormalized Hadamard matrix H_{2^log_n} (Sylvester construction),
    FFHT's unnormalized sums (normalization is irrelevant to the argmax and
    sign encodings that consume the transform)."""
    h = np.array([[1.0]], dtype=np.float32)
    for _ in range(log_n):
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Normal draws from a CPU generator, moved to `device`."""
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def _unit_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    norms = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.where(norms == 0, torch.ones_like(norms), norms)


@dataclasses.dataclass
class SimHash:
    """1-bit hyperplane hash family (reference: hash/simhash.hpp)."""

    dimensions: int
    bits_per_function: int = 1

    def sample(self, gen: torch.Generator, num_functions: int, device="cpu") -> dict:
        """Random unit-vector hyperplanes, one per function
        (reference: simhash.hpp:20-23)."""
        dirs = _randn(gen, (num_functions, self.dimensions), device)
        return {"dirs": _unit_rows(dirs, 1)}

    def hash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(n, F) int32 in {0, 1}: 1 iff dot >= 0 (simhash.hpp:41-45)."""
        dots = torch.matmul(x.float(), params["dirs"].T)
        return (dots >= 0).to(torch.int32)

    def collision_probability(self, sim, num_bits) -> torch.Tensor:
        """p = 1 - acos(2s-1)/pi for 1 bit, 1.0 for 0 bits
        (reference: simhash.hpp:96-102), in f32."""
        sim = torch.as_tensor(np.asarray(sim, np.float32))
        p1 = 1.0 - torch.arccos(torch.clamp(2.0 * sim - 1.0, -1.0, 1.0)) / np.pi
        nb = torch.as_tensor(num_bits)
        return torch.where(nb == 0, torch.ones_like(p1), p1)


def encode_closest_axis(v: torch.Tensor, log_dim: int) -> torch.Tensor:
    """Hash = argmax_i |v_i| with a sign bit: i if v_i > 0 else i + 2^log_dim.

    Reference: crosspolytope.hpp:131-144 scans coordinates in order testing
    +v_i then -v_i with strict `>`. The JAX package reproduces that by
    taking the first argmax over the interleaved (+v_0, -v_0, +v_1, ...).
    Here the same answer comes without the doubled tensor: the first
    interleaved maximum lies at the first i with |v_i| == max|v|
    (torch.argmax returns the first maximal index, on the CPU and on CUDA),
    and it is the +v_i entry unless v_i < 0 (at max|v| == 0 the +0 entry
    wins, as it does in the interleaved scan).

    v: (..., 2^log_dim) -> (...) int32 with log_dim+1 bits.
    """
    idx = torch.argmax(torch.abs(v), dim=-1)
    neg = torch.gather(v, -1, idx.unsqueeze(-1)).squeeze(-1) < 0
    return (idx | (neg.to(torch.int64) << log_dim)).to(torch.int32)


@dataclasses.dataclass
class FHTCrossPolytope:
    """Pseudo-rotation cross-polytope LSH (reference: crosspolytope.hpp:121-311).

    bits_per_function = log2(padded_dim) + 1 (crosspolytope.hpp:301-303).
    Collision probabilities are Monte-Carlo tabulated (ops/collision.py).
    """

    dimensions: int
    num_rotations: int = 3
    estimation_repetitions: int = 1000
    estimation_eps: float = 5e-3

    def __post_init__(self):
        self.log_dim = ceil_log2(self.dimensions)
        self.padded_dim = 1 << self.log_dim
        self.bits_per_function = self.log_dim + 1
        self._estimates: Optional[np.ndarray] = None

    def sample(self, gen: torch.Generator, num_functions: int, device="cpu") -> dict:
        """+-1 diagonal signs per (function, rotation)
        (reference: crosspolytope.hpp:162-173)."""
        bits = torch.rand(
            (num_functions, self.num_rotations, self.padded_dim),
            generator=gen,
        ) < 0.5
        return {"signs": (bits.to(torch.float32) * 2.0 - 1.0).to(device)}

    def hash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """(n, F) int32 cross-polytope hashes.

        Per function: v = H S_r ... H S_1 x (crosspolytope.hpp:187-209),
        then closest-axis encoding; batched over functions as one
        (F, n, dp) @ (dp, dp) matmul per rotation.
        """
        signs = params["signs"]  # (F, R, dp)
        h = torch.as_tensor(hadamard_matrix(self.log_dim), device=x.device)
        v = torch.nn.functional.pad(x.float(), (0, self.padded_dim - x.shape[1]))
        v = v.unsqueeze(0)  # broadcast against (F, 1, dp) signs
        for r in range(self.num_rotations):
            v = torch.matmul(v * signs[:, None, r, :], h)
        return encode_closest_axis(v, self.log_dim).T  # (n, F)

    def collision_probability(self, sim, num_bits) -> torch.Tensor:
        """Tabulated MC estimate lookup (crosspolytope.hpp:117-119):
        probabilities[num_bits][floor(sim / eps)]."""
        if self._estimates is None:
            from clann_tpu_torch.ops.collision import cross_polytope_estimates

            self._estimates = cross_polytope_estimates(
                self.padded_dim, self.estimation_repetitions, self.estimation_eps
            )
        table = torch.as_tensor(self._estimates)  # (log_dim+2, n_buckets)
        bucket = torch.clamp(
            (torch.as_tensor(np.asarray(sim, np.float32)) / self.estimation_eps)
            .to(torch.int64),
            0, table.shape[1] - 1,
        )
        nb = torch.clamp(torch.as_tensor(num_bits, dtype=torch.int64), 0, table.shape[0] - 1)
        return table[nb, bucket]


@dataclasses.dataclass
class CrossPolytope(FHTCrossPolytope):
    """Cross-polytope LSH with a single true Gaussian rotation
    (reference: crosspolytope.hpp:313-469)."""

    def sample(self, gen: torch.Generator, num_functions: int, device="cpu") -> dict:
        """Each output axis gets a random UNIT vector, as the reference
        samples its matrix rows (crosspolytope.hpp:330-336)."""
        rot = _randn(gen, (num_functions, self.dimensions, self.padded_dim), device)
        return {"rot": _unit_rows(rot, 1)}

    def hash(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        v = torch.einsum("nd,fdp->fnp", x.float(), params["rot"])
        return encode_closest_axis(v, self.log_dim).T


def make_hash_family(name: str, dimensions: int, *, num_rotations: int = 3,
                     estimation_repetitions: int = 1000,
                     estimation_eps: float = 5e-3):
    if name == "simhash":
        return SimHash(dimensions)
    if name == "fht_cross_polytope":
        return FHTCrossPolytope(
            dimensions,
            num_rotations=num_rotations,
            estimation_repetitions=estimation_repetitions,
            estimation_eps=estimation_eps,
        )
    if name == "cross_polytope":
        return CrossPolytope(
            dimensions,
            num_rotations=num_rotations,
            estimation_repetitions=estimation_repetitions,
            estimation_eps=estimation_eps,
        )
    raise ValueError(f"unknown hash family {name!r}")

"""1-bit LSH sketch filtering (PyTorch port of ``clann_tpu.ops.sketches``).

Equivalent of the reference Filterer
(reference: libpuffinn/include/puffinn/filterer.hpp): NUM_SKETCHES=32 64-bit
SimHash sketches per point (filterer.hpp:16, typedefs.hpp:12-15), filter
test popcount(xor) <= max_sketch_diff (filterer.hpp:28-31), and the adaptive
threshold round(64 * (1 - p_1(kth_sim))) (filterer.hpp:108-111).

Each sketch is stored as two 32-bit words, sketches[n, NUM_SKETCHES, 2], as
in the JAX package. The JAX words are uint32; here they are int32 tensors
holding the same bit patterns (compare through ``.view(np.uint32)``). XOR,
AND and per-bit tests work on those directly. torch has no popcount, so
`popcount32` is a SWAR count over the two 16-bit halves of each word: every
intermediate stays below 2^16, so no int32 arithmetic overflows and the
arithmetic right shift never brings in a sign bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clann_tpu_torch.ops.hashing import SimHash, family_hash_clusters

NUM_SKETCHES = 32  # reference: filterer.hpp:16
SKETCH_BITS = 64  # reference: typedefs.hpp NUM_FILTER_HASHBITS


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., 32*w) {0,1} values into (..., w) 32-bit words (int32).

    Bit i of a word is source column 31-i within its 32-column group: the
    first column is the most significant bit (independent.hpp:79-83).
    """
    *lead, nb = bits.shape
    if nb % 32:
        raise ValueError(f"bit count {nb} is not a multiple of 32")
    b = bits.reshape(*lead, nb // 32, 32).to(torch.int64)
    shifts = torch.arange(31, -1, -1, dtype=torch.int64, device=bits.device)
    return to_int32_bits(torch.sum(b << shifts, dim=-1))


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = (v & 0x5555) + ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v & 0x0F0F) + ((v >> 4) & 0x0F0F)
    return (v & 0x00FF) + ((v >> 8) & 0x00FF)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns) as int32."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


@dataclasses.dataclass
class SketchFilterer:
    """Builds and evaluates per-point sketches (reference: filterer.hpp)."""

    dimensions: int
    num_sketches: int = NUM_SKETCHES
    sketch_bits: int = SKETCH_BITS

    def __post_init__(self):
        if self.sketch_bits % 32:
            raise ValueError(f"sketch_bits={self.sketch_bits} is not a multiple of 32")
        self.family = SimHash(self.dimensions)
        self.params = None

    def init(self, gen: torch.Generator, device="cpu") -> "SketchFilterer":
        self.params = self.family.sample(gen, self.num_sketches * self.sketch_bits, device)
        return self

    def sketch(self, x: torch.Tensor) -> torch.Tensor:
        """(n, num_sketches, words) int32 packed sketches: one (n, d) @
        (d, num_sketches*bits) matmul + sign + bit-pack (filterer.hpp:87-96)."""
        return self.sketch_with(self.params, x)

    def sketch_with(self, params, x: torch.Tensor) -> torch.Tensor:
        bits = self.family.hash(params, x)  # (n, S*B) of {0,1}
        bits = bits.reshape(bits.shape[0], self.num_sketches, self.sketch_bits)
        return pack_bits_u32(bits)

    def hash_clusters(self, pc_params, x: torch.Tensor) -> torch.Tensor:
        """(n, Cc, num_sketches, words): sketch_with under each of Cc
        clusters' planes (pc_params["dirs"] (Cc, S*B, d); called through
        ops/sources.hash_per_cluster)."""
        bits = family_hash_clusters(self.family, pc_params, x)  # (n, Cc, S*B)
        return pack_bits_u32(bits.reshape(*bits.shape[:2], self.num_sketches,
                                          self.sketch_bits))

    @staticmethod
    def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """popcount(xor) summed over the word axis (filterer.hpp:28-31)."""
        return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)

    def max_sketch_diff(self, probs_1bit, kth_sim) -> torch.Tensor:
        """round(bits * (1 - p_1(kth_sim))) (reference: filterer.hpp:108-111)."""
        p = probs_1bit(kth_sim)
        return torch.round(self.sketch_bits * (1.0 - p)).to(torch.int32)


def simhash_p1(sim) -> torch.Tensor:
    """1-bit SimHash collision probability (reference: simhash.hpp:96-102), f32."""
    s = torch.as_tensor(np.asarray(sim, np.float32))
    return 1.0 - torch.arccos(torch.clamp(2.0 * s - 1.0, -1.0, 1.0)) / np.pi

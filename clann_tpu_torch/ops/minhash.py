"""MinHash LSH families for Jaccard similarity (PyTorch port of
``clann_tpu.ops.minhash``; the reference's machinery is
libpuffinn/include/puffinn/hash/minhash.hpp).

- MinHash (minhash.hpp:165-254): rank every token of a set by a seeded
  murmur3 finalizer, take the lowest-ranked token and emit the top
  `bits_per_function` bits of its scrambled encoding.
  bits_per_function = ceil_log(universe) (minhash.hpp:240-242); collision
  probability sim + (1 - sim) * miss with miss = (U / min(2^b, U) - 1) /
  (U - 1) (minhash.hpp:244-253).
- MinHash1Bit (minhash.hpp:256-283): the same function's lowest bit, for
  sketches.
- TabulationMinHash / TabulationMinHash1Bit: the reference's exact
  functions (4 x 8-bit tabulation, minhash.hpp:11-48, the first token at
  the 64-bit minimum, a permutation of the low bits, minhash.hpp:51-127),
  with the tables as explicit parameters.

The JAX package computes in uint32. torch has no uint32 shifts or
multiplies, so the murmur mix runs in int64 holding values in [0, 2^32):
a right shift of such a value is the unsigned shift, and a product mod 2^32
is taken in two 16-bit halves of the constant, so no int64 product
overflows. Ranks are compared as those int64 values (unsigned order); the
tabulation words stay int32 bit patterns and are compared with the sign bit
flipped, which maps unsigned order onto signed order. Outputs are below
2^31 and are int32. Parameters are int32 bit patterns of JAX's uint32
words; the port's own draws come from a torch.Generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clann_tpu_torch.ops.hashing import ceil_log2

_U32 = 0xFFFFFFFF
_I32_MIN = -(1 << 31)  # the sign bit of an int32 word
_I32_MAX = (1 << 31) - 1  # 0xFFFFFFFF with the sign bit flipped


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64 values) as int64 in [0, 2^32)."""
    return t.to(torch.int64) & _U32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the constant in two 16-bit
    halves, so each partial product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _random_words(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words as int32 bit patterns, drawn on the CPU."""
    w = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64)
    return torch.where(w > _I32_MAX, w - (1 << 32), w).to(torch.int32).to(device)


def _as_tokens(sets) -> torch.Tensor:
    t = sets if isinstance(sets, torch.Tensor) else torch.as_tensor(np.asarray(sets))
    return t.to(torch.int32)


@dataclasses.dataclass
class MinHash:
    """Min-wise hashing over padded token sets (reference: minhash.hpp)."""

    universe: int

    def __post_init__(self):
        self.set_size = max(self.universe, 2)
        self.bits_per_function = ceil_log2(self.set_size)

    def sample(self, gen: torch.Generator, num_functions: int, device="cpu") -> dict:
        return {
            "rank_seed": _random_words(gen, (num_functions,), device),
            "scramble_seed": _random_words(gen, (num_functions,), device),
        }

    def hash(self, params: dict, sets) -> torch.Tensor:
        """(n, F) int32 minhashes of padded (n, T) token sets (-1 pads).

        For each function f: rank tokens by fmix32(token ^ rank_seed[f])
        (minhash.hpp:185-192), take the first token of the lowest rank, and
        emit the top bits of fmix32(token ^ scramble_seed[f]). An empty set
        ranks its first pad, the token 0xFFFFFFFF, as JAX does.
        """
        tokens = _as_tokens(sets)
        valid = tokens >= 0
        t = _u32(tokens)  # -1 pads are 0xFFFFFFFF, as JAX's uint32 cast
        ranks = fmix32(t[:, :, None] ^ _u32(params["rank_seed"]))  # (n, T, F)
        ranks.masked_fill_(~valid[:, :, None], _U32)
        min_pos = torch.argmin(ranks, dim=1)  # (n, F), first minimum
        del ranks
        min_token = torch.gather(t, 1, min_pos)
        shift = 32 - self.bits_per_function
        return (fmix32(min_token ^ _u32(params["scramble_seed"])) >> shift).to(torch.int32)

    def collision_probability(self, sim, num_bits) -> torch.Tensor:
        """sim + (1 - sim) * miss_collision_prob (minhash.hpp:244-253), in f32."""
        sim = torch.as_tensor(np.asarray(sim, np.float32))
        nb = torch.as_tensor(np.asarray(num_bits))
        u = float(self.set_size)
        hashes = torch.clamp(2.0 ** nb.to(torch.float32), max=u)
        # tensor operands: a Python numerator would be taken as a reciprocal
        # times u, which rounds differently from JAX's division
        u_t, u1_t = (torch.tensor(v, dtype=torch.float32) for v in (u, u - 1.0))
        miss = (u_t / hashes - 1.0) / u1_t
        p = sim + (1.0 - sim) * miss
        return torch.where(nb == 0, torch.ones_like(p), torch.clamp(p, 0.0, 1.0))


@dataclasses.dataclass
class TabulationMinHash(MinHash):
    """Reference-exact MinHash (minhash.hpp:11-127).

    Per function f: rank every token by the 64-bit tabulation hash
    t1[b0]^t2[b1]^t3[b2]^t4[b3] (minhash.hpp:40-47), take the FIRST token
    at the minimum (the reference's strict `<` scan, minhash.hpp:116-127)
    and send its low `randomized_bits` bits through a permutation
    (BitPermutation, minhash.hpp:51-95).

    Params: tab_hi / tab_lo (F, 4, 256) int32 words, the high and low
    halves of the 64-bit tables (the minimum is a lexicographic (hi, lo)
    compare); perm (F, P), P = min(universe, 2^randomized_bits).
    """

    randomized_bits: int = 4  # MinHashArgs default (minhash.hpp:139-143)

    def sample(self, gen: torch.Generator, num_functions: int, device="cpu") -> dict:
        shape = (num_functions, 4, 256)
        p = min(self.universe, 1 << self.randomized_bits)
        perm = torch.argsort(torch.rand((num_functions, p), generator=gen), dim=1)
        return {
            "tab_hi": _random_words(gen, shape, device),
            "tab_lo": _random_words(gen, shape, device),
            "perm": perm.to(torch.int32).to(device),
        }

    def _min_token(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """(F, n) first token at the lexicographic (hi, lo) minimum; 0 for
        an empty set (the reference's initial min_token, minhash.hpp:118)."""
        valid = tokens >= 0  # (n, T)
        t = torch.where(valid, tokens, 0).to(torch.int64)
        tab_hi, tab_lo = params["tab_hi"], params["tab_lo"]
        hi = lo = None
        for j in range(4):
            b = (t >> (8 * j)) & 0xFF
            h, l = tab_hi[:, j, :][:, b], tab_lo[:, j, :][:, b]  # (F, n, T)
            hi, lo = (h, l) if hi is None else (hi ^ h, lo ^ l)
        # flipped sign bits: signed order of the keys is unsigned order of
        # the words; pads rank as 0xFFFFFFFF
        hi = torch.where(valid, hi ^ _I32_MIN, _I32_MAX)
        cand = valid & (hi == hi.min(dim=-1, keepdim=True).values)
        lo = torch.where(cand, lo ^ _I32_MIN, _I32_MAX)
        win = cand & (lo == lo.min(dim=-1, keepdim=True).values)
        pos = torch.argmax(win.to(torch.uint8), dim=-1)  # (F, n), first True
        min_token = torch.gather(t.expand(win.shape[0], -1, -1), 2, pos[..., None])[..., 0]
        return torch.where(valid.any(dim=1)[None], min_token, 0)

    def hash(self, params: dict, sets) -> torch.Tensor:
        min_token = self._min_token(params, _as_tokens(sets))
        # BitPermutation (minhash.hpp:87-96)
        perm = params["perm"]  # (F, P)
        p = perm.shape[1]
        if p < self.universe:
            rand_bits = int(np.round(np.log2(max(p, 1))))
        else:
            rand_bits = ceil_log2(max(p, 1))
        mask = (1 << rand_bits) - 1
        lower = torch.clamp(min_token & mask, 0, p - 1)
        permuted = torch.gather(perm.to(torch.int64), 1, lower)  # (F, n)
        out = (min_token & (_U32 ^ mask)) | permuted
        return out.T.to(torch.int32)  # (n, F)


@dataclasses.dataclass
class TabulationMinHash1Bit(TabulationMinHash):
    """1-bit reduction of TabulationMinHash (minhash.hpp:256-283)."""

    def __post_init__(self):
        super().__post_init__()
        self.full_bits = self.bits_per_function
        self.bits_per_function = 1

    def hash(self, params: dict, sets) -> torch.Tensor:
        return TabulationMinHash.hash(self, params, sets) & 1

    def collision_probability(self, sim, num_bits) -> torch.Tensor:
        return MinHash.collision_probability(self, sim, np.minimum(num_bits, 1))


@dataclasses.dataclass
class MinHash1Bit(MinHash):
    """1-bit MinHash for sketching (reference: minhash.hpp:256-283)."""

    def __post_init__(self):
        super().__post_init__()
        self.full_bits = self.bits_per_function
        self.bits_per_function = 1

    def hash(self, params: dict, sets) -> torch.Tensor:
        return MinHash.hash(self, params, sets) & 1

    def collision_probability(self, sim, num_bits) -> torch.Tensor:
        return MinHash.collision_probability(self, sim, np.minimum(num_bits, 1))

"""Set-format data for Jaccard similarity (PyTorch port of
``clann_tpu.data.setdata``).

- SetFormat: sorted u32 token sets with a universe bound check (reference:
  libpuffinn/include/puffinn/format/set.hpp:30-48), stored as a dense
  padded (n, t_max) int32 array, tokens ascending with -1 pads (`pad_sets`).
- JaccardSimilarity: |A ∩ B| / |A ∪ B| (similarity_measure/jaccard.hpp:
  18-42), as an equality-matrix reduction (`jaccard_similarity_block`), a
  per-row binary search (`jaccard_similarity_rowwise`) or a product of 0/1
  multi-hot matrices (`brute_force_jaccard_topk`, the exact ground truth).

Functions that take numpy arrays run on `device`, the card unless the
caller asks for the CPU; tensors stay where they are.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from clann_tpu_torch.errors import DataError
from clann_tpu_torch.ops.distances import resolve_device

# a multi-hot product may return its counts in bf16 while every count is
# an integer bf16 holds exactly (<= 2^8)
_BF16_EXACT_COUNT = 256


def pad_sets(sets: Sequence[Sequence[int]], universe: int, t_max: int = 0) -> np.ndarray:
    """Validate and pad token sets to a dense (n, t_max) int32 array.

    Mirrors SetFormat's universe bound check (set.hpp:30-48): any token
    outside [0, universe) raises DataError. Duplicate tokens are dropped;
    tokens are stored sorted ascending.
    """
    cleaned: List[np.ndarray] = []
    for i, s in enumerate(sets):
        arr = np.unique(np.asarray(list(s), dtype=np.int64))
        if arr.size and (arr.min() < 0 or arr.max() >= universe):
            raise DataError(f"set {i} has token outside universe [0, {universe})")
        cleaned.append(arr.astype(np.int32))
    need = max((len(a) for a in cleaned), default=1)
    t_max = max(t_max, need, 1)
    out = np.full((len(cleaned), t_max), -1, np.int32)
    for i, a in enumerate(cleaned):
        out[i, : len(a)] = a
    return out


def _tokens(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32)
    return torch.as_tensor(np.asarray(a, np.int32), device=resolve_device(device))


def _ratio(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """inter / union in f32, 0 where the union is empty."""
    inter, union = inter.to(torch.float32), union.to(torch.float32)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def jaccard_similarity_block(a, b, device="cuda") -> torch.Tensor:
    """(na, nb) f32 Jaccard similarities between padded set arrays.

    a: (na, t), b: (nb, t) sorted padded tokens. The sorted merge
    (jaccard.hpp:18-42) as an equality-matrix reduction:
    |A ∩ B| = sum over (ta, tb) of [a == b != pad].
    """
    a, b = _tokens(a, device), _tokens(b, device)
    b = b.to(a.device)
    sizes_a = (a >= 0).sum(dim=1)
    sizes_b = (b >= 0).sum(dim=1)
    eq = (a[:, None, :, None] == b[None, :, None, :]) & (a[:, None, :, None] >= 0)
    inter = eq.sum(dim=(2, 3))
    return _ratio(inter, sizes_a[:, None] + sizes_b[None, :] - inter)


def jaccard_similarity_rowwise(a, b, device="cuda") -> torch.Tensor:
    """(m,) f32 Jaccard similarity of row pairs a[i], b[i].

    a, b: (m, t) sorted padded tokens (pads -1 after the tokens, the
    pad_sets layout); each token of a is looked up in b's row by a binary
    search, the shape a pair join needs (m pairs, not m x m).
    """
    a, b = _tokens(a, device), _tokens(b, device)
    b = b.to(a.device)
    t = a.shape[1]
    big = 1 << 30  # keeps rows sorted once the -1 pads are replaced
    av = torch.where(a < 0, big, a).contiguous()
    bv = torch.where(b < 0, big, b).contiguous()
    pos = torch.searchsorted(bv, av)  # (m, t)
    hit = torch.gather(bv, 1, torch.clamp(pos, 0, t - 1)) == av
    inter = (hit & (av < big)).sum(dim=1)
    return _ratio(inter, (a >= 0).sum(dim=1) + (b >= 0).sum(dim=1) - inter)


class JaccardData:
    """Metric dataset over token sets (distance = 1 - Jaccard).

    As in the reference (whose FFI wires cosine only, SURVEY §2.2), this
    backs the standalone set-LSH index (core/jaccard.py) and brute force.
    """

    metric = "jaccard"

    def __init__(self, sets, universe: int, t_max: int = 0):
        if isinstance(sets, np.ndarray) and sets.ndim == 2:
            self.tokens = sets.astype(np.int32)
        else:
            self.tokens = pad_sets(sets, universe, t_max)
        self.universe = int(universe)
        self.raw = self.tokens  # MetricData-compatible attribute

    def num_points(self) -> int:
        return self.tokens.shape[0]

    def dimensions(self) -> int:
        return self.universe

    def get_point(self, i: int) -> np.ndarray:
        row = self.tokens[i]
        return row[row >= 0]

    def similarities_to(self, query_sets, device="cuda") -> np.ndarray:
        """(q, n) Jaccard similarities of the query sets against the stored
        ones (what JAX's method returns; its docstring says (n, q))."""
        return jaccard_similarity_block(self.tokens, query_sets, device).T.cpu().numpy()

    def distance(self, i: int, j: int, device="cuda") -> float:
        s = jaccard_similarity_block(self.tokens[i][None], self.tokens[j][None], device)
        return float(1.0 - s[0, 0])

    def subset(self, indices) -> "JaccardData":
        return JaccardData(self.tokens[np.asarray(indices)], self.universe)


def _multi_hot(tokens: torch.Tensor, universe: int) -> torch.Tensor:
    """(m, universe) exact 0/1 bf16 membership matrix of padded sets (pads
    land in a dump column that is cut off)."""
    m = tokens.shape[0]
    tok = torch.where(tokens >= 0, tokens, universe).to(torch.int64)
    mh = torch.zeros((m, universe + 1), dtype=torch.bfloat16, device=tokens.device)
    mh.scatter_(1, tok, 1.0)  # tokens are unique per row: a set is an add
    return mh[:, :universe]


def multi_hot_counts(qmh: torch.Tensor, dmh: torch.Tensor, max_count: int) -> torch.Tensor:
    """(Q, B) f32 intersection counts qmh @ dmh.T of 0/1 bf16 multi-hots.

    The products are exact and their sums are integers no larger than
    `max_count` (the smaller of the two sides' largest set), so the bf16
    product, accumulated in f32 and returned in bf16, is exact while
    max_count <= 256; above that the operands go to f32 (0/1 is exact in
    TF32 too, with f32 sums)."""
    if max_count <= _BF16_EXACT_COUNT:
        return torch.matmul(qmh, dmh.T).to(torch.float32)
    return torch.matmul(qmh.to(torch.float32), dmh.to(torch.float32).T)


def _block_jaccard_sims(tokens_blk: torch.Tensor, qmh: torch.Tensor, q_sizes: torch.Tensor,
                        universe: int, max_count: int) -> torch.Tensor:
    """(Q, B) exact Jaccard of one data block against all queries
    (`max_count` bounds every intersection, see multi_hot_counts)."""
    sizes_blk = (tokens_blk >= 0).sum(dim=1).to(torch.float32)
    inter = multi_hot_counts(qmh, _multi_hot(tokens_blk, universe), max_count)
    return _ratio(inter, q_sizes[:, None] + sizes_blk[None, :] - inter)


def brute_force_jaccard_topk(data: JaccardData, query_sets, k: int, block: int = 2048,
                             device="cuda"):
    """Exact top-k by Jaccard similarity (the set analog of
    collection.hpp:524-541 search_bf), blockwise over the dataset, on
    `device`. Returns numpy (sims (Q, k) descending, ids (Q, k) int32);
    among equal similarities the lower id comes first."""
    dev = resolve_device(device)
    n = data.num_points()
    qt = _tokens(query_sets, dev).to(dev)
    qmh = _multi_hot(qt, data.universe)
    q_sizes = (qt >= 0).sum(dim=1).to(torch.float32)
    tokens = torch.as_tensor(data.tokens, device=dev)
    max_count = min(int(np.max((data.tokens >= 0).sum(axis=1), initial=0)), qt.shape[1])
    sims = torch.empty((qt.shape[0], n), dtype=torch.float32, device=dev)
    for s in range(0, n, block):
        sims[:, s : s + block] = _block_jaccard_sims(tokens[s : s + block], qmh, q_sizes,
                                                     data.universe, max_count)
    k = min(k, n)
    order = torch.sort(-sims, dim=1, stable=True).indices[:, :k]
    vals = torch.gather(sims, 1, order)
    return vals.cpu().numpy(), order.to(torch.int32).cpu().numpy()

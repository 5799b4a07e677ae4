"""Top-k closest-pairs self-join (PyTorch port of ``clann_tpu.ops.join``).

PUFFINN's `closest_pairs` (collection.hpp:390-504) walks each table's
hash-sorted array and pairs the points of one prefix segment. Here, as in
JAX, pairs that share a long hash prefix are adjacent in the sorted order,
so the join is windowed: in every table each sorted position is scored
against its next `window` neighbours (one row gather per table, a row-wise
product per offset), the table keeps its best 4k pairs, and the tables'
pairs are deduplicated into the global top-k. `window_sweep` doubles the
window until the failure probability of the k-th pair passes the
delta-recall rule (independent.hpp:108-119, with L tables at depth
~log2(n / window)).

What changes from JAX, none of it in the results: JAX maps `table_pairs`
over all L tables at once, which holds three (L, n * window) arrays (the
sims and the pair ids: ~116 GB at L = 128, n = 1.18M, window 64); the port
loops over chunks of tables under a byte budget (`JOIN_BUDGET_BYTES`,
`table_pairs`' `budget_bytes`), which gives the same pairs because each
table keeps its own top 4k. Inside a table it gathers the rows once and
pairs shifted views of them (data[roll(order, -w)] == roll(data[order],
-w)), and it derives the pair ids from the winners' positions only. Pairs are deduplicated by one exact
int64 key lo * 2^32 + hi (torch has int64 on every device; JAX sorts two
int32 words because its packed key would truncate under x64=off).
Positions past the end of a table (JAX's wrapped neighbours, scored -1)
carry the pair (-1, -1), so they never shadow a real pair in the dedup.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from clann_tpu_torch.ops.distances import exact_dot
from clann_tpu_torch.ops.query import topk_stable

# bytes of one chunk of tables in table_pairs: the gathered rows, the
# (tables, n, window) sims and one row-wise product
JOIN_BUDGET_BYTES = 2 << 30


def _cosine_rowwise(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    sims = torch.sum(va * vb, dim=-1)
    return torch.clamp((sims + 1.0) * 0.5, 0.0, 1.0)


def _topk_low_index(x: torch.Tensor, kk: int):
    """(values, indices) of the kk largest of each row of x (T, m), lower
    index first among equals as lax.top_k: torch.topk, then a stable sort
    for the rows whose k-th value ties an element left out."""
    vals, idx = torch.topk(x, kk, dim=1)
    kth = vals[:, -1:]
    cut = (x == kth).sum(dim=1) > (vals == kth).sum(dim=1)
    if bool(cut.any()):
        rows = torch.nonzero(cut).flatten()
        vals[rows], idx[rows] = topk_stable(x[rows], kk)
    return vals, idx


def table_pairs(data, sorted_idx, *, k: int, window: int, sim_fn=None,
                budget_bytes: int = JOIN_BUDGET_BYTES):
    """Per-table windowed pair candidates.

    data: (n, ...) point storage, row-indexable; sorted_idx: (L, n) point
    id per sorted slot; sim_fn(rows_a, rows_b) -> similarities in [0, 1]
    of row pairs with any leading dims (default: cosine over normalized
    vectors; the Jaccard join passes a row-wise Jaccard). Returns (sims,
    lo, hi), each (L, kk) with kk = min(4k, n * window), lo < hi the
    canonical pair ids ((-1, -1) for positions past a table's end). Tables
    are processed in chunks whose rows, sims and one product fit
    `budget_bytes`; the result does not depend on it.
    """
    sim_fn = sim_fn or _cosine_rowwise
    L, n = sorted_idx.shape
    kk = min(4 * k, n * window)
    row_bytes = data[:1].numel() * data.element_size()
    per_table = n * (2 * row_bytes + 4 * window + 8)
    chunk = int(max(1, min(L, budget_bytes // max(1, per_table))))
    out_s, out_lo, out_hi = [], [], []
    for t0 in range(0, L, chunk):
        order = sorted_idx[t0:t0 + chunk].to(torch.int64)  # (T, n)
        T = order.shape[0]
        rows = data[order]  # (T, n, ...)
        # sims[t, s, w - 1]: position s against position s + w; -1 past the end
        sims = torch.full((T, n, window), -1.0, dtype=torch.float32, device=order.device)
        for w in range(1, min(window, n - 1) + 1):
            sims[:, : n - w, w - 1] = sim_fn(rows[:, : n - w], rows[:, w:])
        del rows
        top_s, sel = _topk_low_index(sims.reshape(T, n * window), kk)
        del sims
        s, w = sel // window, sel % window + 1
        a = torch.gather(order, 1, s)
        b = torch.gather(order, 1, torch.clamp(s + w, max=n - 1))
        valid = s + w < n
        out_s.append(top_s)
        out_lo.append(torch.where(valid, torch.minimum(a, b), -1).to(torch.int32))
        out_hi.append(torch.where(valid, torch.maximum(a, b), -1).to(torch.int32))
    return torch.cat(out_s), torch.cat(out_lo), torch.cat(out_hi)


def dedup_topk_pairs(sims_flat, lo_flat, hi_flat, *, k: int):
    """Global top-k over flattened (sims, canonical lo < hi pair) candidates.

    Copies of one pair found in several tables carry identical sims (same
    vectors, same product), so a stable sort on the exact int64 key
    lo * 2^32 + hi groups them and all but the first are masked (the
    reference's MaxPairBuffer canonical ordering + add_all merge,
    maxpairbuffer.hpp:64-88). Ties go to the lower (lo, hi), as JAX's
    top_k over its key-sorted order. Returns (sims (k,) descending, pairs
    (k, 2) int32, -1 where fewer than k pairs exist).
    """
    key = lo_flat.to(torch.int64) * (1 << 32) + hi_flat.to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    sims_s = sims_flat[order]
    dup = torch.cat([torch.zeros_like(key_s[:1], dtype=torch.bool), key_s[1:] == key_s[:-1]])
    sims_s = torch.where(dup, -1.0, sims_s)
    top_s, sel = topk_stable(sims_s[None, :], k)
    top_s, sel = top_s[0], sel[0]
    pairs = torch.stack([key_s[sel] >> 32, key_s[sel] & 0xFFFFFFFF], dim=1).to(torch.int32)
    pairs = torch.where(top_s[:, None] >= 0, pairs, -1)
    return top_s, pairs


def _windowed_pairs(data, sorted_idx, *, k: int, window: int, sim_fn=None):
    """Top-k pairs from hash adjacency in every table: (sims desc (k,),
    pairs (k, 2) int32)."""
    sims, lo, hi = table_pairs(data, sorted_idx, k=k, window=window, sim_fn=sim_fn)
    return dedup_topk_pairs(sims.reshape(-1), lo.reshape(-1), hi.reshape(-1), k=k)


def window_sweep(
    run, *, n: int, num_tables: int, max_hashbits: int, probs_table,
    sim_eps: float, k: int, delta: float, max_window: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive window doubling with the delta-recall termination rule.

    `run(window) -> (sims desc, pairs)` evaluates one window size; the
    sweep doubles the window until the failure probability for the current
    k-th pair similarity passes (independent.hpp:108-119 with tables = L
    at depth ~ log2(n / window)) or max_window is reached. Host numpy, the
    JAX package's function. Returns (pairs, sims) as numpy arrays.
    """
    window = 4
    while True:
        window = min(window, max(1, n - 1))
        sims, pairs = run(window)
        sims_np = np.asarray(sims)
        kth = float(sims_np[min(k, len(sims_np)) - 1])
        # effective prefix depth: a window of w in a table of n points
        # corresponds to sharing ~log2(n / w) hash bits
        depth = int(
            np.clip(np.log2(max(2, n / max(window, 1))), 1, max_hashbits)
        )
        bucket = int(np.clip(kth / sim_eps, 0, probs_table.shape[1] - 1))
        p_d = probs_table[depth, bucket]
        failure = float((1.0 - p_d) ** num_tables)
        if failure <= 1.0 - delta or window >= min(max_window, n - 1):
            return np.asarray(pairs), sims_np
        window *= 2


def _sweep(data, index, sorted_idx, *, k, delta, max_window, sim_fn=None):
    def run(window):
        sims, pairs = _windowed_pairs(data, sorted_idx, k=k, window=window,
                                      sim_fn=sim_fn)
        return sims.cpu().numpy(), pairs.cpu().numpy()

    return window_sweep(
        run, n=data.shape[0], num_tables=index.sorted_hash.shape[0],
        max_hashbits=index.config.max_hashbits,
        probs_table=index.probs_table.cpu().numpy(), sim_eps=index.sim_eps,
        k=k, delta=delta, max_window=max_window,
    )


def closest_pairs(
    index, k: int, delta: float = 0.9, max_window: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """k most similar pairs in the indexed dataset (Index::closest_pairs,
    collection.hpp:390-504), on the index's device.

    Returns numpy (pairs (k, 2) int32 with i < j, sims (k,) descending);
    the window doubles until the delta-recall rule passes or max_window is
    reached.
    """
    return _sweep(index.vectors, index, index.sorted_idx, k=k, delta=delta,
                  max_window=max_window)


def global_bf_join(index, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force top-k join oracle (collection.hpp:506-521):
    O(n^2) f32 products, for tests and small n. Returns numpy (pairs,
    sims)."""
    x = index.vectors
    n = x.shape[0]
    sims = (exact_dot(x, x.T).cpu().numpy() + 1.0) * 0.5
    iu = np.triu_indices(n, k=1)
    flat = sims[iu]
    order = np.argsort(-flat)[:k]
    pairs = np.stack([iu[0][order], iu[1][order]], axis=1).astype(np.int32)
    return pairs, np.clip(flat[order], 0.0, 1.0)


def _jaccard_rowwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """data/setdata.jaccard_similarity_rowwise over row pairs with any
    leading dims."""
    from clann_tpu_torch.data.setdata import jaccard_similarity_rowwise

    lead = a.shape[:-1]
    sims = jaccard_similarity_rowwise(a.reshape(-1, a.shape[-1]),
                                      b.reshape(-1, b.shape[-1]))
    return sims.reshape(lead)


def jaccard_closest_pairs(
    index, k: int, delta: float = 0.9, max_window: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """k most similar pairs of an indexed set dataset (core.jaccard's
    JaccardIndex): closest_pairs over MinHash adjacency with an exact
    row-wise Jaccard re-score (the upstream SetIndex closest_pairs,
    python_wrapper.cpp:565-567). Returns numpy (pairs (k, 2) int32 with
    i < j, sims (k,) descending)."""
    return _sweep(index.tokens, index, index.sorted_idx, k=k, delta=delta,
                  max_window=max_window, sim_fn=_jaccard_rowwise)


def jaccard_bf_join(data, k: int, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force top-k set-pair oracle (collection.hpp:506-521 for
    the Jaccard instantiation); O(n^2), for tests and small n."""
    from clann_tpu_torch.data.setdata import jaccard_similarity_block

    tokens = np.asarray(data.tokens)
    n = tokens.shape[0]
    sims = jaccard_similarity_block(tokens, tokens, device=device).cpu().numpy()
    iu = np.triu_indices(n, k=1)
    flat = sims[iu]
    order = np.argsort(-flat)[:k]
    pairs = np.stack([iu[0][order], iu[1][order]], axis=1).astype(np.int32)
    return pairs, flat[order].astype(np.float32)

"""The comparison that decides `correct`.

The window's answers are (pool rows, distances, ids) triples, every batch
the program returned, the rows naming the pool's queries the batch held.
For every answer the reference recomputes the distance of each returned id
itself and reads:

- ``recall``: the reference's recall@k rule on those recomputed distances
  against the exact k-NN, over every query of the window;
- ``dist_err``: the largest gap between a returned distance and the
  recomputed distance of its id;
- ``bad_rows``: queries answered with fewer than k distinct rows of the
  collection, with distances out of order, or not answered at all.

Each number is held to its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.knn import distances_of, exact_knn, recall_matches

Answer = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (pool rows, distances, ids)
CHUNK_ROWS = 1 << 16  # answered queries judged together on the device


def _rows_answered(dists: np.ndarray, ids: np.ndarray, rows: int, k: int) -> int:
    """How many of the `rows` queries the answer holds in shape."""
    if dists.ndim != 2 or ids.shape != dists.shape or ids.shape[1] < k:
        return 0
    return min(rows, ids.shape[0])


class _Tally:
    def __init__(self, train: torch.Tensor, pool: torch.Tensor, true_d: np.ndarray):
        self.train, self.pool, self.true_d = train, pool, true_d
        self.matches = self.bad_rows = 0
        self.dist_err = 0.0

    def add(self, parts: List[Answer], k: int) -> None:
        if not parts:
            return
        dev, n = self.train.device, self.train.shape[0]
        rows = np.concatenate([p[0] for p in parts])
        ids = torch.as_tensor(np.concatenate([p[2] for p in parts]).astype(np.int64),
                              device=dev)
        d = torch.as_tensor(np.concatenate([p[1] for p in parts]), device=dev).double()
        in_range = ((ids >= 0) & (ids < n)).all(dim=1)
        s = torch.sort(ids, dim=1).values
        distinct = (s[:, 1:] != s[:, :-1]).all(dim=1)
        ordered = (torch.diff(d, dim=1) >= 0).all(dim=1) & torch.isfinite(d).all(dim=1)
        self.bad_rows += int((~(in_range & distinct & ordered)).sum())
        rec = distances_of(self.train, self.pool[torch.as_tensor(rows, device=dev)], ids)
        valid = torch.isfinite(rec)
        if bool(valid.any()):
            gap = torch.nan_to_num((d - rec.double()).abs()[valid], nan=torch.inf)
            self.dist_err = max(self.dist_err, float(gap.max()))
        self.matches += int(recall_matches(self.true_d[rows], rec.cpu().numpy(), k).sum())


def compare(train: torch.Tensor, pool: torch.Tensor, answers: Sequence[Answer],
            k: int) -> dict:
    """The numbers of `answers` against the exact k-NN of `pool`'s queries
    over `train` (both device tensors). Returns recall, dist_err, bad_rows
    and queries (compared)."""
    tally = _Tally(train, pool, exact_knn(train, pool, k)[0].cpu().numpy())
    queries, held, parts = 0, 0, []
    for rows, dists, ids in answers:
        dists, ids = np.asarray(dists), np.asarray(ids)
        queries += len(rows)
        m = _rows_answered(dists, ids, len(rows), k)
        tally.bad_rows += len(rows) - m
        if m:
            parts.append((rows[:m], dists[:m, :k], ids[:m, :k]))
            held += m
        if held >= CHUNK_ROWS:
            tally.add(parts, k)
            held, parts = 0, []
    tally.add(parts, k)
    return {
        "recall": tally.matches / max(1, queries * k),
        "dist_err": tally.dist_err,
        "bad_rows": tally.bad_rows,
        "queries": queries,
    }


def judge(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "at_least" | "at_most"}}) for every limit."""
    shown, ok = {}, True
    for name, lim in limits.items():
        v = numbers[name]
        if "at_least" in lim:
            holds = v >= lim["at_least"]
            shown[name] = {"value": v, "at_least": lim["at_least"]}
        else:
            holds = v <= lim["at_most"]
            shown[name] = {"value": v, "at_most": lim["at_most"]}
        ok = ok and bool(holds)
    return ok, shown

"""Exact angular k-NN and distance recomputation in plain torch.

Angular distance is 1 - cos(x, q), as ann-benchmarks' angular datasets and
the program's returned distances define it. Products run in float32 with
TF32 off (``tf32=True`` is the control: the same arithmetic one precision
lower), in blocks of queries and of rows so that a 20M-row collection fits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

EPSILON = 1e-3  # the reference's recall threshold slack, src/utils/mod.rs:76


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def exact_knn(train: torch.Tensor, queries: torch.Tensor, k: int, tf32: bool = False,
              block_q: int = 2048, block_n: int = 1 << 20):
    """(distances (Q, k) ascending, ids (Q, k) int64) of the k nearest rows
    of `train` to each query, on train's device. Ties go to the lower id
    within a row block."""
    xs = unit_rows(train) if train.shape[0] <= block_n else None
    out_d, out_i = [], []
    with matmul_precision(tf32):
        for q0 in range(0, queries.shape[0], block_q):
            qn = unit_rows(queries[q0:q0 + block_q].to(train.device))
            best_s = torch.full((qn.shape[0], k), -torch.inf, device=train.device)
            best_i = torch.full((qn.shape[0], k), -1, dtype=torch.int64, device=train.device)
            for n0 in range(0, train.shape[0], block_n):
                rows = xs if xs is not None else unit_rows(train[n0:n0 + block_n])
                s = qn @ rows.T
                ts, ti = torch.topk(s, min(k, s.shape[1]), dim=1)
                cat_s = torch.cat([best_s, ts], 1)
                cat_i = torch.cat([best_i, ti + n0], 1)
                best_s, sel = torch.topk(cat_s, k, dim=1)
                best_i = torch.gather(cat_i, 1, sel)
            out_d.append(1.0 - best_s)
            out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def distances_of(train: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """1 - cos(train[ids[i, j]], queries[i]) for every returned id, +inf
    where the id is not a row of train (-1 or out of range)."""
    n = train.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = unit_rows(train[torch.where(ok, ids, 0).reshape(-1)]).reshape(*ids.shape, -1)
    qn = unit_rows(queries.to(train.device))
    with matmul_precision(tf32):
        cos = torch.bmm(rows, qn[:, :, None])[:, :, 0]
    return torch.where(ok, 1.0 - cos, torch.inf)


def recall_matches(true_dists: np.ndarray, run_dists: np.ndarray, count: int,
                   epsilon: float = EPSILON) -> np.ndarray:
    """Per query, how many of the first `count` run distances are <= the
    true count-th distance + epsilon (the reference's rule,
    src/utils/mod.rs:59-95). Feed it distances recomputed for the returned
    ids, never the program's own."""
    thresholds = np.sort(np.asarray(true_dists, np.float32), axis=1)[:, count - 1] + epsilon
    run = np.asarray(run_dists, np.float32)[:, :count]
    return (run <= thresholds[:, None]).sum(axis=1)

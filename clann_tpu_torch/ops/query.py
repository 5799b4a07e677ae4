"""Helpers of the batched adaptive LSH engines (PyTorch port).

The pieces of ``clann_tpu.ops.query`` that the global engine
(ops/global_query.py) imports: the per-query counters, the collision-table
lookup of the termination check, the batch driver, candidate scoring,
compaction and the deduplicating top-k merge (the reference's MaxBuffer,
maxbuffer.hpp:25-76). The clustered walk itself (`search_batch_impl` and
the rest of that module) comes with its own slice (ROADMAP.md).

`lax.top_k` puts the lower index first among equal values; every top-k
here is a stable descending sort cut to k, which keeps that order, because
the merge's ties (empty slots, equal scores) decide which ids survive.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SearchStats(NamedTuple):
    """Per-query counters (reference: performance.hpp + RunMetrics §2.1)."""

    distance_computations: torch.Tensor  # (Q,) int32 — parity counter
    candidates: torch.Tensor  # (Q,) int32 pre-filter candidates gathered
    clusters_visited: torch.Tensor  # (Q,) int32 ranks actually searched


def probs_lookup(index, depth, sim):
    """P(depth bits collide | sim bucket) from the precomputed table
    (ops/collision.HashSourceProbs)."""
    bucket = torch.clamp((sim / index.sim_eps).to(torch.int64), 0,
                         index.probs_table.shape[1] - 1)
    dd = torch.clamp(depth.to(torch.int64), 0, index.probs_table.shape[0] - 1)
    return index.probs_table[dd, bucket]


def batched_query_driver(qn, batch_size, run_block):
    """Pad / batch / slice / concatenate driver of the LSH search frontends.

    run_block(block (B, d)) -> (sims, ids, stats) tensors; returns host
    (sims, ids, SearchStats) numpy arrays over all batches.
    """
    all_sims, all_ids, all_stats = [], [], []
    for start in range(0, qn.shape[0], batch_size):
        block = qn[start : start + batch_size]
        pad = 0
        if block.shape[0] < batch_size and qn.shape[0] > batch_size:
            pad = batch_size - block.shape[0]
            # repeat the last real query: a zero row would be a worst-case
            # query, and the batch loop runs to its slowest lane
            block = torch.cat([block, block[-1:].expand(pad, -1)], dim=0)
        sims, ids, stats = run_block(block)
        if pad:
            sims, ids = sims[:-pad], ids[:-pad]
            stats = SearchStats(*(s[:-pad] for s in stats))
        all_sims.append(sims.cpu().numpy())
        all_ids.append(ids.cpu().numpy())
        all_stats.append([s.cpu().numpy() for s in stats])
    sims = np.concatenate(all_sims, axis=0)
    ids = np.concatenate(all_ids, axis=0)
    stats = SearchStats(*(np.concatenate([s[i] for s in all_stats])
                          for i in range(len(SearchStats._fields))))
    return sims, ids, stats


def _score_candidates(index, queries_n, queries_q8, safe_ids):
    """Candidate similarity (Q, CB) in f32: (dot + 1) / 2 clipped to [0, 1]
    (cosine.hpp:19-23). f32 products at full precision (TF32 off, the
    JAX package's Precision.HIGHEST). The int8 path (`queries_q8`) belongs
    to `rescore_dtype="int8"`, which the port does not build yet."""
    if queries_q8 is not None:
        raise NotImplementedError(
            "int8 candidate scoring: ROADMAP.md slice 7 (int8 rescore)")
    vecs = index.vectors[safe_ids.to(torch.int64)]  # (Q, CB, d)
    dots = torch.bmm(vecs, queries_n[:, :, None]).squeeze(2)
    return torch.clamp((dots + 1.0) * 0.5, 0.0, 1.0)


def _exact_rescore_topk(index, queries_n, topk_sims, topk_ids, out_k):
    """Exact f32 re-score of the kept candidates; a no-op in f32 mode, the
    only mode the port builds (the buffer already holds exact scores)."""
    del index, queries_n
    return topk_sims[:, :out_k], topk_ids[:, :out_k]


def _compact_take(take, cand_ids, *, cap, n_sentinel):
    """Compact taken candidate ids into the first `cap` slots, in order.

    Taken lanes get unique ranks 0..T-1 and are scattered to them; every
    other slot holds the sentinel, and ranks past `cap` are dropped — the
    JAX package's (rank, id) sort gives the same array.
    """
    Q, WL = take.shape
    rank = torch.where(take, torch.cumsum(take, dim=1) - 1, WL)
    out = torch.full((Q, WL + 1), n_sentinel, dtype=torch.int32, device=take.device)
    src = torch.where(take, cand_ids.to(torch.int32), n_sentinel)
    out.scatter_(1, rank, src)
    return out[:, : min(cap, WL)]


def topk_stable(values, k):
    """(top k values, their indices) in descending order, lower index first
    among equals (lax.top_k's order)."""
    vals, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _merge_topk(topk_sims, topk_ids, cand_ids, cand_sims, *, n_sentinel):
    """Merge chunk candidates into the running top-k with exact dedup.

    Replaces MaxBuffer (maxbuffer.hpp:25-76): candidates sorted by id make
    duplicates adjacent (masked), ids already in the top-k are masked, and
    one top-k over [top-k, candidates] keeps the best. topk_ids never holds
    a duplicate; a candidate's score is the same at every occurrence.
    """
    ids_sorted, order = torch.sort(cand_ids, dim=1)
    sims_sorted = torch.gather(cand_sims, 1, order)
    dup = torch.cat([
        torch.zeros_like(ids_sorted[:, :1], dtype=torch.bool),
        ids_sorted[:, 1:] == ids_sorted[:, :-1],
    ], dim=1)
    in_topk = (ids_sorted[:, :, None] == topk_ids[:, None, :]).any(dim=-1)
    sentinel = ids_sorted >= n_sentinel
    sims_final = torch.where(dup | in_topk | sentinel, -1.0, sims_sorted)

    all_sims = torch.cat([topk_sims, sims_final], dim=1)
    all_ids = torch.cat([topk_ids, ids_sorted], dim=1)
    new_sims, sel = topk_stable(all_sims, topk_sims.shape[1])
    new_ids = torch.gather(all_ids, 1, sel)
    return (torch.clamp(new_sims, min=0.0),
            torch.where(new_sims < 0, -1, new_ids).to(torch.int32))

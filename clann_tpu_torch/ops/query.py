"""The reference-faithful clustered δ walk and the helpers of both LSH
engines (PyTorch port of ``clann_tpu.ops.query``; see its docstring for the
design).

The walk (`search_batch_impl`): clusters in center-distance order
(index.rs:592-616), per cluster rank the PUFFINN adaptive search over the
cluster's segment of every table (collection.hpp:768-948) — candidate
stream by prefix peeling, sketch filter, f32 rescore, deduplicating top-k
merge, failure-probability stop (independent.hpp:108-119) — and the
ball-overlap full stop (index.rs:342-361). The helpers (the per-query
counters, the collision-table lookup, the query batching, candidate scoring,
compaction and the merge, the reference's MaxBuffer, maxbuffer.hpp:25-76)
are shared with the global engine (ops/global_query.py).

What changes from the JAX walk, none of it in the results:

- Its two `lax.while_loop`s are Python loops of device work. JAX runs
  every lane until ALL are done, and a done lane still takes updates there
  (its cursor advances, its delta flags are set), so an iteration run after
  JAX would have stopped is not a no-op: the inner loop reads its stop flag
  before every iteration and runs exactly JAX's iterations. The outer loop
  reads whether every query has stopped at the inner loop's last read, and
  the lazy walk's descend flag once per window (host syncs, counted in
  LoopStats).
- The record gather (JAX's `rec_view[t_sel, blk]`, query.py:545) goes
  through K7, `ops.gather.gather_rows` (csrc/gather.cu).
- The prefix directory is read by plain gathers (JAX's `dir_onehot` MXU
  contractions give the same values).

`lax.top_k` puts the lower index first among equal values; every top-k
here is a stable descending sort cut to k, which keeps that order, because
the merge's ties (empty slots, equal scores) decide which ids survive.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.metrics.trace import TRACER
from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize
from clann_tpu_torch.ops.gather import gather_rows
from clann_tpu_torch.ops.prefixmap import (
    block_stream,
    blocked_window,
    candidate_stream,
    chunk_stream_direct,
    count_leq,
    depth_bounds,
)
from clann_tpu_torch.ops.sketches import popcount32

# body steps between two host reads of a loop's stop flag
SYNC_EVERY = 4


@dataclasses.dataclass
class LoopStats:
    """What the adaptive loops of a search did (accumulated over calls):
    batches run, outer steps (the walk's (group, window) steps; the
    continuous global driver's lane steps; 0 for the batched global
    engine), loop-body iterations, and host syncs (stop-flag, map-sizing,
    descend and lane done-flag pulls; the results pull of each batch is
    not counted)."""

    batches: int = 0
    outer_steps: int = 0
    iterations: int = 0
    syncs: int = 0


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


# the int8 dots are exact in f32 while every partial sum of 127^2-sized
# products stays below 2^24: d * 127 * 127 < 2^24, d <= 1,040
Q8_F32_EXACT_D = ((1 << 24) - 1) // (127 * 127)


def _int8_dots(vecs: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> integer dots (Q, C) as f32: an f32 bmm of the
    int8 values where every sum is exact (d <= Q8_F32_EXACT_D), else an
    int32 multiply-and-sum."""
    if vecs.shape[-1] <= Q8_F32_EXACT_D:
        return torch.bmm(vecs.to(torch.float32), q8.to(torch.float32)[:, :, None]).squeeze(2)
    prod = vecs.to(torch.int32) * q8.to(torch.int32)[:, None, :]
    return prod.sum(dim=-1, dtype=torch.int32).to(torch.float32)


def _score_candidates(index, queries_n, queries_q8, safe_ids):
    """Candidate similarity (Q, CB) in f32: (dot + 1) / 2 clipped to [0, 1]
    (cosine.hpp:19-23). f32 products at full precision (TF32 off, the
    JAX package's Precision.HIGHEST); with `queries_q8` (rescore_dtype
    "int8") the exact integer dot of the int8 shadows, scaled by 1/127^2
    (the reference's i16 ranking dot, math.hpp:11-34)."""
    if queries_q8 is not None:
        vecs = index.vectors_q8[safe_ids.to(torch.int64)]  # (Q, CB, d) int8
        dots = _int8_dots(vecs, queries_q8) * (1.0 / (127.0 * 127.0))
    else:
        vecs = index.vectors[safe_ids.to(torch.int64)]  # (Q, CB, d)
        dots = torch.bmm(vecs, queries_n[:, :, None]).squeeze(2)
    return torch.clamp((dots + 1.0) * 0.5, 0.0, 1.0)


def _exact_rescore_topk(index, queries_n, topk_sims, topk_ids, out_k):
    """Re-score the kept candidates exactly in f32, re-sort, keep out_k.

    In f32 mode the buffer already holds exact scores (its first out_k).
    In int8 mode the buffer holds 2k candidates ranked by their int8 dots
    (the reference's 2k MaxBuffer, maxbuffer.hpp:25-46); their f32 scores
    decide the top out_k (CLANN's re-scoring, index.rs:400-416).
    """
    if index.vectors_q8 is None:
        return topk_sims[:, :out_k], topk_ids[:, :out_k]
    n = index.vectors.shape[0]
    v = index.vectors[torch.clamp(topk_ids, 0, n - 1).to(torch.int64)]  # (Q, kk, d)
    dots = torch.bmm(v, queries_n[:, :, None]).squeeze(2)
    sims = torch.clamp((dots + 1.0) * 0.5, 0.0, 1.0)
    sims = torch.where(topk_ids >= 0, sims, -1.0)
    new_sims, sel = topk_stable(sims, out_k)
    new_ids = torch.gather(topk_ids, 1, sel)
    return torch.clamp(new_sims, min=0.0), torch.where(new_sims < 0, -1, new_ids)


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


def search_batch_impl(
    index,
    queries_n: torch.Tensor,
    query_hashes: torch.Tensor,
    query_sketches: torch.Tensor,
    delta,
    *,
    k: int,
    chunk: int,
    min_depth: int = 1,
    filter_type: str = "default",
    filter_expand: int = 8,
    group_ranks: int = 8,
    loop_stats: Optional[LoopStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """The clustered walk over a pre-hashed query batch (the JAX
    `search_batch_impl`, query.py:246-758). Returns (sims desc (Q, k), ids
    (Q, k) int32, SearchStats) tensors.

    queries_n (Q, d) normalized; query_hashes (Q, L) int32 and
    query_sketches (Q, S, W) int32 words — or (Q, C, L) and (Q, C, S, W),
    each cluster's own hash and sketch functions (the reference's
    per-cluster functions), the walk then taking the current cluster's
    row per rank.

    group_ranks: consecutive cluster ranks whose streams are concatenated
    per outer step (config.lsh_group_ranks); the delta check runs against
    each member's own cursor, the ball-overlap stop at every member
    boundary. Eager walks materialize every peel level of a member at
    once; with config.lsh_level_chunk (and the prefix directory and
    lsh_entry_cap) levels come in windows of that many, and a deeper window
    runs only while some query's delta check still fails. Blocked records
    (G = gather_block consecutive [id, sketch] records per gather, through
    K7) need slot_records; without them the stream runs a slot at a time
    (G = 1) through the id table and a dependent sketch gather.
    """
    if query_sketches.dtype != torch.int32 or query_hashes.dtype != torch.int32:
        raise ValueError("query hashes and sketches must be int32 words")
    Q, d = queries_n.shape
    dev = queries_n.device
    cfg = index.config
    L = index.sorted_hash.shape[0]
    n = index.vectors.shape[0]
    C = index.centers.shape[0]
    D = cfg.max_hashbits
    S = index.sketches.shape[1]
    Wd = index.sketches.shape[2]
    per_cluster = query_hashes.dim() == 3
    max_seg = index.max_seg_len or n
    n_iters = max(1, int(np.ceil(np.log2(max(2, max_seg)))) + 1)
    # entry depth: deeper prefixes than log2(max segment) + 2 hold ~no
    # candidates (prefixmap.candidate_stream)
    d_entry = int(np.clip(np.ceil(np.log2(max(2, max_seg))) + 2, min_depth, D))
    have_dir = index.prefix_dir is not None and index.dir_bits > 0
    if have_dir and cfg.lsh_entry_cap:
        # enter at directory granularity: every level bound is a directory answer
        d_entry = int(max(min_depth, min(d_entry, index.dir_bits)))
    records = index.slot_records is not None
    G = max(1, cfg.gather_block) if records else 1
    g_log = int(np.log2(G))
    WB = max(1, (chunk * filter_expand) // G)  # window width in blocks
    WL = WB * G  # window width in record lanes
    CB = chunk + G  # compacted rescore capacity
    if records:
        R = index.slot_records.shape[2]  # 1 + Wd record words
        if index.slot_records.shape[1] % G:
            raise ValueError(
                "slot_records slot axis is not a multiple of config.gather_block; "
                "build records with make_slot_records(..., pad_to=gather_block)"
            )
        nb = index.slot_records.shape[1] // G
        rec_view = index.slot_records.view(L * nb, G * R)  # (L, n_pad, R) -> block rows

    RG = int(max(1, min(group_ranks, C)))  # members per group
    n_groups = -(-C // RG)
    ND = d_entry - min_depth + 1  # peel levels of a whole walk
    lazy = have_dir and cfg.lsh_entry_cap and 0 < cfg.lsh_level_chunk < ND
    LC = cfg.lsh_level_chunk if lazy else ND
    M = LC * L  # ranges per member stream per window (level-major)
    SM = RG * M  # ranges per group stream

    # cluster order (index.rs:592-616): jnp.argsort is stable
    center_dist = torch.clamp(1.0 - exact_dot(queries_n, index.centers.T), 0.0, 2.0)
    order = torch.argsort(center_dist, dim=1, stable=True)  # (Q, C)
    if n_groups * RG > C:  # pad ranks repeat the last cluster, masked by rank_ok
        order = torch.cat([order, order[:, -1:].expand(Q, n_groups * RG - C)], dim=1)

    # int8 rescore: a 2k buffer (the reference's MaxBuffer keeps 2k,
    # maxbuffer.hpp:25), and every consumer of the k-th similarity (ball
    # bounds, sketch threshold, failure check) subtracts the int8 dot's
    # error bound sqrt(d)/127, so an overestimated k-th never prunes
    queries_q8 = None
    kk, q8_margin = k, 0.0
    if index.vectors_q8 is not None:
        from clann_tpu_torch.core.index import quantize_q8

        queries_q8 = quantize_q8(queries_n)
        kk, q8_margin = 2 * k, float(np.sqrt(d)) / 127.0

    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    stop_at = 1.0 - delta  # f32, as the JAX walk's 1.0 - delta
    blk_iota = torch.arange(WB, device=dev)
    g_iota = torch.arange(RG, device=dev)
    qh64 = query_hashes.to(torch.int64)

    def take(a, i):
        return torch.gather(a, 1, i.to(torch.int64))

    def window_scan(gi: int, ci: int, st):
        """Scan one depth-level window of the RG cluster ranks of group gi:
        (new outer state, iterations, syncs, every query stopped)."""
        topk_sims, topk_ids, stopped, msat, dc, cand_ct, visited = st
        d_top = d_entry - ci * LC  # deepest level of this window
        entry_chunk = ci == 0  # the window holds the entry level
        members = order[:, gi * RG : (gi + 1) * RG]  # (Q, RG)
        rank_ok = (gi * RG + g_iota) < C  # (RG,)
        minpos_g = take(center_dist, members) - index.radii[members]  # ball bounds
        seg_lo_g = index.cluster_starts[members]
        seg_hi_g = index.cluster_starts[members + 1]
        seg_len_g = seg_hi_g - seg_lo_g
        # collection.hpp:550-554 brute fallback for small segments
        is_brute_g = index.brute[members] | (seg_len_g < 100)

        if per_cluster:
            qh_g = torch.gather(query_hashes, 1, members[:, :, None].expand(Q, RG, L))
            qs_g = torch.gather(query_sketches, 1,
                                members[:, :, None, None].expand(Q, RG, S, Wd))
        else:
            qh_g = query_hashes[:, None, :].expand(Q, RG, L)
        qh_flat = qh_g.reshape(Q * RG, L)

        mflat = members.reshape(-1)
        if lazy:
            st_f, sz_f = chunk_stream_direct(
                qh_flat, d_top, entry_chunk, LC, D, index.dir_bits, min_depth, d_entry,
                cdir=index.prefix_dir.index_select(1, mflat))
        else:
            lo, hi = depth_bounds(
                index.sorted_hash, qh_flat, seg_lo_g.reshape(-1), seg_hi_g.reshape(-1), D,
                index.dir_iters if have_dir else n_iters, up_to_depth=d_entry,
                prefix_dir=index.prefix_dir if have_dir else None,
                cluster=mflat if have_dir else None,
                dir_bits=index.dir_bits if have_dir else 0,
            )  # (Q*RG, L, d_entry+1)
            st_f, sz_f = candidate_stream(lo, hi, qh_flat, D, min_depth, start_depth=d_entry)
        st3 = st_f.view(Q, RG, M)
        sz3 = sz_f.view(Q, RG, M)
        # brute members: one range over the whole segment at the member's
        # first stream slot, consumed in the entry window only (index.rs:666-685)
        brute3 = is_brute_g[:, :, None]
        first = torch.arange(M, device=dev) == 0
        brute_len = seg_len_g if entry_chunk else torch.zeros_like(seg_len_g)
        sz3 = torch.where(brute3, torch.where(first, brute_len[:, :, None], 0), sz3)
        st3 = torch.where(brute3, torch.where(first, seg_lo_g[:, :, None], 0), st3)
        sz3 = torch.where(rank_ok[None, :, None], sz3, 0)
        # delta-satisfied members contribute nothing in deeper windows
        sz3 = torch.where(msat[:, :, None], 0, sz3)
        starts_s = st3.reshape(Q, SM).to(torch.int32)
        sizes_s = sz3.reshape(Q, SM).to(torch.int32)

        bstarts, bcounts = block_stream(starts_s, sizes_s, g_log)
        fc = torch.cumsum(bcounts, dim=1, dtype=torch.int32)  # cumulative BLOCK counts
        total = fc[:, -1]
        mend = fc[:, (g_iota + 1) * M - 1]  # (Q, RG) each member's end

        # ball-overlap check of member 0 on entering it (index.rs:342-361;
        # members >= 1 are checked where the cursor crosses into them),
        # active once the queue holds k results
        full0 = topk_ids[:, k - 1] >= 0
        kth0 = torch.where(full0, 2.0 * (1.0 - (topk_sims[:, k - 1] - q8_margin)), torch.inf)
        stopped0 = stopped | (full0 & (minpos_g[:, 0] > kth0) & entry_chunk)
        dc0 = dc + (full0 & ~stopped & entry_chunk).to(torch.int32)  # index.rs:352
        visited0 = visited + (~stopped0 & entry_chunk).to(torch.int32)
        qdone0 = stopped0 | (total <= 0)
        zero = torch.zeros((Q,), dtype=torch.int32, device=dev)

        def body(t):
            (topk_sims, topk_ids, qdone, stopped, off, mcur, msat, dc, cand_ct,
             visited) = t
            # --- phase 1: sketch-filter a window of WB blocks; windows cross
            # member boundaries freely ---
            j, blk, lane_slot, lane_valid = blocked_window(
                fc, off, WB, bstarts, starts_s, sizes_s, g_log)
            valid = (lane_valid & ~qdone[:, None, None]).reshape(Q, WL)
            j = j.to(torch.int64)
            msel = torch.div(j, M, rounding_mode="floor")  # member of each block
            t_sel = j % L  # table (level-major layout; M is a multiple of L)
            brute_blk = take(is_brute_g, msel)
            if records:
                # ONE row gather per block fetches G packed records (K7)
                fidx = (t_sel * nb + torch.clamp(blk, 0, nb - 1)).to(torch.int32)
                rec = gather_rows(rec_view, fidx.reshape(-1)).view(Q, WB, G, R)
                cand_ids = rec[..., 0].reshape(Q, WL)
                cand_sk = rec[..., 1 : 1 + Wd]  # (Q, WB, G, Wd)
            else:
                slot = torch.clamp(lane_slot.reshape(Q, WL), 0, n - 1).to(torch.int64)
                cand_ids = index.sorted_idx[t_sel, slot]  # G = 1: WL == WB
                cand_sk = index.sketches[cand_ids.to(torch.int64), t_sel % S][:, :, None, :]

            kth_sim = topk_sims[:, k - 1] - q8_margin
            maxdiff = index.maxdiff_table[torch.clamp(
                (kth_sim / index.sim_eps).to(torch.int64), 0,
                index.maxdiff_table.shape[0] - 1)]
            # one query sketch per block (table t filters with sketch t % S)
            if per_cluster:
                q_sk = torch.gather(qs_g.reshape(Q, RG * S, Wd), 1,
                                    (msel * S + t_sel % S)[:, :, None].expand(Q, WB, Wd))
            else:
                q_sk = torch.gather(query_sketches, 1,
                                    (t_sel % S)[:, :, None].expand(Q, WB, Wd))
            ham = torch.sum(popcount32(cand_sk ^ q_sk[:, :, None, :]), dim=-1,
                            dtype=torch.int32).reshape(Q, WL)
            if filter_type == "none":
                # FilterType::None (collection.hpp:670-712): no sketch test
                passes = valid
            else:
                brute_lane = brute_blk[:, :, None].expand(Q, WB, G).reshape(Q, WL)
                passes = valid & (brute_lane | (ham <= maxdiff[:, None]))

            # --- phase 2: consume whole blocks until ~chunk passing
            # candidates (collection.hpp:775-781; at least one block),
            # compact, rescore and merge them ---
            pb = passes.view(Q, WB, G).sum(dim=2, dtype=torch.int32)
            consumed = torch.clamp(
                (torch.cumsum(pb, dim=1) <= chunk).sum(dim=1, dtype=torch.int32), min=1)
            in_window = (blk_iota[None, :] < consumed[:, None])[:, :, None].expand(
                Q, WB, G).reshape(Q, WL)
            took = passes & in_window
            compact_ids = _compact_take(took, cand_ids, cap=CB, n_sentinel=n)
            sims = _score_candidates(index, queries_n, queries_q8,
                                     torch.clamp(compact_ids, 0, n - 1))
            topk_sims, topk_ids = _merge_topk(topk_sims, topk_ids, compact_ids, sims,
                                              n_sentinel=n)
            dc = dc + took.sum(dim=1, dtype=torch.int32)
            cand_ct = cand_ct + (valid & in_window).sum(dim=1, dtype=torch.int32)

            # --- advance the cursor; termination against the member's own
            # cursor (collection.hpp:927-943) ---
            off_new = off + consumed
            mcur_new = (mend <= off_new[:, None]).sum(dim=1, dtype=torch.int32)
            mcur_idx = torch.clamp(mcur_new, max=RG - 1)
            r_star = count_leq(fc, off_new[:, None])[:, 0]
            local_r = r_star - mcur_idx * M  # ranges consumed IN the member
            depth_cur = torch.clamp(d_top - torch.div(local_r, L, rounding_mode="floor"),
                                    min=min_depth)
            tables_consumed = (local_r % L).to(torch.float32)

            kth_sim = topk_sims[:, k - 1] - q8_margin
            p_d = probs_lookup(index, depth_cur, kth_sim)
            p_d1 = probs_lookup(index, depth_cur + 1, kth_sim)
            # at the entry depth the unconsumed tables carry no guarantee
            # yet (collection.hpp:927-930)
            rest = torch.where(depth_cur == d_entry, 0.0,
                               torch.clamp(L - tables_consumed, min=0.0))
            failure = torch.pow(1.0 - p_d, tables_consumed) * torch.pow(1.0 - p_d1, rest)
            cur_brute = take(is_brute_g, mcur_idx[:, None])[:, 0]
            member_done = ~cur_brute & (failure <= stop_at) & (mcur_new < RG)
            # deeper windows skip a delta-satisfied member ...
            msat = msat | ((g_iota[None, :] == mcur_idx[:, None]) & member_done[:, None])
            # ... and the cursor jumps over the rest of its stream
            jump_to = take(mend, mcur_idx[:, None])[:, 0]
            off2 = torch.where(member_done, jump_to, off_new)
            mcur2 = (mend <= off2[:, None]).sum(dim=1, dtype=torch.int32)

            # --- ball-overlap check of every member crossed this iteration
            # (index.rs:342-361), members being entered in the entry window only
            full = topk_ids[:, k - 1] >= 0
            kth_dist = torch.where(full, 2.0 * (1.0 - kth_sim), torch.inf)
            crossed = ((g_iota[None, :] > mcur[:, None]) & (g_iota[None, :] <= mcur2[:, None])
                       & rank_ok[None, :] & ~qdone[:, None] & entry_chunk)
            ball_fire = torch.any(crossed & (minpos_g > kth_dist[:, None]), dim=1)
            dc = dc + crossed.sum(dim=1, dtype=torch.int32) * full.to(torch.int32)
            newly_stopped = ~qdone & full & ball_fire
            stopped = stopped | newly_stopped
            visited = visited + (crossed & ~newly_stopped[:, None]).sum(dim=1, dtype=torch.int32)
            qdone = qdone | stopped | (off2 >= total)
            return (topk_sims, topk_ids, qdone, stopped, off2, mcur2, msat, dc, cand_ct,
                    visited)

        t = (topk_sims, topk_ids, qdone0, stopped0, zero, zero, msat, dc0, cand_ct, visited0)
        iters = syncs = 0
        while True:
            # JAX runs the body while any lane is live, updating done lanes
            # too, so the flag is read before every step
            all_done, all_stopped = torch.stack([torch.all(t[2]), torch.all(t[3])]).tolist()
            syncs += 1
            if all_done:
                break
            t = body(t)
            iters += 1
        topk_sims, topk_ids, _, stopped, _, _, msat, dc, cand_ct, visited = t

        descend = False
        if lazy:
            # the descend decision: a member that stopped at the window edge
            # consumed all L tables at depth d_top - LC + 1, so its failure is
            # (1 - p)^L, one lookup for every exhausted member at once
            d_next = d_top - LC
            p_end = probs_lookup(index, torch.full((Q,), max(d_next + 1, min_depth), device=dev),
                                 topk_sims[:, k - 1])
            end_fail = torch.pow(1.0 - p_end, float(L))
            # a query met at the edge retires all its exhausted members
            msat = msat | ((end_fail <= stop_at)[:, None] & rank_ok[None, :])
            unsat = torch.any(~msat & ~is_brute_g & rank_ok[None, :], dim=1)
            if d_next >= min_depth:
                descend = bool(torch.any(~stopped & unsat))
                syncs += 1
        if not descend:
            msat = torch.zeros_like(msat)
        return ((topk_sims, topk_ids, stopped, msat, dc, cand_ct, visited), descend,
                (iters, syncs), all_stopped)

    zq = torch.zeros((Q,), dtype=torch.int32, device=dev)
    st = (torch.zeros((Q, kk), dtype=torch.float32, device=dev),
          torch.full((Q, kk), -1, dtype=torch.int32, device=dev),
          torch.zeros((Q,), dtype=torch.bool, device=dev),
          torch.zeros((Q, RG), dtype=torch.bool, device=dev),
          zq, zq.clone(), zq.clone())
    gi = ci = steps = 0
    counts = np.zeros(2, np.int64)  # iterations, syncs
    # JAX's outer loop: while not every query stopped and groups remain; a
    # step after every query stopped would change nothing
    while gi < n_groups:
        st, descend, c, all_stopped = window_scan(gi, ci, st)
        steps, counts = steps + 1, counts + c
        gi, ci = (gi, ci + 1) if descend else (gi + 1, 0)
        if all_stopped:
            break
    if loop_stats is not None:
        loop_stats.batches += 1
        loop_stats.outer_steps += steps
        loop_stats.iterations += int(counts[0])
        loop_stats.syncs += int(counts[1])

    topk_sims, topk_ids, _, _, dc, cand_ct, visited = st
    topk_sims, topk_ids = _exact_rescore_topk(index, queries_n, topk_sims, topk_ids, out_k=k)
    return topk_sims, topk_ids, SearchStats(dc, cand_ct, visited)


def search(index, queries, k: int = None, delta: float = None, batch_size: int = 256,
           filter_type: str = "default", loop_stats: Optional[LoopStats] = None):
    """Full clustered-walk search: hash + sketch the queries, walk the
    clusters, return k-NN (clann::search, lib.rs:183-189 -> index.rs:311-439,
    over a batch). Returns numpy (distances ascending (Q, k), ids (Q, k),
    SearchStats); `loop_stats` accumulates the walk's loop counts."""
    if index.pc_hash_params is not None:
        raise NotImplementedError(
            "per-cluster hash functions (a faithful reference import): ROADMAP.md "
            "slice 14 (interop, h5 and CLI)")
    cfg = index.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    source, filterer = index.rebuild_objects()
    q = as_device_f32(queries, index.device)
    if q.dim() == 1:
        q = q[None, :]
    qn = l2_normalize(q)

    def run_block(block):
        with TRACER.span("search/hashing"):
            qh = source.hash(block)
        with TRACER.span("search/sketching"):
            qs = filterer.sketch(block)
        with TRACER.span("search/scan"):
            out = search_batch_impl(
                index, block, qh, qs, delta, k=k, chunk=cfg.candidate_chunk,
                min_depth=cfg.min_depth, filter_type=filter_type,
                filter_expand=cfg.filter_expand, group_ranks=cfg.lsh_group_ranks,
                loop_stats=loop_stats,
            )
            if TRACER.enabled and out[0].is_cuda:
                torch.cuda.synchronize()
        return out

    sims, ids, stats = batched_query_driver(qn, batch_size, run_block)
    dists = 2.0 * (1.0 - sims)  # puffinn_types.rs:77-79 inverse
    dists = np.where(ids < 0, np.inf, dists)
    return dists, ids, stats


def search_by_id(index, point_ids, k: int = None, delta: float = None,
                 exclude_self: bool = True, loop_stats: Optional[LoopStats] = None):
    """k-NN of already-indexed points (collection.hpp:341-356
    search_from_index). With exclude_self the point is removed from its own
    list (one more slot is searched to keep k results)."""
    ids = np.atleast_1d(np.asarray(point_ids, np.int64))
    queries = index.vectors[torch.as_tensor(ids, device=index.device)]
    kk = (k or index.config.k) + (1 if exclude_self else 0)
    dists, out_ids, stats = search(index, queries, k=kk, delta=delta, loop_stats=loop_stats)
    if exclude_self:
        # stable-compact each row's non-self entries to the front and keep
        # k (an id appears at most once per row, so kk or kk-1 remain)
        keep = out_ids != ids[:, None]
        order = np.argsort(~keep, axis=1, kind="stable")
        keep_d = np.take_along_axis(dists, order, axis=1)[:, : kk - 1]
        keep_i = np.take_along_axis(out_ids, order, axis=1)[:, : kk - 1]
        return keep_d.astype(np.float32, copy=False), keep_i.astype(np.int32, copy=False), stats
    return dists, out_ids, stats

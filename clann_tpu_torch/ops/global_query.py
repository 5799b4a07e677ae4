"""Ball-filtered GLOBAL adaptive LSH, the default delta engine (PyTorch port).

Port of ``clann_tpu.ops.global_query`` (see its docstring for the design):
one global PUFFINN adaptive search (collection.hpp:768-948 semantics) over
hash tables sorted by hash across the whole dataset, with CLANN's
clustering acting as a per-candidate feasibility filter — a candidate from
cluster c is dropped before rescoring iff dist(q, center_c) - radius_c >
kth_dist (index.rs:342-361 applied per candidate) — and a full stop when
even the closest ball cannot beat the k-th distance. Guarantee: per point p
with sim(q, p) >= the termination similarity, P(p never collides) <=
1 - delta (independent.hpp:108-119).

What changes from the JAX engine, none of it in the results:

- The `lax.while_loop` is a Python loop of device work. One more body
  step after every query is done changes nothing (cursors are frozen, no
  lane is valid), so the loop pulls its stop flag, and the live cursors'
  maximum, only every SYNC_EVERY iterations: one host sync per SYNC_EVERY
  body steps instead of one per step.
- JAX picks, per iteration, between the precomputed stream map and the
  in-loop derivation with a `lax.cond` on `live_max + WB <= tb`. Cursors
  advance by at most WB blocks per iteration, so from the maximum read at
  the last sync the loop knows on the host, for each of the next steps,
  whether every live cursor still fits the map; where it might not, it
  takes the in-loop derivation, which gives the same values.
- The record gather (JAX's `rec_view[t_sel, blk]`, global_query.py:284)
  goes through K7, `ops.gather.gather_rows` (csrc/gather.cu).
- The ball-feasibility lookup is a plain gather of the (Q, C) booleans
  (JAX contracts a one-hot on the MXU; the values are the same).

`global_search_continuous` is the continuous-batching driver: a fixed set
of lanes, each step advancing them a few iterations and refilling finished
lanes with pending queries (`_global_step_packed`).

With `rescore_dtype="int8"` the loop scores candidates against the int8
shadow `vectors_q8` into a 2k buffer, with the k-th similarity lowered by
the int8 error bound, and `_finalize` re-scores the buffer in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize
from clann_tpu_torch.ops.gather import gather_rows
from clann_tpu_torch.ops.prefixmap import (
    block_stream,
    blocked_window,
    candidate_stream,
    count_leq,
    depth_bounds,
    stream_block_map,
)
from clann_tpu_torch.ops.query import (
    SYNC_EVERY,
    LoopStats,
    SearchStats,
    _compact_take,
    _exact_rescore_topk,
    _merge_topk,
    _score_candidates,
    batched_query_driver,
    probs_lookup,
)
from clann_tpu_torch.ops.sketches import popcount32


def _entry_depth(index, min_depth: int) -> int:
    """Static stream entry depth (see prefixmap.candidate_stream)."""
    n = index.vectors.shape[0]
    D = index.config.max_hashbits
    d_entry = int(np.clip(np.ceil(np.log2(max(2, n))) + 2, min_depth, D))
    if index.config.global_entry_cap > 0:
        d_entry = int(max(min_depth, min(d_entry, index.config.global_entry_cap)))
    return d_entry


def _prepare_streams(index, queries_n, query_hashes, query_sketches, *,
                     min_depth: int) -> dict:
    """Per-query device state of the adaptive loop (leading dim Q, no
    cross-query coupling)."""
    Q = queries_n.shape[0]
    dev = queries_n.device
    D = index.config.max_hashbits
    d_entry = _entry_depth(index, min_depth)
    G = max(1, index.config.gather_block)
    g_log = int(np.log2(G))

    # cluster geometry for the feasibility filter (one f32 matmul)
    center_dist = torch.clamp(1.0 - exact_dot(queries_n, index.centers.T), 0.0, 2.0)
    feas_bound = center_dist - index.radii[None, :]  # (Q, C)
    ball_floor = torch.min(feas_bound, dim=1).values  # (Q,) full-stop threshold

    zero = torch.zeros((Q,), dtype=torch.int32, device=dev)
    # table width, not len(vectors): pending insertions are not in the tables
    full_n = torch.full((Q,), index.g_sorted_hash.shape[1], dtype=torch.int32, device=dev)
    lo, hi = depth_bounds(
        index.g_sorted_hash, query_hashes, zero, full_n, D, index.g_dir_iters,
        up_to_depth=d_entry, prefix_dir=index.g_dir, cluster=zero,
        dir_bits=index.config.global_dir_bits,
    )  # (Q, L, d_entry+1)
    starts_s, sizes_s = candidate_stream(lo, hi, query_hashes, D, min_depth,
                                         start_depth=d_entry)  # (Q, M)
    bstarts, bcounts = block_stream(starts_s, sizes_s, g_log)
    fc = torch.cumsum(bcounts, dim=1, dtype=torch.int32)  # cumulative block counts
    streams = {
        "qn": queries_n,
        "qsk": query_sketches,
        "feas_bound": feas_bound,
        "ball_floor": ball_floor,
        "starts": starts_s,
        "sizes": sizes_s,
        "bstarts": bstarts,
        "fc": fc,
        "total": fc[:, -1],
    }
    if index.vectors_q8 is not None:
        from clann_tpu_torch.core.index import quantize_q8

        streams["q8"] = quantize_q8(queries_n)
    return streams


def _buffer_depth(index, k: int) -> int:
    """The loop's top-k buffer: 2k under int8 scoring (the reference's 2k
    MaxBuffer, maxbuffer.hpp:25), else k."""
    return k if index.vectors_q8 is None else 2 * k


def _init_state(Q: int, kk: int, total: torch.Tensor) -> tuple:
    dev = total.device
    z = torch.zeros((Q,), dtype=torch.int32, device=dev)
    return (
        torch.zeros((Q, kk), dtype=torch.float32, device=dev),
        torch.full((Q, kk), -1, dtype=torch.int32, device=dev),
        total <= 0,
        z, z.clone(), z.clone(),
    )


def _record_window(streams: dict, records: torch.Tensor, *, gather_block: int, wb: int,
                   dense_index: bool, routing: bool):
    """fetch(qdone, off, use_map) -> (t_sel (Q, WB), rec (Q, WB, G, R),
    valid (Q, WB * G)): the next WB stream blocks of every query, mapped to
    (table, block, lane mask) from the stream map (`use_map`; the caller
    guarantees every live cursor + WB fits it) or by the in-loop
    derivation (prefixmap.blocked_window, the same values), and their G
    packed records of R words each, fetched with one row gather per block
    (K7, ops.gather.gather_rows). With `routing` the dead blocks (done
    queries, fully masked edge blocks) fetch table 0's block 0; `valid`
    masks every consumer of their words. Shared by both global engines
    (cosine, ops/global_query.py; Jaccard, core/jaccard.py)."""
    starts_s, sizes_s = streams["starts"], streams["sizes"]
    bstarts, fc = streams["bstarts"], streams["fc"]
    smap = streams.get("smap")
    Q, dev = fc.shape[0], fc.device
    L, n_pad, R = records.shape
    G = gather_block
    if n_pad % G:
        raise ValueError(
            "the records' slot axis is not a multiple of config.gather_block; "
            "build them with pad_to=gather_block"
        )
    nb = n_pad // G
    rec_flat = records.view(L * nb, G * R)  # (L, n_pad, R) -> block rows
    g_log = int(np.log2(G))
    blk_iota = torch.arange(wb, dtype=torch.int32, device=dev)
    lane_iota = torch.arange(G, dtype=torch.int32, device=dev)

    def window(off, use_map):
        if use_map:
            # one contiguous slice of the precomputed map per query
            tb = smap.shape[1]
            pos = torch.clamp(off, 0, tb - wb)[:, None].to(torch.int64) + blk_iota
            win = torch.gather(smap, 1, pos[:, :, None].expand(Q, wb, 3))
            lm = win[..., 2]
            lane_valid = ((lm[:, :, None] >> lane_iota) & 1) != 0  # (Q, WB, G)
            return win[..., 0], win[..., 1], lane_valid
        j, blk, _, lane_valid = blocked_window(
            fc, off, wb, bstarts, starts_s, sizes_s, g_log, dense_index=dense_index)
        return (j % L), blk, lane_valid

    def fetch(qdone, off, use_map: bool):
        t_sel, blk, lane_valid = window(off, use_map)
        if routing:
            block_live = lane_valid.any(dim=2) & ~qdone[:, None]
            blk = torch.where(block_live, blk, 0)
            t_sel = torch.where(block_live, t_sel, 0)
        valid = (lane_valid & ~qdone[:, None, None]).reshape(Q, wb * G)
        fidx = (t_sel * nb + torch.clamp(blk, 0, nb - 1)).to(torch.int32)
        rec = gather_rows(rec_flat, fidx.reshape(-1)).view(Q, wb, G, R)
        return t_sel, rec, valid

    return fetch


def _consumer(*, wb: int, gather_block: int, chunk: int, device):
    """consume(passes (Q, WB * G)) -> (blocks consumed (Q,), lanes in the
    consumed blocks (Q, WB * G)): whole blocks from the window's front
    until ~chunk passing candidates accumulate, at least one block so the
    cursor advances (collection.hpp:775-781)."""
    G = gather_block
    blk_iota = torch.arange(wb, dtype=torch.int32, device=device)

    def consume(passes):
        Q = passes.shape[0]
        pb = passes.view(Q, wb, G).sum(dim=2, dtype=torch.int32)
        consumed = torch.clamp(
            (torch.cumsum(pb, dim=1) <= chunk).sum(dim=1, dtype=torch.int32), min=1)
        in_window = (blk_iota[None, :] < consumed[:, None])[:, :, None].expand(
            Q, wb, G).reshape(Q, wb * G)
        return consumed, in_window

    return consume


def _loop_pieces(index, streams: dict, delta, *, k: int, chunk: int,
                 min_depth: int, filter_type: str, filter_expand: int):
    """(cond, body) of the adaptive probe loop over `streams`' queries.

    State tuple: (topk_sims (Q,kk), topk_ids, qdone, off, dc, cand_ct).
    cond(state) is a 0-d device bool (some query still live); body(state,
    use_map) runs one iteration, reading the stream map when `use_map`
    (the caller guarantees every live cursor + WB fits the map).
    """
    queries_n = streams["qn"]
    query_sketches = streams["qsk"]
    feas_bound = streams["feas_bound"]
    ball_floor = streams["ball_floor"]
    fc, total = streams["fc"], streams["total"]
    queries_q8 = streams.get("q8")
    dev = queries_n.device

    Q = queries_n.shape[0]
    L = index.g_sorted_hash.shape[0]
    n = index.vectors.shape[0]
    S = index.sketches.shape[1]
    C = feas_bound.shape[1]
    d_entry = _entry_depth(index, min_depth)
    # blocked gather: G consecutive records per gather lane; the stream
    # cursor runs in block units (prefixmap.block_stream)
    G = max(1, index.config.gather_block)
    WB = max(1, (chunk * filter_expand) // G)  # window width in blocks
    WL = WB * G  # window width in record lanes
    CB = chunk + G  # compacted rescore capacity (block-granular overshoot)
    Wd = index.sketches.shape[2]
    # record layout: [id, sketch words..., cluster] (make_global_tables)
    fetch = _record_window(streams, index.g_records, gather_block=G, wb=WB,
                           dense_index=index.config.window_index_dense,
                           routing=index.config.dead_block_routing)
    consume = _consumer(wb=WB, gather_block=G, chunk=chunk, device=dev)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    stop_at = 1.0 - delta  # f32, as the JAX engine's 1.0 - delta
    # int8 k-th overestimation margin (see ops/query.py's walk): an inflated
    # k-th would irreversibly prune feasible balls and candidates
    q8_margin = float(np.sqrt(queries_n.shape[1])) / 127.0 if queries_q8 is not None else 0.0

    def cond(s):
        return ~torch.all(s[2])

    def kth(topk_sims, topk_ids):
        kth_sim = topk_sims[:, k - 1] - q8_margin
        full = topk_ids[:, k - 1] >= 0
        kth_dist = torch.where(full, 2.0 * (1.0 - kth_sim), torch.inf)
        return kth_sim, full, kth_dist

    def body(s, use_map: bool):
        topk_sims, topk_ids, qdone, off, dc, cand_ct = s
        t_sel, rec, valid = fetch(qdone, off, use_map)
        cand_ids = rec[..., 0].reshape(Q, WL)
        cand_cluster = torch.clamp(rec[..., 1 + Wd].reshape(Q, WL), 0, C - 1)

        kth_sim, full, kth_dist = kth(topk_sims, topk_ids)
        maxdiff = index.maxdiff_table[torch.clamp(
            (kth_sim / index.sim_eps).to(torch.int64), 0, index.maxdiff_table.shape[0] - 1)]
        # the query sketch is constant across a block's G lanes
        q_sk = torch.gather(query_sketches, 1,
                            (t_sel % S).to(torch.int64)[:, :, None].expand(Q, WB, Wd))
        ham = torch.sum(popcount32(rec[..., 1 : 1 + Wd] ^ q_sk[:, :, None, :]),
                        dim=-1, dtype=torch.int32).reshape(Q, WL)
        # per-candidate ball feasibility (index.rs:342-361 per candidate)
        ok = feas_bound <= kth_dist[:, None]  # (Q, C)
        feas = torch.gather(ok, 1, cand_cluster.to(torch.int64))
        passes = valid & feas
        if filter_type != "none":
            passes = passes & (ham <= maxdiff[:, None])

        consumed, in_window = consume(passes)
        take = passes & in_window
        compact_ids = _compact_take(take, cand_ids, cap=CB, n_sentinel=n)
        sims = _score_candidates(index, queries_n, queries_q8,
                                 torch.clamp(compact_ids, 0, n - 1))
        topk_sims, topk_ids = _merge_topk(topk_sims, topk_ids, compact_ids, sims, n_sentinel=n)

        dc = dc + take.sum(dim=1, dtype=torch.int32)
        cand_ct = cand_ct + (valid & in_window).sum(dim=1, dtype=torch.int32)

        # finished queries' cursors stay frozen
        off_new = torch.where(qdone, off, off + consumed)
        exhausted = off_new >= total
        r_star = count_leq(fc, off_new[:, None])[:, 0]
        depth_cur = torch.clamp(d_entry - torch.div(r_star, L, rounding_mode="floor"),
                                min=min_depth)
        tables_consumed = (r_star % L).to(torch.float32)

        kth_sim, full, kth_dist = kth(topk_sims, topk_ids)
        p_d = probs_lookup(index, depth_cur, kth_sim)
        p_d1 = probs_lookup(index, depth_cur + 1, kth_sim)
        rest = torch.where(depth_cur == d_entry, 0.0,
                           torch.clamp(L - tables_consumed, min=0.0))
        failure = torch.pow(1.0 - p_d, tables_consumed) * torch.pow(1.0 - p_d1, rest)
        ball_stop = full & (ball_floor > kth_dist)
        qdone = qdone | (failure <= stop_at) | exhausted | ball_stop
        return (topk_sims, topk_ids, qdone, off_new, dc, cand_ct)

    return cond, body


def _finalize(index, streams, state, *, k):
    """Exact rescore + per-run stats from a finished loop state."""
    topk_sims, topk_ids, _, _, dc, cand_ct = state
    topk_sims, topk_ids = _exact_rescore_topk(index, streams["qn"], topk_sims, topk_ids,
                                              out_k=k)
    # clusters still feasible at the final kth (clusters_visited's analog)
    kth_dist = torch.where(topk_ids[:, k - 1] >= 0, 2.0 * (1.0 - topk_sims[:, k - 1]),
                           torch.inf)
    visited = torch.sum(streams["feas_bound"] <= kth_dist[:, None], dim=1, dtype=torch.int32)
    return topk_sims, topk_ids, SearchStats(dc, cand_ct, visited)


def _advance(cond, body, state, *, tb: int, wb: int, max_iters: Optional[int] = None):
    """Run body while some query is live (and at most `max_iters` steps):
    the stop flag and the live cursors' maximum are read once per
    SYNC_EVERY steps; a step may read the stream map where every live
    cursor + its WB blocks still fit it. Steps past the last live query
    change nothing (frozen cursors, no valid lane). Returns (state,
    iterations, host syncs)."""
    iters = syncs = 0
    while max_iters is None or iters < max_iters:
        qdone, off = state[2], state[3]
        live, live_max = torch.stack([
            cond(state).to(torch.int64),
            torch.max(torch.where(qdone, 0, off)).to(torch.int64),
        ]).tolist()  # the one host sync per SYNC_EVERY steps
        syncs += 1
        if not live:
            break
        steps = SYNC_EVERY if max_iters is None else min(SYNC_EVERY, max_iters - iters)
        for j in range(steps):
            # cursors move at most WB blocks per step
            state = body(state, tb > 0 and live_max + (j + 1) * wb <= tb)
            iters += 1
    return state, iters, syncs


def _run_loop(index, streams, delta, *, k, chunk, min_depth, filter_type,
              filter_expand, loop_stats: Optional[LoopStats] = None):
    """The adaptive loop + finalize over prepared (possibly mapped) streams."""
    Q = streams["qn"].shape[0]
    cond, body = _loop_pieces(
        index, streams, delta, k=k, chunk=chunk, min_depth=min_depth,
        filter_type=filter_type, filter_expand=filter_expand,
    )
    G = max(1, index.config.gather_block)
    tb = streams["smap"].shape[1] if "smap" in streams else 0
    state = _init_state(Q, _buffer_depth(index, k), streams["total"])
    state, iters, syncs = _advance(cond, body, state, tb=tb,
                                   wb=max(1, (chunk * filter_expand) // G))
    if loop_stats is not None:
        loop_stats.batches += 1
        loop_stats.iterations += iters
        loop_stats.syncs += syncs
    return _finalize(index, streams, state, k=k)


def global_search_batch_impl(index, queries_n, query_hashes, query_sketches, delta, *,
                             k: int, chunk: int, min_depth: int = 1,
                             filter_type: str = "default", filter_expand: int = 8,
                             static_map_tb: int = 0,
                             loop_stats: Optional[LoopStats] = None):
    """Search a pre-hashed query batch on the global tables.

    Returns (sims desc (Q, k), ids (Q, k) int32, SearchStats) tensors.
    static_map_tb > 0 attaches the stream map at that position count
    without a host sync; cursors past it take the in-loop derivation.
    """
    streams = _prepare_streams(index, queries_n, query_hashes, query_sketches,
                               min_depth=min_depth)
    G = max(1, index.config.gather_block)
    if static_map_tb > 0 and index.config.stream_map and G <= 32:
        streams = _attach_stream_map(streams, g=int(np.log2(G)),
                                     L=index.g_sorted_hash.shape[0], tb=static_map_tb)
    return _run_loop(index, streams, delta, k=k, chunk=chunk, min_depth=min_depth,
                     filter_type=filter_type, filter_expand=filter_expand,
                     loop_stats=loop_stats)


def _attach_stream_map(streams: dict, *, g: int, L: int, tb: int) -> dict:
    """streams + the precomputed position map (prefixmap.stream_block_map)."""
    smap = stream_block_map(streams["fc"], streams["bstarts"], streams["starts"],
                            streams["sizes"], g, L, tb)
    return {**streams, "smap": smap}


def _map_tb(total_max: int, cap: int, wb: int, q: int) -> int:
    """Position count (map depth) of a batch's stream maps: pow2-rounded
    past the batch's deepest stream, capped by `cap`
    (config.stream_map_blocks) and by a ~512 MB map footprint (12 bytes
    per (query, position)), floored by the window width `wb`. JAX's sizing
    rule verbatim; every cap is a performance choice, not a correctness one."""
    tb = max(1024, 1 << int(max(0, total_max)).bit_length())
    tb = min(tb, max(1024, cap))
    mem_cap = (512 << 20) // (12 * max(1, q))
    tb = min(tb, 1 << max(0, int(mem_cap).bit_length() - 1))
    tb = max(tb, 1 << max(0, wb - 1).bit_length())
    return tb


def global_search_batch_mapped(index, queries_n, query_hashes, query_sketches, delta, *,
                               k: int, chunk: int, min_depth: int = 1,
                               filter_type: str = "default", filter_expand: int = 8,
                               loop_stats: Optional[LoopStats] = None):
    """global_search_batch_impl with the precomputed stream maps, sized
    from the batch's deepest stream: one host pull of `total_max` per batch
    (global_query.py:580). Per-query results equal the unmapped path's.
    Used when config.stream_map is on and gather_block <= 32."""
    G = max(1, index.config.gather_block)
    if G > 32 or not index.config.stream_map:
        return global_search_batch_impl(
            index, queries_n, query_hashes, query_sketches, delta, k=k, chunk=chunk,
            min_depth=min_depth, filter_type=filter_type, filter_expand=filter_expand,
            loop_stats=loop_stats,
        )
    streams = _prepare_streams(index, queries_n, query_hashes, query_sketches,
                               min_depth=min_depth)
    total_max = int(torch.max(streams["total"]))
    if loop_stats is not None:
        loop_stats.syncs += 1
    wb = max(1, (chunk * filter_expand) // G)
    tb = _map_tb(total_max, index.config.stream_map_blocks, wb, queries_n.shape[0])
    streams = _attach_stream_map(streams, g=int(np.log2(G)),
                                 L=index.g_sorted_hash.shape[0], tb=tb)
    return _run_loop(index, streams, delta, k=k, chunk=chunk, min_depth=min_depth,
                     filter_type=filter_type, filter_expand=filter_expand,
                     loop_stats=loop_stats)


def difficulty(index, query_hashes, *, d_entry: int, min_depth: int) -> torch.Tensor:
    """Per-query total stream length (in slots), the batch-cost driver.

    The adaptive loop runs to the SLOWEST query of a batch, so sorting a
    query set by this total before batching groups queries of similar
    depth. Same table width and entry cap as the engine.
    """
    n = index.g_sorted_hash.shape[1]
    Q = query_hashes.shape[0]
    dev = query_hashes.device
    zero = torch.zeros((Q,), dtype=torch.int32, device=dev)
    full_n = torch.full((Q,), n, dtype=torch.int32, device=dev)
    lo, hi = depth_bounds(
        index.g_sorted_hash, query_hashes, zero, full_n, index.config.max_hashbits,
        index.g_dir_iters, up_to_depth=d_entry, prefix_dir=index.g_dir, cluster=zero,
        dir_bits=index.config.global_dir_bits,
    )
    _, sizes = candidate_stream(lo, hi, query_hashes, index.config.max_hashbits,
                                min_depth, start_depth=d_entry)
    return torch.sum(sizes, dim=1)


def global_search(
    index,
    queries,
    k: int = None,
    delta: float = None,
    batch_size: int = 256,
    filter_type: str = "default",
    sort_by_difficulty: bool = False,
    loop_stats: Optional[LoopStats] = None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Full global-engine search: hash + sketch, one adaptive loop per batch.

    Returns numpy (distances (Q, k) ascending, ids (Q, k), SearchStats).
    batch_size defaults to the JAX package's 256 (there it avoids a TPU
    worker fault); the engine is batch-invariant, so any size gives the
    same per-query results. `loop_stats` (a LoopStats) accumulates the
    loops' iterations and host syncs.
    """
    from clann_tpu_torch.errors import DataError

    if index.g_records is None:
        raise DataError(
            "index lacks global LSH structures; build with config.lsh_engine='global'"
        )
    cfg = index.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    source, filterer = index.rebuild_objects()

    q = as_device_f32(queries, index.device)
    if q.dim() == 1:
        q = q[None, :]
    qn = l2_normalize(q)

    perm = None
    if sort_by_difficulty and qn.shape[0] > batch_size:
        tot = difficulty(index, source.hash(qn), d_entry=_entry_depth(index, cfg.min_depth),
                         min_depth=cfg.min_depth)
        perm = np.argsort(tot.cpu().numpy(), kind="stable")
        qn = qn[torch.as_tensor(perm, device=qn.device)]

    def run_block(block):
        return global_search_batch_mapped(
            index, block, source.hash(block), filterer.sketch(block), delta,
            k=k, chunk=cfg.candidate_chunk, min_depth=cfg.min_depth,
            filter_type=filter_type, filter_expand=cfg.filter_expand,
            loop_stats=loop_stats,
        )

    sims, ids, stats = batched_query_driver(qn, batch_size, run_block)
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        sims, ids = sims[inv], ids[inv]
        stats = SearchStats(*(np.asarray(f)[inv] for f in stats))
    dists = 2.0 * (1.0 - sims)
    dists = np.where(ids < 0, np.inf, dists)
    return dists, ids, stats


def _global_step_packed(index, streams_all: dict, state_all: tuple, active: torch.Tensor,
                        delta, *, k: int, chunk: int, min_depth: int, filter_type: str,
                        filter_expand: int, max_iters: int,
                        loop_stats: Optional[LoopStats] = None):
    """Advance the `active` lanes by at most `max_iters` loop iterations.

    The continuous-batching step (JAX global_query.py:603-649): the active
    rows of every stream and state tensor of the whole query set form a
    lane batch, the bounded adaptive loop advances it, and the lanes' state
    is written back into the full state in place. `active` never holds a
    query twice, so the write-back is well defined. Returns (state_all,
    the lanes' qdone flags).
    """
    lane_streams = {name: t[active] for name, t in streams_all.items()}
    lane_state = tuple(t[active] for t in state_all)
    cond, body = _loop_pieces(
        index, lane_streams, delta, k=k, chunk=chunk, min_depth=min_depth,
        filter_type=filter_type, filter_expand=filter_expand,
    )
    G = max(1, index.config.gather_block)
    tb = lane_streams["smap"].shape[1] if "smap" in lane_streams else 0
    lane_state, iters, syncs = _advance(cond, body, lane_state, tb=tb,
                                        wb=max(1, (chunk * filter_expand) // G),
                                        max_iters=max_iters)
    for full, lane in zip(state_all, lane_state):
        full[active] = lane
    if loop_stats is not None:
        loop_stats.outer_steps += 1
        loop_stats.iterations += iters
        loop_stats.syncs += syncs
    return state_all, lane_state[2]


def global_search_continuous(
    index,
    queries,
    k: int = None,
    delta: float = None,
    lanes: int = 256,
    step_iters: int = 8,
    filter_type: str = "default",
    prepare_batch: int = 2048,
    loop_stats: Optional[LoopStats] = None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Continuous-batching global search: keep every loop lane busy.

    The batched driver runs each batch's loop to its slowest query. Here a
    fixed set of `lanes` lanes advances by at most `step_iters` iterations
    per step, and between steps finished queries are swapped out for
    pending ones, until the queue drains (JAX global_query.py:770-891).
    Per-query results are those of global_search: the loop carries no
    cross-query state, so scheduling cannot change any query's walk (the
    reference's dynamic scheduling over per-query searches,
    collection.hpp:479-481). Every query's streams are prepared up front
    in slabs of `prepare_batch`, with one stream map for the whole set;
    per step the host sends the lane -> query indices and reads the lanes'
    done flags. With Q <= lanes it is global_search(batch_size=lanes), as
    in JAX.

    Returns numpy (distances (Q, k) ascending, ids (Q, k), SearchStats).
    `loop_stats` counts one batch, a step per outer step, the body's
    iterations and the host syncs (stop flags, done flags, map sizing).
    """
    from clann_tpu_torch.errors import DataError

    if index.g_records is None:
        raise DataError(
            "index lacks global LSH structures; build with config.lsh_engine='global'"
        )
    cfg = index.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    source, filterer = index.rebuild_objects()

    q = as_device_f32(queries, index.device)
    if q.dim() == 1:
        q = q[None, :]
    qn = l2_normalize(q)
    Q = qn.shape[0]
    if Q <= lanes:
        # a single batch cannot be repacked (JAX passes the normalized queries)
        return global_search(index, qn, k=k, delta=delta, batch_size=lanes,
                             filter_type=filter_type, loop_stats=loop_stats)

    slabs = []
    for s in range(0, Q, prepare_batch):
        block = qn[s : s + prepare_batch]
        slabs.append(_prepare_streams(index, block, source.hash(block), filterer.sketch(block),
                                      min_depth=cfg.min_depth))
    streams_all = {name: torch.cat([sl[name] for sl in slabs], dim=0) for name in slabs[0]}
    del slabs
    syncs = 0
    G = max(1, cfg.gather_block)
    if cfg.stream_map and G <= 32:
        # one map depth for the whole set; lanes pick up map rows like any
        # other stream row (_map_tb bounds the (Q, tb) footprint)
        total_max = int(torch.max(streams_all["total"]))
        syncs += 1
        wb = max(1, (cfg.candidate_chunk * cfg.filter_expand) // G)
        tb = _map_tb(total_max, cfg.stream_map_blocks, wb, Q)
        streams_all = _attach_stream_map(streams_all, g=int(np.log2(G)),
                                         L=index.g_sorted_hash.shape[0], tb=tb)
    state_all = _init_state(Q, _buffer_depth(index, k), streams_all["total"])

    # lane scheduling on the host, O(lanes) per step. A lane whose query is
    # done, with no pending query left, keeps its assignment: its qdone
    # row masks all its work.
    active = np.arange(lanes, dtype=np.int64)
    next_q = lanes
    stats = LoopStats() if loop_stats is None else loop_stats
    while True:
        state_all, lane_done = _global_step_packed(
            index, streams_all, state_all, torch.tensor(active, device=qn.device), delta,
            k=k, chunk=cfg.candidate_chunk, min_depth=cfg.min_depth,
            filter_type=filter_type, filter_expand=cfg.filter_expand,
            max_iters=step_iters, loop_stats=stats,
        )
        done_np = lane_done.cpu().numpy()
        syncs += 1
        refilled = False
        if next_q < Q:
            for i in np.nonzero(done_np)[0]:
                if next_q >= Q:
                    break
                active[i] = next_q
                next_q += 1
                refilled = True
        # stop only on a step that finished all its lanes and refilled none:
        # refilled lanes hold unstarted queries
        if not refilled and done_np.all():
            break
    stats.batches += 1
    stats.syncs += syncs

    sims, ids, st = _finalize(index, streams_all, state_all, k=k)
    sims, ids = sims.cpu().numpy(), ids.cpu().numpy()
    st = SearchStats(*(f.cpu().numpy() for f in st))
    dists = 2.0 * (1.0 - sims)
    dists = np.where(ids < 0, np.inf, dists)
    return dists, ids, st

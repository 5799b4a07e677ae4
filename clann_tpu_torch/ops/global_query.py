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
- `global_search`'s batches on a card replay each loop body from a CUDA
  graph captured over persistent buffers (`_BodyGraphs`, one graph a body
  form) instead of issuing its ~80 small ops one by one; the same kernels
  on the same inputs, so the same results. The sharded and continuous
  loops, the Jaccard engine and CPU tensors issue the body op by op.
- The window's record gather (JAX's `rec_view[t_sel, blk]`,
  global_query.py:284), its sketch and ball filters and the take run as one
  kernel, the window filter (`ops.window_filter`, csrc/window_filter.cu),
  which looks the ball feasibility up in a bit table (JAX contracts a
  one-hot on the MXU; the values are the same). Its plain version, which
  CPU tensors take, is the torch chain the loop ran before, over K7.
- The candidates' scoring and the top-k merge run as one kernel, the
  score-and-merge (`ops.score_merge`, csrc/score_merge.cu), which reads
  only the distinct live candidates' rows (JAX gathers and scores every
  compacted slot); its f32 dots sum in another order than cuBLAS's, its
  int8 sims and every merge decision are the torch chain's, which CPU
  tensors take.

The batch entry points `global_search_batch_impl` (a static map, the
shard bodies'), `global_search_batch_mapped` (a map sized from the batch)
and `global_search_batch_graphed` (the same in the graphs' buffers, the
card's) share one runner, `_run_loop` (`_advance`, which counts the loop,
then a finalize), with core/jaccard; the window width is
`query.window_blocks` and the map's depth `map_depth` for all of them.
`global_search_continuous` is the continuous-batching driver: a fixed set
of lanes, each step advancing them a few iterations and refilling finished
lanes with pending queries (`_global_step_packed`).

With `rescore_dtype="int8"` the loop scores candidates against the int8
shadow `vectors_q8` into a 2k buffer, with the k-th similarity lowered by
the int8 error bound, and `_finalize` re-scores the buffer in f32.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.metrics.trace import TRACER
from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize
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
    _exact_rescore_topk,
    batched_query_driver,
    probs_lookup,
    sims_to_dists,
    window_blocks,
)
from clann_tpu_torch.ops import score_merge as tsm
from clann_tpu_torch.ops import window_filter as twf
from clann_tpu_torch.ops.score_merge import score_merge
from clann_tpu_torch.ops.window_filter import pack_window, window_filter
from clann_tpu_torch.parallel.mesh import host_read


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
    with TRACER.span("engine/bounds"):
        lo, hi = depth_bounds(
            index.g_sorted_hash, query_hashes, zero, full_n, D, index.g_dir_iters,
            up_to_depth=d_entry, prefix_dir=index.g_dir, cluster=zero,
            dir_bits=index.config.global_dir_bits,
        )  # (Q, L, d_entry+1)
    with TRACER.span("engine/streams"):
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


def _reset_state(state: tuple, total: torch.Tensor) -> None:
    """`_init_state`'s values, written into `state` in place."""
    topk_sims, topk_ids, qdone, off, dc, cand_ct = state
    topk_sims.zero_()
    topk_ids.fill_(-1)
    torch.le(total, 0, out=qdone)
    for t in (off, dc, cand_ct):
        t.zero_()


def derived_window(streams: dict, off: torch.Tensor, *, wb: int, gather_block: int,
                   tables: int, dense_index: bool) -> torch.Tensor:
    """The next WB stream blocks at the cursors `off` by the in-loop
    derivation (prefixmap.blocked_window), packed as the stream map's
    entries for the window filter."""
    j, blk, _, lane_valid = blocked_window(
        streams["fc"], off, wb, streams["bstarts"], streams["starts"], streams["sizes"],
        int(np.log2(gather_block)), dense_index=dense_index)
    return pack_window(j % tables, blk, lane_valid)


def _loop_pieces(index, streams: dict, delta, *, k: int, chunk: int,
                 min_depth: int, filter_type: str, filter_expand: int,
                 loop_stats: Optional[LoopStats] = None):
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
    # the records scored: the int8 shadows under int8 rescoring
    score_operands = ((index.vectors, queries_n) if queries_q8 is None
                      else (index.vectors_q8, queries_q8))
    dev = queries_n.device

    L = index.g_sorted_hash.shape[0]
    n = index.vectors.shape[0]
    d_entry = _entry_depth(index, min_depth)
    # blocked gather: G consecutive records per gather lane; the stream
    # cursor runs in block units (prefixmap.block_stream)
    G = max(1, index.config.gather_block)
    WB = window_blocks(chunk, filter_expand, G)
    CB = chunk + G  # compacted rescore capacity (block-granular overshoot)
    smap = streams.get("smap")
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
        # the phases' spans keep each under a few hundred profiler events
        topk_sims, topk_ids, qdone, off, dc, cand_ct = s
        with TRACER.span("engine/filter"):
            kth_sim, _, kth_dist = kth(topk_sims, topk_ids)
            maxdiff = index.maxdiff_table[torch.clamp(
                (kth_sim / index.sim_eps).to(torch.int64), 0, index.maxdiff_table.shape[0] - 1)]
            # record layout: [id, sketch words..., cluster] (make_global_tables)
            compact_ids, consumed, taken, seen = window_filter(
                index.g_records, smap if use_map else derived_window(
                    streams, off, wb=WB, gather_block=G, tables=L,
                    dense_index=index.config.window_index_dense), off, qdone,
                query_sketches, feas_bound, kth_dist, maxdiff, gather_block=G, wb=WB,
                chunk=chunk, cap=CB, n_sentinel=n, use_filter=filter_type != "none",
                routing=index.config.dead_block_routing, loop_stats=loop_stats)
        with TRACER.span("engine/score"):
            topk_sims, topk_ids = score_merge(
                *score_operands, topk_sims, topk_ids, compact_ids, n_sentinel=n,
                loop_stats=loop_stats)

        with TRACER.span("engine/stop"):
            dc = dc + taken
            cand_ct = cand_ct + seen

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


def _advance(cond, body, state, *, tb: int, wb: int, loop_stats: Optional[LoopStats],
             max_iters: Optional[int] = None):
    """Run body while some query is live (and at most `max_iters` steps):
    the stop flag and the live cursors' maximum are read once per
    SYNC_EVERY steps; a step may read the stream map where every live
    cursor + its WB blocks still fit it. Steps past the last live query
    change nothing (frozen cursors, no valid lane). Returns the state;
    its iterations, host syncs and iterations without the map are counted
    into `loop_stats`."""
    iters = syncs = unmapped = 0
    while max_iters is None or iters < max_iters:
        qdone, off = state[2], state[3]
        with TRACER.span("engine/read"):  # the one host sync per SYNC_EVERY steps
            live, live_max = host_read(torch.stack([
                cond(state).to(torch.int64),
                torch.max(torch.where(qdone, 0, off)).to(torch.int64),
            ]).tolist)
        syncs += 1
        if not live:
            break
        steps = SYNC_EVERY if max_iters is None else min(SYNC_EVERY, max_iters - iters)
        for j in range(steps):
            # cursors move at most WB blocks per step
            use_map = tb > 0 and live_max + (j + 1) * wb <= tb
            with TRACER.span("engine/body"):
                state = body(state, use_map)
            iters += 1
            unmapped += not use_map
    if loop_stats is not None:
        loop_stats.iterations += iters
        loop_stats.syncs += syncs
        loop_stats.unmapped_iterations += unmapped
    return state


def _run_loop(streams: dict, cond, body, state, finalize, *, wb: int,
              loop_stats: Optional[LoopStats]):
    """One batch of a delta engine (this module's and core/jaccard's):
    `cond` / `body` (eager, or a graph replayer) from `state` over the
    prepared, possibly mapped, `streams` until no query is live, counted
    into `loop_stats` as a batch, then the engine's `finalize(state)`."""
    tb = streams["smap"].shape[1] if "smap" in streams else 0
    state = _advance(cond, body, state, tb=tb, wb=wb, loop_stats=loop_stats)
    if loop_stats is not None:
        loop_stats.batches += 1
    with TRACER.span("engine/finalize"):
        return finalize(state)


def _search_prepared(index, streams: dict, delta, *, loop_stats: Optional[LoopStats],
                     graphs: Optional["_BodyGraphs"] = None, **pieces):
    """The cosine engine's batch over prepared streams (`pieces`: k, chunk,
    min_depth, filter_type, filter_expand); with `graphs` (loaded with
    those streams) each body is a graph replay."""
    if graphs is None:
        cond, body = _loop_pieces(index, streams, delta, loop_stats=loop_stats, **pieces)
        state = _init_state(streams["total"].shape[0], _buffer_depth(index, pieces["k"]),
                            streams["total"])
    else:
        cond, body, state = graphs.cond, graphs.replayer(loop_stats), graphs.state
    wb = window_blocks(pieces["chunk"], pieces["filter_expand"], index.config.gather_block)
    return _run_loop(streams, cond, body, state,
                     lambda s: _finalize(index, streams, s, k=pieces["k"]),
                     wb=wb, loop_stats=loop_stats)


def _attach_stream_map(streams: dict, *, g: int, L: int, tb: int) -> dict:
    """streams + the precomputed position map (prefixmap.stream_block_map)."""
    smap = stream_block_map(streams["fc"], streams["bstarts"], streams["starts"],
                            streams["sizes"], g, L, tb)
    return {**streams, "smap": smap}


def _map_tb(total_max: Optional[int], cap: int, wb: int, q: int) -> int:
    """Position count (map depth) of a batch's stream maps: pow2-rounded
    past the batch's deepest stream, capped by `cap`
    (config.stream_map_blocks) and by a ~512 MB map footprint (12 bytes
    per (query, position)), floored by the window width `wb`. JAX's sizing
    rule verbatim; every cap is a performance choice, not a correctness one.
    With total_max None: the deepest map of any batch of q queries."""
    mem_cap = (512 << 20) // (12 * max(1, q))
    tb = min(max(1024, cap), 1 << max(0, int(mem_cap).bit_length() - 1))
    if total_max is not None:
        tb = min(tb, max(1024, 1 << int(max(0, total_max)).bit_length()))
    return max(tb, 1 << max(0, wb - 1).bit_length())


def map_depth(config, wb: int, q: int, total_max: Optional[int] = None) -> int:
    """The stream map's depth for q queries and windows of `wb` blocks: 0
    where the map is off (config.stream_map off, or gather blocks of more
    than 32 lanes), else _map_tb's. total_max None gives the deepest map
    any batch of q queries can need: the graphs' buffer, and the sharded
    bodies' static map (JAX sizes it at total_max = the cap, the same
    depth)."""
    if not config.stream_map or config.gather_block > 32:
        return 0
    return _map_tb(total_max, config.stream_map_blocks, wb, q)


def _map_batch(streams: dict, config, *, wb: int, tables: int,
               loop_stats: Optional[LoopStats], write=None) -> dict:
    """`streams` with the batch's stream map where the map is on: sized by
    map_depth from the batch's deepest stream, read once on the host (a
    sync, counted into `loop_stats`), inside `engine/map`. Built anew, or
    by `write(tb, g=, L=)` into a buffer (_BodyGraphs.write_map)."""
    q = streams["total"].shape[0]
    if not map_depth(config, wb, q):
        return streams
    g = int(np.log2(config.gather_block))
    with TRACER.span("engine/map"):
        total_max = host_read(torch.max(streams["total"]).item)
        if loop_stats is not None:
            loop_stats.syncs += 1
        tb = map_depth(config, wb, q, total_max)
        if write is None:
            return _attach_stream_map(streams, g=g, L=tables, tb=tb)
        return {**streams, "smap": write(tb, g=g, L=tables)}


def global_search_batch_impl(index, queries_n, query_hashes, query_sketches, delta, *,
                             k: int, chunk: int, min_depth: int = 1,
                             filter_type: str = "default", filter_expand: int = 8,
                             static_map_tb: int = 0,
                             loop_stats: Optional[LoopStats] = None):
    """Search a pre-hashed query batch on the global tables.

    Returns (sims desc (Q, k), ids (Q, k) int32, SearchStats) tensors.
    static_map_tb > 0 attaches the stream map at that position count
    without a host sync, where the map is on (map_depth); cursors past it
    take the in-loop derivation.
    """
    pieces = dict(k=k, chunk=chunk, min_depth=min_depth, filter_type=filter_type,
                  filter_expand=filter_expand)
    with TRACER.span("engine/prepare"):
        streams = _prepare_streams(index, queries_n, query_hashes, query_sketches,
                                   min_depth=min_depth)
        cfg = index.config
        wb = window_blocks(chunk, filter_expand, cfg.gather_block)
        if static_map_tb > 0 and map_depth(cfg, wb, queries_n.shape[0]):  # the map is on
            streams = _attach_stream_map(streams, g=int(np.log2(cfg.gather_block)),
                                         L=index.g_sorted_hash.shape[0], tb=static_map_tb)
    return _search_prepared(index, streams, delta, loop_stats=loop_stats, **pieces)


def global_search_batch_mapped(index, queries_n, query_hashes, query_sketches, delta, *,
                               k: int, chunk: int, min_depth: int = 1,
                               filter_type: str = "default", filter_expand: int = 8,
                               loop_stats: Optional[LoopStats] = None):
    """global_search_batch_impl with the precomputed stream maps, sized
    from the batch's deepest stream: one host pull of `total_max` per batch
    (global_query.py:580), where the map is on (map_depth). Per-query
    results equal the unmapped path's."""
    pieces = dict(k=k, chunk=chunk, min_depth=min_depth, filter_type=filter_type,
                  filter_expand=filter_expand)
    with TRACER.span("engine/prepare"):
        streams = _prepare_streams(index, queries_n, query_hashes, query_sketches,
                                   min_depth=min_depth)
        streams = _map_batch(streams, index.config,
                             wb=window_blocks(chunk, filter_expand, index.config.gather_block),
                             tables=index.g_sorted_hash.shape[0], loop_stats=loop_stats)
    return _search_prepared(index, streams, delta, loop_stats=loop_stats, **pieces)


# Bytes of the graphed path's stream map built at once: each slice of rows
# holds (rows, tb) int64 intermediates, several times its part of the map.
_MAP_SLICE_BYTES = 128 << 20


class _BodyGraphs:
    """The batched loop's body as CUDA graphs, one for each form
    (`use_map`), captured over persistent operands and replayed in place
    of issuing the body's ~80 small ops one by one.

    The graphs read a batch's streams from `streams`, the stream map from
    a buffer as deep as any batch of this shape can need, and the loop
    state from `state`, and leave the next state in `state`. A batch
    writes its streams into the buffers and resets the state (`load`),
    then replays: the same kernels on the same inputs as the eager body,
    so the results are the eager body's, bit for bit. A map shallower
    than its buffer reuses the graphs: a step reads the map only where
    every live cursor's window ends within the batch's depth (`_advance`),
    and there the window filter, which starts at clamp(off, 0, P - WB),
    reads the same entries at either depth; done queries read none.
    Replays of one object run one batch at a time (`lock`)."""

    def __init__(self, key: tuple):
        self.key = key
        self.lock = threading.Lock()
        self.streams = self.state = self.cond = self._body = self._pool = None
        self.graphs = {}  # use_map -> torch.cuda.CUDAGraph
        self.launches = {}  # use_map -> (window-filter, score-merge) launches a replay makes
        self.captures = 0

    def load(self, index, streams: dict, depth: int, delta, **pieces) -> None:
        """Write a batch's streams into the buffers, made at its first batch
        (the stream map's at `depth` positions), and reset the state."""
        if self.streams is None:
            bufs = {name: torch.empty_like(t) for name, t in streams.items() if name != "total"}
            bufs["total"] = bufs["fc"][:, -1]
            Q = bufs["fc"].shape[0]
            if depth:
                bufs["smap"] = torch.zeros((Q, depth, 3), dtype=torch.int32,
                                           device=bufs["fc"].device)
            self.streams = bufs
            self.state = _init_state(Q, _buffer_depth(index, pieces["k"]), bufs["total"])
            self._stats = LoopStats()  # what the captured bodies count
            # over a twin of the index, which shares its tensors and not this
            # cache: the graphs do not keep the index alive
            self.cond, self._body = _loop_pieces(index.replace(), bufs, delta,
                                                 loop_stats=self._stats, **pieces)
        for name, t in streams.items():
            if name != "total":
                self.streams[name].copy_(t)
        _reset_state(self.state, self.streams["total"])

    def write_map(self, tb: int, *, g: int, L: int) -> torch.Tensor:
        """The loaded batch's stream map at depth `tb`, written into the
        buffer's first tb positions a slice of rows at a time."""
        s = self.streams
        smap = s["smap"][:, :tb]
        Q = smap.shape[0]
        slices = -(-Q * 12 * tb // _MAP_SLICE_BYTES)
        rows = -(-Q // slices)
        for r in range(0, Q, rows):
            sl = slice(r, r + rows)
            stream_block_map(s["fc"][sl], s["bstarts"][sl], s["starts"][sl], s["sizes"][sl],
                             g, L, tb, out=smap[sl])
        return smap

    def capture(self, forms) -> None:
        """Capture the graph of each body form in `forms`: a warm-up body on
        a side stream, then the capture, all forms in one memory pool (they
        never run at once, and no tensor of one outlives its replay)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graphs, launches = {}, {}  # kept only once every form is captured
        with torch.cuda.device(self.state[0].device):
            for use_map in forms:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._body(self.state, use_map)  # its next state is dropped
                torch.cuda.current_stream().wait_stream(side)
                before = (self._stats.filter_launches, self._stats.score_launches)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool):
                    for buf, t in zip(self.state, self._body(self.state, use_map)):
                        buf.copy_(t)
                launches[use_map] = (self._stats.filter_launches - before[0],
                                     self._stats.score_launches - before[1])
                graphs[use_map] = graph
        self.graphs, self.launches = graphs, launches
        self.captures += len(graphs)

    def replayer(self, loop_stats: Optional[LoopStats]):
        """body(state, use_map) for `_advance`: a replay of that form's
        graph, which leaves the next state in `state`, counted into
        `loop_stats` (its replays and the window-filter and score-merge
        launches it makes)."""
        dev = self.state[0].get_device()

        def body(state, use_map: bool):
            self.graphs[use_map].replay()
            filters, scores = self.launches[use_map]
            twf.count_launches(dev, filters, loop_stats)
            tsm.count_launches(dev, scores, loop_stats)
            if loop_stats is not None:
                loop_stats.graph_replays += 1
            return state

        return body


_GRAPHS_LOCK = threading.Lock()


def _graphs_for(index, key: tuple) -> _BodyGraphs:
    """The index's body graphs for `key`, made empty where it holds
    another key's (one key's at a time)."""
    with _GRAPHS_LOCK:
        graphs = index.body_graphs
        if graphs is None or graphs.key != key:
            graphs = index.body_graphs = _BodyGraphs(key)
        return graphs


def global_search_batch_graphed(index, queries_n, query_hashes, query_sketches, delta, *,
                                k: int, chunk: int, min_depth: int = 1,
                                filter_type: str = "default", filter_expand: int = 8,
                                loop_stats: Optional[LoopStats] = None):
    """global_search_batch_mapped with its streams, stream map and loop
    state in the buffers of `_BodyGraphs` (cached on the index, captured at
    the first batch of each shape) and each loop body a replay of their
    graphs: the batched search on one card. The results are the eager
    body's, bit for bit, and leave the graphs' buffers. CPU tensors take
    global_search_batch_mapped."""
    if not queries_n.is_cuda:
        return global_search_batch_mapped(
            index, queries_n, query_hashes, query_sketches, delta, k=k, chunk=chunk,
            min_depth=min_depth, filter_type=filter_type, filter_expand=filter_expand,
            loop_stats=loop_stats,
        )
    cfg = index.config
    wb = window_blocks(chunk, filter_expand, cfg.gather_block)
    depth = map_depth(cfg, wb, queries_n.shape[0])
    pieces = dict(k=k, chunk=chunk, min_depth=min_depth, filter_type=filter_type,
                  filter_expand=filter_expand)
    graphs = _graphs_for(index, (queries_n.shape[0], depth, float(delta),
                                 index.vectors_q8 is not None, *sorted(pieces.items())))
    with graphs.lock:
        with TRACER.span("engine/prepare"):
            streams = _prepare_streams(index, queries_n, query_hashes, query_sketches,
                                       min_depth=min_depth)
            graphs.load(index, streams, depth, delta, **pieces)
            streams = _map_batch(graphs.streams, cfg, wb=wb, tables=index.g_sorted_hash.shape[0],
                                 loop_stats=loop_stats, write=graphs.write_map)
            if not graphs.graphs:  # the first batch of this key
                with TRACER.span("engine/capture"):
                    graphs.capture((True, False) if depth else (False,))
        sims, ids, stats = _search_prepared(index, streams, delta, loop_stats=loop_stats,
                                            graphs=graphs, **pieces)
        return sims.clone(), ids.clone(), SearchStats(*(t.clone() for t in stats))


def count_lanes(loop_stats: Optional[LoopStats], stats: SearchStats) -> None:
    """Add the host stats' valid window lanes (SearchStats.candidates) to
    `loop_stats`, where there is one."""
    if loop_stats is not None:
        loop_stats.lanes += int(np.asarray(stats.candidates).sum(dtype=np.int64))


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


def _front_end(index, queries, k, delta, loop_stats: Optional[LoopStats]) -> tuple:
    """What both global drivers do first: (k and delta, the config's where
    None, the index's hash source and sketcher, the queries normalized on
    the index's device as (Q, d), the LoopStats to count into: the
    caller's, else the tracer's own while it is active)."""
    from clann_tpu_torch.errors import DataError

    if index.g_records is None:
        raise DataError(
            "index lacks global LSH structures; build with config.lsh_engine='global'"
        )
    q = as_device_f32(queries, index.device)
    if q.dim() == 1:
        q = q[None, :]
    return (index.config.k if k is None else k, index.config.delta if delta is None else delta,
            *index.rebuild_objects(), l2_normalize(q), TRACER.loop_stats(loop_stats))


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
    loops' iterations and host syncs (the tracer's own while it is active
    and the caller passes none). On a card each batch's loop bodies are
    replays of CUDA graphs cached on the index
    (global_search_batch_graphed).
    """
    k, delta, source, filterer, qn, loop_stats = _front_end(index, queries, k, delta,
                                                            loop_stats)
    cfg = index.config

    perm = None
    if sort_by_difficulty and qn.shape[0] > batch_size:
        tot = difficulty(index, source.hash(qn), d_entry=_entry_depth(index, cfg.min_depth),
                         min_depth=cfg.min_depth)
        perm = np.argsort(tot.cpu().numpy(), kind="stable")
        qn = qn[torch.as_tensor(perm, device=qn.device)]

    def run_block(block):
        with TRACER.span("engine/hash"):
            qh, qs = source.hash(block), filterer.sketch(block)
        return global_search_batch_graphed(
            index, block, qh, qs, delta,
            k=k, chunk=cfg.candidate_chunk, min_depth=cfg.min_depth,
            filter_type=filter_type, filter_expand=cfg.filter_expand,
            loop_stats=loop_stats,
        )

    sims, ids, stats = batched_query_driver(qn, batch_size, run_block)
    count_lanes(loop_stats, stats)
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        sims, ids = sims[inv], ids[inv]
        stats = SearchStats(*(np.asarray(f)[inv] for f in stats))
    return sims_to_dists(sims, ids), ids, stats


def _global_step_packed(index, streams_all: dict, state_all: tuple, active: torch.Tensor,
                        delta, *, max_iters: int, loop_stats: Optional[LoopStats] = None,
                        **pieces):
    """Advance the `active` lanes by at most `max_iters` loop iterations.

    The continuous-batching step (JAX global_query.py:603-649): the active
    rows of every stream and state tensor of the whole query set form a
    lane batch, the bounded adaptive loop advances it, and the lanes' state
    is written back into the full state in place. `active` never holds a
    query twice, so the write-back is well defined. Returns (state_all,
    the lanes' qdone flags on the host); `loop_stats` counts the step and
    its reads.
    """
    lane_streams = {name: t[active] for name, t in streams_all.items()}
    lane_state = tuple(t[active] for t in state_all)
    cond, body = _loop_pieces(index, lane_streams, delta, loop_stats=loop_stats, **pieces)
    tb = lane_streams["smap"].shape[1] if "smap" in lane_streams else 0
    lane_state = _advance(cond, body, lane_state, tb=tb, max_iters=max_iters,
                          wb=window_blocks(pieces["chunk"], pieces["filter_expand"],
                                           index.config.gather_block),
                          loop_stats=loop_stats)
    for full, lane in zip(state_all, lane_state):
        full[active] = lane
    done = lane_state[2].cpu().numpy()
    if loop_stats is not None:
        loop_stats.outer_steps += 1
        loop_stats.syncs += 1
    return state_all, done


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
    `loop_stats` (the tracer's own while it is active and the caller
    passes none) counts one batch, a step per outer step, the body's
    iterations and the host syncs (stop flags, done flags, map sizing).
    """
    k, delta, source, filterer, qn, loop_stats = _front_end(index, queries, k, delta,
                                                            loop_stats)
    cfg = index.config
    Q = qn.shape[0]
    if Q <= lanes:
        # a single batch cannot be repacked (JAX passes the normalized queries)
        return global_search(index, qn, k=k, delta=delta, batch_size=lanes,
                             filter_type=filter_type, loop_stats=loop_stats)

    slabs = []
    for s in range(0, Q, prepare_batch):
        block = qn[s : s + prepare_batch]
        with TRACER.span("engine/hash"):
            qh, qs = source.hash(block), filterer.sketch(block)
        with TRACER.span("engine/prepare"):
            slabs.append(_prepare_streams(index, block, qh, qs, min_depth=cfg.min_depth))
    streams_all = {name: torch.cat([sl[name] for sl in slabs], dim=0) for name in slabs[0]}
    del slabs
    # one map depth for the whole set; lanes pick up map rows like any
    # other stream row (map_depth bounds the (Q, tb) footprint)
    streams_all = _map_batch(streams_all, cfg, wb=window_blocks(
        cfg.candidate_chunk, cfg.filter_expand, cfg.gather_block),
        tables=index.g_sorted_hash.shape[0], loop_stats=loop_stats)
    state_all = _init_state(Q, _buffer_depth(index, k), streams_all["total"])
    pieces = dict(k=k, chunk=cfg.candidate_chunk, min_depth=cfg.min_depth,
                  filter_type=filter_type, filter_expand=cfg.filter_expand)

    # lane scheduling on the host, O(lanes) per step. A lane whose query is
    # done, with no pending query left, keeps its assignment: its qdone
    # row masks all its work.
    active = np.arange(lanes, dtype=np.int64)
    next_q = lanes
    while True:
        state_all, done_np = _global_step_packed(
            index, streams_all, state_all, torch.tensor(active, device=qn.device), delta,
            max_iters=step_iters, loop_stats=loop_stats, **pieces)
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
    if loop_stats is not None:
        loop_stats.batches += 1

    sims, ids, st = _finalize(index, streams_all, state_all, k=k)
    sims, ids = sims.cpu().numpy(), ids.cpu().numpy()
    st = SearchStats(*(f.cpu().numpy() for f in st))
    count_lanes(loop_stats, st)
    return sims_to_dists(sims, ids), ids, st

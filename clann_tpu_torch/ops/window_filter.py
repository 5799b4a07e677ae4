"""The global δ engine's window filter (PyTorch wrapper of ``csrc/window_filter.cu``).

One loop iteration of the cosine global engine (ops/global_query.py) asks,
for every query q of the loop: which lanes of its next WB stream blocks
pass the filters, how many blocks to consume, and the ids of the passing
lanes in those blocks, in window order. That is JAX's window fetch, sketch
filter, ball filter and take in the loop body of
``clann_tpu.ops.global_query`` (the `rec_view[t_sel, blk]` record gather,
the popcount Hamming test, the one-hot feasibility contraction, the
chunk consume and the (rank, id) sort). `window_filter` computes it:

- window (Q, P, 2 + NW) int32: per stream position [table, table block,
  NW lane-mask words] (bit l of word w: lane 32 w + l of the block lies in
  the stream), NW = ceil(G / 32). The loop reads WB positions from
  clamp(off[q], 0, P - WB): the stream map (`prefixmap.stream_block_map`,
  P = its depth) or the in-loop derivation packed by `pack_window` (P = WB).
- records (L, n_pad, R) int32 [id, Wd sketch words, cluster] rows, read
  in blocks of G (the records' slot axis padded to a multiple of G).
- a lane is valid where its mask bit is set and its query is not done; it
  passes where it is valid, its cluster's ball is feasible
  (feas_bound[q, clamp(cluster, 0, C - 1)] <= kth_dist[q]) and, unless the
  filter is off, the Hamming distance of its sketch words to the query's
  sketch of its table, qsk[q, table % S], is at most maxdiff[q].
- consumed[q]: the leading blocks whose running pass count stays <= chunk,
  at least 1 (collection.hpp:775-781).

Returns (compact_ids (Q, min(cap, WB G)): the passing lanes' ids of the
consumed blocks in window order, the sentinel n elsewhere, ranks past cap
dropped; consumed (Q,); taken (Q,): the lanes compacted; seen (Q,): the
valid lanes of the consumed blocks), all int32.

For CPU tensors `window_filter` runs `window_filter_plain`, the engine's
former chain of torch ops (the record gather through K7); for CUDA
tensors it launches the kernel, one CTA a query, and raises on what the
kernel does not take. Both give the same integers, bit for bit.
"""

from __future__ import annotations

import collections

import torch

from clann_tpu_torch.ops import _build
from clann_tpu_torch.ops.gather import _launcher, _stream, gather_rows
from clann_tpu_torch.ops.query import _compact_take
from clann_tpu_torch.ops.sketches import popcount32, to_int32_bits

# Launches of the kernel, in all and by card index: made by the wrapper,
# or replayed from a captured CUDA graph (a launch the wrapper records into
# a graph counts at each replay, `count_launches`). The plain version never
# counts.
FILTER_LAUNCHES = 0
FILTER_DEVICE_LAUNCHES: collections.Counter = collections.Counter()

MAX_SHARED = 227 * 1024  # a CTA's shared memory on an H100


def reset_launches() -> None:
    global FILTER_LAUNCHES
    FILTER_LAUNCHES = 0
    FILTER_DEVICE_LAUNCHES.clear()


def count_launches(device: int, n: int, loop_stats=None) -> None:
    """Count `n` launches of the kernel on card `device`, also into
    `loop_stats.filter_launches` where given."""
    global FILTER_LAUNCHES
    with _build.COUNT_LOCK:
        FILTER_LAUNCHES += n
        FILTER_DEVICE_LAUNCHES[device] += n
    if loop_stats is not None:
        loop_stats.filter_launches += n


def mask_words(gather_block: int) -> int:
    """Lane-mask words of a window entry: one per 32 lanes of a block."""
    return -(-gather_block // 32)


def pack_window(t_sel: torch.Tensor, blk: torch.Tensor, lane_valid: torch.Tensor) -> torch.Tensor:
    """(Q, WB) tables, (Q, WB) blocks and (Q, WB, G) lane validity as the
    (Q, WB, 2 + NW) int32 window of `window_filter`."""
    Q, wb, G = lane_valid.shape
    per = min(G, 32)
    bits = lane_valid.reshape(Q, wb, mask_words(G), per).to(torch.int64)
    shifts = torch.arange(per, dtype=torch.int64, device=bits.device)
    words = to_int32_bits(torch.sum(bits << shifts, dim=-1))
    return torch.cat([t_sel.to(torch.int32)[:, :, None], blk.to(torch.int32)[:, :, None],
                      words], dim=2)


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


def window_entries(window, off, *, wb: int, gather_block: int):
    """(t_sel (Q, WB), blk (Q, WB), lane_valid (Q, WB, G)): the WB entries of
    a packed window (Q, P, 2 + NW) from clamp(off, 0, P - WB) on."""
    Q, P, ew = window.shape
    G = gather_block
    lane_iota = torch.arange(G, dtype=torch.int32, device=window.device)
    pos = torch.clamp(off, 0, P - wb)[:, None].to(torch.int64) + torch.arange(
        wb, dtype=torch.int64, device=window.device)
    win = torch.gather(window, 1, pos[:, :, None].expand(Q, wb, ew))
    lm = torch.gather(win, 2, (2 + lane_iota // 32).to(torch.int64)[None, None, :].expand(
        Q, wb, G))
    return win[..., 0], win[..., 1], ((lm >> (lane_iota % 32)) & 1) != 0


def block_rows(t_sel, blk, lane_valid, qdone, *, blocks: int, routing: bool):
    """(t_sel, rows (Q, WB) int32, valid (Q, WB * G)) of a window's entries:
    each entry's row of the records viewed as (L * blocks, G * R) block
    rows, the source K7 gathers from. With `routing` the dead blocks (done
    queries, fully masked blocks) take table 0's block 0; `valid` masks
    every consumer of their words."""
    Q, wb, G = lane_valid.shape
    if routing:
        block_live = lane_valid.any(dim=2) & ~qdone[:, None]
        blk = torch.where(block_live, blk, 0)
        t_sel = torch.where(block_live, t_sel, 0)
    valid = (lane_valid & ~qdone[:, None, None]).reshape(Q, wb * G)
    rows = (t_sel * blocks + torch.clamp(blk, 0, blocks - 1)).to(torch.int32)
    return t_sel, rows, valid


def fetch_records(records, t_sel, blk, lane_valid, qdone, *, routing: bool):
    """(t_sel, rec (Q, WB, G, R), valid (Q, WB * G)): the G records of each
    of a window's entries, one row gather a block through K7
    (ops.gather.gather_rows); see `block_rows`."""
    Q, wb, G = lane_valid.shape
    L, n_pad, R = records.shape
    t_sel, rows, valid = block_rows(t_sel, blk, lane_valid, qdone, blocks=n_pad // G,
                                    routing=routing)
    rec = gather_rows(records.view(L * (n_pad // G), G * R), rows.reshape(-1))
    return t_sel, rec.view(Q, wb, G, R), valid


def window_filter_plain(records, window, off, qdone, qsk, feas_bound, kth_dist, maxdiff, *,
                        gather_block: int, wb: int, chunk: int, cap: int, n_sentinel: int,
                        use_filter: bool, routing: bool = True, loop_stats=None):
    """The window filter in plain PyTorch: the global engine's former
    fetch, sketch, filter and take phases. With `routing` the dead blocks
    fetch table 0's block 0 (`block_rows`); the results do not depend on
    it. It launches no window filter, so `loop_stats` is left as it is."""
    Q = window.shape[0]
    G = gather_block
    S, Wd = qsk.shape[1], qsk.shape[2]
    C = feas_bound.shape[1]
    WL = wb * G
    dev = window.device

    # fetch: the window's WB entries, their lane masks, their records
    t_sel, blk, lane_valid = window_entries(window, off, wb=wb, gather_block=G)
    t_sel, rec, valid = fetch_records(records, t_sel, blk, lane_valid, qdone, routing=routing)

    # sketch: the query sketch is constant across a block's G lanes
    q_sk = torch.gather(qsk, 1, (t_sel % S).to(torch.int64)[:, :, None].expand(Q, wb, Wd))
    ham = torch.sum(popcount32(rec[..., 1 : 1 + Wd] ^ q_sk[:, :, None, :]),
                    dim=-1, dtype=torch.int32).reshape(Q, WL)

    # filter: per-candidate ball feasibility (index.rs:342-361 per candidate)
    cand_ids = rec[..., 0].reshape(Q, WL)
    cand_cluster = torch.clamp(rec[..., 1 + Wd].reshape(Q, WL), 0, C - 1)
    ok = feas_bound <= kth_dist[:, None]  # (Q, C)
    feas = torch.gather(ok, 1, cand_cluster.to(torch.int64))
    passes = valid & feas
    if use_filter:
        passes = passes & (ham <= maxdiff[:, None])

    # take
    consume = _consumer(wb=wb, gather_block=G, chunk=chunk, device=dev)
    consumed, in_window = consume(passes)
    take = passes & in_window
    compact_ids = _compact_take(take, cand_ids, cap=cap, n_sentinel=n_sentinel)
    return (compact_ids, consumed, take.sum(dim=1, dtype=torch.int32),
            (valid & in_window).sum(dim=1, dtype=torch.int32))


def _check(records, window, off, qdone, qsk, feas_bound, kth_dist, maxdiff, gather_block, wb):
    Q = qdone.shape[0]
    if records.dim() != 3 or records.dtype != torch.int32:
        raise ValueError(f"records must be (L, n_pad, R) int32, got {records.dtype} "
                         f"{tuple(records.shape)}")
    if gather_block < 1 or gather_block & (gather_block - 1) or records.shape[1] % gather_block:
        raise ValueError(f"gather_block {gather_block} must be a power of two dividing the "
                         f"records' {records.shape[1]} slots")
    nw = mask_words(gather_block)
    if (window.dim() != 3 or window.dtype != torch.int32 or window.shape[0] != Q
            or window.shape[2] != 2 + nw or window.shape[1] < wb or wb < 1):
        raise ValueError(f"window must be (Q={Q}, P >= {wb}, {2 + nw}) int32, got "
                         f"{window.dtype} {tuple(window.shape)}")
    for name, t, dtype, dims in (
            ("off", off, torch.int32, 1), ("qdone", qdone, torch.bool, 1),
            ("qsk", qsk, torch.int32, 3), ("feas_bound", feas_bound, torch.float32, 2),
            ("kth_dist", kth_dist, torch.float32, 1), ("maxdiff", maxdiff, torch.int32, 1)):
        if (t.dtype != dtype or t.dim() != dims or t.shape[0] != Q or 0 in t.shape[1:]
                or t.device != records.device):
            raise ValueError(f"{name} must be a {dims}-D {dtype} tensor of {Q} non-empty rows "
                             f"on {records.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if records.shape[2] < qsk.shape[2] + 2:
        raise ValueError(f"records of {records.shape[2]} words cannot hold an id, "
                         f"{qsk.shape[2]} sketch words and a cluster")


def _shared_bytes(wl: int, clusters: int, sketch_words: int) -> int:
    """csrc/window_filter.cu's dynamic shared memory: pass, valid and prefix
    words of the window's 32-lane words, the feasibility bits and the query's
    sketches."""
    nw32 = -(-wl // 32)
    return 4 * (3 * nw32 + 1 + -(-clusters // 32) + sketch_words)


def window_filter(records, window, off, qdone, qsk, feas_bound, kth_dist, maxdiff, *,
                  gather_block: int, wb: int, chunk: int, cap: int, n_sentinel: int,
                  use_filter: bool, routing: bool = True, loop_stats=None):
    """(compact_ids, consumed, taken, seen) of one loop iteration (see the
    module docstring); `cap` is cut to the window's WB * G lanes. A launch
    of the kernel counts one in `loop_stats.filter_launches` (a LoopStats
    of the calling loop, where given) and in the module's counts; a launch
    recorded into a CUDA graph counts in `loop_stats` alone, and each
    replay of the graph counts it (`count_launches`)."""
    _check(records, window, off, qdone, qsk, feas_bound, kth_dist, maxdiff, gather_block, wb)
    cap = min(cap, wb * gather_block)
    if records.device.type == "cpu":
        return window_filter_plain(records, window, off, qdone, qsk, feas_bound, kth_dist,
                                   maxdiff, gather_block=gather_block, wb=wb, chunk=chunk,
                                   cap=cap, n_sentinel=n_sentinel, use_filter=use_filter,
                                   routing=routing, loop_stats=loop_stats)
    operands = (records, window, off, qdone, qsk, feas_bound, kth_dist, maxdiff)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the window filter's operands must be contiguous")
    L, n_pad, R = records.shape
    Q, P, _ = window.shape
    C, S, Wd = feas_bound.shape[1], qsk.shape[1], qsk.shape[2]
    smem = _shared_bytes(wb * gather_block, C, S * Wd)
    if smem > MAX_SHARED:
        raise ValueError(f"a window of {wb * gather_block} lanes, {C} clusters and {S * Wd} "
                         f"sketch words needs {smem} B of shared memory, over {MAX_SHARED}")
    ids = torch.empty((Q, cap), dtype=torch.int32, device=records.device)
    counts = torch.empty((3, Q), dtype=torch.int32, device=records.device)
    if Q:
        fn = _launcher("clann_window_filter", records)
        dev = records.get_device()
        code = fn(records.data_ptr(), L, n_pad, R, gather_block.bit_length() - 1,
                  window.data_ptr(), P, wb, off.data_ptr(), qdone.data_ptr(),
                  qsk.data_ptr(), S, Wd, feas_bound.data_ptr(), C, kth_dist.data_ptr(),
                  maxdiff.data_ptr(), int(use_filter), chunk, ids.data_ptr(), cap, n_sentinel,
                  counts.data_ptr(), Q, smem, dev, _stream(dev))
        if code:
            _build.check(_build.load_library(), code, "window filter launch")
        if torch.cuda.is_current_stream_capturing():
            # recorded into a graph: each replay counts it
            if loop_stats is not None:
                loop_stats.filter_launches += 1
        else:
            count_launches(dev, 1, loop_stats)
    return ids, counts[0], counts[1], counts[2]

"""Sorted-hash table layout and prefix-range computation (PyTorch port).

Port of ``clann_tpu.ops.prefixmap`` (the replacement of the reference
PrefixMap, libpuffinn/include/puffinn/prefixmap.hpp):

- `sorted_hash (L, n)`: per-table hashes sorted ascending within each
  cluster segment, `sorted_idx (L, n)` the global point id at each slot,
  segment starts `(C+1,)` shared by all tables.
- the candidate range of query q in table t at prefix depth d is [lo, hi)
  from a vectorized masked binary search over all (q, t, d) at once;
- the whole peeling walk (prefixmap.hpp:267-304) is materialized up front
  as a stream of one-sided ranges (`candidate_stream`), cut into G-slot
  blocks (`block_stream`), and mapped to (table, block, lane mask) per
  stream position (`blocked_window`, `stream_block_map`);
- `revealed_range` is the single-depth peel step that `candidate_stream`
  vectorizes, and `chunk_stream_direct` the clustered walk's lazy window of
  a few levels, every bound a direct directory answer.

Hashes are int32 (values below 2^24); search keys are int64, because the
depth-0 upper key is 0xFFFFFFFF as in the JAX package. Lane masks are
32-bit words carried as int32 bit patterns.

Two JAX mechanisms are not carried over and return the same values: the
MXU one-hot directory lookups (`config.dir_onehot`, JAX's f32 directory
dispatch, `_dir_rows_onehot` / `_dir_select_onehot`) become plain gathers, and `window_range_index`'s scatter and
dense variants (`config.window_index_dense`) are one searchsorted. The
JAX `while_loop` of the binary search stops once every search converged;
here it runs its `n_iters` iterations, which gives the same answer (a
converged search does not move) without a host synchronization.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from clann_tpu_torch.ops.sketches import to_int32_bits

_U32 = 0xFFFFFFFF


# tables a blocked table pass (the segmented sort, the global tables, the
# prefix directory) handles at once, so that its transients are this many
# tables' keys, orders and gathered records whatever the index's L; a
# table's result depends on no other table, so every block size gives the
# same bits
TABLE_BLOCK = 8


def table_blocks(num_tables: int):
    """Slices of TABLE_BLOCK tables covering the L tables, in order."""
    return [slice(t0, t0 + TABLE_BLOCK) for t0 in range(0, num_tables, TABLE_BLOCK)]


def sort_tables_segmented(
    hashes: torch.Tensor, cluster_of_point: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each table's hashes by (cluster, hash), carrying point ids.

    hashes: (L, n) int32; cluster_of_point: (n,) int32. Returns
    (sorted_hash (L, n) int32, sorted_idx (L, n) int32). Equal
    (cluster, hash) keys keep ascending point ids (a stable sort); the JAX
    package's `lax.sort` is unstable, so the order inside such runs may
    differ between the packages while the runs themselves agree.

    Tables are sorted in blocks (`table_blocks`), each straight into the
    preallocated outputs; a table's stable sort depends on no other table,
    so every block size gives the same bits.
    """
    from clann_tpu_torch.metrics.trace import TRACER

    L, n = hashes.shape
    cluster_key = cluster_of_point.to(torch.int64)[None, :] << 32
    sorted_hash = torch.empty_like(hashes)
    sorted_idx = torch.empty((L, n), dtype=torch.int32, device=hashes.device)
    for b in table_blocks(L):
        with TRACER.span("build/table_block", block_on=hashes.device):
            h = hashes[b]
            _, order = torch.sort(cluster_key | (h.to(torch.int64) & _U32), dim=1, stable=True)
            sorted_hash[b] = torch.gather(h, 1, order)
            sorted_idx[b] = order
    return sorted_hash, sorted_idx


def masked_binary_search(
    sorted_hash: torch.Tensor,
    table_ids: torch.Tensor,
    keys: torch.Tensor,
    seg_lo: torch.Tensor,
    seg_hi: torch.Tensor,
    n_iters: int,
) -> torch.Tensor:
    """Lower-bound binary search restricted to [seg_lo, seg_hi) per element.

    sorted_hash (L, n); table_ids, keys, seg_lo, seg_hi broadcastable to
    one shape. Returns the first position p in [seg_lo, seg_hi] with
    sorted_hash[table, p] >= key (int32). n_iters >= ceil(log2(max
    segment)) + 1 covers every search.
    """
    n = sorted_hash.shape[1]
    shape = torch.broadcast_shapes(table_ids.shape, keys.shape, seg_lo.shape, seg_hi.shape)
    lo = seg_lo.expand(shape).to(torch.int32)
    hi = seg_hi.expand(shape).to(torch.int32)
    flat = sorted_hash.reshape(-1)
    base = table_ids.to(torch.int64) * n
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        # a converged search (lo == hi, possibly == n) reads a clamped slot
        # whose value it does not use
        v = flat[base + torch.clamp(mid, max=n - 1).to(torch.int64)]
        open_ = lo < hi
        go_right = v < keys
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo


def build_prefix_directory(
    sorted_hash: torch.Tensor,
    cluster_starts: torch.Tensor,
    dir_bits: int,
    n_iters: int,
    max_hashbits: int = 24,
    table_block: int = TABLE_BLOCK,
) -> torch.Tensor:
    """Per-(table, cluster) prefix directory seeding later binary searches.

    dir[t, c, p] = first position in segment c of table t whose hash has
    top `dir_bits` bits >= p (the reference's PREFIX_INDEX directory,
    prefixmap.hpp:70,86,228-240, per cluster segment). Returns
    (L, C, 2^dir_bits + 1) int32.
    """
    L = sorted_hash.shape[0]
    dev = sorted_hash.device
    starts = cluster_starts.to(device=dev, dtype=torch.int32)
    C = starts.shape[0] - 1
    P = (1 << dir_bits) + 1
    keys = (torch.arange(P, dtype=torch.int64, device=dev)
            << (max_hashbits - dir_bits))[None, None, :]  # (1, 1, P)
    slo = starts[:-1][None, :, None]
    shi = starts[1:][None, :, None]
    out = []
    for t0 in range(0, L, table_block):  # bounds the transient search arrays
        tids = torch.arange(t0, min(L, t0 + table_block), device=dev)[:, None, None]
        out.append(masked_binary_search(
            sorted_hash, tids.expand(-1, C, P), keys, slo, shi, n_iters))
    return torch.cat(out, dim=0)


def depth_bounds(
    sorted_hash: torch.Tensor,
    query_hashes: torch.Tensor,
    seg_lo: torch.Tensor,
    seg_hi: torch.Tensor,
    max_hashbits: int,
    n_iters: int,
    up_to_depth: int = None,
    prefix_dir: torch.Tensor = None,
    cluster: torch.Tensor = None,
    dir_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate range [lo_d, hi_d) for every (query, table, depth).

    query_hashes (Q, L); seg_lo / seg_hi (Q,) the query's segment bounds.
    Returns lo, hi: (Q, L, S+1) int32 for depths 0..S, S = up_to_depth
    (default D). At depth d the keys are (h >> (D-d)) << (D-d) and that
    plus 2^(D-d); the depth-0 upper key is 0xFFFFFFFF.

    With `prefix_dir` and the queries' `cluster`, depths d <= dir_bits are
    direct directory answers (their keys are directory-aligned) and deeper
    searches are seeded from their key's bucket [dir[p], dir[p+1]], so
    n_iters only needs to cover log2(max bucket size).
    """
    L = query_hashes.shape[1]
    dev = query_hashes.device
    D = max_hashbits
    S = D if up_to_depth is None else min(up_to_depth, D)
    shifts = D - torch.arange(S + 1, dtype=torch.int64, device=dev)  # (S+1,)
    qh = query_hashes.to(torch.int64)[:, :, None]
    prefix = (qh >> shifts) << shifts  # (Q, L, S+1)
    upper = torch.where(shifts == D, torch.full_like(prefix, _U32),
                        prefix + (torch.ones_like(shifts) << shifts))
    t_ids = torch.arange(L, device=dev)[None, :, None]

    if prefix_dir is not None and dir_bits > 0:
        P = prefix_dir.shape[2] - 1  # == 2^dir_bits
        C = prefix_dir.shape[1]
        # gather straight from the (L, C, P+1) directory: materializing each
        # query's rows would cost (L, Q, P+1) ints (a GB at the bench shape)
        row = (t_ids * C + cluster.to(torch.int64)[:, None, None]) * (P + 1)
        flat_dir = prefix_dir.reshape(-1)

        def positions(keys):
            return torch.clamp(keys >> (D - dir_bits), max=P)

        def direct(keys):
            return flat_dir[row + positions(keys)]

        def seeded(keys):
            p = positions(keys)
            b_lo = flat_dir[row + p]
            b_hi = flat_dir[row + torch.clamp(p + 1, max=P)]
            return masked_binary_search(sorted_hash, t_ids, keys, b_lo, b_hi, n_iters)

        if S <= dir_bits:
            return direct(prefix), direct(upper)
        cut = dir_bits + 1
        lo = torch.cat([direct(prefix[:, :, :cut]), seeded(prefix[:, :, cut:])], dim=2)
        hi = torch.cat([direct(upper[:, :, :cut]), seeded(upper[:, :, cut:])], dim=2)
        return lo, hi

    slo = seg_lo[:, None, None]
    shi = seg_hi[:, None, None]
    lo = masked_binary_search(sorted_hash, t_ids, prefix, slo, shi, n_iters)
    hi = masked_binary_search(sorted_hash, t_ids, upper, slo, shi, n_iters)
    return lo, hi


def revealed_range(
    lo: torch.Tensor,
    hi: torch.Tensor,
    query_hashes: torch.Tensor,
    depth: torch.Tensor,
    max_hashbits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-sided range newly revealed when entering `depth`.

    lo, hi: (Q, L, D+1) from depth_bounds; depth: (Q,) in [1, D], where D
    means the exact-match range [lo_D, hi_D). Returns (start, size) (Q, L)
    int32. The peeled bit (index D - (d+1)) picks the direction
    (prefixmap.hpp:272-279): 0 extends upward, 1 downward.
    """
    D = max_hashbits
    dd = depth.to(torch.int64)[:, None].expand(-1, lo.shape[1])  # (Q, L)

    def at(a, i):
        return torch.gather(a, 2, i[:, :, None])[:, :, 0]

    d1 = torch.clamp(dd + 1, max=D)
    lo_d, hi_d, lo_d1, hi_d1 = at(lo, dd), at(hi, dd), at(lo, d1), at(hi, d1)
    # the JAX package's uint32 (D - (d+1)) % 32: 31 at d == D
    shift = torch.remainder(D - (dd + 1), 32)
    bit = (query_hashes.to(torch.int64) >> shift) & 1
    exact = dd == D
    start = torch.where(exact, lo_d, torch.where(bit == 0, hi_d1, lo_d))
    end = torch.where(exact, hi_d, torch.where(bit == 0, hi_d, lo_d1))
    return start.to(torch.int32), torch.clamp(end - start, min=0).to(torch.int32)


def _shl_u32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 x << s in int64: masked to 32 bits, 0 for s >= 32 (XLA's
    shift semantics)."""
    return torch.where(s >= 32, 0, (x << torch.clamp(s, max=31)) & _U32)


def _shr_u32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 x >> s in int64 (x in [0, 2^32)): 0 for s >= 32."""
    return torch.where(s >= 32, 0, x >> torch.clamp(s, max=31))


def chunk_stream_direct(
    query_hashes: torch.Tensor,
    d_top,
    entry_first,
    lc: int,
    max_hashbits: int,
    dir_bits: int,
    min_depth: int,
    d_entry: int,
    *,
    cdir_oh: Optional[torch.Tensor] = None,
    cdir: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peel-level ranges for ONE window of `lc` depth levels (the lazy walk,
    config.lsh_level_chunk).

    query_hashes (QG, L); d_top: the window's deepest level (an int or a
    0-d tensor); every level lies in [min_depth, d_entry], d_entry <=
    dir_bits, so each bound is a direct answer of the search's own
    directory row (prefix_dir[:, cluster, :]), given as exactly one of
    cdir (L, QG, P+1) int32 or cdir_oh, the same rows as f32 (JAX's
    one-hot MXU form, prefixmap._dir_rows_onehot; slot positions < 2^24
    are exact in f32), which gives the same ranges. entry_first:
    level 0 is the walk's entry range [lo(d_top), hi(d_top)) instead of a
    one-sided spill. Returns (starts, sizes) (QG, lc*L) int32, level-major
    (slot j = level j // L, table j % L), as candidate_stream lays out one
    member; levels below min_depth have size 0.
    """
    if (cdir_oh is None) == (cdir is None):
        raise ValueError("chunk_stream_direct takes exactly one of cdir_oh and cdir")
    if cdir is None:
        cdir = cdir_oh.to(torch.int32)
    QG, L = query_hashes.shape
    D = max_hashbits
    dev = query_hashes.device
    P = cdir.shape[2] - 1
    jj = torch.arange(lc + 1, dtype=torch.int64, device=dev)  # bound levels, deepest first
    dep = torch.clamp(d_top + 1 - jj, min_depth, d_entry)  # (lc+1,)
    shifts = D - dep
    qh = query_hashes.to(torch.int64)[:, :, None] & _U32
    prefix = _shl_u32(_shr_u32(qh, shifts), shifts)  # (QG, L, lc+1)
    upper = (prefix + _shl_u32(torch.ones_like(shifts), shifts)) & _U32

    def positions(keys):
        return torch.clamp(keys >> (D - dir_bits), max=P)

    p_both = torch.cat([positions(prefix), positions(upper)], dim=2)  # (QG, L, 2(lc+1))
    t_ids = torch.arange(L, device=dev)[None, :, None]
    q_ids = torch.arange(QG, device=dev)[:, None, None]
    both = cdir.reshape(-1)[(t_ids * QG + q_ids) * (P + 1) + p_both]
    lo, hi = both[:, :, : lc + 1], both[:, :, lc + 1 :]

    # level j (depth d_top - j) uses bounds jj = j+1 (its own depth) and
    # jj = j (depth + 1); the peeled bit picks the spill side
    lo_d, hi_d = lo[:, :, 1:], hi[:, :, 1:]
    lo_d1, hi_d1 = lo[:, :, :lc], hi[:, :, :lc]
    bit = _shr_u32(qh, shifts[None, None, :lc]) & 1
    is_entry = (jj[:lc] == 0) & torch.as_tensor(entry_first, device=dev)
    start = torch.where(is_entry, lo_d, torch.where(bit == 0, hi_d1, lo_d))
    end = torch.where(is_entry, hi_d, torch.where(bit == 0, hi_d, lo_d1))
    level_ok = (d_top - jj[:lc]) >= min_depth
    sizes = torch.where(level_ok, torch.clamp(end - start, min=0), 0)
    starts = start.transpose(1, 2).reshape(QG, lc * L)
    sizes = sizes.transpose(1, 2).reshape(QG, lc * L)
    return starts.to(torch.int32), sizes.to(torch.int32)


def count_leq(sorted_rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-row count of sorted_rows[q] entries <= values[q, i].

    sorted_rows: (Q, M) ascending per row; values: (Q, C). Returns (Q, C)
    int32: a right-sided searchsorted, which is the count of entries <= v
    in an ascending row.
    """
    return torch.searchsorted(
        sorted_rows.contiguous(), values.to(sorted_rows.dtype).contiguous(), right=True
    ).to(torch.int32)


def window_range_index(
    fc: torch.Tensor, off: torch.Tensor, window: int, dense: bool = False
) -> torch.Tensor:
    """Range index j for each window position pos = off + w, w < window:
    j_w = #{m : fc[q, m] <= off + w}. `dense` selects between two
    evaluations of the same count in the JAX package; both are this one."""
    del dense
    pos = off[:, None] + torch.arange(window, dtype=off.dtype, device=off.device)[None, :]
    return count_leq(fc, pos)


def block_stream(
    starts: torch.Tensor, sizes: torch.Tensor, g: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert a position stream to a G-block stream (G = 1 << g).

    A range [start, start+size) covers the G-aligned blocks
    floor(start/G) .. floor((start+size-1)/G); empty ranges cover none.
    Returns (bstarts, bcounts) (Q, M) int32; g=0 is the identity.
    """
    if g == 0:
        return starts, sizes
    bstarts = starts >> g
    bend = (starts + sizes + ((1 << g) - 1)) >> g
    bcounts = torch.where(sizes > 0, bend - bstarts, torch.zeros_like(bend))
    return bstarts, bcounts


def _take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, j.to(torch.int64))


def blocked_window(
    fc_b: torch.Tensor,
    off_b: torch.Tensor,
    wb: int,
    bstarts: torch.Tensor,
    starts_s: torch.Tensor,
    sizes_s: torch.Tensor,
    g: int,
    dense_index: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map WB block-stream positions per query to gatherable blocks.

    fc_b: (Q, M) cumsum of block counts; off_b: (Q,) cursor in blocks.
    Returns j (Q, WB) range index, blk (Q, WB) table block (slot // G),
    lane_slot (Q, WB, G) table slot of each lane, lane_valid (Q, WB, G)
    lane inside its range and the stream.
    """
    M = fc_b.shape[1]
    G = 1 << g
    pos = off_b[:, None] + torch.arange(wb, dtype=off_b.dtype, device=off_b.device)[None, :]
    total_b = fc_b[:, -1]
    j = torch.clamp(window_range_index(fc_b, off_b, wb, dense=dense_index), 0, M - 1)
    prev = torch.where(j > 0, _take(fc_b, torch.clamp(j - 1, min=0)), torch.zeros_like(j))
    blk = _take(bstarts, j) + (pos - prev)
    st = _take(starts_s, j)
    en = st + _take(sizes_s, j)
    lane_slot = blk[:, :, None] * G + torch.arange(G, dtype=blk.dtype, device=blk.device)
    lane_valid = (
        (lane_slot >= st[:, :, None])
        & (lane_slot < en[:, :, None])
        & (pos < total_b[:, None])[:, :, None]
    )
    return j, blk, lane_slot, lane_valid


def stream_block_map(
    fc: torch.Tensor,
    bstarts: torch.Tensor,
    starts_s: torch.Tensor,
    sizes_s: torch.Tensor,
    g: int,
    L: int,
    tb: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The block-stream mapping of the first tb positions, computed once.

    Position p of query q lands in range j = #{m: fc[m] <= p} at block
    bstarts[j] + (p - fc[j-1]); that depends only on the stream layout, so
    the loop reads a window of this map instead of re-deriving it. Returns
    one packed (Q, tb, 3) int32 array: [..., 0] table (j % L), [..., 1]
    table block, [..., 2] lane-validity mask (bit l set iff slot
    blk*G + l lies in p's range and p < total; a 32-bit word as int32).
    Equal to blocked_window at every valid position; requires G <= 32.
    Position p's entry does not depend on tb. `out`, a (Q, tb, 3) int32
    tensor (a view of a deeper buffer, say), receives the map in place of
    a new array.
    """
    Q, M = fc.shape
    G = 1 << g
    if G > 32:
        raise ValueError(f"stream_block_map supports G<=32, got {G}")
    dev = fc.device
    bump = torch.zeros((Q, tb + 1), dtype=torch.int32, device=dev)
    bump.scatter_add_(1, torch.clamp(fc, 0, tb).to(torch.int64),
                      torch.ones_like(fc, dtype=torch.int32))
    j = torch.clamp(torch.cumsum(bump[:, :tb], dim=1), 0, M - 1)
    prev = torch.where(j > 0, _take(fc, torch.clamp(j - 1, min=0)), torch.zeros_like(j))
    pos = torch.arange(tb, dtype=torch.int64, device=dev)[None, :]
    blk = _take(bstarts, j) + (pos - prev)
    st = _take(starts_s, j)
    en = st + _take(sizes_s, j)
    base = blk << g
    lo = torch.clamp(st - base, 0, G)
    hi = torch.maximum(torch.clamp(en - base, 0, G), lo)
    one = torch.ones_like(hi)
    # (1 << b) - 1 in int64: exact at b == 32, where uint32 would wrap
    mask = ((one << hi) - 1) ^ ((one << lo) - 1)
    mask = torch.where(pos < fc[:, -1:], mask, torch.zeros_like(mask))
    planes = ((j % L).to(torch.int32), blk.to(torch.int32), to_int32_bits(mask))
    if out is None:
        return torch.stack(planes, dim=2)
    for i, plane in enumerate(planes):
        out[:, :, i] = plane
    return out


def candidate_stream(
    lo: torch.Tensor,
    hi: torch.Tensor,
    query_hashes: torch.Tensor,
    max_hashbits: int,
    min_depth: int = 1,
    start_depth: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All revealed ranges of a query's whole peeling walk, flattened.

    Returns (starts, sizes): (Q, M) int32 with M = (start_depth - min_depth
    + 1) * L, depth-major descending (index j is depth start_depth - j // L,
    table j % L). The first L slots hold the entry range [lo_s, hi_s) at
    start_depth; each later level is the one-sided spill revealed by peeling
    one prefix bit: above [hi_{d+1}, hi_d) when the peeled bit is 0, below
    [lo_d, lo_{d+1}) when it is 1 (prefixmap.hpp:272-279).
    """
    Q, L, _ = lo.shape
    D = max_hashbits
    S = D if start_depth is None else min(start_depth, D)
    dev = lo.device
    depths = torch.arange(S, min_depth - 1, -1, dtype=torch.int64, device=dev)  # S..min
    nd = depths.shape[0]
    lo_d = lo[:, :, min_depth : S + 1].flip(2)
    hi_d = hi[:, :, min_depth : S + 1].flip(2)
    lo_d1 = torch.cat([lo_d[:, :, :1], lo_d[:, :, :-1]], dim=2)
    hi_d1 = torch.cat([hi_d[:, :, :1], hi_d[:, :, :-1]], dim=2)
    # the JAX package's uint32 (D - (d+1)) % 32 (31 at d == D, where the
    # bit is unused: that level is the entry range)
    shift = torch.remainder(D - (depths + 1), 32)
    bit = (query_hashes.to(torch.int64)[:, :, None] >> shift[None, None, :]) & 1
    exact = (depths == S)[None, None, :]
    start = torch.where(exact, lo_d, torch.where(bit == 0, hi_d1, lo_d))
    end = torch.where(exact, hi_d, torch.where(bit == 0, hi_d, lo_d1))
    sizes = torch.clamp(end - start, min=0)
    starts = start.transpose(1, 2).reshape(Q, nd * L)
    sizes = sizes.transpose(1, 2).reshape(Q, nd * L)
    return starts.to(torch.int32), sizes.to(torch.int32)

"""Block-probed fused scan (PyTorch port of ``clann_tpu.ops.pallas.block_scan``).

The dataset is laid out cluster-major and cut into `block_n`-row blocks, each
with a centroid c, a radius r and sampled representative rows. A query ranks
the blocks by its best representative, probes only its top `n_probe` blocks
with the packed scan kernel, and re-scores the winners exactly. The sound
bound q . c + r of the unprobed blocks gives the `uncertified` stat.

- ``block_scan_candidates_packed`` is the wrapper of K3, the hand-written
  CUDA kernel in ``csrc/block_scan.cu`` that replaces the ``pallas_call`` of
  the JAX ``block_scan_topk_e2e``: K1's packed bin winners for tiles of
  pre-gathered query slots, tile t against base block ``tile_block[t]``.
  ``block_candidates_plain`` is its plain PyTorch version (CPU tensors, and
  the reference on the card).
- ``block_scan_topk_e2e`` is one batch on the device: ranking, the pair
  bookkeeping with static sizes (no host sync), K3, the decode, the exact
  rescore and the stats. ``block_scan_search`` and
  ``block_scan_search_adaptive`` are the index-level entries.

The layout's random draws (representatives and the within-block shuffle)
come from ``torch.Generator``s, so they differ from JAX's; the tests carry a
JAX layout across with ``layout_from_arrays``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from clann_tpu_torch.metrics.trace import TRACER
from clann_tpu_torch.ops.distances import (
    _normalize_queries, as_device_f32, refuse_interpret, rescore, resolve_device)
from clann_tpu_torch.ops.scan_topk import (
    _INVALID,
    _check_cuda_operands,
    _check_operands,
    _check_tma_rows,
    packed_candidates_plain,
)

# Launches of the K3 kernel made by block_scan_candidates_packed (the plain
# version never counts). A run resets it and reads it back to show that its
# path went through the kernel.
KERNEL_LAUNCHES = 0

LAYOUT_FIELDS = ("base_bf16", "base_f32", "gids", "centroids", "radii", "reps",
                 "block_rows")

# real packed scores are bitcast(dot + 3.0) with dot >= ~-1, so >= ~2.0, an
# int >= 0x40000000; dead slots and pad rows carry bias 0 and pack below
# 2^14. The floor at bitcast(1.0) keeps every real score and drops the rest.
_VALID_FLOOR = 0x3F800000


def dead_slot_winner(per_bin: int) -> int:
    """The packed winner of a slot or a block that scores 0 on every row (a
    dead slot's query row, bias included, is zero; so is every row of a
    block outside the base): (bitcast(0.0) & ~(per_bin - 1)) | (per_bin -
    1). K3 writes it for the work it skips, and the plain version computes
    it there."""
    return per_bin - 1


@dataclasses.dataclass(eq=False)
class BlockLayout:
    """Cluster-major blocked copy of an index's vectors (device tensors)."""

    base_bf16: torch.Tensor  # (n_pad, dpad) bf16, bias col 1.0 at [:, d] on real rows
    base_f32: torch.Tensor  # (n_pad, d) f32 permuted, pad rows zero
    gids: torch.Tensor  # (n_pad,) int32 global ids, -1 on pad rows
    centroids: torch.Tensor  # (n_blocks, d) f32 block centroids (means)
    radii: torch.Tensor  # (n_blocks,) f32 max member distance to centroid
    reps: torch.Tensor  # (n_blocks, R, d) f32 ranking representatives
    block_rows: torch.Tensor  # (n_blocks,) int32 real rows per block
    block_n: int
    d: int

    @property
    def n_blocks(self) -> int:
        return self.centroids.shape[0]


def build_block_layout(vectors, assignment, block_n: int, num_reps: int = 64,
                       seed: int = 0, device=None) -> BlockLayout:
    """Cluster-major permutation + per-block geometry (JAX function's steps
    in its order).

    `vectors` must already be L2-normalized. Blocks cut the stable
    cluster-major order at block_n strides. `centroids`/`radii` give the
    sound bound q . x <= q . c + r; `reps` (num_reps rows drawn uniformly
    from each block's real rows) rank the blocks. The rows of each block are
    then shuffled, so that a query's neighbours spread over the kernel's
    bins; the reps are drawn first, while the real rows still form each
    block's prefix. `device` defaults to the device of `vectors`, or the
    card for numpy input (no fallback: a CPU caller passes device="cpu").
    """
    if device is None:
        device = vectors.device if isinstance(vectors, torch.Tensor) else resolve_device("cuda")
    x = as_device_f32(vectors, device)
    dev = x.device
    n, d = x.shape
    if not isinstance(assignment, torch.Tensor):
        assignment = torch.from_numpy(np.array(assignment))  # a writable copy
    order = torch.argsort(assignment.to(dev, torch.int32), stable=True)
    n_pad = ((n + block_n - 1) // block_n) * block_n
    n_blocks = n_pad // block_n

    xp = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    xp[:n] = x[order]
    gids = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    gids[:n] = order.to(torch.int32)
    real = (gids >= 0).view(n_blocks, block_n)
    rows = real.sum(dim=1).to(torch.int32)
    xb = xp.view(n_blocks, block_n, d)
    cent = xb.sum(dim=1) / torch.clamp(rows, min=1)[:, None].float()
    dist = torch.linalg.vector_norm(xb - cent[:, None, :], dim=-1)
    radii = torch.where(real, dist, 0.0).amax(dim=1)

    R = max(1, min(num_reps, block_n))
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = torch.randint(0, 1 << 30, (n_blocks, R), generator=gen, device=dev)
    draw = draw % torch.clamp(rows, min=1)[:, None]
    reps = xb[torch.arange(n_blocks, device=dev)[:, None], draw]

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    local = torch.argsort(
        torch.rand((n_blocks, block_n), generator=gen, device=dev), dim=1)
    shuf = (torch.arange(n_blocks, device=dev)[:, None] * block_n + local).reshape(-1)
    xp = xp[shuf]
    gids = gids[shuf]

    dpad = ((d + 1 + 127) // 128) * 128
    bb = torch.zeros((n_pad, dpad), dtype=torch.bfloat16, device=dev)
    bb[:, :d] = xp.to(torch.bfloat16)
    bb[:, d] = (gids >= 0).to(torch.bfloat16)
    return BlockLayout(bb, xp, gids, cent, radii, reps, rows, block_n, d)


def layout_from_arrays(arrays: Dict[str, np.ndarray], block_n: int,
                       device="cuda") -> BlockLayout:
    """A BlockLayout on `device` from LAYOUT_FIELDS as numpy arrays, e.g.
    the fields of a layout built by the JAX package (`base_bf16` given in
    float32: its values are bf16, so the conversion back is exact)."""
    missing = [f for f in LAYOUT_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"layout arrays missing {missing}")

    def t(name, dtype):
        a = np.asarray(arrays[name])
        if dtype.is_floating_point:
            a = a.astype(np.float32)
        return torch.tensor(a, device=device).to(dtype)  # a copy

    base_f32 = t("base_f32", torch.float32)
    return BlockLayout(
        base_bf16=t("base_bf16", torch.bfloat16),
        base_f32=base_f32,
        gids=t("gids", torch.int32),
        centroids=t("centroids", torch.float32),
        radii=t("radii", torch.float32),
        reps=t("reps", torch.float32),
        block_rows=t("block_rows", torch.int32),
        block_n=block_n,
        d=base_f32.shape[1],
    )


def auto_block_probe(n_blocks: int) -> int:
    """Default probe budget: ~a quarter of the blocks, at least 2."""
    return min(n_blocks, max(2, round(n_blocks * 0.25)))


def block_scan_candidates_packed(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16
    queries_bf16: torch.Tensor,  # (T * q_tile, dpad) bf16, pre-gathered slots
    tile_block: torch.Tensor,  # (T,) int32 base block of each tile
    *,
    block_n: int,
    q_tile: int,
    per_bin: int,
    tile_live: Optional[torch.Tensor] = None,  # (T,) int32 live slots per tile
) -> torch.Tensor:
    """K3: packed bin winners of tile t's q_tile slots against base block
    tile_block[t], (T * block_n // per_bin, q_tile) int32 (always biased:
    the bias column carries the +3.0).

    CUDA tensors launch the hand-written kernel on the current stream (and
    raise on anything it does not take); CPU tensors run
    block_candidates_plain. A block id outside [0, ceil(n_pad / block_n))
    scans no rows (its winners are those of zero rows). `tile_live` (from
    pair_tiles) says that only the first tile_live[t] slots of tile t are
    live, the rest having all-zero query rows: the kernel then skips the
    groups of 256 slots that hold no live one and writes their winners,
    dead_slot_winner(per_bin), without scanning. The result is the same
    with or without it.
    """
    global KERNEL_LAUNCHES

    _check_block_args(base_bf16, queries_bf16, tile_block, block_n, q_tile, per_bin)
    if tile_live is not None and (
            tile_live.dtype != torch.int32 or tile_live.shape != tile_block.shape
            or tile_live.device != tile_block.device):
        raise ValueError("tile_live must be an int32 tensor shaped and placed like tile_block")
    n_blocks = -(-base_bf16.shape[0] // block_n)
    _check_tma_rows(n_blocks * block_n, queries_bf16.shape[0])
    if base_bf16.device.type == "cpu":
        return block_candidates_plain(base_bf16, queries_bf16, tile_block,
                                      block_n=block_n, q_tile=q_tile, per_bin=per_bin)
    _check_cuda_operands(base_bf16, queries_bf16)
    if not tile_block.is_contiguous() or not (tile_live is None or tile_live.is_contiguous()):
        raise ValueError("tile_block and tile_live must be contiguous")
    n_pad, dpad = base_bf16.shape
    n_tiles = tile_block.shape[0]

    from clann_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = base_bf16.device
    out = torch.empty((n_tiles * (block_n // per_bin), q_tile), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out  # nothing to launch (and nothing counted)
    code = lib.clann_block_scan_packed(
        base_bf16.data_ptr(), queries_bf16.data_ptr(), tile_block.data_ptr(),
        None if tile_live is None else tile_live.data_ptr(),
        out.data_ptr(), n_pad, block_n, q_tile, n_tiles, dpad, per_bin,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "clann_block_scan_packed launch")
    with _build.COUNT_LOCK:  # launched from the mesh runner's threads too
        KERNEL_LAUNCHES += 1
    return out


def _check_block_args(base_bf16, queries_bf16, tile_block, block_n, q_tile, per_bin):
    _check_operands(base_bf16, queries_bf16, per_bin)
    if per_bin > (1 << 14):
        raise ValueError(f"per_bin={per_bin} exceeds 16384")
    if tile_block.dtype != torch.int32 or tile_block.dim() != 1:
        raise ValueError("tile_block must be a 1-D int32 tensor")
    if tile_block.device != base_bf16.device:
        raise ValueError("tile_block must be on the operands' device")
    if block_n % per_bin or q_tile < 1:
        raise ValueError(f"block_n={block_n} must be a multiple of per_bin={per_bin} "
                         f"and q_tile={q_tile} positive")
    if queries_bf16.shape[0] != tile_block.shape[0] * q_tile:
        raise ValueError(
            f"queries {tuple(queries_bf16.shape)} do not hold "
            f"{tile_block.shape[0]} tiles of q_tile={q_tile}"
        )


def block_candidates_plain(
    base_bf16: torch.Tensor,
    queries_bf16: torch.Tensor,
    tile_block: torch.Tensor,
    *,
    block_n: int,
    q_tile: int,
    per_bin: int,
) -> torch.Tensor:
    """K3's function in plain PyTorch: packed_candidates_plain (biased) of
    each tile's slots against its block, tile by tile. As in the kernel, a
    block's rows past n_pad, and every row of a block id outside
    [0, n_pad), read as zero."""
    _check_block_args(base_bf16, queries_bf16, tile_block, block_n, q_tile, per_bin)
    n_pad, dpad = base_bf16.shape
    outs = []
    for t, b in enumerate(tile_block.tolist()):
        blk = base_bf16[b * block_n : (b + 1) * block_n] if b >= 0 else base_bf16[:0]
        if blk.shape[0] < block_n:
            blk = torch.cat([blk, blk.new_zeros((block_n - blk.shape[0], dpad))])
        outs.append(packed_candidates_plain(
            blk, queries_bf16[t * q_tile : (t + 1) * q_tile], per_bin=per_bin,
            biased=True, block_rows=block_n,
        ))
    if not outs:
        return torch.empty((0, q_tile), dtype=torch.int32, device=base_bf16.device)
    return torch.cat(outs)


def rank_blocks(layout: BlockLayout, qn: torch.Tensor, B: int):
    """(wants (Q, B) int64: each query's B best blocks by the max over the
    representatives, best first; ub (Q, n_blocks): the sound bound
    q . c + r). A stable descending sort keeps lax.top_k's order, lower
    block first among ties."""
    score = torch.einsum("qd,brd->qbr", qn, layout.reps).amax(dim=-1)
    ub = qn @ layout.centroids.T + layout.radii[None, :]
    wants = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :B]
    return wants, ub


def pair_tiles(wants: torch.Tensor, qn: torch.Tensor, *, n_blocks: int,
               q_tile: int, dpad: int):
    """K3's operands for the (query, block) pairs of `wants`, with static
    sizes (no host sync).

    The Q * B pairs are sorted by block into per-block runs, each run padded
    to a multiple of q_tile and cut into tiles; T = Q * B // q_tile +
    n_blocks bounds the tile count. Returns (ipos (Q, B) int64: the padded
    slot of each pair; tile_block (T,) int32: each tile's block, tiles past
    the last run on the last block, n_blocks - 1 (clipped); qg (T * q_tile,
    dpad) bf16: each slot's query, bias column 3.0 on live slots and all
    zeros on dead ones; tile_live (T,) int32: each tile's live slots, which
    are a prefix of the tile because a run packs its pairs at its start,
    and 0 past the last run).
    """
    Q, B = wants.shape
    d = qn.shape[1]
    dev = wants.device
    PB = Q * B
    T = PB // q_tile + n_blocks
    bb = wants.reshape(-1)
    qq = torch.arange(Q, device=dev).repeat_interleave(B)
    order = torch.argsort(bb, stable=True)
    sb, sq = bb[order], qq[order]
    counts = torch.zeros(n_blocks, dtype=torch.int64, device=dev).scatter_add_(
        0, bb, torch.ones_like(bb))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    starts = torch.cat([zero, torch.cumsum(counts, 0)])
    padded = ((counts + q_tile - 1) // q_tile) * q_tile
    pstarts = torch.cat([zero, torch.cumsum(padded, 0)])  # pstarts[-1] <= T * q_tile
    ppos = pstarts[sb] + (torch.arange(PB, device=dev) - starts[sb])
    slot_q = torch.full((T * q_tile,), -1, dtype=torch.int64, device=dev)
    slot_q[ppos] = sq
    tile_starts = torch.arange(T, device=dev) * q_tile
    tile_blk = torch.clamp(
        torch.searchsorted(pstarts, tile_starts, right=True) - 1, 0, n_blocks - 1)
    tile_block = tile_blk.to(torch.int32)
    # the run of tile_blk holds its live slots at [pstarts, pstarts + counts)
    tile_live = torch.clamp(pstarts[tile_blk] + counts[tile_blk] - tile_starts, 0,
                            q_tile).to(torch.int32)

    live = slot_q >= 0
    qrows = qn[torch.clamp(slot_q, 0, Q - 1)].to(torch.bfloat16)
    qg = torch.zeros((T * q_tile, dpad), dtype=torch.bfloat16, device=dev)
    qg[:, :d] = torch.where(live[:, None], qrows, 0)
    qg[:, d] = live.to(torch.bfloat16) * 3.0
    ipos = torch.empty(PB, dtype=torch.int64, device=dev)
    ipos[order] = ppos
    return ipos.view(Q, B), tile_block, qg, tile_live


def block_scan_topk_e2e(
    layout: BlockLayout,
    queries_f32: torch.Tensor,  # (Q, d), normalized inside
    *,
    k: int,
    n_probe: int,
    rescore_m: int = 32,
    num_bins: int = 64,
    block_n: int = 32768,
    q_tile: int = 256,
    interpret: bool = False,
):
    """One batch of the block-probed query path, all on the device.

    Every query gets exactly its own top-B blocks (B = min(n_probe,
    n_blocks)). Returns (sims desc (Q, k) f32 exact, ids (Q, k) int64
    global (-1 where empty), dc (Q,) int32 rows probed, uncertified (Q,)
    int32 unprobed blocks whose bound exceeds the k-th similarity).
    `interpret`: distances.refuse_interpret.
    """
    refuse_interpret(interpret, layout.base_bf16.device)
    n_pad, dpad = layout.base_bf16.shape
    n_blocks = n_pad // block_n
    B = min(n_probe, n_blocks)
    Q = queries_f32.shape[0]
    per_bin = block_n // num_bins

    qn = _normalize_queries(queries_f32)
    wants, ub = rank_blocks(layout, qn, B)
    ipos, tile_block, qg, tile_live = pair_tiles(wants, qn, n_blocks=n_blocks,
                                                 q_tile=q_tile, dpad=dpad)
    packed = block_scan_candidates_packed(
        layout.base_bf16, qg, tile_block, block_n=block_n, q_tile=q_tile,
        per_bin=per_bin, tile_live=tile_live,
    )

    # decode the per-pair winners back to query-major (Q, B * nb)
    tiles = packed.view(-1, num_bins, q_tile)
    bins = torch.arange(num_bins, device=packed.device)
    pk = tiles[(ipos // q_tile)[:, :, None], bins, (ipos % q_tile)[:, :, None]]
    pk = pk.reshape(Q, B * num_bins)
    sub = (pk & (per_bin - 1)).long()
    pos = (wants.repeat_interleave(num_bins, dim=1) * block_n
           + bins.repeat(B)[None, :] * per_bin + sub)
    pk = torch.where(pk >= _VALID_FLOOR, pk, _INVALID)

    # exact rescore of the best rescore_m (by packed value) in permuted space;
    # a stable sort keeps lax.top_k's tie order (lower index first)
    m = min(rescore_m, B * num_bins)
    if B * num_bins > m:
        top_p, sel = torch.sort(pk, dim=1, descending=True, stable=True)
        top_p, pos = top_p[:, :m], torch.gather(pos, 1, sel[:, :m])
    else:
        top_p = pk
    ex = rescore(layout.base_f32, torch.where(top_p > _INVALID, pos, -1), qn)
    sims, sel2 = torch.topk(ex, k, dim=1)
    pos_k = torch.gather(pos, 1, sel2)
    ids = torch.where(
        torch.isfinite(sims),
        layout.gids[torch.clamp(pos_k, 0, n_pad - 1)].long(),
        -1,
    )

    # stats: rows probed, and the unprobed blocks whose bound beats the k-th
    dc = layout.block_rows[wants].sum(dim=1).to(torch.int32)
    probed = torch.zeros((Q, n_blocks), dtype=torch.bool, device=wants.device)
    probed.scatter_(1, wants, True)
    unc = ((ub > sims[:, k - 1 : k]) & ~probed).sum(dim=1).to(torch.int32)
    return sims, ids, dc, unc


def get_block_layout(index, block_n: int) -> BlockLayout:
    """build_block_layout of the index, cached on it (keyed by the vectors
    tensor and block_n; at most three layouts, as in the JAX cache)."""
    cache = index.block_layout_cache
    key = (id(index.vectors), block_n)
    hit = cache.get(key)
    if hit is not None and hit[0] is index.vectors:
        return hit[1]
    layout = build_block_layout(index.vectors, index.assignment, block_n)
    if len(cache) > 2:
        cache.clear()
    cache[key] = (index.vectors, layout)
    return layout


def block_scan_search_adaptive(
    index,
    queries,
    k: Optional[int] = None,
    n_probe0: Optional[int] = None,
    batch_q: int = 4096,
    interpret: Optional[bool] = None,
    block_n: Optional[int] = None,
):
    """Certificate-driven block probing: rounds of block_scan_search with a
    doubling budget, re-running only the queries whose block certificate
    failed, until every query is certified or the budget covers all blocks.

    Returns (dists, ids, DenseSearchStats) like block_scan_search;
    distance_computations accumulates every streamed row across rounds.
    As in the JAX function, `block_n` only sets the block count that caps
    the budget: every round runs at the plan's block_n. `interpret`:
    distances.refuse_interpret.
    """
    from clann_tpu_torch.ops.ivf import DenseSearchStats, pallas_scan_plan

    k = index.config.k if k is None else k
    q = as_device_f32(queries, index.vectors.device)
    if q.dim() == 1:
        q = q[None, :]
    Q = q.shape[0]
    n = index.vectors.shape[0]
    block_n = block_n or pallas_scan_plan(n, k, d=int(index.vectors.shape[1]))[0]
    n_blocks = get_block_layout(index, block_n).n_blocks
    B = min(n_blocks, n_probe0 or max(2, round(n_blocks / 16)))

    dists = np.full((Q, k), np.inf, np.float32)
    ids = np.full((Q, k), -1, np.int32)
    dc = np.zeros(Q, np.int64)
    visited = np.zeros(Q, np.int32)
    unc = np.zeros(Q, np.int32)
    remaining = np.arange(Q)
    while len(remaining):
        d_r, i_r, st = block_scan_search(index, q[remaining], k=k, n_probe=B,
                                         batch_q=batch_q, interpret=interpret)
        dists[remaining] = d_r
        ids[remaining] = i_r
        dc[remaining] += st.distance_computations
        visited[remaining] = B
        unc[remaining] = st.uncertified
        bad = st.uncertified > 0
        if not bad.any() or B >= n_blocks:
            break
        remaining = remaining[bad]
        B = min(n_blocks, 2 * B)
    return dists, ids, DenseSearchStats(
        distance_computations=dc,
        candidates=dc,
        clusters_visited=visited,
        dropped_probes=np.int32(0),
        uncertified=unc,
    )


def block_scan_search(
    index,
    queries,
    k: Optional[int] = None,
    n_probe: Optional[int] = None,
    batch_q: int = 4096,
    interpret: Optional[bool] = None,
    block_n: Optional[int] = None,
):
    """Block-probed fused scan over a ClusteredIndex, on its device.

    Returns (dists ascending (Q, k), ids (Q, k) int32, DenseSearchStats) as
    numpy, like ivf.scan_search, with one host transfer per call. dc counts
    the rows streamed per query; `uncertified` counts unprobed blocks whose
    centroid bound exceeds the returned k-th similarity (0 is a block-level
    certificate). Within probed blocks the result keeps the fused scan's
    bin-winner approximation. `interpret`: distances.refuse_interpret.
    """
    from clann_tpu_torch.ops.ivf import DenseSearchStats, pallas_scan_plan

    k = index.config.k if k is None else k
    qn = as_device_f32(queries, index.vectors.device)
    if qn.dim() == 1:
        qn = qn[None, :]
    n = index.vectors.shape[0]
    plan_bn, num_bins, rescore_m, q_tile = pallas_scan_plan(
        n, k, d=int(index.vectors.shape[1]))
    block_n = block_n or plan_bn
    num_bins = min(num_bins, block_n)  # an overridden block_n may be smaller
    layout = get_block_layout(index, block_n)
    n_blocks = layout.n_blocks
    B = min(n_blocks, n_probe or auto_block_probe(n_blocks))

    outs = []
    for s in range(0, qn.shape[0], batch_q):
        sims, ids, dc, unc = block_scan_topk_e2e(
            layout, qn[s : s + batch_q], k=k, n_probe=B, rescore_m=rescore_m,
            num_bins=num_bins, block_n=block_n, q_tile=q_tile, interpret=interpret,
        )
        # one int32 tensor (sims as their bit patterns) so that the call
        # makes a single device-to-host copy
        outs.append(torch.cat([sims.view(torch.int32), ids.to(torch.int32),
                               dc[:, None], unc[:, None]], dim=1))
    with TRACER.span("search/pull"):  # waits for the scan
        flat = (torch.cat(outs) if outs
                else torch.zeros((0, 2 * k + 2), dtype=torch.int32)).cpu().numpy()
    with TRACER.span("search/to_numpy"):
        sims = np.ascontiguousarray(flat[:, :k]).view(np.float32)
        ids = np.ascontiguousarray(flat[:, k : 2 * k])
        dists = np.where(ids >= 0, np.clip(1.0 - sims, 0.0, 2.0), np.inf)
        Q = ids.shape[0]
        stats = DenseSearchStats(
            distance_computations=flat[:, 2 * k].copy(),
            candidates=flat[:, 2 * k].copy(),
            clusters_visited=np.full(Q, B, np.int32),
            dropped_probes=np.int32(0),
            uncertified=flat[:, 2 * k + 1].copy(),
        )
    return dists, ids, stats

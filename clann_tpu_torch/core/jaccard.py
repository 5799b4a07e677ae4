"""Standalone Jaccard (set) LSH index (PyTorch port of ``clann_tpu.core.jaccard``).

PUFFINN's Jaccard instantiation (Index<JaccardSimilarity>: MinHash tables,
MinHash1Bit sketches, similarity_measure/jaccard.hpp defaults). As in the
reference, whose clustered layer wires cosine only (SURVEY §2.2), the index
is flat: one segment per table. `build_jaccard_index(clustered=True)` adds
CLANN's composition on top: Gonzalez clustering over Jaccard distance and
ball geometry, which drops candidates from balls that cannot beat the k-th
and stops a query when no ball can. 1 - J is a metric, so the filter is
exact and the results equal the flat index's.

The δ engine is the global cosine engine's loop (ops/global_query.py) on
set records: the same stream of prefix ranges, stream map, dead-block
routing and K7 record gather (`[id, sketch words, cluster]` per table
slot, G per gather), the sketch filter, an exact Jaccard re-score of the
compacted candidates against each query's bitmap, the dedup top-k merge
and the failure-probability stop (independent.hpp:108-119).
`jaccard_scan` is the exact dense scan: 0/1 multi-hot products over point
blocks.

What changes from the JAX package, none of it in the results: the
`lax.while_loop` is ops/global_query's Python loop of device work (one
host sync per SYNC_EVERY steps); the ball filter gathers the (Q, C)
feasibility booleans where JAX contracts a one-hot on the MXU; the packed
records are made on the device at build (JAX packs them on the host, a
TPU workaround). The port's own draws come from torch.Generators seeded
from config.seed; tests carry JAX's index across with
`jaccard_index_from_arrays`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.core.index import _as_tensor, _generators, _params
from clann_tpu_torch.data.setdata import JaccardData, _multi_hot, multi_hot_counts, pad_sets
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.ops.collision import HashSourceProbs
from clann_tpu_torch.ops.distances import resolve_device
from clann_tpu_torch.ops.global_query import (
    _advance,
    _attach_stream_map,
    _consumer,
    _map_tb,
    _record_window,
)
from clann_tpu_torch.ops.minhash import (
    MinHash,
    MinHash1Bit,
    TabulationMinHash,
    TabulationMinHash1Bit,
)
from clann_tpu_torch.ops.prefixmap import (
    block_stream,
    candidate_stream,
    count_leq,
    depth_bounds,
    sort_tables_segmented,
)
from clann_tpu_torch.ops.query import (
    LoopStats,
    SearchStats,
    _compact_take,
    _merge_topk,
    probs_lookup,
    topk_stable,
)
from clann_tpu_torch.ops.sketches import pack_bits_u32, popcount32, to_int32_bits
from clann_tpu_torch.ops.sources import IndependentHashSource

# arrays of a JaccardIndex (None where not built) and their dtypes in the
# port; JAX's uint32 words are int32 bit patterns
JACCARD_FIELDS = {
    "tokens": torch.int32,
    "set_sizes": torch.int32,
    "sorted_hash": torch.int32,
    "sorted_idx": torch.int32,
    "sketches": torch.int32,
    "probs_table": torch.float32,
    "sketch_p1_table": torch.int32,
    "center_ids": torch.int32,
    "radii": torch.float32,
    "assignment": torch.int32,
    "g_records": torch.int32,
}
# static metadata, JAX's names and defaults
JACCARD_META = {"universe": 0, "sim_eps": 5e-3, "table_hash": "minhash",
                "sketch_hash": "1bit_minhash"}


@dataclasses.dataclass(eq=False)
class JaccardIndex:
    """Device-resident set LSH index (the JAX package's fields)."""

    tokens: torch.Tensor  # (n, T) int32 sorted padded token sets
    set_sizes: torch.Tensor  # (n,) int32
    sorted_hash: torch.Tensor  # (L, n) int32
    sorted_idx: torch.Tensor  # (L, n) int32
    sketches: torch.Tensor  # (n, S, W) int32 MinHash1Bit sketch words
    hash_params: Any
    sketch_params: Any
    probs_table: torch.Tensor  # (D+2, B) f32
    sketch_p1_table: torch.Tensor  # (B,) int32 sketch threshold per sim bucket
    # optional CLANN composition (clustered=True): Gonzalez clustering over
    # Jaccard distance
    center_ids: Optional[torch.Tensor] = None  # (C,) int32 point id of each center
    radii: Optional[torch.Tensor] = None  # (C,) f32 largest member distance
    assignment: Optional[torch.Tensor] = None  # (n,) int32 cluster of each point
    # [id, sketch words, cluster] per (table, sorted slot), slot axis padded
    # to config.gather_block (the cosine global engine's record layout)
    g_records: Optional[torch.Tensor] = None  # (L, n_pad, 2 + W) int32
    config: Config = None
    universe: int = 0
    sim_eps: float = 5e-3
    # table family: "minhash" (the reference's default), "1bit_minhash" or
    # "tabulation_minhash" (the reference's exact functions); queries hash
    # with the family the tables were built with
    table_hash: str = "minhash"
    # sketch family: "1bit_minhash" or "tabulation_1bit"
    sketch_hash: str = "1bit_minhash"

    @property
    def n(self) -> int:
        return self.tokens.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tokens.device


def jaccard_table_family(table_hash: str, universe: int):
    """Hash family behind a JaccardIndex's tables (see its table_hash)."""
    if table_hash == "minhash":
        return MinHash(universe)
    if table_hash == "1bit_minhash":
        return MinHash1Bit(universe)
    if table_hash == "tabulation_minhash":
        return TabulationMinHash(universe)
    raise DataError(
        f"unknown table_hash {table_hash!r}; expected 'minhash', "
        "'1bit_minhash' or 'tabulation_minhash'"
    )


def jaccard_sketch_family(sketch_hash: str, universe: int):
    if sketch_hash == "1bit_minhash":
        return MinHash1Bit(universe)
    if sketch_hash == "tabulation_1bit":
        return TabulationMinHash1Bit(universe)
    raise DataError(
        f"unknown sketch_hash {sketch_hash!r}; expected '1bit_minhash' or 'tabulation_1bit'"
    )


def _member_of(bitmaps: torch.Tensor, tokens: torch.Tensor, universe: int) -> torch.Tensor:
    """1.0 where a token is set in its row's bitmap: bitmaps (..., Wu)
    int32 words, tokens (..., T) (pads may be anything; mask them)."""
    t = torch.clamp(tokens, 0, universe - 1).to(torch.int64)
    words = torch.gather(bitmaps, -1, (t >> 5).reshape(*bitmaps.shape[:-1], -1))
    # an arithmetic shift of an int32 word still brings bit (t & 31) to bit 0
    return ((words.reshape(t.shape) >> (t & 31)) & 1).to(torch.float32)


def _set_bitmaps(tokens: torch.Tensor, universe: int) -> torch.Tensor:
    """(m, ceil(U/32)) int32 multi-hot bitmaps of padded sets. Tokens are
    unique per row, so adding their single-bit words (in int64, where bit
    31 is positive) is an or."""
    words = -(-universe // 32)
    valid = tokens >= 0
    t = torch.clamp(tokens, 0, universe - 1).to(torch.int64)
    bits = torch.where(valid, torch.ones_like(t) << (t & 31), 0)
    bm = torch.zeros((tokens.shape[0], words), dtype=torch.int64, device=tokens.device)
    return to_int32_bits(bm.scatter_add_(1, t >> 5, bits))


def _jaccard_from_counts(inter, sizes_a, sizes_b):
    union = sizes_a + sizes_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def _set_gmm(tokens: torch.Tensor, k: int, universe: int):
    """Greedy min-max (Gonzalez) clustering over Jaccard distance
    (src/core/gmm.rs:21-63 with dist = 1 - J). The first center is point
    0, each next one the point farthest from its center (the lowest index
    among ties); a distance column is (n, T) lookups into one center's
    bitmap, so no (n, U) tensor exists. Returns (center ids (k,) int32,
    assignment (n,) int32, radii (k,) f32), all on the device, with no host
    sync."""
    n = tokens.shape[0]
    dev = tokens.device
    valid = tokens >= 0
    sizes = valid.sum(dim=1).to(torch.float32)

    def dist_col(c):
        bm = _set_bitmaps(tokens[c][None], universe)  # (1, Wu)
        member = _member_of(bm.expand(n, -1), tokens, universe)
        inter = torch.where(valid, member, 0.0).sum(dim=1)
        return 1.0 - _jaccard_from_counts(inter, sizes, sizes[c])

    centers = torch.zeros((k,), dtype=torch.int32, device=dev)
    dists = dist_col(torch.zeros((), dtype=torch.int64, device=dev))
    assignment = torch.zeros((n,), dtype=torch.int32, device=dev)
    for idx in range(1, k):
        farthest = torch.argmax(dists)
        centers[idx] = farthest
        new = dist_col(farthest)
        closer = new < dists
        assignment = torch.where(closer, idx, assignment)
        dists = torch.where(closer, new, dists)
    radii = torch.zeros((k,), dtype=torch.float32, device=dev).scatter_reduce_(
        0, assignment.to(torch.int64), dists, "amax")
    return centers, assignment, radii


def _map_point_blocks(fn, tokens: torch.Tensor, num_functions: int,
                      budget_bytes: int = 1 << 30) -> torch.Tensor:
    """fn over row blocks of the token tensor, concatenated: MinHash makes
    an (n, T, F) int64 rank tensor, which would not fit at benchmark scale;
    blocks keep it under budget_bytes."""
    n, t = tokens.shape
    block = max(8, int(budget_bytes // (max(1, t * num_functions) * 8)))
    if block >= n:
        return fn(tokens)
    return torch.cat([fn(tokens[s : s + block]) for s in range(0, n, block)], dim=0)


def _pack_jaccard_records(sorted_idx: torch.Tensor, sketches: torch.Tensor,
                          assignment: Optional[torch.Tensor], pad_to: int = 1) -> torch.Tensor:
    """[id, sketch words, cluster] per (table, sorted slot), slot axis
    padded with zero records to a multiple of `pad_to`. Table t carries
    sketch t % S (collection.hpp:826); the cluster column is zeros on a
    flat index."""
    L, n = sorted_idx.shape
    S = sketches.shape[1]
    idx = sorted_idx.to(torch.int64)
    sk_idx = (torch.arange(L, device=idx.device) % S)[:, None]
    clus = (assignment[idx] if assignment is not None else torch.zeros_like(sorted_idx))
    rec = torch.cat([sorted_idx[:, :, None], sketches[idx, sk_idx, :],
                     clus.to(torch.int32)[:, :, None]], dim=2)
    pad = (-n) % pad_to
    if pad:
        rec = torch.nn.functional.pad(rec, (0, 0, 0, pad))
    return rec


def hash_tables(tokens: torch.Tensor, source, sketch_family, sketch_params, config: Config,
                budget_bytes: int = 1 << 30):
    """(sorted_hash (L, n), sorted_idx (L, n), sketches (n, S, W)) of the
    sets under `source`'s table functions and the sketch family's
    functions: one hashing pass in point blocks (under `budget_bytes`), one
    sketching pass, and a stable sort of each table by hash (one segment)."""
    n = tokens.shape[0]
    hashes = _map_point_blocks(source.hash, tokens,
                               source.num_hashers * source.functions_per_hasher,
                               budget_bytes)  # (n, L)
    n_fns = config.num_sketches * config.sketch_bits
    bits = _map_point_blocks(lambda tk: sketch_family.hash(sketch_params, tk), tokens,
                             n_fns, budget_bytes)  # (n, S*B) of {0, 1}
    sketches = pack_bits_u32(bits.reshape(n, config.num_sketches, config.sketch_bits))
    sorted_hash, sorted_idx = sort_tables_segmented(
        hashes.T.contiguous(), torch.zeros((n,), dtype=torch.int32, device=tokens.device))
    return sorted_hash, sorted_idx, sketches


def jaccard_probs_tables(family, sketch_family, config: Config):
    """(HashSourceProbs of the table family, the int32 sketch thresholds
    round(bits * (1 - p_1(sim))) per similarity bucket)."""
    probs = HashSourceProbs(family, config.max_hashbits, sim_eps=5e-3)
    sims_grid = np.arange(probs.table.shape[1], dtype=np.float32) * probs.sim_eps
    p1 = np.asarray(sketch_family.collision_probability(sims_grid, 1))
    return probs, np.round(config.sketch_bits * (1.0 - p1)).astype(np.int32)


def build_jaccard_index(data: JaccardData, config: Config, clustered: bool = False,
                        table_hash: str = "minhash", device="cuda") -> JaccardIndex:
    """MinHash tables + 1-bit MinHash sketches over a set dataset, on `device`.

    table_hash: "minhash" (the reference's default), "1bit_minhash" (the
    upstream python wrapper's other option, python_wrapper.cpp:289-295) or
    "tabulation_minhash" (the reference's exact functions; sketches then
    use tabulation too). clustered=True also runs Gonzalez clustering over
    Jaccard distance (factor * sqrt(n) clusters, index.rs:78-80) and keeps
    the ball geometry; the tables are unchanged, so results equal the flat
    index's and only the work is pruned.
    """
    n = data.num_points()
    if n == 0:
        raise DataError("empty dataset")
    dev = resolve_device(device)
    tokens = torch.as_tensor(data.tokens, dtype=torch.int32, device=dev)
    g_hash, g_sketch = _generators(config.seed)

    family = jaccard_table_family(table_hash, data.universe)
    sketch_hash = "tabulation_1bit" if table_hash == "tabulation_minhash" else "1bit_minhash"
    sketch_family = jaccard_sketch_family(sketch_hash, data.universe)
    source = IndependentHashSource(family, config.num_tables, config.max_hashbits).init(
        g_hash, dev)
    sk_params = sketch_family.sample(g_sketch, config.num_sketches * config.sketch_bits, dev)
    sorted_hash, sorted_idx, sketches = hash_tables(tokens, source, sketch_family, sk_params,
                                                    config)
    probs, maxdiff = jaccard_probs_tables(family, sketch_family, config)

    geometry = {}
    if clustered:
        C = min(n, config.num_clusters(n))
        center_ids, assignment, radii = _set_gmm(tokens, C, data.universe)
        geometry = dict(center_ids=center_ids, radii=radii, assignment=assignment)

    return JaccardIndex(
        **geometry,
        tokens=tokens,
        set_sizes=(tokens >= 0).sum(dim=1).to(torch.int32),
        sorted_hash=sorted_hash,
        sorted_idx=sorted_idx,
        sketches=sketches,
        g_records=_pack_jaccard_records(sorted_idx, sketches, geometry.get("assignment"),
                                        pad_to=max(1, config.gather_block)),
        hash_params=source.params,
        sketch_params=sk_params,
        probs_table=torch.as_tensor(probs.table, device=dev),
        sketch_p1_table=torch.as_tensor(maxdiff, device=dev),
        config=config,
        universe=data.universe,
        sim_eps=probs.sim_eps,
        table_hash=table_hash,
        sketch_hash=sketch_hash,
    )


def jaccard_index_from_arrays(arrays: Dict[str, Any], config: Config,
                              device="cuda") -> JaccardIndex:
    """A JaccardIndex on `device` from numpy arrays: JACCARD_FIELDS (the
    optional ones may be missing or None), "hash_params" / "sketch_params"
    (dicts of numpy arrays) and the JACCARD_META scalars, e.g. read off a
    JAX-built index by testing.jaccard_index_arrays (uint32 words become
    int32 bit patterns), so both packages search one index."""
    dev = resolve_device(device)
    required = ("tokens", "set_sizes", "sorted_hash", "sorted_idx", "sketches",
                "probs_table", "sketch_p1_table")
    missing = [f for f in required if arrays.get(f) is None]
    if missing:
        raise DataError(f"Jaccard index arrays missing {missing}")
    kw = {f: _as_tensor(arrays[f], dt, dev) for f, dt in JACCARD_FIELDS.items()
          if arrays.get(f) is not None}
    for f, default in JACCARD_META.items():
        kw[f] = type(default)(arrays.get(f, default))
    return JaccardIndex(**kw, hash_params=_params(arrays["hash_params"], dev),
                        sketch_params=_params(arrays["sketch_params"], dev), config=config)


def _jaccard_entry_depth(index: JaccardIndex, min_depth: int) -> int:
    """Static stream entry depth: prefixes deeper than log2(n) + 2 hold
    ~no candidates (the angular engines' cap, ops/query.py)."""
    D = index.config.max_hashbits
    return int(np.clip(np.ceil(np.log2(max(2, index.n))) + 2, min_depth, D))


def _jaccard_prepare(index: JaccardIndex, query_tokens: torch.Tensor, qh: torch.Tensor,
                     qsk: torch.Tensor, *, min_depth: int) -> dict:
    """Per-query device state of the adaptive loop (leading dim Q): query
    bitmaps and sizes, the ball geometry of a clustered index, and the
    candidate stream in gather_block units (prefixmap.block_stream)."""
    cfg = index.config
    Q = query_tokens.shape[0]
    n = index.n
    dev = query_tokens.device
    D = cfg.max_hashbits
    n_iters = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)
    d_entry = _jaccard_entry_depth(index, min_depth)
    g_log = int(np.log2(max(1, cfg.gather_block)))

    qbm = _set_bitmaps(query_tokens, index.universe)  # (Q, Wu)
    q_sizes = (query_tokens >= 0).sum(dim=1).to(torch.float32)
    streams = {"qbm": qbm, "q_sizes": q_sizes, "qsk": qsk}

    if index.center_ids is not None:
        # center intersections: each center's (T,) tokens looked up in the
        # query bitmaps, a (Q, C, T) intermediate (never (Q, C, Wu))
        ct = index.tokens[index.center_ids.to(torch.int64)]  # (C, T)
        C, T = ct.shape
        member = _member_of(qbm[:, None, :].expand(Q, C, -1),
                            ct[None].expand(Q, C, T), index.universe)
        inter_c = torch.where((ct >= 0)[None], member, 0.0).sum(dim=-1)  # (Q, C)
        c_sizes = index.set_sizes[index.center_ids.to(torch.int64)].to(torch.float32)
        cdist = 1.0 - _jaccard_from_counts(inter_c, q_sizes[:, None], c_sizes[None, :])
        streams["feas_bound"] = cdist - index.radii[None, :]  # (Q, C)
        streams["ball_floor"] = torch.min(streams["feas_bound"], dim=1).values

    seg_lo = torch.zeros((Q,), dtype=torch.int32, device=dev)
    seg_hi = torch.full((Q,), n, dtype=torch.int32, device=dev)
    lo, hi = depth_bounds(index.sorted_hash, qh, seg_lo, seg_hi, D, n_iters,
                          up_to_depth=d_entry)
    starts_s, sizes_s = candidate_stream(lo, hi, qh, D, min_depth, start_depth=d_entry)
    bstarts, bcounts = block_stream(starts_s, sizes_s, g_log)
    fc = torch.cumsum(bcounts, dim=1, dtype=torch.int32)  # cumulative block counts
    streams.update(starts=starts_s, sizes=sizes_s, bstarts=bstarts, fc=fc, total=fc[:, -1])
    return streams


def _jaccard_loop_pieces(index: JaccardIndex, streams: dict, delta, *, k: int, chunk: int,
                         min_depth: int, filter_type: str, filter_expand: int):
    """(cond, body) of the adaptive probe loop: the global cosine engine's
    loop (ops/global_query._loop_pieces) on set records. A window of WB
    blocks of G records is fetched (K7), sketch-filtered and, on a
    clustered index, ball-filtered on record words; passers are compacted
    and only ~chunk candidates per iteration pay the (Q, CB, T) token
    lookup of the exact Jaccard re-score.

    State: (topk_sims (Q, k), topk_ids, qdone, off, dc, cand_ct).
    body(state, use_map) reads the stream map when `use_map`.
    """
    cfg = index.config
    qbm, q_sizes, qsk = streams["qbm"], streams["q_sizes"], streams["qsk"]
    fc, total = streams["fc"], streams["total"]
    use_balls = "feas_bound" in streams
    Q = qbm.shape[0]
    dev = qbm.device
    n = index.n
    L = index.sorted_hash.shape[0]
    S, Wd = index.sketches.shape[1], index.sketches.shape[2]
    d_entry = _jaccard_entry_depth(index, min_depth)
    G = max(1, cfg.gather_block)
    WB = max(1, (chunk * filter_expand) // G)  # window width in blocks
    WL = WB * G
    CB = chunk + G  # compacted re-score capacity (block-granular overshoot)
    fetch = _record_window(streams, index.g_records, gather_block=G, wb=WB,
                           dense_index=cfg.window_index_dense, routing=cfg.dead_block_routing)
    consume = _consumer(wb=WB, gather_block=G, chunk=chunk, device=dev)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    stop_at = 1.0 - delta  # f32, as JAX's 1.0 - delta

    def rescore(cand_ids):
        """Exact Jaccard (Q, CB) of the candidates against the query bitmaps."""
        ctok = index.tokens[cand_ids.to(torch.int64)]  # (Q, CB, T)
        valid = ctok >= 0
        member = _member_of(qbm, ctok.reshape(Q, -1), index.universe).view(ctok.shape)
        inter = torch.where(valid, member, 0.0).sum(dim=-1)
        c_sizes = valid.sum(dim=-1).to(torch.float32)
        return _jaccard_from_counts(inter, q_sizes[:, None], c_sizes)

    def kth(topk_sims, topk_ids):
        kth_sim = topk_sims[:, k - 1]
        full = topk_ids[:, k - 1] >= 0
        return kth_sim, full, torch.where(full, 1.0 - kth_sim, torch.inf)

    def cond(s):
        return ~torch.all(s[2])

    def body(s, use_map: bool):
        topk_sims, topk_ids, qdone, off, dc, cand_ct = s
        t_sel, rec, valid = fetch(qdone, off, use_map)
        cand_ids = rec[..., 0].reshape(Q, WL)

        kth_sim, full, kth_dist = kth(topk_sims, topk_ids)
        maxdiff = index.sketch_p1_table[torch.clamp(
            (kth_sim / index.sim_eps).to(torch.int64), 0, index.sketch_p1_table.shape[0] - 1)]
        # one query sketch per block: table t filters with sketch t % S
        q_sk = torch.gather(qsk, 1, (t_sel % S).to(torch.int64)[:, :, None].expand(Q, WB, Wd))
        ham = torch.sum(popcount32(rec[..., 1 : 1 + Wd] ^ q_sk[:, :, None, :]),
                        dim=-1, dtype=torch.int32).reshape(Q, WL)
        if filter_type == "none":
            # FilterType::None (collection.hpp:543-601): score every candidate
            passes = valid
        else:
            passes = valid & (ham <= maxdiff[:, None])
        if use_balls:
            # index.rs:342-361 per candidate, against the pre-merge k-th
            feas_bound = streams["feas_bound"]
            cand_cluster = torch.clamp(rec[..., 1 + Wd].reshape(Q, WL), 0,
                                       feas_bound.shape[1] - 1)
            ok = feas_bound <= kth_dist[:, None]  # (Q, C)
            passes = passes & torch.gather(ok, 1, cand_cluster.to(torch.int64))

        consumed, in_window = consume(passes)
        take = passes & in_window
        compact_ids = _compact_take(take, cand_ids, cap=CB, n_sentinel=n)
        sims = rescore(torch.clamp(compact_ids, 0, n - 1))
        topk_sims, topk_ids = _merge_topk(topk_sims, topk_ids, compact_ids, sims, n_sentinel=n)
        dc = dc + take.sum(dim=1, dtype=torch.int32)
        cand_ct = cand_ct + (valid & in_window).sum(dim=1, dtype=torch.int32)

        # finished queries' cursors stay frozen
        off_new = torch.where(qdone, off, off + consumed)
        exhausted = off_new >= total
        r_star = count_leq(fc, off_new[:, None])[:, 0]
        depth_cur = torch.clamp(d_entry - torch.div(r_star, L, rounding_mode="floor"),
                                min=min_depth)
        tables = (r_star % L).to(torch.float32)
        kth_sim, full, kth_dist = kth(topk_sims, topk_ids)
        p_d = probs_lookup(index, depth_cur, kth_sim)
        p_d1 = probs_lookup(index, depth_cur + 1, kth_sim)
        rest = torch.where(depth_cur == d_entry, 0.0, torch.clamp(L - tables, min=0.0))
        failure = torch.pow(1.0 - p_d, tables) * torch.pow(1.0 - p_d1, rest)
        qdone = qdone | (failure <= stop_at) | exhausted
        if use_balls:
            # full stop: even the closest ball cannot beat the k-th (index.rs:342-361)
            qdone = qdone | (full & (streams["ball_floor"] > kth_dist))
        return (topk_sims, topk_ids, qdone, off_new, dc, cand_ct)

    return cond, body


def _jaccard_run_loop(index: JaccardIndex, streams: dict, delta, *, k: int, chunk: int,
                      min_depth: int, filter_type: str, filter_expand: int,
                      loop_stats: Optional[LoopStats] = None):
    """The adaptive loop over prepared (possibly mapped) streams; returns
    (sims desc (Q, k), ids (Q, k) int32, SearchStats) tensors."""
    Q = streams["qbm"].shape[0]
    dev = streams["qbm"].device
    cond, body = _jaccard_loop_pieces(index, streams, delta, k=k, chunk=chunk,
                                      min_depth=min_depth, filter_type=filter_type,
                                      filter_expand=filter_expand)
    z = torch.zeros((Q,), dtype=torch.int32, device=dev)
    state = (torch.zeros((Q, k), dtype=torch.float32, device=dev),
             torch.full((Q, k), -1, dtype=torch.int32, device=dev),
             streams["total"] <= 0, z, z.clone(), z.clone())
    G = max(1, index.config.gather_block)
    tb = streams["smap"].shape[1] if "smap" in streams else 0
    state, iters, syncs = _advance(cond, body, state, tb=tb,
                                   wb=max(1, (chunk * filter_expand) // G))
    if loop_stats is not None:
        loop_stats.batches += 1
        loop_stats.iterations += iters
        loop_stats.syncs += syncs
    topk_sims, topk_ids, _, _, dc, cand_ct = state
    if "feas_bound" in streams:
        kth_dist = torch.where(topk_ids[:, k - 1] >= 0, 1.0 - topk_sims[:, k - 1], torch.inf)
        visited = torch.sum(streams["feas_bound"] <= kth_dist[:, None], dim=1, dtype=torch.int32)
    else:
        visited = torch.ones((Q,), dtype=torch.int32, device=dev)
    return topk_sims, topk_ids, SearchStats(dc, cand_ct, visited)


def jaccard_search_batch(index: JaccardIndex, query_tokens: torch.Tensor, qh: torch.Tensor,
                         qsk: torch.Tensor, delta, *, k: int, chunk: int, min_depth: int = 1,
                         filter_type: str = "default", filter_expand: int = 8,
                         loop_stats: Optional[LoopStats] = None):
    """Adaptive delta-recall search of pre-hashed queries without the
    stream map (the in-loop derivation at every step): query_tokens (Q, T)
    padded sorted sets, qh (Q, L) table hashes, qsk (Q, S, W) sketch
    words. Returns (sims desc (Q, k), ids (Q, k), SearchStats) tensors."""
    streams = _jaccard_prepare(index, query_tokens, qh, qsk, min_depth=min_depth)
    return _jaccard_run_loop(index, streams, delta, k=k, chunk=chunk, min_depth=min_depth,
                             filter_type=filter_type, filter_expand=filter_expand,
                             loop_stats=loop_stats)


def jaccard_search_batch_mapped(index: JaccardIndex, query_tokens: torch.Tensor,
                                qh: torch.Tensor, qsk: torch.Tensor, delta, *, k: int,
                                chunk: int, min_depth: int = 1, filter_type: str = "default",
                                filter_expand: int = 8,
                                loop_stats: Optional[LoopStats] = None):
    """jaccard_search_batch with the stream map, sized from the batch's
    deepest stream (one host pull, as the cosine engine's
    global_search_batch_mapped). Per-query results equal the unmapped
    path's."""
    cfg = index.config
    G = max(1, cfg.gather_block)
    if G > 32 or not cfg.stream_map:
        return jaccard_search_batch(index, query_tokens, qh, qsk, delta, k=k, chunk=chunk,
                                    min_depth=min_depth, filter_type=filter_type,
                                    filter_expand=filter_expand, loop_stats=loop_stats)
    streams = _jaccard_prepare(index, query_tokens, qh, qsk, min_depth=min_depth)
    total_max = int(torch.max(streams["total"]))
    if loop_stats is not None:
        loop_stats.syncs += 1
    wb = max(1, (chunk * filter_expand) // G)
    tb = _map_tb(total_max, cfg.stream_map_blocks, wb, query_tokens.shape[0])
    streams = _attach_stream_map(streams, g=int(np.log2(G)), L=index.sorted_hash.shape[0],
                                 tb=tb)
    return _jaccard_run_loop(index, streams, delta, k=k, chunk=chunk, min_depth=min_depth,
                             filter_type=filter_type, filter_expand=filter_expand,
                             loop_stats=loop_stats)


def _query_tokens(index: JaccardIndex, query_sets) -> torch.Tensor:
    """Padded (Q, T) int32 query sets on the index's device."""
    if isinstance(query_sets, torch.Tensor):
        return query_sets.to(device=index.device, dtype=torch.int32)
    if isinstance(query_sets, np.ndarray) and query_sets.ndim == 2:
        qt = query_sets.astype(np.int32)
    else:
        qt = pad_sets(query_sets, index.universe)
    return torch.as_tensor(qt, device=index.device)


def hash_queries(index: JaccardIndex, qt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table hashes (Q, L), sketch words (Q, S, W)) of padded query sets,
    with the index's families and parameters."""
    cfg = index.config
    source = IndependentHashSource(jaccard_table_family(index.table_hash, index.universe),
                                   cfg.num_tables, cfg.max_hashbits)
    source.params = index.hash_params
    qbits = jaccard_sketch_family(index.sketch_hash, index.universe).hash(
        index.sketch_params, qt)
    return source.hash(qt), pack_bits_u32(
        qbits.reshape(qt.shape[0], cfg.num_sketches, cfg.sketch_bits))


def jaccard_search(index: JaccardIndex, query_sets, k: Optional[int] = None,
                   delta: Optional[float] = None, filter_type: str = "default",
                   loop_stats: Optional[LoopStats] = None):
    """Delta-recall search of raw or padded query sets, one batch.
    Returns numpy (sims desc (Q, k), ids (Q, k) int32, SearchStats)."""
    cfg = index.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    qt = _query_tokens(index, query_sets)
    qh, qsk = hash_queries(index, qt)
    if index.g_records is None:
        # an index without packed records: pack them for this call
        index = dataclasses.replace(index, g_records=_pack_jaccard_records(
            index.sorted_idx, index.sketches, index.assignment,
            pad_to=max(1, cfg.gather_block)))
    sims, ids, stats = jaccard_search_batch_mapped(
        index, qt, qh, qsk, delta, k=k, chunk=cfg.candidate_chunk, min_depth=cfg.min_depth,
        filter_type=filter_type, filter_expand=cfg.filter_expand, loop_stats=loop_stats)
    return (sims.cpu().numpy(), ids.cpu().numpy(),
            SearchStats(*(f.cpu().numpy() for f in stats)))


def _jaccard_scan_impl(tokens: torch.Tensor, qmh: torch.Tensor, q_sizes: torch.Tensor, *,
                       k: int, block: int, universe: int, max_count: int):
    """Dense exact Jaccard top-k over point blocks: each block's 0/1
    multi-hot against the queries' (data.setdata.multi_hot_counts), a
    block top-k and a merge with the running one (the lower id first among
    equal similarities, as lax.top_k). Empty sets score -1."""
    n = tokens.shape[0]
    Q = qmh.shape[0]
    best_s = torch.full((Q, k), -torch.inf, dtype=torch.float32, device=tokens.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=tokens.device)
    for s in range(0, n, block):
        blk = tokens[s : s + block]
        sz = (blk >= 0).sum(dim=1).to(torch.float32)
        inter = multi_hot_counts(qmh, _multi_hot(blk, universe), max_count)
        union = q_sizes[:, None] + sz[None, :] - inter
        ok = (union > 0) & (sz[None, :] > 0)
        sims = torch.where(ok, inter / torch.where(ok, union, 1.0), -1.0)
        s_blk, i_blk = topk_stable(sims, min(k, blk.shape[0]))
        cat_s = torch.cat([best_s, s_blk], dim=1)
        cat_i = torch.cat([best_i, (i_blk + s).to(torch.int32)], dim=1)
        best_s, pos = topk_stable(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def jaccard_scan(index: JaccardIndex, query_sets, k: Optional[int] = None, block: int = 0):
    """EXACT dense Jaccard top-k over the whole set corpus: 0/1 multi-hot
    products over point blocks (the sorted merge of jaccard.hpp:18-42 as
    counts). Recall is 1.0 by construction. The block's multi-hot is
    (block, universe) bf16, so `block` (0: auto) shrinks with the universe
    to keep it near 128 MB. Returns numpy (sims desc (Q, k), ids (Q, k)
    int32, SearchStats with dc = candidates = n per query); k past n pads
    with -inf / -1."""
    cfg = index.config
    k = cfg.k if k is None else k
    qt = _query_tokens(index, query_sets)
    universe = index.universe
    if block <= 0:
        block = int(np.clip((128 << 20) // (2 * (universe + 1)), 128, 4096))
        block = max(128, (block // 128) * 128)
    n = index.n
    q_sizes = (qt >= 0).sum(dim=1).to(torch.float32)
    max_count = min(int(index.set_sizes.max()), qt.shape[1])
    k_eff = min(k, n)
    sims, ids = _jaccard_scan_impl(index.tokens, _multi_hot(qt, universe), q_sizes, k=k_eff,
                                   block=block, universe=universe, max_count=max_count)
    Q = qt.shape[0]
    if k_eff < k:
        sims = torch.nn.functional.pad(sims, (0, k - k_eff), value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    full = np.full((Q,), n, np.int32)
    stats = SearchStats(full, full.copy(), np.ones((Q,), np.int32))
    return sims.cpu().numpy(), ids.cpu().numpy(), stats

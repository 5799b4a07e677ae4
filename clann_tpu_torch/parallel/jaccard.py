"""Point-sharded Jaccard (set) LSH search over a device mesh (PyTorch port
of ``clann_tpu.parallel.jaccard``).

The set analog of parallel/sharded.py's vector paths: points are split
across the shards of a mesh, every shard runs the same adaptive
delta-recall search (core/jaccard.py, its record gathers through kernel K7)
over its local sorted tables, and the per-shard top-k lists are merged with
an all_gather (the mesh form of the reference's per-thread MaxBuffer merge,
collection.hpp:479-481).

Guarantee: the delta-recall bound is PER POINT (independent.hpp:108-119),
and each shard stops against its LOCAL k-th best similarity, which never
exceeds the global one, so every shard works at least as hard as the flat
index would for its own points, and the union keeps the per-point bound.

Padding: shards are padded with EMPTY sets (all tokens -1), hashed and
sketched with the shared functions; their Jaccard against any non-empty
query is 0 and their global id is -1, so the merge drops them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.core.jaccard import (
    JaccardIndex,
    _pack_jaccard_records,
    hash_queries,
    hash_tables,
    jaccard_probs_tables,
    jaccard_search_batch_mapped,
    jaccard_sketch_family,
    jaccard_table_family,
)
from clann_tpu_torch.ops.prefixmap import sort_tables_segmented
from clann_tpu_torch.ops.query import SearchStats
from clann_tpu_torch.ops.sketches import pack_bits_u32
from clann_tpu_torch.ops.sources import IndependentHashSource
from clann_tpu_torch.parallel.mesh import make_mesh, psum, run_shards, taking_turns
from clann_tpu_torch.parallel.sharded import _merge_topk, _params_to, _place, _placement

SHARD_FIELDS = ("tokens", "set_sizes", "sorted_hash", "sorted_idx", "sketches",
                "global_ids", "g_records")


@dataclasses.dataclass(eq=False)
class ShardedJaccardIndex:
    """Per-shard set index pieces (lists, one entry per shard, None for
    another process's shard) and the replicated functions."""

    tokens: List  # (n_loc, T) int32, -1-padded sets
    set_sizes: List  # (n_loc,) int32
    sorted_hash: List  # (L, n_loc) int32, sorted per shard
    sorted_idx: List  # (L, n_loc) int32 LOCAL slots
    sketches: List  # (n_loc, S, W) int32 words
    global_ids: List  # (n_loc,) int32, -1 = padding
    # [id, sketch words, cluster] records per shard for the K7 gathers
    # (core/jaccard._pack_jaccard_records)
    g_records: List  # (L, n_pad, 2 + W) int32
    hash_params: Any  # replicated
    sketch_params: Any  # replicated
    probs_table: torch.Tensor
    sketch_p1_table: torch.Tensor
    config: Config = None
    universe: int = 0
    sim_eps: float = 5e-3
    table_hash: str = "minhash"
    sketch_hash: str = "1bit_minhash"

    def replace(self, **changes):
        """A copy with `changes` to its fields (flax's struct.dataclass
        `replace`, which the JAX package's index has)."""
        return dataclasses.replace(self, **changes)

    @property
    def n_devices(self) -> int:
        return len(self.tokens)

    def stacked(self, field: str) -> np.ndarray:
        """A per-shard field as one host array (D, ...)."""
        return np.stack([t.cpu().numpy() for t in getattr(self, field)])


def _shard_records(cfg: Config, sorted_idx, sketches):
    return _pack_jaccard_records(sorted_idx, sketches, None, pad_to=max(1, cfg.gather_block))


def shard_jaccard_index(index: JaccardIndex, n_devices: int, mesh=None) -> ShardedJaccardIndex:
    """Slice a flat JaccardIndex into contiguous point shards.

    Per-point hashes are recovered from the sorted tables (they were
    computed with the shared functions at build) and re-sorted per shard,
    no re-hashing. Shards are placed on the mesh's cluster-axis devices, or
    all on the index's device without a mesh.
    """
    from clann_tpu_torch.core.index import unsort_hashes

    n = index.n
    D = n_devices
    L = index.sorted_hash.shape[0]
    T = index.tokens.shape[1]
    n_loc = -(-n // D)

    tokens = index.tokens.cpu().numpy()
    sketches = index.sketches.cpu().numpy()
    hashes_pt = unsort_hashes(index.sorted_hash, index.sorted_idx).cpu().numpy()  # (L, n)

    # padding rows: empty sets hashed / sketched with the same functions
    cfg = index.config
    empty = torch.full((1, T), -1, dtype=torch.int32, device=index.device)
    source = IndependentHashSource(jaccard_table_family(index.table_hash, index.universe), L,
                                   cfg.max_hashbits)
    empty_hash = source.hash_with(index.hash_params, empty).cpu().numpy()[0]  # (L,)
    ebits = jaccard_sketch_family(index.sketch_hash, index.universe).hash(
        index.sketch_params, empty)
    empty_sketch = pack_bits_u32(
        ebits.reshape(1, cfg.num_sketches, cfg.sketch_bits)).cpu().numpy()[0]  # (S, W)

    tok_s = np.full((D, n_loc, T), -1, np.int32)
    sk_s = np.broadcast_to(empty_sketch[None, None], (D, n_loc) + empty_sketch.shape).copy()
    hp_s = np.broadcast_to(empty_hash[None, :, None], (D, L, n_loc)).copy()
    gid_s = np.full((D, n_loc), -1, np.int32)
    for dev in range(D):
        lo, hi = dev * n_loc, min(n, (dev + 1) * n_loc)
        m = hi - lo
        if m <= 0:
            continue
        tok_s[dev, :m] = tokens[lo:hi]
        sk_s[dev, :m] = sketches[lo:hi]
        hp_s[dev, :, :m] = hashes_pt[:, lo:hi]
        gid_s[dev, :m] = np.arange(lo, hi, dtype=np.int32)

    devices = _placement(mesh, D, index.device)
    toks, sks = _place(tok_s, devices), _place(sk_s, devices)
    sorted_hash, sorted_idx, records = [None] * D, [None] * D, [None] * D
    for s, dev in enumerate(devices):  # per-shard table sorts (one flat segment)
        if dev is None:
            continue
        sorted_hash[s], sorted_idx[s] = sort_tables_segmented(
            torch.as_tensor(hp_s[s], device=dev), torch.zeros((n_loc,), dtype=torch.int32,
                                                             device=dev))
        records[s] = _shard_records(cfg, sorted_idx[s], sks[s])

    return ShardedJaccardIndex(
        tokens=toks,
        set_sizes=[None if t is None else (t >= 0).sum(dim=1).to(torch.int32) for t in toks],
        sorted_hash=sorted_hash,
        sorted_idx=sorted_idx,
        sketches=sks,
        global_ids=_place(gid_s, devices),
        g_records=records,
        hash_params=index.hash_params,
        sketch_params=index.sketch_params,
        probs_table=index.probs_table,
        sketch_p1_table=index.sketch_p1_table,
        config=cfg,
        universe=index.universe,
        sim_eps=index.sim_eps,
        table_hash=index.table_hash,
        sketch_hash=index.sketch_hash,
    )


def sharded_jaccard_search(
    sh: ShardedJaccardIndex,
    query_sets,
    k: Optional[int] = None,
    delta: Optional[float] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Adaptive delta-recall search over the sharded set index.

    The contract of core/jaccard.jaccard_search: numpy (sims desc (Q, k),
    GLOBAL ids, stats summed over the shards). Each shard runs the engine
    with its stream map (jaccard_search_batch_mapped; per-query results
    equal the unmapped loop's, which the JAX package runs under shard_map).
    """
    from clann_tpu_torch.data.setdata import pad_sets

    cfg = sh.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    if mesh is None:
        mesh = make_mesh(sh.n_devices)
    devs = mesh.cluster_devices()
    lead = devs[0]

    if isinstance(query_sets, np.ndarray) and query_sets.ndim == 2:
        qt = query_sets.astype(np.int32)
    else:
        qt = pad_sets(query_sets, sh.universe)
    qt = torch.as_tensor(qt, device=lead)
    qh, qsk = hash_queries(dataclasses.replace(
        sh, hash_params=_params_to(sh.hash_params, lead),
        sketch_params=_params_to(sh.sketch_params, lead)), qt)

    def shard(s):
        dev = devs[s]
        local = JaccardIndex(
            **{f: getattr(sh, f)[s].to(dev) for f in SHARD_FIELDS if f != "global_ids"},
            hash_params=_params_to(sh.hash_params, dev),
            sketch_params=_params_to(sh.sketch_params, dev),
            probs_table=sh.probs_table.to(dev),
            sketch_p1_table=sh.sketch_p1_table.to(dev),
            config=cfg,
            universe=sh.universe,
            sim_eps=sh.sim_eps,
            table_hash=sh.table_hash,
            sketch_hash=sh.sketch_hash,
        )
        with taking_turns():  # the engine's loop: small ops
            sims, lids, stats = jaccard_search_batch_mapped(
                local, qt.to(dev), qh.to(dev), qsk.to(dev), float(delta), k=k,
                chunk=cfg.candidate_chunk, min_depth=cfg.min_depth)
            gids = sh.global_ids[s].to(dev)
            out_ids = torch.where(lids >= 0, gids[torch.clamp(lids, min=0).to(torch.int64)], -1)
            # padding hits dropped
            return torch.where(out_ids >= 0, sims, -1.0), out_ids, stats

    parts = run_shards([dev if mesh.is_local(s) else None for s, dev in enumerate(devs)],
                       shard)
    sims_p, ids_p, stats_p = zip(*(p or (None, None, None) for p in parts))
    ts, ti = _merge_topk(mesh, sims_p, ids_p, lead, k)
    ti = torch.where(ts > -1.0, ti, -1)
    stats = SearchStats(*(psum(mesh, [None if st is None else st[f] for st in stats_p], lead)
                          for f in range(len(SearchStats._fields))))
    return (np.maximum(ts.cpu().numpy(), 0.0), ti.cpu().numpy(),
            SearchStats(*(f.cpu().numpy() for f in stats)))


def build_jaccard_sharded(
    sets,
    universe: int,
    config: Config,
    mesh=None,
    table_hash: str = "minhash",
    hash_budget_bytes: int = 1 << 30,
) -> ShardedJaccardIndex:
    """End-to-end sharded set-index build: each shard hashes, sketches and
    table-sorts ITS OWN points on its device, so no single-device (L, n)
    structure is ever made. With the same config and seed the shards equal
    `shard_jaccard_index(build_jaccard_index(...))` byte for byte (hashing
    is per point with the shared functions, and the per-shard sorts see the
    same rows). `hash_budget_bytes` bounds the MinHash rank tensors of one
    hashing block (core/jaccard._map_point_blocks)."""
    from clann_tpu_torch.core.index import _generators
    from clann_tpu_torch.data.setdata import JaccardData, pad_sets
    from clann_tpu_torch.errors import DataError

    if isinstance(sets, JaccardData):
        tokens_np, universe = np.asarray(sets.tokens), sets.universe
    elif isinstance(sets, np.ndarray) and sets.ndim == 2:
        tokens_np = sets.astype(np.int32)
    else:
        tokens_np = np.asarray(pad_sets(sets, universe))
    n, T = tokens_np.shape
    if n == 0:
        raise DataError("empty dataset")
    if mesh is None:
        mesh = make_mesh()
    devices = _placement(mesh, len(mesh.cluster_devices()), None)
    D = len(devices)
    lead = mesh.cluster_devices()[0]
    n_loc = -(-n // D)
    cfg = config

    # host-side shard assembly: -1 (empty-set) padding rows, global ids
    tok_s = np.full((D, n_loc, T), -1, np.int32)
    gid_s = np.full((D, n_loc), -1, np.int32)
    for dev in range(D):
        lo, hi = dev * n_loc, min(n, (dev + 1) * n_loc)
        if hi > lo:
            tok_s[dev, : hi - lo] = tokens_np[lo:hi]
            gid_s[dev, : hi - lo] = np.arange(lo, hi, dtype=np.int32)

    # shared functions, drawn as the flat build draws them
    # (core/jaccard.build_jaccard_index): same seed -> same tables
    g_hash, g_sketch = _generators(cfg.seed)
    family = jaccard_table_family(table_hash, universe)
    sketch_hash = "tabulation_1bit" if table_hash == "tabulation_minhash" else "1bit_minhash"
    sketch_family = jaccard_sketch_family(sketch_hash, universe)
    source = IndependentHashSource(family, cfg.num_tables, cfg.max_hashbits).init(g_hash, lead)
    sk_params = sketch_family.sample(g_sketch, cfg.num_sketches * cfg.sketch_bits, lead)
    probs, maxdiff = jaccard_probs_tables(family, sketch_family, cfg)

    toks = _place(tok_s, devices)
    def shard(s):  # each shard on its device, the cards at once
        dev = devices[s]
        src = copy.copy(source)
        src.params = _params_to(source.params, dev)
        sh, si, sk = hash_tables(toks[s], src, sketch_family, _params_to(sk_params, dev), cfg,
                                 budget_bytes=hash_budget_bytes)
        return {"sorted_hash": sh, "sorted_idx": si, "sketches": sk,
                "g_records": _shard_records(cfg, si, sk)}

    parts = run_shards(devices, shard)
    built = {f: [None if p is None else p[f] for p in parts]
             for f in ("sorted_hash", "sorted_idx", "sketches", "g_records")}

    return ShardedJaccardIndex(
        tokens=toks,
        set_sizes=[None if t is None else (t >= 0).sum(dim=1).to(torch.int32) for t in toks],
        **built,
        global_ids=_place(gid_s, devices),
        hash_params=source.params,
        sketch_params=sk_params,
        probs_table=torch.as_tensor(probs.table, device=lead),
        sketch_p1_table=torch.as_tensor(maxdiff, device=lead),
        config=cfg,
        universe=universe,
        sim_eps=probs.sim_eps,
        table_hash=table_hash,
        sketch_hash=sketch_hash,
    )

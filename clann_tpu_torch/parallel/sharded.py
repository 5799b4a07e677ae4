"""Cluster-sharded search over a device mesh (PyTorch port of
``clann_tpu.parallel.sharded``).

Clusters, with their table segments, points and sketches, are split across
the shards of a mesh (parallel/mesh.py); every shard runs the same batched
adaptive search (ops/query.py, ops/global_query.py) or dense scan over its
own clusters, and the per-shard top-k lists are merged with an all_gather
and one top-k over the shard axis, the collective form of the reference's
per-thread MaxBuffer merge (libpuffinn collection.hpp:479-481). The shard
bodies below are the JAX package's shard_map bodies, run shard by shard
from one thread.

Design notes (as in the JAX package):
- Clusters are greedily bin-packed by point count, so shards are balanced.
- Clusters are disjoint, so the merge needs no dedup: a point lives on
  exactly one shard.
- The ball bound stops each shard against its LOCAL k-th best, never
  tighter than the global one: pruning is weaker than on one device, and
  recall can only improve.
- Padding clusters carry radius PAD_RADIUS > 2 (the largest cosine
  distance) and empty segments.
- Pad slots of the hash tables hold PAD_HASH. The port sorts and searches
  hashes as signed int32, so the pad is 0x7FFFFFFF: it sorts after every
  real hash (< 2^max_hashbits) and lies above every prefix key, so no
  prefix range reaches it (the JAX package's pad, 0xFFFFFFFF, does the
  same under its unsigned sort).

Every array field of a ShardedIndex is a list with one tensor per shard, on
the device the shard was placed on (None for the shards of another process,
parallel/distributed.py). `shard_points` / `shard_clusters` keep each
shard's real point and cluster counts on the host.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.ops.query import SearchStats, search_batch_impl, topk_stable
from clann_tpu_torch.parallel.mesh import (
    CLUSTER_AXIS,
    QUERY_AXIS,
    all_gather,
    make_mesh,
    psum,
)

PAD_RADIUS = 2.5  # > max cosine distance 2.0 -> the ball bound can never fire
PAD_HASH = 0x7FFFFFFF  # see the module docstring

SHARD_FIELDS = (
    "vectors", "sorted_hash", "sorted_idx", "sketches", "cluster_starts",
    "centers", "center_ids", "radii", "brute", "assignment", "global_ids",
)
GLOBAL_FIELDS = ("g_sorted_hash", "g_records", "g_dir")


@dataclasses.dataclass(eq=False)
class ShardedIndex:
    """Per-shard index pieces (lists, one entry per shard) and the
    replicated hash machinery."""

    vectors: List[Optional[torch.Tensor]]  # (n_max, d) f32
    sorted_hash: List  # (L, n_max) int32, PAD_HASH past the real slots
    sorted_idx: List  # (L, n_max) int32 LOCAL ids
    sketches: List  # (n_max, S, W) int32 words
    cluster_starts: List  # (C_max+1,) int32
    centers: List  # (C_max, d) f32
    center_ids: List  # (C_max,) int32 global ids (metadata), -1 pad
    radii: List  # (C_max,) f32
    brute: List  # (C_max,) bool
    assignment: List  # (n_max,) int32 local cluster of each local point
    global_ids: List  # (n_max,) int32 local -> global id, -1 pad
    hash_params: Any
    sketch_params: Any
    probs_table: torch.Tensor
    maxdiff_table: torch.Tensor
    config: Config
    shard_points: Tuple[int, ...]  # real points per shard
    shard_clusters: Tuple[int, ...]  # real clusters per shard
    metric: str = "angular"
    sim_eps: float = 5e-3
    max_seg_len: int = 0
    # per-shard global-engine structures (ops/global_query.py): each
    # shard's points hash-sorted locally, pad slots PAD_HASH; None when the
    # source index has no global engine
    g_sorted_hash: Optional[List] = None  # (L, n_max) int32
    g_records: Optional[List] = None  # (L, n_pad, 2 + W) int32
    g_dir: Optional[List] = None  # (L, 1, P+1) int32
    g_dir_iters: int = 0
    # the walk's blocked [id, sketch] records per shard, made when the
    # source index has them (config.pack_slot_records): the sharded walk
    # then gathers them through kernel K7, as the single-device walk does
    slot_records: Optional[List] = None  # (L, n_pad, 1 + W) int32

    @property
    def n_devices(self) -> int:
        return len(self.vectors)

    @property
    def n_max(self) -> int:
        return next(v for v in self.vectors if v is not None).shape[0]

    @property
    def dims(self) -> int:
        return next(v for v in self.vectors if v is not None).shape[1]

    @property
    def c_max(self) -> int:
        """Cluster slots per shard (real clusters + padding)."""
        return next(c for c in self.centers if c is not None).shape[0]

    def rebuild_objects(self):
        """(source, filterer) bound to the replicated parameters."""
        from clann_tpu_torch.core.index import ClusteredIndex

        return ClusteredIndex.rebuild_objects(self)

    def stacked(self, field: str) -> np.ndarray:
        """A per-shard field as one host array (D, ...), the JAX package's
        stacked layout (every shard must be in this process)."""
        return np.stack([t.cpu().numpy() for t in getattr(self, field)])


def _params_to(p, device):
    return None if p is None else {k: v.to(device) for k, v in p.items()}


def partition_clusters(sizes: np.ndarray, n_devices: int) -> List[np.ndarray]:
    """Greedy balanced bin packing of clusters by point count."""
    order = np.argsort(sizes)[::-1]
    loads = np.zeros(n_devices, dtype=np.int64)
    groups: List[list] = [[] for _ in range(n_devices)]
    for c in order:
        d = int(np.argmin(loads))
        groups[d].append(int(c))
        loads[d] += int(sizes[c])
    return [np.sort(np.asarray(g, dtype=np.int32)) for g in groups]


def _placement(mesh, n_devices: int, default) -> List[Optional[torch.device]]:
    """Each shard's device (None for another process's shard): the mesh's
    cluster axis, or `default` for every shard without a mesh."""
    if mesh is None:
        return [torch.device(default)] * n_devices
    devs = mesh.cluster_devices()
    if len(devs) != n_devices:
        raise ValueError(
            f"{n_devices} shards but the mesh '{CLUSTER_AXIS}' axis is {len(devs)} wide")
    return [dev if mesh.is_local(s) else None for s, dev in enumerate(devs)]


def _place(arrays: np.ndarray, devices) -> List[Optional[torch.Tensor]]:
    """(D, ...) host array -> per-shard tensors on their devices."""
    return [None if dev is None else torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a, dev in zip(arrays, devices)]


def _dir_iters(g_dir: torch.Tensor) -> int:
    return int(np.ceil(np.log2(max(2, int(torch.max(g_dir[:, :, 1:] - g_dir[:, :, :-1])))))) + 1


def _global_tables(cfg: Config, hashes_T, sketches, assignment, n_max: int):
    """One shard's (g_sorted_hash, g_records, g_dir) over its local points,
    and the directory's search depth."""
    from clann_tpu_torch.core.index import make_global_tables
    from clann_tpu_torch.ops.prefixmap import build_prefix_directory

    gh, gr = make_global_tables(hashes_T, sketches, assignment, pad_to=cfg.gather_block)
    gd = build_prefix_directory(
        gh, torch.as_tensor(np.asarray([0, n_max], np.int32)), cfg.global_dir_bits,
        int(np.ceil(np.log2(max(2, n_max)))) + 1, cfg.max_hashbits)
    return gh, gr, gd, _dir_iters(gd)


def _slot_records(cfg: Config, sorted_idx, sketches):
    from clann_tpu_torch.core.index import make_slot_records

    return make_slot_records(sorted_idx, sketches, pad_to=cfg.gather_block)


def shard_index(index, n_devices: int, mesh=None) -> ShardedIndex:
    """Split a built ClusteredIndex into balanced per-device shards.

    The shard arrays are assembled in host numpy (the JAX package's layout,
    byte for byte with the pads mapped), then placed: on the mesh's
    cluster-axis devices when `mesh` is given, else every shard on the
    index's device. The global engine's per-shard tables are sorted on the
    shard's device.
    """
    from clann_tpu_torch.core.index import host_array, unsort_hashes

    starts = host_array(index.cluster_starts)
    sizes = np.diff(starts)
    C = index.n_clusters
    groups = partition_clusters(sizes, n_devices)
    C_max = max(1, max(len(g) for g in groups))
    n_max = max(1, int(max(sizes[g].sum() if len(g) else 0 for g in groups)))

    g_sorted_hash = host_array(index.sorted_hash)
    g_sorted_idx = host_array(index.sorted_idx)
    g_vectors = host_array(index.vectors)
    g_sketches = host_array(index.sketches)
    g_centers = host_array(index.centers)
    g_center_ids = host_array(index.center_ids)
    g_radii = host_array(index.radii)
    g_brute = host_array(index.brute)
    g_assign = host_array(index.assignment)
    L = g_sorted_hash.shape[0]
    d = g_vectors.shape[1]
    S, W = g_sketches.shape[1], g_sketches.shape[2]
    n_global = g_vectors.shape[0]

    out = {
        "vectors": np.zeros((n_devices, n_max, d), np.float32),
        "sorted_hash": np.full((n_devices, L, n_max), PAD_HASH, np.int32),
        "sorted_idx": np.zeros((n_devices, L, n_max), np.int32),
        "sketches": np.zeros((n_devices, n_max, S, W), np.int32),
        "cluster_starts": np.zeros((n_devices, C_max + 1), np.int32),
        "centers": np.zeros((n_devices, C_max, d), np.float32),
        "center_ids": np.full((n_devices, C_max), -1, np.int32),
        "radii": np.full((n_devices, C_max), PAD_RADIUS, np.float32),
        "brute": np.zeros((n_devices, C_max), bool),
        "assignment": np.zeros((n_devices, n_max), np.int32),
        "global_ids": np.full((n_devices, n_max), -1, np.int32),
    }

    # one O(n log n) pass gives every cluster's member list
    member_order = np.argsort(g_assign, kind="stable").astype(np.int32)
    member_bounds = np.searchsorted(g_assign[member_order], np.arange(C + 1))

    for dev, g in enumerate(groups):
        # local point ids ordered by (cluster, original id)
        inv = np.full(n_global, -1, np.int32)
        local_starts = [0]
        gids_parts = []
        for c in g:
            members = member_order[member_bounds[c]:member_bounds[c + 1]]
            gids_parts.append(members)
            local_starts.append(local_starts[-1] + len(members))
        gids = np.concatenate(gids_parts) if gids_parts else np.zeros(0, np.int32)
        n_local = len(gids)
        inv[gids] = np.arange(n_local, dtype=np.int32)

        out["global_ids"][dev, :n_local] = gids
        out["vectors"][dev, :n_local] = g_vectors[gids]
        out["sketches"][dev, :n_local] = g_sketches[gids]
        for ci, c in enumerate(g):
            lo, hi = starts[c], starts[c + 1]
            llo, lhi = local_starts[ci], local_starts[ci + 1]
            out["sorted_hash"][dev, :, llo:lhi] = g_sorted_hash[:, lo:hi]
            out["sorted_idx"][dev, :, llo:lhi] = inv[g_sorted_idx[:, lo:hi]]
            out["assignment"][dev, llo:lhi] = ci
            out["centers"][dev, ci] = g_centers[c]
            out["center_ids"][dev, ci] = g_center_ids[c]
            out["radii"][dev, ci] = g_radii[c]
            out["brute"][dev, ci] = g_brute[c]
        cs = np.asarray(local_starts, np.int32)
        out["cluster_starts"][dev, : len(cs)] = cs
        out["cluster_starts"][dev, len(cs):] = n_local

    devices = _placement(mesh, n_devices, index.device)
    shards = {f: _place(v, devices) for f, v in out.items()}
    cfg = index.config

    # per-shard global-engine structures (hash-sorted over local points)
    g_fields = {}
    g_dir_iters = 0
    if index.g_records is not None:
        hashes_pt = host_array(unsort_hashes(index.sorted_hash, index.sorted_idx))  # (L, n)
        lists = {f: [None] * n_devices for f in GLOBAL_FIELDS}
        for dev, place in enumerate(devices):
            if place is None:
                continue
            gids = out["global_ids"][dev]
            n_local = int((gids >= 0).sum())
            h_loc = np.full((L, n_max), PAD_HASH, np.int32)
            h_loc[:, :n_local] = hashes_pt[:, gids[:n_local]]
            gh, gr, gd, iters = _global_tables(
                cfg, torch.as_tensor(h_loc, device=place), shards["sketches"][dev],
                shards["assignment"][dev], n_max)
            g_dir_iters = max(g_dir_iters, iters)
            for f, t in zip(GLOBAL_FIELDS, (gh, gr, gd)):
                lists[f][dev] = t
        g_fields = lists

    slot_records = None
    if index.slot_records is not None:
        slot_records = [None if p is None else _slot_records(cfg, si, sk)
                        for p, si, sk in zip(devices, shards["sorted_idx"], shards["sketches"])]

    return ShardedIndex(
        **shards,
        **g_fields,
        slot_records=slot_records,
        hash_params=index.hash_params,
        sketch_params=index.sketch_params,
        probs_table=index.probs_table,
        maxdiff_table=index.maxdiff_table,
        config=cfg,
        shard_points=tuple(int(v) for v in (out["global_ids"] >= 0).sum(axis=1)),
        shard_clusters=tuple(len(g) for g in groups),
        metric=index.metric,
        sim_eps=index.sim_eps,
        max_seg_len=index.max_seg_len,
        g_dir_iters=g_dir_iters,
    )


def build_sharded(data, config: Config, mesh=None, metric: str = "angular") -> ShardedIndex:
    """End-to-end sharded index build: per-shard tables are built from
    per-shard points, so no single-device (L, n) structure is ever made.

    1. mesh-sharded GMM (parallel/gmm.py), bit-identical to the
       single-device clustering;
    2. the balanced cluster partition (host integer bookkeeping);
    3. per shard, on its device: hash, sketch and segment-sort its own
       points, and the global engine's hash-sorted records;
    4. per-shard prefix directories for the global engine.

    With the same config and seed the shards equal
    `shard_index(build_index(data, config, gmm_mesh=mesh), D, mesh)` on
    every real slot; as in JAX, n_max is rounded up to a gather_block
    multiple, so the pad lengths may differ. Host memory holds the raw
    dataset; device memory per shard is bounded by its shard.
    """
    from clann_tpu_torch.core.index import _generators, _hash_in_blocks, derive_probs_tables
    from clann_tpu_torch.errors import DataError, IndexCreationError
    from clann_tpu_torch.ops.distances import l2_normalize
    from clann_tpu_torch.ops.hashing import make_hash_family
    from clann_tpu_torch.ops.prefixmap import sort_tables_segmented
    from clann_tpu_torch.ops.sketches import SketchFilterer
    from clann_tpu_torch.ops.sources import make_hash_source
    from clann_tpu_torch.parallel.gmm import sharded_gmm

    x = np.asarray(data, np.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        raise DataError("empty or non-2D dataset")
    if metric != "angular":
        raise IndexCreationError("sharded LSH build supports the angular metric")
    n, d = x.shape
    if mesh is None:
        mesh = make_mesh()
    D = len(mesh.cluster_devices())
    cfg = config

    # 1. clustering over the mesh
    centers_idx, assignment, radii = sharded_gmm(x, cfg.num_clusters(n), mesh=mesh,
                                                 metric=metric)
    centers_idx = centers_idx.cpu().numpy()
    assignment = assignment.cpu().numpy()
    radii = radii.cpu().numpy()
    C = len(centers_idx)
    sizes = np.bincount(assignment, minlength=C)
    brute_np = sizes < max(cfg.brute_force_threshold, cfg.k)

    # 2. balanced partition + host-side shard assembly (the layout rules of
    # shard_index)
    groups = partition_clusters(sizes, D)
    C_max = max(1, max(len(g) for g in groups))
    n_max = max(1, int(max(sizes[g].sum() if len(g) else 0 for g in groups)))
    # uniform slot padding so per-shard g_records stack cleanly
    n_max += (-n_max) % max(1, cfg.gather_block)

    lead = mesh.cluster_devices()[0]
    # normalized as build_index normalizes (on the device), so the shard
    # vectors equal shard_index(build_index(...))'s bit for bit
    xn_host = l2_normalize(torch.as_tensor(x, device=lead)).cpu().numpy()
    vecs = np.zeros((D, n_max, d), np.float32)
    clus_local = np.full((D, n_max), C_max, np.int32)  # pads sort last
    global_ids = np.full((D, n_max), -1, np.int32)
    cluster_starts = np.zeros((D, C_max + 1), np.int32)
    centers_arr = np.zeros((D, C_max, d), np.float32)
    center_ids = np.full((D, C_max), -1, np.int32)
    radii_arr = np.full((D, C_max), PAD_RADIUS, np.float32)
    brute_arr = np.zeros((D, C_max), bool)
    member_order = np.argsort(assignment, kind="stable").astype(np.int32)
    member_bounds = np.searchsorted(assignment[member_order], np.arange(C + 1))
    for dev, g in enumerate(groups):
        local_starts = [0]
        parts = []
        for ci, c in enumerate(g):
            members = member_order[member_bounds[c]:member_bounds[c + 1]]
            parts.append(members)
            local_starts.append(local_starts[-1] + len(members))
            centers_arr[dev, ci] = xn_host[centers_idx[c]]
            center_ids[dev, ci] = centers_idx[c]
            radii_arr[dev, ci] = radii[c]
            brute_arr[dev, ci] = brute_np[c]
            clus_local[dev, local_starts[ci]: local_starts[ci + 1]] = ci
        gids = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        n_local = len(gids)
        global_ids[dev, :n_local] = gids
        vecs[dev, :n_local] = xn_host[gids]
        cs = np.asarray(local_starts, np.int32)
        cluster_starts[dev, : len(cs)] = cs
        cluster_starts[dev, len(cs):] = n_local
    n_locals = (global_ids >= 0).sum(axis=1)

    # shared hash functions (the draws of build_index)
    g_hash, g_sketch = _generators(cfg.seed)
    family = make_hash_family(
        cfg.hash_family, d,
        num_rotations=cfg.num_rotations,
        estimation_repetitions=cfg.estimation_repetitions,
        estimation_eps=cfg.estimation_eps,
    )
    devices = _placement(mesh, D, None)
    source = make_hash_source(
        cfg.hash_source, family, cfg.num_tables, cfg.max_hashbits, pool_size=cfg.pool_size,
    ).init(g_hash, lead)
    filterer = SketchFilterer(d, cfg.num_sketches, cfg.sketch_bits).init(g_sketch, lead)
    probs, maxdiff = derive_probs_tables(family, cfg)
    build_global = cfg.lsh_engine in ("global", "both")
    build_records = cfg.pack_slot_records and cfg.lsh_engine in ("clustered", "both")

    # 3. per shard: hash + sketch + sorts of its own points
    built = {f: [None] * D for f in ("vectors", "sorted_hash", "sorted_idx", "sketches")
             + GLOBAL_FIELDS + ("slot_records",)}
    g_dir_iters = 0
    for s, dev in enumerate(devices):
        if dev is None:
            continue
        src, flt = copy.copy(source), copy.copy(filterer)
        src.params, flt.params = _params_to(source.params, dev), _params_to(filterer.params, dev)
        xl = torch.as_tensor(vecs[s], device=dev)  # normalized; pad rows zero
        cl = torch.as_tensor(clus_local[s], device=dev)
        hashes = _hash_in_blocks(src.hash, xl, 8192)  # (n_max, L)
        sk = _hash_in_blocks(flt.sketch, xl, 8192)  # (n_max, S, W)
        pad = torch.arange(n_max, device=dev) >= int(n_locals[s])
        hashes_T = torch.where(pad[None, :], PAD_HASH, hashes.T).contiguous()
        built["vectors"][s] = xl
        built["sorted_hash"][s], built["sorted_idx"][s] = sort_tables_segmented(hashes_T, cl)
        built["sketches"][s] = sk
        if build_global:
            # 4. the global engine's tables and directory
            (built["g_sorted_hash"][s], built["g_records"][s], built["g_dir"][s],
             iters) = _global_tables(cfg, hashes_T, sk, cl, n_max)
            g_dir_iters = max(g_dir_iters, iters)
        if build_records:
            built["slot_records"][s] = _slot_records(cfg, built["sorted_idx"][s], sk)

    return ShardedIndex(
        vectors=built["vectors"],
        sorted_hash=built["sorted_hash"],
        sorted_idx=built["sorted_idx"],
        sketches=built["sketches"],
        cluster_starts=_place(cluster_starts, devices),
        centers=_place(centers_arr, devices),
        center_ids=_place(center_ids, devices),
        radii=_place(radii_arr, devices),
        brute=_place(brute_arr, devices),
        assignment=_place(np.where(clus_local >= C_max, 0, clus_local), devices),
        global_ids=_place(global_ids, devices),
        hash_params=source.params,
        sketch_params=filterer.params,
        probs_table=torch.as_tensor(probs.table, device=lead),
        maxdiff_table=torch.as_tensor(maxdiff, device=lead),
        config=cfg,
        shard_points=tuple(int(v) for v in n_locals),
        shard_clusters=tuple(len(g) for g in groups),
        metric=metric,
        sim_eps=probs.sim_eps,
        max_seg_len=int(sizes.max()) if len(sizes) else 0,
        g_dir_iters=g_dir_iters,
        **({f: built[f] for f in GLOBAL_FIELDS} if build_global else {}),
        slot_records=built["slot_records"] if build_records else None,
    )


def _local_index(sharded: ShardedIndex, s: int, device):
    """Shard `s` as a ClusteredIndex on `device` (the shard_map block)."""
    from clann_tpu_torch.core.index import ClusteredIndex

    def at(field):
        v = getattr(sharded, field)
        return None if v is None else v[s].to(device)

    return ClusteredIndex(
        **{f: at(f) for f in SHARD_FIELDS if f != "global_ids"},
        **{f: at(f) for f in GLOBAL_FIELDS},
        slot_records=at("slot_records"),
        g_dir_iters=sharded.g_dir_iters,
        hash_params=_params_to(sharded.hash_params, device),
        sketch_params=_params_to(sharded.sketch_params, device),
        probs_table=sharded.probs_table.to(device),
        maxdiff_table=sharded.maxdiff_table.to(device),
        config=sharded.config,
        metric=sharded.metric,
        sim_eps=sharded.sim_eps,
        max_seg_len=sharded.max_seg_len,
    )


def _check_mesh(mesh, sharded: ShardedIndex, n_queries: int) -> int:
    """Validate the mesh against the shard count; returns the number of
    query blocks (the 'query' axis of a 2-D mesh, else 1)."""
    shape = mesh.shape
    if CLUSTER_AXIS not in shape:
        raise ValueError(
            f"mesh must carry a '{CLUSTER_AXIS}' axis; got {mesh.axis_names}"
        )
    if shape[CLUSTER_AXIS] != sharded.n_devices:
        raise ValueError(
            f"index has {sharded.n_devices} cluster shards but the mesh "
            f"'{CLUSTER_AXIS}' axis is {shape[CLUSTER_AXIS]} wide"
        )
    if QUERY_AXIS in shape:
        dq = shape[QUERY_AXIS]
        if n_queries % dq:
            raise ValueError(
                f"query batch of {n_queries} does not divide over the "
                f"{dq}-wide '{QUERY_AXIS}' axis; pad the batch "
                "(sharded_search does this automatically)"
            )
        return dq
    return 1


def _merge_topk(mesh, sims, ids, lead, k: int):
    """The per-shard (Q, k) lists merged: all_gather to (D, Q, k), then one
    top-k over the D * k candidates of each query (lax.top_k's order)."""
    all_sims = all_gather(mesh, sims, lead)  # (D, Q, k)
    all_ids = all_gather(mesh, ids, lead)
    D, Q = all_sims.shape[0], all_sims.shape[1]
    flat_sims = all_sims.permute(1, 0, 2).reshape(Q, D * k)
    flat_ids = all_ids.permute(1, 0, 2).reshape(Q, D * k)
    top_sims, sel = topk_stable(flat_sims, k)
    return top_sims, torch.gather(flat_ids, 1, sel)


def _run_shards(sharded: ShardedIndex, mesh, queries_n, query_hashes, query_sketches,
                body, *, k: int):
    """Run `body(index, qn, qh, qs) -> (sims, local ids, stats)` on every
    local shard of every query block, map ids to global ids, merge the
    top-k across the cluster axis and psum the stats. Returns tensors on
    the first device of the mesh."""
    D = sharded.n_devices
    dq = _check_mesh(mesh, sharded, queries_n.shape[0])
    qb = queries_n.shape[0] // dq
    lead = mesh.cluster_devices(0)[0]
    out_s, out_i, out_st = [], [], []
    for b in range(dq):
        rows = slice(b * qb, (b + 1) * qb)
        devs = mesh.cluster_devices(b)
        sims_p, ids_p, stats_p = [None] * D, [None] * D, [None] * D
        for s in range(D):
            if not mesh.is_local(s, b):
                continue
            dev = devs[s]
            index = _local_index(sharded, s, dev)
            sims, ids, stats = body(index, queries_n[rows].to(dev),
                                    query_hashes[rows].to(dev), query_sketches[rows].to(dev))
            gids = sharded.global_ids[s].to(dev)
            sims_p[s] = sims
            ids_p[s] = torch.where(ids >= 0, gids[torch.clamp(ids, min=0).to(torch.int64)], -1)
            stats_p[s] = stats
        top_sims, top_ids = _merge_topk(mesh, sims_p, ids_p, devs[0], k)
        stats = SearchStats(*(psum(mesh, [None if st is None else st[f] for st in stats_p],
                                   devs[0])
                              for f in range(len(SearchStats._fields))))
        out_s.append(top_sims.to(lead))
        out_i.append(top_ids.to(lead))
        out_st.append([f.to(lead) for f in stats])
    return (torch.cat(out_s), torch.cat(out_i),
            SearchStats(*(torch.cat([st[f] for st in out_st])
                          for f in range(len(SearchStats._fields)))))


def sharded_search_batch(
    sharded: ShardedIndex,
    queries_n: torch.Tensor,
    query_hashes: torch.Tensor,
    query_sketches: torch.Tensor,
    delta,
    *,
    k: int,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """The clustered walk on every shard, top-k merged across the mesh.

    Returns (sims desc (Q, k), GLOBAL ids (Q, k), stats summed over the
    shards) tensors. On a 2-D (query, cluster) mesh (make_mesh_2d) the
    batch is also split along the query axis, each block merged over its
    own row of shards.
    """
    if mesh is None:
        mesh = make_mesh(sharded.n_devices)
    cfg = sharded.config

    def body(index, qn, qh, qs):
        return search_batch_impl(index, qn, qh, qs, float(delta), k=k,
                                 chunk=cfg.candidate_chunk, min_depth=cfg.min_depth)

    return _run_shards(sharded, mesh, queries_n, query_hashes, query_sketches, body, k=k)


def sharded_global_search_batch(
    sharded: ShardedIndex,
    queries_n: torch.Tensor,
    query_hashes: torch.Tensor,
    query_sketches: torch.Tensor,
    delta,
    *,
    k: int,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Point-sharded ball-filtered global LSH over the mesh.

    Every shard runs the global adaptive engine (ops/global_query.py) over
    its local hash-sorted tables, its record gathers through kernel K7;
    per-shard top-k merged as in sharded_search_batch. Per-shard k-th
    bests are never tighter than the global one, so per-shard termination
    is conservative: recall can only improve vs the single-device engine.
    Supports the same 2-D meshes as sharded_search_batch.
    """
    from clann_tpu_torch.ops.global_query import _map_tb, global_search_batch_impl

    if sharded.g_records is None:
        raise ValueError(
            "sharded index lacks global-engine structures; build the "
            "source index with config.lsh_engine='global' or 'both'"
        )
    if mesh is None:
        mesh = make_mesh(sharded.n_devices)
    cfg = sharded.config

    # the stream map at the JAX package's static size (the _map_tb rule
    # with the per-batch total replaced by the config cap); cursors past it
    # take the in-loop derivation, with identical results
    G = max(1, cfg.gather_block)
    map_tb = 0
    if cfg.stream_map and G <= 32:
        wb = max(1, (cfg.candidate_chunk * cfg.filter_expand) // G)
        map_tb = _map_tb(cfg.stream_map_blocks, cfg.stream_map_blocks, wb,
                         queries_n.shape[0])

    def body(index, qn, qh, qs):
        return global_search_batch_impl(
            index, qn, qh, qs, float(delta), k=k, chunk=cfg.candidate_chunk,
            min_depth=cfg.min_depth, filter_expand=cfg.filter_expand,
            static_map_tb=map_tb)

    return _run_shards(sharded, mesh, queries_n, query_hashes, query_sketches, body, k=k)


def _search(batch_fn, sharded: ShardedIndex, queries, k, delta, mesh):
    """Normalize + hash the queries on the mesh's first device, run
    `batch_fn`, return host (distances ascending, global ids, stats)."""
    from clann_tpu_torch.ops.distances import as_device_f32, l2_normalize

    cfg = sharded.config
    k = cfg.k if k is None else k
    delta = cfg.delta if delta is None else delta
    if mesh is None:
        mesh = make_mesh(sharded.n_devices)
    lead = mesh.cluster_devices()[0]
    source, filterer = sharded.rebuild_objects()
    source.params = _params_to(source.params, lead)
    filterer.params = _params_to(filterer.params, lead)

    qn = l2_normalize(as_device_f32(queries, lead))
    qn, n_real = _pad_queries(qn, mesh)
    sims, ids, stats = batch_fn(sharded, qn, source.hash(qn), filterer.sketch(qn), delta,
                                k=k, mesh=mesh)
    sims, ids, stats = _slice_queries(sims, ids, stats, n_real)
    sims, ids = sims.cpu().numpy(), ids.cpu().numpy()
    dists = np.where(ids < 0, np.inf, 2.0 * (1.0 - sims))
    return dists, ids, SearchStats(*(f.cpu().numpy() for f in stats))


def sharded_global_search(
    sharded: ShardedIndex,
    queries,
    k: Optional[int] = None,
    delta: Optional[float] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Full point-sharded global-engine search: numpy (distances ascending
    (Q, k), global ids, stats)."""
    return _search(sharded_global_search_batch, sharded, queries, k, delta, mesh)


def sharded_search(
    sharded: ShardedIndex,
    queries,
    k: Optional[int] = None,
    delta: Optional[float] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Full sharded walk: hash the queries, walk every shard, merge.
    Returns numpy (distances ascending (Q, k), global ids, stats)."""
    return _search(sharded_search_batch, sharded, queries, k, delta, mesh)


def _pad_queries(qn: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """Pad the query batch to divide over a 2-D mesh's query axis."""
    n_real = qn.shape[0]
    if mesh is None or QUERY_AXIS not in mesh.shape:
        return qn, n_real
    dq = mesh.shape[QUERY_AXIS]
    pad = (-n_real) % dq
    if pad:
        qn = torch.cat([qn, qn[:1].expand(pad, -1)])
    return qn, n_real


def _slice_queries(sims, ids, stats: SearchStats, n_real: int):
    """Drop pad-query rows from batch outputs."""
    if sims.shape[0] == n_real:
        return sims, ids, stats
    return sims[:n_real], ids[:n_real], SearchStats(*(f[:n_real] for f in stats))


def assert_balanced(sharded: ShardedIndex, cluster_sizes: np.ndarray) -> int:
    """Assert the shard layout meets the packer's exact guarantee.

    partition_clusters assigns clusters largest-first to the least-loaded
    shard, so at the end `max_load - min_load <= max cluster size`: when
    the most loaded shard received its last cluster (size s) it was the
    argmin, so its prior load was <= every final load. A layout that breaks
    this is a packer regression, not data. Returns the bound (the largest
    cluster size).
    """
    pts = np.asarray(sharded.shard_points)
    bound = int(np.max(cluster_sizes))
    spread = int(pts.max() - pts.min())
    if spread > bound:
        raise AssertionError(
            f"shard point spread {spread} exceeds the greedy-packing bound "
            f"{bound} (max cluster size); packer regression")
    return bound


def shard_report(sharded: ShardedIndex, Q: int, k: int) -> dict:
    """Per-shard balance and collective volumes of one search.

    Balance comes from the shard layout (real points and clusters per
    shard; padding = allocated minus real). The volumes follow from the
    merge shapes: every sharded search gathers per-shard (Q, k) sims f32 +
    ids i32 into (D, Q, k) and psums three (Q,) i32 stat vectors; a
    bidirectional ring all_gather moves (D-1)/D of the gathered bytes per
    device. (On one card, or one process, the "collectives" are copies.)
    """
    D = sharded.n_devices
    pts = np.asarray(sharded.shard_points)
    cls = np.asarray(sharded.shard_clusters)
    alloc = sharded.n_max
    gather_bytes = D * Q * k * (4 + 4)  # sims f32 + ids i32, per device
    psum_bytes = 3 * Q * 4
    return {
        "devices": int(D),
        "points_per_device": pts.tolist(),
        "point_balance": round(float(pts.min() / max(1, pts.max())), 4),
        "clusters_per_device": cls.tolist(),
        "pad_fraction": round(float(1.0 - pts.sum() / (D * alloc)), 4),
        "allgather_bytes_per_device_per_batch": int(gather_bytes),
        "psum_bytes_per_batch": int(psum_bytes),
        "ici_bytes_per_device_per_batch": int(gather_bytes * (D - 1) / D + psum_bytes),
        "batch_shape": {"Q": int(Q), "k": int(k)},
    }


def _balance_record(sharded, cluster_sizes, Q: int, k: int) -> dict:
    bound = assert_balanced(sharded, cluster_sizes)
    report = shard_report(sharded, Q=Q, k=k)
    report["balance_spread_bound"] = {
        "max_minus_min_points": int(max(report["points_per_device"])
                                    - min(report["points_per_device"])),
        "greedy_packing_bound": bound,
        "note": "LPT invariant: spread <= max cluster size (asserted)",
    }
    return report


def dryrun(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Tiny end-to-end sharded step on `n_devices` shards of `devices`
    (default: the visible CUDA devices): build, shard, search, verify."""
    from clann_tpu_torch.core.index import build_index
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors, random_unit_vectors

    cfg = Config(
        num_tables=4, num_clusters_factor=1.0, k=5, delta=0.8, hash_family="simhash",
        candidate_chunk=64, brute_force_threshold=8, seed=0, lsh_engine="both",
    )
    train = clustered_unit_vectors(512, 16, n_modes=max(8, 2 * n_devices), seed=0)
    mesh = make_mesh(n_devices, devices=devices)
    lead = mesh.cluster_devices()[0]
    # mesh-sharded GMM build stage, bit-identical to the single-device path
    index = build_index(train, cfg, gmm_mesh=mesh, device=lead)
    sharded = shard_index(index, n_devices, mesh=mesh)
    queries = random_unit_vectors(32, 16, seed=1)

    def check(cond, what):
        if not cond:
            raise AssertionError(f"dryrun: {what}")

    # adaptive LSH path over the mesh
    dists, ids, stats = sharded_search(sharded, queries, mesh=mesh)
    check(dists.shape == (32, 5) and ids.shape == (32, 5), "walk shape")
    check(int(stats.distance_computations.sum()) > 0, "walk dc")
    check(ids.max() < 512 and np.all(np.diff(dists, axis=1) >= -1e-5), "walk order")
    # dense scan path over the mesh
    d2, i2, _ = sharded_scan_search(sharded, queries, k=5, exact=True, mesh=mesh)
    check(d2.shape == (32, 5) and i2.max() < 512, "exact scan shape")
    check(np.all(np.diff(d2, axis=1) >= -1e-5), "exact scan order")
    # packed fused-kernel scan over the mesh (kernel K1 on a card)
    d2p, i2p, _ = sharded_scan_search(sharded, queries, k=5, use_pallas=True, mesh=mesh)
    check(d2p.shape == (32, 5) and i2p.max() < 512, "fused scan shape")
    # ball-filtered global LSH path over the mesh
    d3, i3, st3 = sharded_global_search(sharded, queries, mesh=mesh)
    check(d3.shape == (32, 5) and i3.max() < 512, "global shape")
    check(int(st3.distance_computations.sum()) > 0, "global dc")
    check(np.all(np.diff(d3, axis=1) >= -1e-5), "global order")
    # end-to-end sharded build: reproduces the shard-a-built-index path
    direct = build_sharded(train, cfg, mesh=mesh)
    d4, i4, _ = sharded_search(direct, queries, mesh=mesh)
    check(np.array_equal(i4, ids) and np.allclose(d4, dists, atol=1e-6), "build_sharded")
    d5, i5, _ = sharded_global_search(direct, queries, mesh=mesh)
    check(d5.shape == (32, 5) and i5.max() < 512, "build_sharded global")
    # table-sharded closest-pairs join: identical to the single-device join
    from clann_tpu_torch.ops.join import closest_pairs
    from clann_tpu_torch.parallel.join import sharded_closest_pairs

    pairs_1, sims_1 = closest_pairs(index, k=5, delta=0.8)
    pairs_s, sims_s = sharded_closest_pairs(index, k=5, delta=0.8, mesh=mesh)
    check(pairs_s.tolist() == pairs_1.tolist(), "join pairs")
    check(np.allclose(sims_s, sims_1, atol=1e-6), "join sims")
    # point-sharded Jaccard: direct sharded build + adaptive search
    from clann_tpu_torch.data.synthetic import clustered_sets
    from clann_tpu_torch.parallel.jaccard import build_jaccard_sharded, sharded_jaccard_search

    jcfg = Config(num_tables=4, k=3, delta=0.8, candidate_chunk=32, max_hashbits=12, seed=0)
    jsets = clustered_sets(160, 300, avg_size=8, n_modes=8, seed=0)
    jsh = build_jaccard_sharded(jsets, 300, jcfg, mesh=mesh)
    js, ji, jst = sharded_jaccard_search(jsh, jsets[:8], k=3, delta=0.8, mesh=mesh)
    check(js.shape == (8, 3) and ji.max() < 160, "jaccard shape")
    check(int(jst.distance_computations.sum()) > 0, "jaccard dc")
    # 2-D (query, cluster) mesh: query-data-parallel over the cluster
    # sharding, identical results (pad-and-slice path via 31 queries)
    if n_devices >= 4 and n_devices % 2 == 0:
        from clann_tpu_torch.parallel.mesh import make_mesh_2d

        half_devs = list(mesh.cluster_devices())
        half = shard_index(index, n_devices // 2, mesh=make_mesh(n_devices // 2,
                                                                 devices=half_devs))
        mesh2 = make_mesh_2d(2, n_devices // 2, devices=half_devs)
        d1d, i1d, _ = sharded_search(half, queries[:31],
                                     mesh=make_mesh(n_devices // 2, devices=half_devs))
        d2d, i2d, _ = sharded_search(half, queries[:31], mesh=mesh2)
        check(np.array_equal(i2d, i1d) and np.allclose(d2d, d1d, atol=1e-6), "2-D mesh")

    cluster_sizes = np.diff(index.cluster_starts.cpu().numpy())
    report = _balance_record(sharded, cluster_sizes, Q=queries.shape[0], k=5)
    print("SHARD_REPORT " + json.dumps(report), flush=True)


def dryrun_large(n_devices: int, n: int = 100_000,
                 devices: Optional[Sequence] = None) -> None:
    """Non-toy sharded dryrun (~100k points): at this shape the balance
    bound has teeth (max cluster size << n / D), so point balance must
    reach 0.9, asserted with the LPT invariant; also runs the global
    engine's static stream map at realistic table extents and holds its
    recall to exact brute force."""
    from clann_tpu_torch.core.index import build_index
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors, random_unit_vectors
    from clann_tpu_torch.ops.distances import brute_force_topk

    cfg = Config(
        num_tables=8, num_clusters_factor=0.4, k=10, delta=0.9, hash_family="simhash",
        candidate_chunk=512, filter_expand=8, gather_block=16, seed=0,
        lsh_engine="global", pack_slot_records=False,
    )
    d = 32
    train = clustered_unit_vectors(n, d, n_modes=64, spread=0.7, seed=0)
    mesh = make_mesh(n_devices, devices=devices)
    lead = mesh.cluster_devices()[0]
    index = build_index(train, cfg, gmm_mesh=mesh, device=lead)
    sharded = shard_index(index, n_devices, mesh=mesh)
    queries = random_unit_vectors(32, d, seed=1)

    dists, ids, stats = sharded_global_search(sharded, queries, mesh=mesh)
    gt_d, _ = brute_force_topk(train, queries, k=10, metric="angular", device=lead)
    gt_d = gt_d.cpu().numpy()
    hit = (dists <= gt_d[:, 9:10] + 1e-3).sum(axis=1) / 10.0
    mean_recall = float(hit.mean())
    if mean_recall < 0.8 * cfg.delta or int(stats.distance_computations.sum()) <= 0:
        raise AssertionError(f"dryrun_large: global recall {mean_recall}")
    d2, _, _ = sharded_scan_search(sharded, queries, k=10, mesh=mesh)
    if float((d2 <= gt_d[:, 9:10] + 1e-3).mean()) < 0.9:
        raise AssertionError("dryrun_large: scan recall")

    cluster_sizes = np.diff(index.cluster_starts.cpu().numpy())
    report = _balance_record(sharded, cluster_sizes, Q=queries.shape[0], k=10)
    report["mean_recall_at_10"] = round(mean_recall, 4)
    if report["point_balance"] < 0.9:
        raise AssertionError(f"dryrun_large: balance {report}")
    print("SHARD_REPORT_LARGE " + json.dumps(report), flush=True)


# (id(vectors list), block_n, shard devices) -> (vectors list, bp, vperm,
# gperm): one shard set, as the JAX package's _SHARD_BASE_CACHE and
# ops/ivf's cache
_SHARD_BASE_CACHE: dict = {}


def _shard_pallas_base(sharded: ShardedIndex, block_n: int, devices):
    """Per-shard padded bf16 base for the fused scan (K1), cached.

    - rows are SHUFFLED within each shard (real rows permuted by numpy
      default_rng(0), in shard order; pads kept at the end): shard layouts
      are cluster-major, and the kernel's contiguous bins would otherwise
      hold one cluster each, so a query's true neighbours share 1-2 bins
      and all but the bin winners are lost;
    - the bias column is 1.0 on REAL rows only: a pad row with bias would
      score dot + 3.0 = 3.0 and displace real candidates;
    - built once per (shard set, plan) and cached (one shard set held).

    Returns per-shard lists (bp (n_pad, dpad) bf16, vperm (n_local, d) f32
    permuted vectors for the exact rescore, gperm (n_local,) permuted
    global ids); kernel candidate ids index the PERMUTED layout.
    """
    key = (id(sharded.vectors), block_n, tuple(devices))
    hit = _SHARD_BASE_CACHE.get(key)
    if hit is not None and hit[0] is sharded.vectors:
        return hit[1:]
    D, n_local, d = sharded.n_devices, sharded.n_max, sharded.dims
    n_pad = ((n_local + block_n - 1) // block_n) * block_n
    dpad = ((d + 1 + 127) // 128) * 128  # spare dim for the bias column
    rng = np.random.default_rng(0)
    bps, vps, gps = [None] * D, [None] * D, [None] * D
    for s in range(D):
        n_real = sharded.shard_points[s]
        perm = np.empty(n_local, np.int64)
        perm[:n_real] = rng.permutation(n_real)
        perm[n_real:] = np.arange(n_real, n_local)
        if devices[s] is None:
            continue
        dev = devices[s]
        p = torch.as_tensor(perm, device=dev)
        v = sharded.vectors[s].to(dev)[p]  # (n_local, d) shuffled
        g = sharded.global_ids[s].to(dev)[p]
        bp = torch.zeros((n_pad, dpad), dtype=torch.bfloat16, device=dev)
        bp[:n_local, :d] = v.to(torch.bfloat16)
        bp[:n_local, d] = (g >= 0).to(torch.bfloat16)
        bps[s], vps[s], gps[s] = bp, v, g
    _SHARD_BASE_CACHE.clear()  # hold exactly one shard set
    _SHARD_BASE_CACHE[key] = (sharded.vectors, bps, vps, gps)
    return bps, vps, gps


def sharded_scan_search(
    sharded: ShardedIndex,
    queries,
    k: Optional[int] = None,
    recall_target: float = 0.95,
    exact: bool = False,
    use_pallas: bool = False,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Full dense scan sharded over the mesh.

    Every shard scans its local points, with the blocked scan
    (ops/distances._dense_scan_impl) or, with use_pallas, the packed fused
    scan (ops/scan_topk.fused_scan_topk_e2e, kernel K1 on a card, its plain
    version on the CPU), and the per-shard top-k lists are merged with an
    all_gather. Point shards are disjoint, so no dedup is needed. Returns
    numpy (distances ascending, GLOBAL ids, stats). The queries are not
    split on a 2-D mesh (JAX replicates them); its first row scans.
    """
    from clann_tpu_torch.ops.distances import _dense_scan_impl, as_device_f32, l2_normalize

    if mesh is None:
        mesh = make_mesh(sharded.n_devices)
    k = sharded.config.k if k is None else k
    devs = mesh.cluster_devices()
    if len(devs) != sharded.n_devices:
        raise ValueError(
            f"index has {sharded.n_devices} cluster shards but the mesh "
            f"'{CLUSTER_AXIS}' axis is {len(devs)} wide")
    lead = devs[0]
    qn = l2_normalize(as_device_f32(queries, lead))
    if qn.dim() == 1:
        qn = qn[None, :]
    n_local, d = sharded.n_max, sharded.dims
    block_points = min(262144, n_local)
    local = [dev if mesh.is_local(s) else None for s, dev in enumerate(devs)]
    if use_pallas:
        from clann_tpu_torch.ops.ivf import pallas_scan_plan
        from clann_tpu_torch.ops.scan_topk import fused_scan_topk_e2e

        block_n, num_bins, rescore_m, q_tile = pallas_scan_plan(n_local, k, d=int(d))
        bp_all, vec_in, gid_in = _shard_pallas_base(sharded, block_n, local)
    else:
        vec_in, gid_in = sharded.vectors, sharded.global_ids

    D = sharded.n_devices
    sims_p, ids_p = [None] * D, [None] * D
    for s, dev in enumerate(local):
        if dev is None:
            continue
        vecs, gids, q = vec_in[s].to(dev), gid_in[s].to(dev), qn.to(dev)
        # padded rows (gid < 0) are zero vectors; masked via global ids
        if use_pallas:
            sims, lids = fused_scan_topk_e2e(
                bp_all[s], vecs, q, n_real=n_local, k=k, rescore_m=rescore_m,
                num_bins=num_bins, block_n=block_n, q_tile=q_tile, biased=True)
        else:
            sims, lids = _dense_scan_impl(vecs, q, k=k, block_points=block_points,
                                          recall_target=recall_target, exact=exact)
        safe = torch.clamp(lids, 0, n_local - 1)
        out_ids = torch.where(lids >= 0, gids[safe], -1)
        sims_p[s] = torch.where(out_ids >= 0, sims, -torch.inf)
        ids_p[s] = out_ids
    sims, ids = _merge_topk(mesh, sims_p, ids_p, lead, k)
    sims_np, ids_np = sims.cpu().numpy(), ids.cpu().numpy()
    dists = np.where(ids_np >= 0, np.clip(1.0 - sims_np, 0.0, 2.0), np.inf)
    Q = ids_np.shape[0]
    n_total = int(sum(sharded.shard_points))
    stats = SearchStats(
        distance_computations=np.full(Q, n_total, np.int32),
        candidates=np.full(Q, n_total, np.int32),
        clusters_visited=np.full(Q, sharded.c_max, np.int32),
    )
    return dists, ids_np, stats

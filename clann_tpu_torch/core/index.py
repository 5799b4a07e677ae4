"""The clustered LSH index: device-resident structure and builder (PyTorch port).

Port of ``clann_tpu.core.index``: GMM clustering (reference:
src/core/index.rs:177-289), the per-cluster bookkeeping, one hashing pass
over all points for the L tables (collection.hpp:287-297), one sketching
pass (filterer.hpp:76-97), the per-table segmented sort
(prefixmap.hpp:169-247) with its per-(table, cluster) prefix directory, and
the global engine's hash-sorted tables with [id, sketch, cluster] records
(ops/global_query.py).

With `config.dense_layout` (the default) the build also makes the dense IVF
layout (`build_dense_layout`): every cluster split into rows of at most
`config.dense_seg_cap` points, padded, for the batched probing of
ops/ivf.py. With `config.rescore_dtype == "int8"` it keeps an int8 shadow
of the vectors (`quantize_q8`), which the LSH engines score candidates
against before an exact f32 re-score of their final top-k.

`insert` appends points (pending until `rebuild`, which hashes only them
with the stored functions and re-assembles the layouts);
`build_lsh_index` is the single-cluster (C = 1) index.

Random draws: the JAX package splits `jax.random.PRNGKey(config.seed)`
into a hash key and a sketch key. The port seeds two `torch.Generator`s
from `config.seed` instead, so its functions are its own; tests get the
JAX functions by carrying the JAX index's parameters across with
`index_from_arrays`.

Words that the JAX package stores as uint32 (hashes, sketch words, records)
are int32 tensors here with the same bit patterns.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.errors import DataError, IndexCreationError
from clann_tpu_torch.ops.collision import HashSourceProbs
from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize
from clann_tpu_torch.ops.gmm import greedy_minimum_maximum
from clann_tpu_torch.ops.hashing import make_hash_family
from clann_tpu_torch.ops.prefixmap import (
    build_prefix_directory,
    sort_tables_segmented,
    table_blocks,
)
from clann_tpu_torch.ops.sketches import SketchFilterer, simhash_p1
from clann_tpu_torch.ops.sources import make_hash_source

log = logging.getLogger("clann_tpu_torch")

GEOMETRY_FIELDS = (
    "vectors", "cluster_starts", "centers", "center_ids", "radii", "brute",
    "assignment",
)
# LSH arrays (None where not built) and their dtypes in the port
LSH_FIELDS = {
    "sorted_hash": torch.int32,
    "sorted_idx": torch.int32,
    "sketches": torch.int32,
    "probs_table": torch.float32,
    "maxdiff_table": torch.int32,
    "slot_records": torch.int32,
    "prefix_dir": torch.int32,
    "g_sorted_hash": torch.int32,
    "g_records": torch.int32,
    "g_dir": torch.int32,
    # the int8 shadow of `vectors` (config.rescore_dtype == "int8")
    "vectors_q8": torch.int8,
}
# the dense IVF layout (None where not built) and its dtypes in the port
DENSE_FIELDS = {
    "seg_vectors": torch.float32,
    "seg_ids": torch.int32,
    "seg_centers": torch.float32,
    "seg_radii": torch.float32,
    "seg_sizes": torch.int32,
    "seg_cluster": torch.int32,
}
# the arrays memory_usage counts: JAX's list (clann_tpu/core/index.py:
# 184-204), which leaves out the collision tables and the dense layout
_MEMORY_FIELDS = GEOMETRY_FIELDS + (
    "sorted_hash", "sorted_idx", "sketches", "slot_records", "prefix_dir",
    "g_sorted_hash", "g_records", "g_dir",
)
# the JAX package's dtype of every hash / sketch parameter leaf, by name
# (the port holds the integer leaves as int32, uint32 words as their bit
# patterns): what the native h5 format writes and what a JAX index takes
PARAM_DTYPES = {
    "dirs": np.float32,  # SimHash planes (tables and sketches)
    "signs": np.float32,  # FHT cross-polytope +-1 diagonals
    "rot": np.float32,  # cross-polytope rotations
    "pool_indices": np.int32,  # the pooled source's per-table sampling
    "rank_seed": np.uint32,  # MinHash, MinHash1Bit
    "scramble_seed": np.uint32,
    "tab_hi": np.uint32,  # tabulation MinHash (the reference's functions)
    "tab_lo": np.uint32,
    "perm": np.uint32,
}
PARAM_FIELDS = ("hash_params", "sketch_params", "pc_hash_params", "pc_sketch_params")
# static metadata (python scalars), JAX's names and defaults
META_FIELDS = {
    "sim_eps": 5e-3, "max_seg_len": 0, "dir_bits": 0, "dir_iters": 0,
    "g_dir_iters": 0, "n_indexed": -1,
}


@dataclasses.dataclass(eq=False)
class ClusteredIndex:
    """Device-resident clustered LSH index (the JAX package's fields)."""

    # --- point data and cluster geometry (reference: index.rs:27-35) ---
    vectors: torch.Tensor  # (n, d) f32, L2-normalized for angular
    cluster_starts: torch.Tensor  # (C+1,) int32 segment boundaries
    centers: torch.Tensor  # (C, d) f32 center vectors (normalized)
    center_ids: torch.Tensor  # (C,) int32 center point ids
    radii: torch.Tensor  # (C,) f32 cluster radii
    brute: torch.Tensor  # (C,) bool brute-force flag (index.rs:204-205)
    assignment: torch.Tensor  # (n,) int32 cluster of each point
    # --- hash tables (reference: prefixmap.hpp), sorted by (cluster, hash) ---
    sorted_hash: Optional[torch.Tensor] = None  # (L, n) int32
    sorted_idx: Optional[torch.Tensor] = None  # (L, n) int32 global point ids
    # --- sketches (reference: filterer.hpp) ---
    sketches: Optional[torch.Tensor] = None  # (n, S, W) int32 sketch words
    # --- hash machinery ---
    hash_params: Any = None  # dict of the table hash family's tensors
    sketch_params: Any = None  # dict of the sketch family's tensors
    probs_table: Optional[torch.Tensor] = None  # (D+2, B) f32 collision probs
    maxdiff_table: Optional[torch.Tensor] = None  # (B,) int32 sketch thresholds
    # per-cluster hash and sketch functions of a faithful reference import
    # (io/interop.py): dicts of tensors with a leading C axis; the walk
    # hashes and sketches queries with each cluster's own (ops/query.search)
    pc_hash_params: Any = None
    pc_sketch_params: Any = None
    # --- packed per-(table, slot) [id, sketch words] records of the
    # clustered walk (config.pack_slot_records) ---
    slot_records: Optional[torch.Tensor] = None  # (L, n_pad, 1+W) int32
    # --- per-(table, cluster) prefix directory (prefixmap.hpp:70,86,228-240) ---
    prefix_dir: Optional[torch.Tensor] = None  # (L, C, 2^dir_bits+1) int32
    # --- global LSH structures (ops/global_query.py): tables sorted by hash
    # over the whole dataset, [id, sketch words, cluster] records ---
    g_sorted_hash: Optional[torch.Tensor] = None  # (L, n) int32
    g_records: Optional[torch.Tensor] = None  # (L, n_pad, 2+W) int32
    g_dir: Optional[torch.Tensor] = None  # (L, 1, 2^global_dir_bits+1) int32
    # --- int8 shadow of `vectors` for the LSH engines' in-loop candidate
    # scoring (config.rescore_dtype == "int8"; the reference's Q15 ranking
    # dots, unit_vector.hpp:26-45, with CLANN's f32 re-scoring of winners,
    # index.rs:400-416). Not counted by memory_usage, as in JAX ---
    vectors_q8: Optional[torch.Tensor] = None  # (n, d) int8, scale 127
    # --- dense IVF layout (config.dense_layout): each cluster split into
    # rows of <= dense_seg_cap points; a row inherits its owner's center
    # and radius ---
    seg_vectors: Optional[torch.Tensor] = None  # (R, seg_cap, d) f32, 0 pad
    seg_ids: Optional[torch.Tensor] = None  # (R, seg_cap) int32, -1 pad
    seg_centers: Optional[torch.Tensor] = None  # (R, d) owner centers
    seg_radii: Optional[torch.Tensor] = None  # (R,) owner radii
    seg_sizes: Optional[torch.Tensor] = None  # (R,) real points per row
    seg_cluster: Optional[torch.Tensor] = None  # (R,) owner cluster id
    # --- static metadata ---
    config: Config = None
    metric: str = "angular"
    sim_eps: float = 5e-3
    max_seg_len: int = 0  # largest cluster segment
    dir_bits: int = 0  # prefix directory geometry
    dir_iters: int = 0
    g_dir_iters: int = 0
    # points in the hash tables; -1 = all. Points that `insert` appends
    # beyond this count are pending: in `vectors` (so the dense scans,
    # which read it directly, see them) but invisible to the table-backed
    # paths (the LSH engines, IVF probing) until `rebuild` (the reference's
    # insert-then-rebuild contract, collection.hpp:218-222, 241-306)
    n_indexed: int = -1
    # ops/ivf._pallas_base's padded bf16 copy of `vectors` (derived)
    pallas_base_cache: Dict = dataclasses.field(default_factory=dict, repr=False)
    # ops/block_scan.get_block_layout's BlockLayouts, by block_n (derived)
    block_layout_cache: Dict = dataclasses.field(default_factory=dict, repr=False)
    # ops/global_query's captured loop bodies (derived): a class attribute
    # and not a field, so that each copy made by `replace`, `insert` or
    # `rebuild` starts without
    body_graphs = None

    def replace(self, **changes):
        """A copy with `changes` to its fields (flax's struct.dataclass
        `replace`, which the JAX package's index has)."""
        return dataclasses.replace(self, **changes)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def num_indexed(self) -> int:
        """Points searchable through the hash tables (see n_indexed)."""
        return self.n if self.n_indexed < 0 else self.n_indexed

    @property
    def num_pending(self) -> int:
        """Points added by `insert` that wait for `rebuild`."""
        return self.n - self.num_indexed

    @property
    def dims(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_tables(self) -> int:
        return self.sorted_hash.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def max_hashbits(self) -> int:
        return self.config.max_hashbits

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def _tensors(self, fields):
        for f in fields:
            t = getattr(self, f)
            if t is not None:
                yield f, t
        for name in ("hash_params", "sketch_params"):
            for k, t in (getattr(self, name) or {}).items():
                yield f"{name}.{k}", t

    def memory_usage(self) -> int:
        """Index bytes: dataset, geometry, tables, sketches, records,
        directories and hash parameters — the JAX package's count, which
        leaves out the collision tables and the dense layout (reference:
        collection.hpp:249-254)."""
        return int(sum(t.numel() * t.element_size()
                       for _, t in self._tensors(_MEMORY_FIELDS)))

    def array_bytes(self) -> Dict[str, int]:
        """Bytes of each array field that is built."""
        fields = GEOMETRY_FIELDS + tuple(LSH_FIELDS) + tuple(DENSE_FIELDS)
        return {f: int(t.numel() * t.element_size()) for f, t in self._tensors(fields)}

    def rebuild_objects(self):
        """(source, filterer) driver objects bound to the stored params."""
        cfg = self.config
        family = make_hash_family(
            cfg.hash_family, self.dims,
            num_rotations=cfg.num_rotations,
            estimation_repetitions=cfg.estimation_repetitions,
            estimation_eps=cfg.estimation_eps,
        )
        source = make_hash_source(
            cfg.hash_source, family, cfg.num_tables, cfg.max_hashbits,
            pool_size=cfg.pool_size,
        )
        source.params = self.hash_params
        filterer = SketchFilterer(self.dims, cfg.num_sketches, cfg.sketch_bits)
        filterer.params = self.sketch_params
        return source, filterer


def quantize_q8(xn: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization (scale 127) of unit-norm vectors:
    round(clip(x * 127, -127, 127)), halves to even as jnp.round does
    (the reference's Q15 idea, format/unit_vector.hpp:26-45, at 8 bits)."""
    return torch.round(torch.clamp(xn * 127.0, -127.0, 127.0)).to(torch.int8)


def rescore_shadow(xn: torch.Tensor, config: Config) -> Optional[torch.Tensor]:
    """The build's `vectors_q8`: quantize_q8(xn) when config.rescore_dtype
    is "int8", else None."""
    return quantize_q8(xn) if config.rescore_dtype == "int8" else None


def with_rescore_dtype(index: "ClusteredIndex", rescore_dtype: str) -> "ClusteredIndex":
    """The same index under another config.rescore_dtype: the shadow the
    build would make (rescore_shadow) and every other array shared."""
    config = index.config.replace(rescore_dtype=rescore_dtype)
    return dataclasses.replace(
        index, config=config, vectors_q8=rescore_shadow(index.vectors, config),
        pallas_base_cache={}, block_layout_cache={})


def build_dense_layout(xn: torch.Tensor, cluster_order_ids: torch.Tensor, starts,
                       centers_vec: torch.Tensor, radii, seg_cap: int) -> dict:
    """Row-chunked dense segments: every cluster split into rows of at most
    `seg_cap` points (an empty cluster keeps one empty row).

    cluster_order_ids: (n,) global ids grouped by cluster (any table's
    sorted_idx; the segments partition it identically); starts: (C+1,)
    cluster boundaries. The row bookkeeping is integer work on the host;
    the padded (R, seg_cap, d) gather runs on xn's device. Returns the
    seg_* fields of ClusteredIndex (the JAX package's values, bit for bit).
    """
    dev = xn.device
    starts = np.asarray(starts, np.int64)
    sizes = np.diff(starts)
    n_rows = np.maximum(1, -(-sizes // seg_cap))
    seg_cluster = np.repeat(np.arange(len(sizes)), n_rows)
    first_row = np.repeat(np.cumsum(n_rows) - n_rows, n_rows)
    lo = starts[seg_cluster] + (np.arange(len(seg_cluster)) - first_row) * seg_cap
    seg_sizes = np.minimum(lo + seg_cap, starts[seg_cluster + 1]) - lo
    col = torch.arange(seg_cap, device=dev)
    real = col[None, :] < torch.as_tensor(seg_sizes, device=dev)[:, None]  # (R, seg_cap)
    pos = torch.as_tensor(lo, device=dev)[:, None] + col[None, :]
    order = cluster_order_ids.to(device=dev, dtype=torch.int64)
    ids = torch.where(real, order[torch.clamp(pos, max=order.shape[0] - 1)], -1)
    vec = xn[torch.clamp(ids, min=0)]  # (R, seg_cap, d)
    vec.masked_fill_(~real[:, :, None], 0.0)
    owner = torch.as_tensor(seg_cluster, device=dev)
    return {
        "seg_vectors": vec.to(torch.float32),
        "seg_ids": ids.to(torch.int32),
        "seg_centers": centers_vec[owner],
        "seg_radii": as_device_f32(radii, dev)[owner],
        "seg_sizes": torch.as_tensor(seg_sizes.astype(np.int32), device=dev),
        "seg_cluster": owner.to(torch.int32),
    }


def derive_probs_tables(family, config: Config):
    """(HashSourceProbs, maxdiff int32 numpy array) for the termination checks."""
    probs = HashSourceProbs(family, config.max_hashbits, sim_eps=5e-3)
    if config.hash_source == "tensor":
        # tensored tables are correlated: the effective per-table
        # probabilities (ops/collision.tensored_effective_table)
        from clann_tpu_torch.ops.collision import tensored_effective_table

        probs.table = tensored_effective_table(probs.table, config.num_tables)
    n_buckets = probs.table.shape[1]
    sims = np.arange(n_buckets, dtype=np.float32) * probs.sim_eps
    maxdiff = np.round(
        config.sketch_bits * (1.0 - np.asarray(simhash_p1(sims)))
    ).astype(np.int32)
    return probs, maxdiff


def _iters(size: int) -> int:
    return int(np.ceil(np.log2(max(2, size)))) + 1


def derive_prefix_directory(sorted_hash, starts, config: Config, max_seg: int):
    """(prefix_dir, dir_bits, dir_iters) for a segmented table layout;
    None/0/0 when disabled or trivial."""
    if config.prefix_dir_bits <= 0 or max_seg <= 1:
        return None, 0, 0
    dir_bits = min(config.prefix_dir_bits, config.max_hashbits)
    prefix_dir = build_prefix_directory(
        sorted_hash, torch.tensor(np.asarray(starts)), dir_bits, _iters(max_seg),
        config.max_hashbits,
    )
    max_bucket = int(torch.max(prefix_dir[:, :, 1:] - prefix_dir[:, :, :-1]))
    return prefix_dir, dir_bits, _iters(max_bucket)


def make_global_tables(hashes_T: torch.Tensor, sketches: torch.Tensor,
                       assignment: torch.Tensor, pad_to: int = 1):
    """Hash-sorted global tables + [id, sketch words, cluster] records.

    Per table, slots sorted by hash over the whole dataset; ids inside a
    run of equal hashes ascend (a stable sort; the JAX package's sort is
    unstable there). Table t's records carry sketch t % S (collection.hpp:
    826). `pad_to` (config.gather_block) pads the RECORDS' slot axis with
    zero records so the blocked query gather can view it as
    (L, n_pad / G, G * R) rows. Returns (g_sorted_hash (L, n) int32,
    g_records (L, n_pad, 2 + W) int32).

    Tables are sorted and gathered in blocks (prefixmap.table_blocks), each
    written straight into the preallocated, already padded outputs; every
    block size gives the same bits.
    """
    from clann_tpu_torch.metrics.trace import TRACER

    L, n = hashes_T.shape
    S, W = sketches.shape[1:]
    dev = hashes_T.device
    n_pad = n + (-n) % pad_to
    g_hash = torch.empty_like(hashes_T)
    g_records = torch.empty((L, n_pad, 2 + W), dtype=torch.int32, device=dev)
    g_records[:, n:] = 0
    sk_idx = (torch.arange(L, device=dev) % S)[:, None]
    for b in table_blocks(L):
        with TRACER.span("build/table_block", block_on=dev):
            g_hash[b], order = torch.sort(hashes_T[b], dim=1, stable=True)
            rec = g_records[b, :n]
            rec[:, :, 0] = order
            rec[:, :, 1:1 + W] = sketches[order, sk_idx[b], :]
            rec[:, :, 1 + W] = assignment[order]
    return g_hash, g_records


def unsort_hashes(sorted_hash: torch.Tensor, sorted_idx: torch.Tensor, n: int = None):
    """Per-point hashes (L, n) from a sorted table layout (`n` defaults to
    the table width; ids in sorted_idx must be below it)."""
    L, n_tbl = sorted_hash.shape
    out = torch.zeros((L, n or n_tbl), dtype=sorted_hash.dtype, device=sorted_hash.device)
    return out.scatter_(1, sorted_idx.to(torch.int64), sorted_hash)


def make_slot_records(sorted_idx: torch.Tensor, sketches: torch.Tensor,
                      pad_to: int = 1) -> torch.Tensor:
    """[id, sketch words] per (table, slot); table t carries sketch t % S
    (collection.hpp:826); `pad_to` pads the slot axis with zero records as
    in make_global_tables."""
    L, n = sorted_idx.shape
    S, W = sketches.shape[1:]
    dev = sorted_idx.device
    rec = torch.zeros((L, n + (-n) % pad_to, 1 + W), dtype=torch.int32, device=dev)
    sk_idx = (torch.arange(L, device=dev) % S)[:, None]
    rec[:, :n, 0] = sorted_idx
    rec[:, :n, 1:] = sketches[sorted_idx.to(torch.int64), sk_idx, :]
    return rec


def _hash_in_blocks(fn, x: torch.Tensor, block: int, transpose: bool = False) -> torch.Tensor:
    """fn over point blocks of `block` rows, each written into one
    preallocated output: (n, ...), or with `transpose` the (L, n) transpose
    of fn's (rows, L) output. Bounds the (num_functions, block,
    padded_dim) floats of cross-polytope hashing, and holds no second copy
    of the output."""
    n = x.shape[0]
    out = None
    for s in range(0, n, block):
        part = fn(x[s:s + block])
        if transpose:
            part = part.T
        if out is None:
            shape = (part.shape[0], n) if transpose else (n, *part.shape[1:])
            out = torch.empty(shape, dtype=part.dtype, device=part.device)
        if transpose:
            out[:, s:s + block] = part
        else:
            out[s:s + block] = part
    return out


def _generators(seed: int):
    """(hash, sketch) torch.Generators seeded from config.seed — the port's
    counterpart of splitting jax.random.PRNGKey(seed) in two."""
    seeds = [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
             for s in np.random.SeedSequence(seed).spawn(2)]
    return tuple(torch.Generator().manual_seed(s) for s in seeds)


def build_index(
    data,
    config: Config,
    metric: str = "angular",
    n_clusters: Optional[int] = None,
    hash_block: int = 8192,
    device="cuda",
    gmm_mesh=None,
) -> ClusteredIndex:
    """Build the clustered LSH index on `device` (reference:
    src/core/index.rs:177-289).

    1. GMM clustering (ops/gmm.py) on the normalized data; with `gmm_mesh`
       (parallel/mesh.Mesh) the points are split over its shards
       (parallel/gmm.py, bit-identical to the single-device clustering).
    2. Cluster bookkeeping: radii, brute-force flags (index.rs:204-205).
    3. One hashing pass over all points for the L tables.
    4. One sketching pass.
    5. Per-table segmented sort, prefix directory, global tables, in
       blocks of tables (prefixmap.table_blocks); every block size builds
       the same index, bit for bit.
    """
    if isinstance(data, torch.Tensor):
        x = data
    else:
        x = np.asarray(data, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        raise DataError("empty or non-2D dataset")
    n, d = x.shape
    if n_clusters is None:
        n_clusters = config.num_clusters(n)
    log.info("build: n=%d d=%d clusters=%d L=%d", n, d, n_clusters, config.num_tables)
    if metric != "angular":
        raise IndexCreationError(
            f"the clustered index supports the angular metric (got {metric!r}); "
            "euclidean data is brute-force only, as in the reference"
        )
    xn = l2_normalize(as_device_f32(x, device))

    from clann_tpu_torch.metrics.trace import TRACER

    with TRACER.span("build/gmm", block_on=xn):
        if gmm_mesh is not None:
            from clann_tpu_torch.parallel.gmm import sharded_gmm

            centers_idx, assignment, radii = sharded_gmm(
                xn, n_clusters, mesh=gmm_mesh, metric=metric, assume_normalized=True)
        else:
            centers_idx, assignment, radii = greedy_minimum_maximum(
                xn, n_clusters, metric, assume_normalized=True
            )

    g_hash, g_sketch = _generators(config.seed)
    family = make_hash_family(
        config.hash_family, d,
        num_rotations=config.num_rotations,
        estimation_repetitions=config.estimation_repetitions,
        estimation_eps=config.estimation_eps,
    )
    source = make_hash_source(
        config.hash_source, family, config.num_tables, config.max_hashbits,
        pool_size=config.pool_size,
    ).init(g_hash, xn.device)
    filterer = SketchFilterer(d, config.num_sketches, config.sketch_bits).init(
        g_sketch, xn.device)
    # (reference timer nodes Hashing/Sketching, performance.hpp:15-27)
    with TRACER.span("build/hashing", block_on=xn.device):
        hashes_T = _hash_in_blocks(source.hash, xn, hash_block, transpose=True)  # (L, n)
    with TRACER.span("build/sketching", block_on=xn.device):
        sketches = _hash_in_blocks(filterer.sketch, xn, hash_block)

    # one host sync for the integer bookkeeping
    return _assemble_index(
        xn, hashes_T, sketches, assignment.cpu().numpy(),
        centers_idx.cpu().numpy(), radii, config, metric,
        hash_params=source.params, sketch_params=filterer.params, family=family,
    )


def _assemble_index(xn, hashes_T, sketches, assignment: np.ndarray,
                    centers_idx: np.ndarray, radii, config: Config, metric: str,
                    *, hash_params, sketch_params, family=None) -> ClusteredIndex:
    """Steps 5+ of the build: sorts, directories, derived layouts, from
    hashes_T (L, n) int32, sketches (n, S, W) and the cluster geometry."""
    from clann_tpu_torch.metrics.trace import TRACER

    dev = xn.device
    n = xn.shape[0]
    n_clusters = len(centers_idx)
    sizes = np.bincount(assignment, minlength=n_clusters)
    starts = np.zeros(n_clusters + 1, dtype=np.int32)
    np.cumsum(sizes, out=starts[1:])
    brute = sizes < max(config.brute_force_threshold, config.k)
    assign_t = torch.as_tensor(assignment.astype(np.int32), device=dev)

    # 5. per-table segmented sort
    with TRACER.span("build/table_sort", block_on=dev):
        sorted_hash, sorted_idx = sort_tables_segmented(hashes_T, assign_t)

    # 5b. per-(table, cluster) prefix directory
    max_seg = int(sizes.max()) if len(sizes) else 0
    with TRACER.span("build/prefix_dir", block_on=dev):
        prefix_dir, dir_bits, dir_iters = derive_prefix_directory(
            sorted_hash, starts, config, max_seg)

    # 5c. global LSH structures (ball-filtered global engine)
    g_sorted_hash = g_records = g_dir = None
    g_dir_iters = 0
    if config.lsh_engine in ("global", "both"):
        with TRACER.span("build/global_tables", block_on=dev):
            g_sorted_hash, g_records = make_global_tables(
                hashes_T, sketches, assign_t, pad_to=config.gather_block)
            g_dir = build_prefix_directory(
                g_sorted_hash, torch.as_tensor(np.asarray([0, n], np.int32)),
                config.global_dir_bits, _iters(n), config.max_hashbits,
            )
            g_dir_iters = _iters(int(torch.max(g_dir[:, :, 1:] - g_dir[:, :, :-1])))

    # 5d. dense IVF layout, rows in the order of table 0's segments
    cid = torch.as_tensor(centers_idx.astype(np.int64), device=dev)
    dense = {}
    if config.dense_layout:
        with TRACER.span("build/dense_layout", block_on=dev):
            dense = build_dense_layout(xn, sorted_idx[0], starts, xn[cid], radii,
                                       config.dense_seg_cap)

    if family is None:
        family = make_hash_family(
            config.hash_family, xn.shape[1],
            num_rotations=config.num_rotations,
            estimation_repetitions=config.estimation_repetitions,
            estimation_eps=config.estimation_eps,
        )
    with TRACER.span("build/probs_tables"):  # host numpy (cached on disk)
        probs, maxdiff = derive_probs_tables(family, config)

    return ClusteredIndex(
        vectors=xn,
        cluster_starts=torch.as_tensor(starts, device=dev),
        centers=xn[cid],
        center_ids=cid.to(torch.int32),
        radii=as_device_f32(radii, dev),
        brute=torch.as_tensor(brute, device=dev),
        assignment=assign_t,
        sorted_hash=sorted_hash,
        sorted_idx=sorted_idx,
        sketches=sketches,
        hash_params=hash_params,
        sketch_params=sketch_params,
        probs_table=torch.as_tensor(probs.table, device=dev),
        maxdiff_table=torch.as_tensor(maxdiff, device=dev),
        slot_records=(
            make_slot_records(sorted_idx, sketches, pad_to=config.gather_block)
            if config.pack_slot_records and config.lsh_engine in ("clustered", "both")
            else None
        ),
        prefix_dir=prefix_dir,
        g_sorted_hash=g_sorted_hash,
        g_records=g_records,
        g_dir=g_dir,
        vectors_q8=rescore_shadow(xn, config),
        **dense,
        config=config,
        metric=metric,
        sim_eps=probs.sim_eps,
        max_seg_len=max_seg,
        dir_bits=dir_bits,
        dir_iters=dir_iters,
        g_dir_iters=g_dir_iters,
    )


def insert(index: ClusteredIndex, points) -> ClusteredIndex:
    """Append points to the index's dataset; searchable through the tables
    after `rebuild` (Index::insert, collection.hpp:218-222, appends to the
    dataset only).

    The clustered geometry absorbs them too, as in JAX: each new point
    joins its nearest center (an f32 product, the first minimum on ties)
    and that cluster's radius grows to cover it, so the ball bounds stay
    valid without re-clustering (C = 1 is the reference's flat insert).
    Centers never move. Until `rebuild` the new points are pending
    (`num_pending`): in `vectors` (and `vectors_q8`) for the dense scans,
    not in the tables or the dense IVF layout. The returned index has
    caches of its own; `index` is left as it was, less its captured loop
    bodies (`body_graphs`), which it captures again if searched.
    """
    if isinstance(points, torch.Tensor):
        x = points.to(torch.float32)
    else:
        x = np.asarray(points, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[0] == 0:
        raise DataError("insert needs a non-empty (p, d) array")
    if x.shape[1] != index.dims:
        raise DataError(f"point dimension {x.shape[1]} != index dimension {index.dims}")
    if index.metric != "angular":
        raise IndexCreationError("insert supports the angular metric")
    xn_new = l2_normalize(as_device_f32(x, index.device))

    # nearest existing center, and the ball grown to cover the point
    cdist = torch.clamp(1.0 - exact_dot(xn_new, index.centers.T), 0.0, 2.0)
    dist_new, assign_new = torch.min(cdist, dim=1)
    radii = index.radii.clone().scatter_reduce_(0, assign_new, dist_new, "amax",
                                                include_self=True)
    index.body_graphs = None
    return dataclasses.replace(
        index,
        vectors=torch.cat([index.vectors, xn_new]),
        vectors_q8=(None if index.vectors_q8 is None
                    else torch.cat([index.vectors_q8, quantize_q8(xn_new)])),
        assignment=torch.cat([index.assignment, assign_new.to(torch.int32)]),
        radii=radii,
        n_indexed=index.num_indexed,
        pallas_base_cache={}, block_layout_cache={},
    )


def rebuild(index: ClusteredIndex, hash_block: int = 8192) -> ClusteredIndex:
    """Index the pending points (Index::rebuild, collection.hpp:241-306).

    Only the pending rows are hashed and sketched, with the index's stored
    functions, so the older points keep their exact hashes; the sorts and
    every derived layout then cover all points, as the reference rebuilds
    every PrefixMap (prefixmap.hpp:169-247). Where there are pending points,
    `index` drops its captured loop bodies, as `insert` does.
    """
    n, n_idx = index.n, index.num_indexed
    if n_idx >= n:
        return index
    source, filterer = index.rebuild_objects()
    new_x = index.vectors[n_idx:]
    # the old points' hashes unsorted into the first n_idx columns, the
    # pending points' written after them
    hashes_T = unsort_hashes(index.sorted_hash, index.sorted_idx, n=n)
    hashes_T[:, n_idx:] = _hash_in_blocks(source.hash, new_x, hash_block, transpose=True)
    sk_new = _hash_in_blocks(filterer.sketch, new_x, hash_block)
    index.body_graphs = None
    return _assemble_index(
        index.vectors, hashes_T,
        torch.cat([index.sketches, sk_new]), index.assignment.cpu().numpy(),
        index.center_ids.cpu().numpy(), index.radii, index.config, index.metric,
        hash_params=index.hash_params, sketch_params=index.sketch_params,
    )


def build_lsh_index(data, config: Config, metric: str = "angular",
                    device="cuda") -> ClusteredIndex:
    """The single-cluster index, a plain PUFFINN LSH index (the reference's
    standalone PuffinnIndex, src/puffinn_binds/puffinn.rs): the C = 1 case
    of the clustered layout, one segment spanning every table."""
    return build_index(data, config, metric=metric, n_clusters=1, device=device)


def _as_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array (JAX's uint32 words included) as a `dtype` tensor with
    the same bits for 32-bit integer words."""
    a = np.asarray(a)
    if dtype == torch.int32 and a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device).to(dtype)


def _param_dtype(name: str):
    if name not in PARAM_DTYPES:
        raise DataError(f"unknown hash parameter {name!r}")
    return np.dtype(PARAM_DTYPES[name])


def _params(p, device):
    """Parameter dict (numpy arrays of either package) -> tensors: integer
    leaves int32 (uint32 words as bit patterns), float leaves float32."""
    if p is None:
        return None
    return {k: _as_tensor(v, torch.int32 if _param_dtype(k).kind in "iu" else torch.float32,
                          device) for k, v in dict(p).items()}


def host_array(t, dtype=None) -> np.ndarray:
    """A tensor (or array) as numpy, in `dtype` if given: int32 words are
    viewed as uint32 with the same bits (the JAX package's words)."""
    a = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
    if dtype is None:
        return a
    if np.dtype(dtype) == np.uint32 and a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(dtype, copy=False)


def params_numpy(p) -> Optional[Dict[str, np.ndarray]]:
    """Parameter dict (tensors or arrays) -> numpy arrays in the JAX
    package's dtypes (PARAM_DTYPES), keys sorted (the order JAX flattens a
    dict in)."""
    if p is None:
        return None
    return {k: host_array(p[k], _param_dtype(k)) for k in sorted(p)}


def index_from_arrays(arrays: Dict[str, Any], config: Config, device="cuda",
                      metric: str = "angular") -> ClusteredIndex:
    """A ClusteredIndex on `device` from numpy arrays.

    `arrays` holds GEOMETRY_FIELDS and, optionally, any of LSH_FIELDS,
    DENSE_FIELDS, PARAM_FIELDS (dicts of numpy arrays; the per-cluster ones
    with a leading C axis) and the META_FIELDS scalars, e.g. taken whole
    from an index built by the JAX package (uint32 words are carried as
    int32 bit patterns), so both packages can search the same index.
    """
    missing = [f for f in GEOMETRY_FIELDS if f not in arrays]
    if missing:
        raise DataError(f"index arrays missing {missing}")
    geo_types = {"vectors": torch.float32, "cluster_starts": torch.int32,
                 "centers": torch.float32, "center_ids": torch.int32,
                 "radii": torch.float32, "brute": torch.bool, "assignment": torch.int32}
    kw = {f: _as_tensor(arrays[f], geo_types[f], device) for f in GEOMETRY_FIELDS}
    for f, dt in {**LSH_FIELDS, **DENSE_FIELDS}.items():
        if arrays.get(f) is not None:
            kw[f] = _as_tensor(arrays[f], dt, device)
    for f, default in META_FIELDS.items():
        kw[f] = type(default)(arrays.get(f, default))
    return ClusteredIndex(
        **kw,
        **{f: _params(arrays.get(f), device) for f in PARAM_FIELDS},
        config=config,
        metric=metric,
    )

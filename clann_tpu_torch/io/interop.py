"""Reference-format index interop (PyTorch port of ``clann_tpu.io.interop``).

Reads and writes the reference CLANN on-disk format (SURVEY.md §3.3): one
HDF5 file holding datasets "config" (serde JSON of the Rust Config,
src/core/index.rs:529-536), "clusters" (JSON Vec<ClusterCenter>,
index.rs:538-545) and one opaque PUFFINN byte stream per non-brute-force
cluster ("index_{id}", libpuffinn-ffi/c_binder.cpp:106-146), through the
native codec (io/refcodec.py) for the binary streams.

Import semantics (the JAX package's): the reference samples independent
hash functions per cluster. The default import is bit-faithful: the
per-cluster tables, sketches, hash planes / FHT sign diagonals are taken
from the blobs as they are, and queries are hashed with each cluster's own
functions (ClusteredIndex.pc_hash_params / pc_sketch_params, which
ops/query.search consumes). The only arithmetic divergence from the
reference is f32 evaluation of the Q15 planes instead of its i16 mulhrs
dot (math.hpp:11-34), which can flip a hash bit only on rounding-edge
ties. `rebuild=True` re-hashes everything with shared functions (cluster
geometry and the delta guarantee kept; table bits not).

Export (`save_reference_h5`) emits reference-loadable files for the cosine
families: per-cluster streams with localized ids, Q15 vectors,
sentinel-padded sorted tables and valid prefix directories.

Every file function is a thin h5py wrapper around an in-memory half
(`_reference_datasets`, `_index_from_reference`), so everything but the
container runs where h5py is absent; h5py is imported only inside the
wrappers. The byte and format work is host numpy, as in JAX; only the
assembly of the device index is torch. The shared hash functions of a
faithful import (used only as `rebuild_objects` defaults) are the port's
own draws (torch.Generators seeded from config.seed).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.core.index import host_array as _host
from clann_tpu_torch.errors import SerializeError


def _require_h5py():
    import h5py

    return h5py


def _as_str(v) -> str:
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


def parse_reference_config(config_json: str) -> Config:
    """Map the Rust serde Config JSON into our Config."""
    d = json.loads(config_json)
    metrics = d.get("metrics_output", "None")
    if isinstance(metrics, dict):  # serde enum-as-object form
        metrics = next(iter(metrics.keys()), "None")
    return Config(
        num_tables=int(d.get("num_tables", 10)),
        num_clusters_factor=float(d.get("num_clusters_factor", 1.0)),
        k=int(d.get("k", 10)),
        delta=float(d.get("delta", 0.9)),
        dataset_name=str(d.get("dataset_name", "")),
        metrics_output="DB" if metrics == "DB" else "None",
        hash_family="simhash",
    )


#: codec source-kind tag (deserialize.hpp:10-23) -> our config name
SOURCE_NAMES = {0: "independent", 1: "pool", 2: "tensor"}


def _parse_blob(blob: bytes, first: Optional[str] = None):
    """Parse a blob, detecting the hash family.

    The stream carries no family tag (the family is a compile-time type in
    the reference, collection.hpp:90-113), so detection is structural: each
    family's layout is tried until one parses cleanly (the codec validates
    every section length, so a wrong family fails instead of mis-reading).
    `first`: the family to try first (the one found in an earlier blob of
    the file: a wrong layout can take the codec a second to refuse).

    Returns (parsed, family_name)."""
    from clann_tpu_torch.io.refcodec import (
        FAMILY_CROSS_POLYTOPE,
        FAMILY_FHT_CROSS_POLYTOPE,
        FAMILY_MINHASH,
        FAMILY_SIMHASH,
        parse_reference_stream,
    )

    candidates = [
        (FAMILY_SIMHASH, "simhash"),
        (FAMILY_FHT_CROSS_POLYTOPE, "fht_cross_polytope"),
        (FAMILY_CROSS_POLYTOPE, "cross_polytope"),
        (FAMILY_MINHASH, "minhash"),
    ]
    candidates.sort(key=lambda c: c[1] != first)
    last = None
    for fam, name in candidates:
        try:
            return parse_reference_stream(blob, family=fam), name
        except SerializeError as e:
            last = e
    raise SerializeError(
        f"stream matches no reference index layout (last error: {last})"
    )


def load_reference_h5(
    path: str,
    data=None,
    config: Optional[Config] = None,
    rebuild: bool = False,
    device="cuda",
):
    """Load a reference-written index file into a ClusteredIndex on `device`.

    `data` is the original dataset, as the reference's init_from_file
    requires (src/lib.rs:22). It may be omitted when every cluster has a
    PUFFINN blob: the Q15 vectors embedded in the blobs are then
    reassembled instead (brute-force clusters carry no blob, so their
    vectors only exist in the caller's dataset).

    Default: bit-faithful import (module docstring). `rebuild=True`
    re-hashes with shared functions instead.
    """
    h5py = _require_h5py()
    if not os.path.exists(path):
        raise SerializeError(f"index file {path} not found")
    with h5py.File(path, "r") as f:
        datasets = {"config": _as_str(f["config"][()]),
                    "clusters": _as_str(f["clusters"][()])}
        for c in json.loads(datasets["clusters"]):
            name = f"index_{c['idx']}"
            if name in f:
                datasets[name] = np.asarray(f[name], dtype=np.uint8).tobytes()
    return _index_from_reference(datasets, data, config, rebuild, device)


def _index_from_reference(datasets: Dict[str, object], data=None,
                          config: Optional[Config] = None, rebuild: bool = False,
                          device="cuda"):
    """load_reference_h5 on the file's datasets in memory: {"config": JSON,
    "clusters": JSON, "index_{i}": bytes of each non-brute cluster}."""
    from clann_tpu_torch.core.index import build_index
    from clann_tpu_torch.ops.distances import resolve_device

    dev = resolve_device(device)
    clusters = sorted(json.loads(_as_str(datasets["clusters"])), key=lambda c: c["idx"])
    cfg = config or parse_reference_config(_as_str(datasets["config"]))
    total = sum(len(c.get("assignment", [])) for c in clusters)
    if total == 0:
        raise SerializeError(
            "reference file has no assignment lists; cannot reconstruct "
            "cluster geometry"
        )

    parsed_blobs = {}
    family_name = None
    for c in clusters:
        blob = datasets.get(f"index_{c['idx']}")
        if blob is not None:
            parsed, fam = _parse_blob(blob, first=family_name)
            parsed_blobs[c["idx"]] = parsed
            if family_name is None:
                family_name = fam
            elif family_name != fam:
                raise SerializeError("mixed hash families across clusters")
    if family_name == "minhash":
        raise SerializeError(
            "this file holds Index<JaccardSimilarity> blobs; use "
            "load_reference_jaccard"
        )

    vectors = _resolve_vectors(clusters, parsed_blobs, data, total)

    if rebuild:
        if family_name is not None:
            # rebuild with the file's detected family (the config JSON
            # carries no family field; FHT-CP is the reference default)
            cfg = dataclasses.replace(cfg, hash_family=family_name)
        return build_index(vectors, cfg, device=dev)
    return _load_faithful(clusters, parsed_blobs, cfg, vectors, family_name, dev)


def _resolve_vectors(clusters, parsed_blobs, data, total) -> np.ndarray:
    """Caller-supplied dataset, or Q15 vectors reassembled from blobs."""
    if data is not None:
        x = _host(data, np.float32)
        if x.shape[0] != total:
            raise SerializeError(
                f"dataset has {x.shape[0]} points but the index file lists "
                f"{total} (reference contract, src/lib.rs:22)"
            )
        blob_dims = next((p.dims for p in parsed_blobs.values()), None)
        if blob_dims is not None and x.shape[1] != blob_dims:
            raise SerializeError(
                f"dataset has {x.shape[1]} dimensions but the index was "
                f"built on {blob_dims}"
            )
        return x
    dims = None
    vectors = None
    for c in clusters:
        assignment = c.get("assignment", [])
        parsed = parsed_blobs.get(c["idx"])
        if parsed is None:
            continue
        if dims is None:
            dims = parsed.dims
            vectors = np.zeros((total, dims), np.float32)
        v = parsed.vectors[:, :dims]
        if len(assignment) != v.shape[0]:
            raise SerializeError(
                f"cluster {c['idx']}: blob has {v.shape[0]} vectors but "
                f"assignment lists {len(assignment)}"
            )
        vectors[np.asarray(assignment, dtype=np.int64)] = v
    if vectors is None:
        raise SerializeError(
            "no PUFFINN blobs found (all clusters brute-force?); "
            "reference files without blobs carry no vector data"
        )
    missing = np.where(~vectors.any(axis=1))[0]
    if len(missing):
        raise SerializeError(
            f"{len(missing)} points belong to brute-force clusters whose "
            "vectors are not stored in the reference file; supply the "
            "original dataset instead"
        )
    return vectors


def _load_faithful(clusters, parsed_blobs, cfg: Config, vectors, family_name, dev):
    """Assemble a ClusteredIndex on `dev` directly from reference blobs.

    Tables, sketches and hash functions are taken bit for bit from the
    file; queries are hashed with each cluster's own functions
    (pc_hash_params / pc_sketch_params, consumed by ops/query.search).
    """
    from clann_tpu_torch.core.index import (
        ClusteredIndex,
        _generators,
        build_dense_layout,
        derive_prefix_directory,
        derive_probs_tables,
        make_slot_records,
        rescore_shadow,
    )
    from clann_tpu_torch.io.refcodec import q15_to_f32
    from clann_tpu_torch.ops.distances import l2_normalize
    from clann_tpu_torch.ops.hashing import make_hash_family
    from clann_tpu_torch.ops.sketches import SketchFilterer
    from clann_tpu_torch.ops.sources import make_hash_source

    if family_name is None:
        raise SerializeError("faithful import needs at least one PUFFINN blob")
    first = next(iter(parsed_blobs.values()))
    source_name = SOURCE_NAMES.get(first.source_kind)
    if source_name is None:
        raise SerializeError(
            f"unknown hash-source tag {first.source_kind} "
            "(deserialize.hpp:10-23 knows independent/pool/tensor)"
        )
    # table hash width comes from the stream, per source layout
    if source_name == "independent":
        num_bits = first.functions_per_hasher * first.bits_per_function - first.bits_to_cut
    elif source_name == "pool":
        num_bits = first.pool_bits_per_hasher
    else:  # tensor
        num_bits = first.tens_num_bits
    # faithful mode is inherently clustered (each cluster has its own
    # functions; global hash-sorted tables need one shared set)
    cfg = dataclasses.replace(
        cfg, hash_family=family_name, hash_source=source_name,
        max_hashbits=int(num_bits), lsh_engine="clustered",
    )
    if first.est_eps:
        cfg = dataclasses.replace(
            cfg, estimation_eps=float(first.est_eps),
            estimation_repetitions=int(first.est_reps) or cfg.estimation_repetitions,
        )

    C = len(clusters)
    n, d = vectors.shape
    L = cfg.num_tables

    members_per = [np.asarray(c.get("assignment", []), np.int64) for c in clusters]
    sizes = np.asarray([len(m) for m in members_per], np.int64)
    starts = np.zeros(C + 1, np.int32)
    starts[1:] = np.cumsum(sizes).astype(np.int32)
    assignment = np.zeros(n, np.int32)
    for c, m in enumerate(members_per):
        assignment[m] = c

    sorted_hash = np.zeros((L, n), np.uint32)
    sorted_idx = np.zeros((L, n), np.int32)
    sketches64 = np.zeros((n, cfg.num_sketches), np.uint64)
    for c, cj in enumerate(clusters):
        lo, hi = int(starts[c]), int(starts[c + 1])
        members = members_per[c]
        parsed = parsed_blobs.get(cj["idx"])
        if parsed is None:
            # brute cluster: no tables; slots in member order with zero
            # hashes (never consulted: is_brute short-circuits)
            sorted_idx[:, lo:hi] = members
            continue
        if len(parsed.map_hashes) != L:
            raise SerializeError(
                f"cluster {cj['idx']}: blob has {len(parsed.map_hashes)} "
                f"tables, config says {L}"
            )
        for t, mh in enumerate(parsed.map_hashes):
            if len(mh) != hi - lo:
                raise SerializeError(
                    f"cluster {cj['idx']} table {t}: {len(mh)} entries for "
                    f"{hi - lo} points"
                )
        sorted_hash[:, lo:hi] = np.stack(parsed.map_hashes)
        sorted_idx[:, lo:hi] = members[np.stack(parsed.map_indices)]
        if parsed.sketches is not None:
            sketches64[members] = parsed.sketches

    # u64 -> (S, 2) 32-bit words, MSB word first (ops/sketches.py pack order)
    sketches = np.stack([(sketches64 >> np.uint64(32)).astype(np.uint32),
                         (sketches64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=2)

    # per-cluster function parameters (zeros for brute clusters)
    def stack_params(get_rows, shape):
        out = np.zeros((C,) + shape, np.float32)
        for c, cj in enumerate(clusters):
            parsed = parsed_blobs.get(cj["idx"])
            if parsed is not None:
                out[c] = get_rows(parsed)
        return out

    sk_f = first.sketch_planes.shape[0]
    pc_sketch_params = {
        "dirs": stack_params(lambda p: q15_to_f32(p.sketch_planes[:, :d]), (sk_f, d))
    }
    if family_name == "simhash":
        hash_f = first.hash_planes.shape[0]
        pc_hash_params = {
            "dirs": stack_params(lambda p: q15_to_f32(p.hash_planes[:, :d]), (hash_f, d))
        }
    elif family_name == "fht_cross_polytope":
        # FHT cross-polytope: +-1 sign diagonals per function
        pc_hash_params = {
            "signs": stack_params(lambda p: p.fht_signs.astype(np.float32),
                                  first.fht_signs.shape)
        }
    else:
        # vanilla cross-polytope: explicit Q15 rotation matrices, stored
        # row-major (axis, padded-coord) (crosspolytope.hpp:336-354); the
        # family consumes (F, d, axes) columns (ops/hashing.py)
        hash_f = first.cp_matrices.shape[0]
        axes = 1
        while axes < d:
            axes <<= 1

        def cp_rot(p):
            m = q15_to_f32(p.cp_matrices.reshape(hash_f, axes, -1)[:, :, :d])
            return np.transpose(m, (0, 2, 1))  # (F, d, axes)

        pc_hash_params = {"rot": stack_params(cp_rot, (hash_f, d, axes))}
    if source_name == "pool":
        # per-table pool sampling indices (pool.hpp:44-55) ride along in
        # the params dict; PooledHashSource reads them
        pool_idx = np.zeros((C, L, len(first.pool_indices[0])), np.int32)
        for c, cj in enumerate(clusters):
            parsed = parsed_blobs.get(cj["idx"])
            if parsed is not None:
                pool_idx[c] = np.stack(parsed.pool_indices).astype(np.int32)
        pc_hash_params["pool_indices"] = pool_idx

    if family_name == "fht_cross_polytope" and first.num_rotations:
        cfg = dataclasses.replace(cfg, num_rotations=int(first.num_rotations))
    family = make_hash_family(
        family_name, d, num_rotations=cfg.num_rotations,
        estimation_repetitions=cfg.estimation_repetitions,
        estimation_eps=cfg.estimation_eps,
    )
    if first.estimates is not None and family_name != "simhash":
        # the stream's own Monte-Carlo collision table
        # (CrossPolytopeCollisionEstimates, crosspolytope.hpp:10-119), used
        # verbatim instead of re-estimating
        family._estimates = np.asarray(first.estimates, np.float32)
    # shared params: the port's own draws, only rebuild_objects defaults
    # (queries are hashed with the per-cluster params)
    g_hash, g_sketch = _generators(cfg.seed)
    source = make_hash_source(cfg.hash_source, family, L, cfg.max_hashbits,
                              pool_size=cfg.pool_size).init(g_hash, dev)
    filterer = SketchFilterer(d, cfg.num_sketches, cfg.sketch_bits).init(g_sketch, dev)
    probs, maxdiff = derive_probs_tables(family, cfg)

    xn = l2_normalize(torch.as_tensor(vectors, dtype=torch.float32, device=dev))
    sorted_hash_dev = torch.as_tensor(sorted_hash.view(np.int32), device=dev)
    sorted_idx_dev = torch.as_tensor(sorted_idx, device=dev)
    sketches_dev = torch.as_tensor(sketches.view(np.int32), device=dev)
    max_seg = int(sizes.max()) if len(sizes) else 0
    prefix_dir, dir_bits, dir_iters = derive_prefix_directory(
        sorted_hash_dev, starts, cfg, max_seg)

    radii = np.asarray([float(c.get("radius", 0.0)) for c in clusters], np.float32)
    center_ids = np.asarray([int(c.get("center_idx", 0)) for c in clusters], np.int32)
    brute = np.asarray([bool(c.get("brute_force", False)) or c["idx"] not in parsed_blobs
                        for c in clusters])
    cid = torch.as_tensor(center_ids.astype(np.int64), device=dev)
    dense = (build_dense_layout(xn, sorted_idx_dev[0], starts, xn[cid], radii,
                                cfg.dense_seg_cap)
             if cfg.dense_layout else {})

    def to_dev(p):
        return {k: torch.as_tensor(v, device=dev) for k, v in p.items()}

    return ClusteredIndex(
        vectors=xn,
        vectors_q8=rescore_shadow(xn, cfg),
        sorted_hash=sorted_hash_dev,
        sorted_idx=sorted_idx_dev,
        sketches=sketches_dev,
        slot_records=(make_slot_records(sorted_idx_dev, sketches_dev, pad_to=cfg.gather_block)
                      if cfg.pack_slot_records else None),
        prefix_dir=prefix_dir,
        pc_hash_params=to_dev(pc_hash_params),
        pc_sketch_params=to_dev(pc_sketch_params),
        cluster_starts=torch.as_tensor(starts, device=dev),
        centers=xn[cid],
        center_ids=cid.to(torch.int32),
        radii=torch.as_tensor(radii, device=dev),
        brute=torch.as_tensor(brute, device=dev),
        assignment=torch.as_tensor(assignment, device=dev),
        hash_params=source.params,
        sketch_params=filterer.params,
        probs_table=torch.as_tensor(probs.table, device=dev),
        maxdiff_table=torch.as_tensor(maxdiff, device=dev),
        **dense,
        config=cfg,
        metric="angular",
        sim_eps=probs.sim_eps,
        max_seg_len=max_seg,
        dir_bits=dir_bits,
        dir_iters=dir_iters,
    )


def _mh_params_from_parsed(tabs, perms):
    """Reference MinHash function arrays -> TabulationMinHash params (numpy,
    uint32 words).

    tabs: (F, 1024) u64 in stream order t1|t2|t3|t4 (minhash.hpp:34-38);
    perms: per-function u32 arrays (all the same length)."""
    tab = np.asarray(tabs, np.uint64).reshape(-1, 4, 256)
    lens = {len(p) for p in perms}
    if len(lens) != 1:
        raise SerializeError(f"MinHash permutations have mixed lengths {sorted(lens)}")
    return {
        "tab_hi": (tab >> np.uint64(32)).astype(np.uint32),
        "tab_lo": (tab & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        "perm": np.stack(perms).astype(np.uint32),
    }


def _mh_params_to_stream_arrays(params, rand_bits: int):
    """Inverse of _mh_params_from_parsed (+ per-function perm_bits)."""
    hi = _host(params["tab_hi"], np.uint32).astype(np.uint64)
    lo = _host(params["tab_lo"], np.uint32).astype(np.uint64)
    tabs = ((hi << np.uint64(32)) | lo).reshape(hi.shape[0], 1024)
    perm = _host(params["perm"], np.uint32)
    return (
        tabs,
        np.full((hi.shape[0],), rand_bits, np.uint32),
        [perm[f] for f in range(perm.shape[0])],
    )


def jaccard_index_from_parsed(parsed, config: Optional[Config] = None, device="cuda"):
    """Assemble a searchable JaccardIndex on `device` from a parsed MinHash
    stream.

    Tables, sketches, tabulation-hash tables and bit permutations are taken
    bit for bit from the stream (minhash.hpp:11-127); queries hash with the
    TabulationMinHash families, so candidate generation matches the
    reference engine exactly (the delta stop rule stays depth-granular).
    """
    from clann_tpu_torch.core.index import _params
    from clann_tpu_torch.core.jaccard import (
        JaccardIndex,
        _pack_jaccard_records,
        jaccard_probs_tables,
    )
    from clann_tpu_torch.data.setdata import pad_sets
    from clann_tpu_torch.ops.distances import resolve_device
    from clann_tpu_torch.ops.minhash import TabulationMinHash, TabulationMinHash1Bit

    dev = resolve_device(device)
    if parsed.source_kind != 0:
        raise SerializeError(
            "jaccard import supports the independent hash source (the only "
            "one the reference FFI instantiates, c_binder.cpp:39-50)"
        )
    universe = int(parsed.dims)
    n = len(parsed.set_lens)
    L = len(parsed.map_hashes)
    num_bits = parsed.functions_per_hasher * parsed.bits_per_function - parsed.bits_to_cut
    cfg = config or Config(num_tables=L, k=10, delta=0.9, dataset_name="jaccard_import")
    cfg = dataclasses.replace(
        cfg, num_tables=L, max_hashbits=int(num_bits),
        num_sketches=len(parsed.sketches[0]) if n else 32, sketch_bits=64,
    )

    tokens = pad_sets(parsed.sets(), universe)
    sorted_hash = np.stack(parsed.map_hashes).astype(np.uint32)
    sorted_idx = np.stack(parsed.map_indices).astype(np.int32)
    sk64 = np.asarray(parsed.sketches, np.uint64)  # (n, S)
    sketches = np.stack([(sk64 >> np.uint64(32)).astype(np.uint32),
                         (sk64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=2)

    probs, maxdiff = jaccard_probs_tables(TabulationMinHash(universe),
                                          TabulationMinHash1Bit(universe), cfg)
    tokens_dev = torch.as_tensor(tokens, device=dev)
    sorted_idx_dev = torch.as_tensor(sorted_idx, device=dev)
    sketches_dev = torch.as_tensor(sketches.view(np.int32), device=dev)
    return JaccardIndex(
        tokens=tokens_dev,
        set_sizes=(tokens_dev >= 0).sum(dim=1).to(torch.int32),
        sorted_hash=torch.as_tensor(sorted_hash.view(np.int32), device=dev),
        sorted_idx=sorted_idx_dev,
        sketches=sketches_dev,
        g_records=_pack_jaccard_records(sorted_idx_dev, sketches_dev, None,
                                        pad_to=max(1, cfg.gather_block)),
        hash_params=_params(_mh_params_from_parsed(parsed.mh_tabs, parsed.mh_perms), dev),
        sketch_params=_params(_mh_params_from_parsed(parsed.sk_mh_tabs, parsed.sk_mh_perms),
                              dev),
        probs_table=torch.as_tensor(probs.table, device=dev),
        sketch_p1_table=torch.as_tensor(maxdiff, device=dev),
        config=cfg,
        universe=universe,
        sim_eps=probs.sim_eps,
        table_hash="tabulation_minhash",
        sketch_hash="tabulation_1bit",
    )


def load_reference_jaccard(path: str, config: Optional[Config] = None, device="cuda"):
    """Load a reference Index<JaccardSimilarity> into a JaccardIndex.

    Accepts a raw serialized stream (collection.hpp:185) or an HDF5
    container holding the stream as an "index_{i}" byte dataset
    (c_binder.cpp:106-146 layout)."""
    from clann_tpu_torch.io.refcodec import FAMILY_MINHASH, parse_reference_stream

    if not os.path.exists(path):
        raise SerializeError(f"index file {path} not found")
    try:
        h5py = _require_h5py()
        with h5py.File(path, "r") as f:
            names = [k for k in f.keys() if k.startswith("index_")]
            if len(names) != 1:
                raise SerializeError(
                    f"expected one index_N dataset, found {names} (the "
                    "jaccard engine is flat, as the reference FFI's)"
                )
            blob = np.asarray(f[names[0]], dtype=np.uint8).tobytes()
    except OSError:
        with open(path, "rb") as f:
            blob = f.read()
    parsed = parse_reference_stream(blob, family=FAMILY_MINHASH)
    return jaccard_index_from_parsed(parsed, config, device=device)


def jaccard_to_reference_stream(index) -> bytes:
    """Serialize a JaccardIndex as a reference-loadable byte stream.

    Requires tabulation-form hash functions (build_jaccard_index with
    table_hash="tabulation_minhash"): the reference engine re-evaluates the
    serialized functions on queries, and the native murmur-mix families
    cannot be expressed as tabulation tables (ops/minhash.py docstring).
    """
    from clann_tpu_torch.io.refcodec import (
        FAMILY_MINHASH,
        ReferenceIndexData,
        write_reference_stream_v2,
    )
    from clann_tpu_torch.ops.hashing import ceil_log2

    if index.table_hash != "tabulation_minhash":
        raise SerializeError(
            "reference export needs tabulation-form functions; build with "
            "table_hash='tabulation_minhash' "
            f"(this index uses {index.table_hash!r})"
        )
    cfg = index.config
    universe = index.universe
    tokens = _host(index.tokens)
    valid = tokens >= 0

    d = ReferenceIndexData()
    d.family = FAMILY_MINHASH
    d.source_kind = 0
    d.dims = universe
    d.storage_len = 1
    d.set_lens = valid.sum(axis=1).astype(np.uint64)
    d.set_tokens = tokens[valid].astype(np.uint32)
    sketches = _host(index.sketches, np.uint32)  # (n, S, 2)
    d.sketches = (sketches[:, :, 0].astype(np.uint64) << np.uint64(32)) | sketches[
        :, :, 1].astype(np.uint64)

    # MinHashArgs randomized_bits: recovered from the perm length where it
    # is unambiguous, else the family default 4 (minhash.hpp:139-143)
    def rand_bits_of(params):
        p = params["perm"].shape[1]
        return int(np.round(np.log2(p))) if p < universe else 4

    rb = rand_bits_of(index.hash_params)
    d.mh_tabs, d.mh_perm_bits, d.mh_perms = _mh_params_to_stream_arrays(index.hash_params, rb)
    d.mh_rand_bits = rb
    d.mh_set_size = max(universe, 2)
    srb = rand_bits_of(index.sketch_params)
    d.sk_mh_tabs, d.sk_mh_perm_bits, d.sk_mh_perms = _mh_params_to_stream_arrays(
        index.sketch_params, srb)
    d.sk_mh_rand_bits = srb
    d.sk_mh_set_size = max(universe, 2)

    bpf = ceil_log2(max(universe, 2))
    fph = (cfg.max_hashbits + bpf - 1) // bpf
    d.num_hashers = cfg.num_tables
    d.functions_per_hasher = fph
    d.bits_per_function = bpf
    d.bits_to_cut = bpf * fph - cfg.max_hashbits
    d.sketch_hashers = cfg.num_sketches
    d.sketch_fph = index.sketch_params["perm"].shape[0] // cfg.num_sketches
    d.sketch_bits_per_function = 1
    d.sketch_cut = 0

    sorted_hash = _host(index.sorted_hash, np.uint32)
    sorted_idx = _host(index.sorted_idx, np.uint32)
    d.map_hashes = [sorted_hash[t] for t in range(cfg.num_tables)]
    d.map_indices = [sorted_idx[t] for t in range(cfg.num_tables)]
    d.last_rebuild = tokens.shape[0]
    return write_reference_stream_v2(d)


def save_reference_jaccard(index, path: str) -> str:
    """Write a reference-loadable jaccard index (.h5 container layout)."""
    h5py = _require_h5py()
    buf = jaccard_to_reference_stream(index)
    with h5py.File(path, "w") as f:
        f.create_dataset("config", data=index.config.to_json())
        f.create_dataset("index_0", data=np.frombuffer(buf, dtype=np.uint8))
    return path


def save_reference_h5(index, path: str) -> str:
    """Write a reference-loadable .h5 (any cosine family x hash source)."""
    h5py = _require_h5py()
    datasets = _reference_datasets(index)
    with h5py.File(path, "w") as f:
        f.create_dataset("config", data=datasets.pop("config"))
        clusters = datasets.pop("clusters")
        for name, buf in datasets.items():
            f.create_dataset(name, data=np.frombuffer(buf, dtype=np.uint8))
        f.create_dataset("clusters", data=clusters)
    return path


def _reference_datasets(index) -> Dict[str, object]:
    """save_reference_h5's datasets in memory: {"config": JSON, "clusters":
    JSON, "index_{c}": the stream bytes of each non-brute cluster c}."""
    from clann_tpu_torch.core.index import params_numpy
    from clann_tpu_torch.io.refcodec import (
        f32_to_q15,
        write_reference_stream,
        write_reference_stream_fhtcp,
    )

    cfg = index.config
    if index.num_pending:
        raise SerializeError(
            "index has pending (un-rebuilt) insertions; call rebuild() "
            "before exporting to the reference format"
        )
    if cfg.hash_family not in ("simhash", "fht_cross_polytope", "cross_polytope"):
        raise SerializeError(
            f"reference export supports the cosine families (got {cfg.hash_family!r})"
        )
    if cfg.sketch_bits != 64:
        raise SerializeError(
            "the reference format stores 64-bit sketches "
            f"(typedefs.hpp:12-15); got sketch_bits={cfg.sketch_bits}"
        )
    starts = _host(index.cluster_starts)
    assignment = _host(index.assignment)
    brute = _host(index.brute)
    radii = _host(index.radii)
    center_ids = _host(index.center_ids)
    sorted_idx = _host(index.sorted_idx)
    sorted_hash = _host(index.sorted_hash, np.uint32)
    vectors = _host(index.vectors)
    sketches = _host(index.sketches, np.uint32)  # (n, S, W)
    # (n, S) u64: word 0 is the high half (ops/sketches.py pack order
    # matches the reference's accumulate-shift MSB-first order)
    sk64 = (sketches[:, :, 0].astype(np.uint64) << np.uint64(32)) | sketches[
        :, :, 1].astype(np.uint64)

    d = vectors.shape[1]
    storage_len = ((d + 15) // 16) * 16  # 16-value padding (generic.hpp:33-40)

    def to_q15_padded(mat):
        out = np.zeros((mat.shape[0], storage_len), np.int16)
        out[:, :d] = f32_to_q15(mat)
        return out

    # per-cluster function params when present (bit-faithful imports keep
    # each cluster's own functions: re-export them, not the shared set)
    per_cluster = index.pc_hash_params is not None
    hash_params = params_numpy(index.pc_hash_params if per_cluster else index.hash_params)
    sketch_dirs = params_numpy(index.pc_sketch_params if per_cluster
                               else index.sketch_params)["dirs"]

    def sketch_planes_for(c: int):
        return to_q15_padded(sketch_dirs[c] if per_cluster else sketch_dirs)

    def hash_param(c: int, name: str):
        return hash_params[name][c] if per_cluster else hash_params[name]

    is_cp = cfg.hash_family == "fht_cross_polytope"
    # the legacy golden-tested writers cover the two default-source
    # families; everything else (pool/tensor sources, vanilla CP) goes
    # through the general v2 writer
    use_v2 = cfg.hash_source != "independent" or cfg.hash_family == "cross_polytope"
    if is_cp or cfg.hash_family == "cross_polytope":
        from clann_tpu_torch.ops.collision import cross_polytope_estimates
        from clann_tpu_torch.ops.hashing import ceil_log2

        def signs_for(c: int):
            return hash_param(c, "signs").astype(np.int8)

        dp = signs_for(0).shape[2] if is_cp else hash_param(0, "rot").shape[2]
        estimates = cross_polytope_estimates(
            dp, cfg.estimation_repetitions, cfg.estimation_eps
        ).astype(np.float32)
        bpf = ceil_log2(d) + 1
        fph = (cfg.max_hashbits + bpf - 1) // bpf
        cut = bpf * fph - cfg.max_hashbits
    else:
        bpf = 1
        fph = cfg.max_hashbits
        cut = 0

    def v2_blob(c: int, members, map_indices, map_hashes) -> bytes:
        """Assemble and write one cluster stream through the v2 writer,
        with the field values reference-built streams carry."""
        from clann_tpu_torch.io.refcodec import (
            FAMILY_CROSS_POLYTOPE,
            FAMILY_FHT_CROSS_POLYTOPE,
            FAMILY_SIMHASH,
            SOURCE_INDEPENDENT,
            SOURCE_POOL,
            SOURCE_TENSOR,
            ReferenceIndexData,
            write_reference_stream_v2,
        )

        r = ReferenceIndexData()
        r.dims = d
        r.storage_len = storage_len
        r.vectors_q15 = to_q15_padded(vectors[members])
        r.sketches = sk64[members]
        r.sketch_planes = sketch_planes_for(c)
        r.sketch_hashers = cfg.num_sketches
        r.sketch_fph = r.sketch_planes.shape[0] // cfg.num_sketches
        r.sketch_bits_per_function = 1
        r.sketch_cut = 0
        r.map_indices = map_indices
        r.map_hashes = map_hashes
        r.last_rebuild = len(members)
        if cfg.hash_family == "simhash":
            r.family = FAMILY_SIMHASH
            r.hash_planes = to_q15_padded(hash_param(c, "dirs"))
            n_fns = r.hash_planes.shape[0]
        elif is_cp:
            r.family = FAMILY_FHT_CROSS_POLYTOPE
            r.fht_signs = signs_for(c)
            r.num_rotations = cfg.num_rotations
            n_fns = r.fht_signs.shape[0]
        else:
            r.family = FAMILY_CROSS_POLYTOPE
            # (F, d, axes) columns -> reference row-major (axis, storage)
            # Q15 matrices (crosspolytope.hpp:336-354)
            rot = hash_param(c, "rot")
            n_fns, _, axes = rot.shape
            m = np.zeros((n_fns, axes, storage_len), np.float32)
            m[:, :, :d] = np.transpose(rot, (0, 2, 1))
            r.cp_matrices = f32_to_q15(m.reshape(n_fns, -1)).reshape(n_fns, axes * storage_len)
        if cfg.hash_family != "simhash":
            r.estimates = estimates
            r.est_reps = cfg.estimation_repetitions
            r.est_eps = cfg.estimation_eps
        if cfg.hash_source == "pool":
            r.source_kind = SOURCE_POOL
            pool_idx = hash_param(c, "pool_indices")
            r.pool_indices = [pool_idx[t].astype(np.uint32) for t in range(pool_idx.shape[0])]
            r.pool_size = n_fns * bpf  # HashPoolArgs pool size in BITS
            r.pool_bits_per_hasher = cfg.max_hashbits
            r.pool_bits_per_function = bpf
            r.pool_sampling_rep = 0
            r.pool_bits_to_cut = bpf * pool_idx.shape[1] - cfg.max_hashbits
        elif cfg.hash_source == "tensor":
            r.source_kind = SOURCE_TENSOR
            src = index.rebuild_objects()[0]  # TensoredHashSource
            r.num_hashers = src.num_halves
            r.functions_per_hasher = src.fph
            r.bits_per_function = bpf
            r.bits_to_cut = src.bits_to_cut
            r.tens_num_hashers = cfg.num_tables
            r.tens_next_idx = 0
            r.tens_num_bits = cfg.max_hashbits
        else:
            r.source_kind = SOURCE_INDEPENDENT
            r.num_hashers = cfg.num_tables
            r.functions_per_hasher = fph
            r.bits_per_function = bpf
            r.bits_to_cut = cut
        return write_reference_stream_v2(r)

    # one O(n log n) pass gives every cluster's member list and each
    # point's position within its cluster
    order = np.argsort(assignment, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(index.n_clusters + 1))
    pos_in_cluster = np.empty(vectors.shape[0], np.int64)
    pos_in_cluster[order] = np.arange(vectors.shape[0]) - bounds[assignment[order]]

    out: Dict[str, object] = {"config": cfg.to_json(reference_only=True)}
    clusters_json = []
    for c in range(index.n_clusters):
        members = order[bounds[c] : bounds[c + 1]]
        clusters_json.append({
            "idx": int(c),
            "center_idx": int(center_ids[c]),
            "radius": float(radii[c]),
            "assignment": members.tolist(),
            "brute_force": bool(brute[c]),
            "memory_used": 0,
        })
        if brute[c]:
            continue
        lo, hi = int(starts[c]), int(starts[c + 1])
        map_indices = [pos_in_cluster[sorted_idx[t, lo:hi]].astype(np.uint32)
                       for t in range(sorted_hash.shape[0])]
        map_hashes = [sorted_hash[t, lo:hi] for t in range(sorted_hash.shape[0])]
        if use_v2:
            buf = v2_blob(c, members, map_indices, map_hashes)
        elif is_cp:
            buf = write_reference_stream_fhtcp(
                to_q15_padded(vectors[members]), d, sketch_planes_for(c), sk64[members],
                signs_for(c), estimates, cfg.estimation_repetitions, cfg.estimation_eps,
                num_hashers=cfg.num_tables, functions_per_hasher=fph, bits_to_cut=cut,
                map_indices=map_indices, map_hashes=map_hashes, last_rebuild=len(members),
            )
        else:
            buf = write_reference_stream(
                to_q15_padded(vectors[members]), d, sketch_planes_for(c), sk64[members],
                to_q15_padded(hash_param(c, "dirs")), num_hashers=cfg.num_tables,
                functions_per_hasher=cfg.max_hashbits, bits_to_cut=0,
                map_indices=map_indices, map_hashes=map_hashes, last_rebuild=len(members),
            )
        out[f"index_{c}"] = buf
    out["clusters"] = json.dumps(clusters_json)
    return out

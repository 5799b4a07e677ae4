"""HDF5 index serialization (PyTorch port of ``clann_tpu.io.h5``).

The native format of the JAX package, read and written without jax, so a
file written by either package loads in the other (reference persistence:
src/core/index.rs:511-557 serialize, index.rs:107-162 init_from_file):

- the file name index_{dataset}_k{factor:.2}_L{tables}.h5 (index.rs:519-525);
- top-level datasets "config" (JSON) and "clusters" (JSON cluster
  metadata), as the reference's;
- the index body as named numeric datasets under "tpu_index/" in the JAX
  package's dtypes: the port's int32 words (sorted_hash, sketches) are
  written and read as uint32 with the same bits, and every hash / sketch
  parameter leaf in its JAX dtype (core.index.PARAM_DTYPES), in sorted-key
  order, with the "keys" and "treedef" attributes of JAX's pytree writer;
- the caller supplies the same dataset on load (src/lib.rs:22): vectors
  are not stored. The dense layout, slot records and global tables are
  derived on load, as JAX derives them.

Per-cluster functions (a faithful reference import's) are not part of
the format, as in JAX. h5py is imported only inside the functions.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.core.index import (
    ClusteredIndex,
    _iters,
    _params,
    build_dense_layout,
    derive_prefix_directory,
    make_global_tables,
    make_slot_records,
    params_numpy,
    rescore_shadow,
    unsort_hashes,
)
from clann_tpu_torch.core.index import host_array as _host
from clann_tpu_torch.errors import SerializeError
from clann_tpu_torch.ops.distances import l2_normalize, resolve_device
from clann_tpu_torch.ops.prefixmap import build_prefix_directory

FORMAT_VERSION = 1

# "tpu_index/" datasets and their dtypes in the files of both packages
_INDEX_ARRAYS = {
    "sorted_hash": np.uint32,
    "sorted_idx": np.int32,
    "sketches": np.uint32,
    "cluster_starts": np.int32,
    "center_ids": np.int32,
    "radii": np.float32,
    "brute": np.bool_,
    "assignment": np.int32,
    "probs_table": np.float32,
    "maxdiff_table": np.int32,
}
# "tpu_jaccard_index/" datasets (and its "geometry/" group's) and dtypes
_JACCARD_ARRAYS = {
    "tokens": np.int32,
    "sorted_hash": np.uint32,
    "sorted_idx": np.int32,
    "sketches": np.uint32,
    "probs_table": np.float32,
    "sketch_p1_table": np.int32,
}
_JACCARD_GEOMETRY = {"center_ids": np.int32, "radii": np.float32, "assignment": np.int32}


def index_file_name(config: Config) -> str:
    """index_{dataset}_k{factor:.2}_L{tables}.h5 (reference: index.rs:519-525)."""
    return (
        f"index_{config.dataset_name or 'unknown'}"
        f"_k{config.num_clusters_factor:.2f}_L{config.num_tables}.h5"
    )


def _device(a: np.ndarray, device) -> torch.Tensor:
    """A file array as a tensor: uint32 words as int32 bit patterns."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _clusters_json(index) -> str:
    """Cluster metadata in the reference's ClusterCenter field shape
    (index.rs:27-35) minus the per-point assignment list, which is stored
    as a numeric dataset instead."""
    starts = _host(index.cluster_starts, np.int64)
    sizes = np.diff(starts)
    center_ids = _host(index.center_ids, np.int64)
    radii = _host(index.radii, np.float32)
    brute = _host(index.brute, np.bool_)
    return json.dumps([
        {
            "idx": int(i),
            "center_idx": int(center_ids[i]),
            "radius": float(radii[i]),
            "brute_force": bool(brute[i]),
            "num_points": int(sizes[i]),
            "memory_used": 0,
        }
        for i in range(index.n_clusters)
    ])


def save_index(index, path: str) -> str:
    """Write the index to `path` (a file or a directory); returns the file
    written (clann::serialize, src/lib.rs:255-264 -> index.rs:511-557)."""
    import h5py

    if os.path.isdir(path):
        path = os.path.join(path, index_file_name(index.config))
    try:
        with h5py.File(path, "w") as f:
            f.create_dataset("config", data=index.config.to_json())
            f.create_dataset("clusters", data=_clusters_json(index))
            g = f.create_group("tpu_index")
            g.attrs["format_version"] = FORMAT_VERSION
            g.attrs["metric"] = index.metric
            g.attrs["sim_eps"] = index.sim_eps
            # serialize before rebuild (collection_test.hpp:367-380): the
            # tables cover the first n_indexed points; the later rows of
            # the caller's dataset are pending until rebuild() after load
            g.attrs["n_indexed"] = index.num_indexed if index.num_pending else -1
            for name, dt in _INDEX_ARRAYS.items():
                g.create_dataset(name, data=_host(getattr(index, name), dt))
            _save_pytree(g.create_group("hash_params"), index.hash_params)
            _save_pytree(g.create_group("sketch_params"), index.sketch_params)
    except OSError as e:
        raise SerializeError(f"failed to write index to {path}: {e}") from e
    return path


def load_index(data, path: str, device="cuda"):
    """Load an index written by save_index (either package's) onto
    `device`, re-binding the caller's data (clann::init_from_file,
    src/lib.rs:41-47 -> index.rs:107-162): the caller must supply the same
    dataset the index was built on."""
    import h5py

    dev = resolve_device(device)
    if not os.path.exists(path):
        raise SerializeError(f"index file {path} not found")
    x = _host(data, np.float32)
    try:
        with h5py.File(path, "r") as f:
            config = Config.from_json(_as_str(f["config"][()]))
            g = f["tpu_index"]
            version = int(g.attrs["format_version"])
            if version != FORMAT_VERSION:
                raise SerializeError(f"index format version {version} != {FORMAT_VERSION}")
            metric = str(g.attrs["metric"])
            n_indexed = int(g.attrs.get("n_indexed", -1))
            arrays = {name: np.asarray(g[name]) for name in _INDEX_ARRAYS}
            hash_params = _load_pytree(g["hash_params"])
            sketch_params = _load_pytree(g["sketch_params"])
            sim_eps = float(g.attrs["sim_eps"])
    except (OSError, KeyError) as e:
        raise SerializeError(f"failed to read index from {path}: {e}") from e

    if x.shape[0] != arrays["assignment"].shape[0]:
        raise SerializeError(
            f"dataset has {x.shape[0]} points but index was built on "
            f"{arrays['assignment'].shape[0]}: the caller must supply the "
            "same dataset (reference contract, src/lib.rs:22)"
        )
    return _assemble_loaded(x, arrays, hash_params, sketch_params, config, metric,
                            sim_eps, n_indexed, dev)


def _assemble_loaded(x, arrays, hash_params, sketch_params, config: Config, metric: str,
                     sim_eps: float, n_indexed: int, dev):
    """The device index from a file's arrays and the caller's data: the
    stored tables as they are, the derived layouts (dense layout, slot
    records, global tables, prefix directories) made again as JAX's
    load_index makes them."""
    xt = torch.as_tensor(x, device=dev)
    xn = l2_normalize(xt) if metric == "angular" else xt
    t = {name: _device(a, dev) for name, a in arrays.items()}
    starts = arrays["cluster_starts"]
    max_seg = int(np.diff(starts).max()) if len(starts) > 1 else 0
    cid = t["center_ids"].to(torch.int64)

    dense = (build_dense_layout(xn, t["sorted_idx"][0], starts, xn[cid], arrays["radii"],
                                config.dense_seg_cap)
             if config.dense_layout else {})
    slot_records = (
        make_slot_records(t["sorted_idx"], t["sketches"], pad_to=config.gather_block)
        if config.pack_slot_records and config.lsh_engine in ("clustered", "both") else None)
    g_sorted_hash = g_records = g_dir = None
    g_dir_iters = 0
    if config.lsh_engine in ("global", "both"):
        hashes_T = unsort_hashes(t["sorted_hash"], t["sorted_idx"])
        g_sorted_hash, g_records = make_global_tables(
            hashes_T, t["sketches"], t["assignment"], pad_to=config.gather_block)
        n_tbl = hashes_T.shape[1]
        g_dir = build_prefix_directory(
            g_sorted_hash, torch.as_tensor(np.asarray([0, n_tbl], np.int32)),
            config.global_dir_bits, _iters(n_tbl), config.max_hashbits)
        g_dir_iters = _iters(int(torch.max(g_dir[:, :, 1:] - g_dir[:, :, :-1])))
    prefix_dir, dir_bits, dir_iters = derive_prefix_directory(
        t["sorted_hash"], starts, config, max_seg)
    return ClusteredIndex(
        vectors=xn,
        vectors_q8=rescore_shadow(xn, config),
        sorted_hash=t["sorted_hash"],
        sorted_idx=t["sorted_idx"],
        sketches=t["sketches"],
        slot_records=slot_records,
        prefix_dir=prefix_dir,
        g_sorted_hash=g_sorted_hash,
        g_records=g_records,
        g_dir=g_dir,
        cluster_starts=t["cluster_starts"],
        centers=xn[cid],
        center_ids=t["center_ids"],
        radii=t["radii"],
        brute=t["brute"],
        assignment=t["assignment"],
        hash_params=_params(hash_params, dev),
        sketch_params=_params(sketch_params, dev),
        probs_table=t["probs_table"],
        maxdiff_table=t["maxdiff_table"],
        **dense,
        config=config,
        metric=metric,
        sim_eps=sim_eps,
        max_seg_len=max_seg,
        dir_bits=dir_bits,
        dir_iters=dir_iters,
        g_dir_iters=g_dir_iters,
        n_indexed=n_indexed,
    )


def save_jaccard_index(index, path: str) -> str:
    """Write a core.jaccard.JaccardIndex to `path` (file or directory).

    The set index's counterpart of save_index. The file is self-contained:
    the token sets are the index's own storage, so loading needs no
    caller-supplied dataset.
    """
    import h5py

    if os.path.isdir(path):
        # "jaccard_" infix: the vector index of the same config would
        # otherwise get the same file name in a shared directory
        name = index_file_name(index.config)
        path = os.path.join(path, name.replace("index_", "index_jaccard_", 1))
    try:
        with h5py.File(path, "w") as f:
            f.create_dataset("config", data=index.config.to_json())
            g = f.create_group("tpu_jaccard_index")
            g.attrs["format_version"] = FORMAT_VERSION
            g.attrs["universe"] = index.universe
            g.attrs["sim_eps"] = index.sim_eps
            g.attrs["table_hash"] = index.table_hash
            g.attrs["sketch_hash"] = index.sketch_hash
            for name, dt in _JACCARD_ARRAYS.items():
                g.create_dataset(name, data=_host(getattr(index, name), dt))
            if index.center_ids is not None:
                geo = g.create_group("geometry")
                for name, dt in _JACCARD_GEOMETRY.items():
                    geo.create_dataset(name, data=_host(getattr(index, name), dt))
            _save_pytree(g.create_group("hash_params"), index.hash_params)
            _save_pytree(g.create_group("sketch_params"), index.sketch_params)
    except OSError as e:
        raise SerializeError(f"failed to write index to {path}: {e}") from e
    return path


def load_jaccard_index(path: str, device="cuda"):
    """Load a set index written by save_jaccard_index (self-contained)."""
    import h5py

    from clann_tpu_torch.core.jaccard import JaccardIndex, _pack_jaccard_records

    dev = resolve_device(device)
    if not os.path.exists(path):
        raise SerializeError(f"index file {path} not found")
    try:
        with h5py.File(path, "r") as f:
            config = Config.from_json(_as_str(f["config"][()]))
            g = f["tpu_jaccard_index"]
            version = int(g.attrs["format_version"])
            if version != FORMAT_VERSION:
                raise SerializeError(f"index format version {version} != {FORMAT_VERSION}")
            arrays = {name: _device(np.asarray(g[name]), dev) for name in _JACCARD_ARRAYS}
            geometry = {}
            if "geometry" in g:
                geometry = {name: _device(np.asarray(g["geometry"][name]), dev)
                            for name in _JACCARD_GEOMETRY}
            hash_params = _load_pytree(g["hash_params"])
            sketch_params = _load_pytree(g["sketch_params"])
            universe = int(g.attrs["universe"])
            sim_eps = float(g.attrs["sim_eps"])
            table_hash = str(g.attrs.get("table_hash", "minhash"))
            sketch_hash = str(g.attrs.get("sketch_hash", "1bit_minhash"))
    except (OSError, KeyError) as e:
        raise SerializeError(f"failed to read index from {path}: {e}") from e

    tokens = arrays["tokens"]
    return JaccardIndex(
        **arrays,
        **geometry,
        set_sizes=(tokens >= 0).sum(dim=1).to(torch.int32),
        # the packed query records are derived, not stored
        g_records=_pack_jaccard_records(arrays["sorted_idx"], arrays["sketches"],
                                        geometry.get("assignment"),
                                        pad_to=max(1, config.gather_block)),
        hash_params=_params(hash_params, dev),
        sketch_params=_params(sketch_params, dev),
        config=config,
        universe=universe,
        sim_eps=sim_eps,
        table_hash=table_hash,
        sketch_hash=sketch_hash,
    )


def _as_str(v) -> str:
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


def _save_pytree(group, params) -> None:
    """A parameter dict as datasets leaf_0.. in sorted-key order (the order
    jax.tree_util flattens a dict in), each in its JAX dtype, with the
    "keys" and "treedef" attributes JAX's writer gives them."""
    leaves = params_numpy(params)
    group.attrs["treedef"] = "PyTreeDef({" + ", ".join(f"'{k}': *" for k in leaves) + "})"
    group.attrs["keys"] = json.dumps(list(leaves))
    for i, leaf in enumerate(leaves.values()):
        group.create_dataset(f"leaf_{i}", data=leaf)


def _load_pytree(group) -> dict:
    """Inverse of _save_pytree (and of JAX's): a dict of numpy leaves."""
    leaves = [np.asarray(group[f"leaf_{i}"]) for i in range(len(group.keys()))]
    if "keys" in group.attrs:
        return dict(zip(json.loads(group.attrs["keys"]), leaves))
    if len(leaves) == 1:
        return {"dirs": leaves[0]}
    raise SerializeError("a parameter group without a keys attribute")

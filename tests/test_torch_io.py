"""The port's native HDF5 format (io/h5: save_index / load_index, the
Jaccard pair, Clann.serialize / from_file, init_from_file / serialize)
against the JAX package's, on the CPU.

A file written by either package loads in the other. JAX builds each index
and it is carried into the port whole (index_from_arrays,
jaccard_index_from_arrays), so both write the same index: their files hold
the same datasets with the same dtypes and attributes, and the indexes
loaded from them (by either package) search alike. The per-leaf dtype map
(core.index.PARAM_DTYPES) is checked on every hash and sketch family.
Tolerances: arrays exact (float32 tables within 1e-6 where the port makes
them itself), ids per query as sets up to boundary ties, distances within
1e-5.
"""

import json

import h5py
import jax
import numpy as np
import pytest
import torch

import clann_tpu
from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.core import jaccard as jjac
from clann_tpu.data.setdata import JaccardData as JData
from clann_tpu.data.synthetic import clustered_sets, make_synthetic_dataset
from clann_tpu.io import h5 as jh5
from clann_tpu.ops import hashing as jhashing
from clann_tpu.ops import minhash as jminhash
from clann_tpu.ops import sources as jsources
from clann_tpu.ops.sketches import SketchFilterer as JFilterer

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.core import jaccard as tjac
from clann_tpu_torch.errors import SerializeError
from clann_tpu_torch.io import h5 as th5
from clann_tpu_torch.testing import assert_topk_match, index_arrays, jaccard_index_arrays

torch.set_num_threads(1)

# the global engine's tables, the walk's slot records and the dense layout
# are all derived on load
CFG = dict(num_tables=6, num_clusters_factor=0.3, k=10, delta=0.9, seed=2,
           lsh_engine="both", dataset_name="io")
JAC_CFG = dict(num_tables=8, max_hashbits=12, k=5, delta=0.8, candidate_chunk=64,
               filter_expand=4, gather_block=8, seed=3, num_clusters_factor=0.5)


@pytest.fixture(scope="module")
def world():
    """(dataset, JAX index, the same index in the port)."""
    ds = make_synthetic_dataset(n=2000, d=16, n_queries=30, k_gt=10, seed=3)
    jidx = jindex.build_index(ds.train, JConfig(**CFG))
    tidx = tindex.index_from_arrays(index_arrays(jidx), TConfig(**CFG), device="cpu")
    return ds, jidx, tidx


@pytest.fixture(scope="module")
def files(world, tmp_path_factory):
    """(the JAX-written file, the port-written file) of one index."""
    _, jidx, tidx = world
    d = tmp_path_factory.mktemp("h5")
    return jh5.save_index(jidx, str(d / "jax.h5")), th5.save_index(tidx, str(d / "port.h5"))


def _walk(group, prefix=""):
    """{path: (kind, dtype, shape, value)} of every dataset and attribute."""
    out = {}
    for k, v in group.attrs.items():
        out[f"{prefix}@{k}"] = ("attr", None, None, v)
    for name, obj in group.items():
        path = f"{prefix}/{name}"
        if isinstance(obj, h5py.Group):
            out.update(_walk(obj, path))
        else:
            out[path] = ("data", obj.dtype, obj.shape, obj[()])
    return out


def test_files_hold_the_same_datasets_dtypes_and_attrs(files):
    with h5py.File(files[0]) as fj, h5py.File(files[1]) as ft:
        j, t = _walk(fj), _walk(ft)
    assert set(j) == set(t)
    for path, (kind, dtype, shape, value) in j.items():
        _, t_dtype, t_shape, t_value = t[path]
        assert (dtype, shape) == (t_dtype, t_shape), path
        if path in ("/config", "/clusters"):
            assert json.loads(value) == json.loads(t_value), path
        elif kind == "data":
            np.testing.assert_array_equal(value, t_value, err_msg=path)
        else:
            assert value == t_value, path
    assert j["/tpu_index/sorted_hash"][1] == np.uint32
    assert j["/tpu_index/hash_params@treedef"][3] == "PyTreeDef({'signs': *})"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_file_loads_in_both(world, files, writer):
    """JAX-written -> port-loaded and port-written -> JAX-loaded: the same
    arrays, and the same searches (the dense scan and the walk)."""
    ds, _, _ = world
    path = files[0] if writer == "jax" else files[1]
    jl = jh5.load_index(ds.train, path)
    tl = th5.load_index(ds.train, path, device="cpu")
    arrays = index_arrays(jl)
    for f in ("sorted_hash", "sorted_idx", "sketches", "cluster_starts", "center_ids",
              "brute", "assignment", "maxdiff_table", "slot_records", "prefix_dir",
              "seg_ids", "seg_sizes", "seg_cluster"):
        a = np.asarray(arrays[f])
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      a.view(np.int32) if a.dtype == np.uint32 else a,
                                      err_msg=f)
    for f in ("vectors", "radii", "probs_table", "seg_vectors"):
        np.testing.assert_allclose(getattr(tl, f).numpy(), np.asarray(arrays[f]), atol=1e-6,
                                   err_msg=f)
    for f in ("hash_params", "sketch_params"):
        for k, v in arrays[f].items():
            np.testing.assert_array_equal(getattr(tl, f)[k].numpy(), v, err_msg=f"{f}.{k}")
    # the global engine's tables are remade by a stable sort in the port
    np.testing.assert_array_equal(tl.g_sorted_hash.numpy(),
                                  np.asarray(jl.g_sorted_hash).view(np.int32))
    assert (tl.n_indexed, tl.dir_bits, tl.dir_iters, tl.g_dir_iters, tl.max_seg_len) == (
        jl.n_indexed, jl.dir_bits, jl.dir_iters, jl.g_dir_iters, jl.max_seg_len)
    assert tl.config.to_dict() == jl.config.to_dict()

    from clann_tpu.ops.ivf import scan_search as jscan
    from clann_tpu.ops.query import search as jwalk
    from clann_tpu_torch.ops.ivf import scan_search as tscan
    from clann_tpu_torch.ops.query import search as twalk

    jd, ji, _ = jscan(jl, ds.test, k=10)
    td, ti, _ = tscan(tl, ds.test, k=10)
    assert_topk_match(ji, jd, ti, td)
    jd, ji, js = jwalk(jl, ds.test)
    td, ti, ts = twalk(tl, ds.test)
    assert_topk_match(ji, jd, ti, td)
    np.testing.assert_array_equal(np.asarray(js.distance_computations),
                                  ts.distance_computations)


def test_facade_serialize_and_init_from_file(world, tmp_path):
    """Clann.serialize into a directory names the file as JAX does;
    init_from_file on it searches as the handle it was written from."""
    ds, _, tidx = world
    h = clann_tpu_torch.init_with_config(ds.train, TConfig(**CFG), device="cpu")
    h.index = tidx
    path = clann_tpu_torch.serialize(h, str(tmp_path))
    assert path.endswith(jh5.index_file_name(JConfig(**CFG)))
    assert th5.index_file_name(TConfig(**CFG)) == jh5.index_file_name(JConfig(**CFG))
    loaded = clann_tpu_torch.init_from_file(ds.train, path, device="cpu")
    assert loaded.config.to_dict() == h.config.to_dict()
    for mode in ("scan", "lsh-global"):
        # the carried vectors are JAX's normalization, the loaded the port's
        d0, i0, _ = h.search_batch(ds.test, mode=mode)
        d1, i1, _ = loaded.search_batch(ds.test, mode=mode)
        assert_topk_match(i0, d0, i1, d1)
    # JAX's facade loads the port's file
    jh = clann_tpu.init_from_file(ds.train, path)
    assert jh.index.n_clusters == tidx.n_clusters


def test_pending_points_survive_a_round_trip(world, tmp_path):
    """serialize before rebuild: n_indexed is written, the loaded index
    has the same pending points, and rebuild() after load indexes them as
    JAX's rebuild does (the old points keep their hashes)."""
    ds, jidx, _ = world
    extra = ds.test[:20]
    jins = jindex.insert(jidx, extra)
    path = jh5.save_index(jins, str(tmp_path / "pending.h5"))
    with h5py.File(path) as f:
        assert int(f["tpu_index"].attrs["n_indexed"]) == jidx.n
    full = np.concatenate([ds.train, extra])
    tl = th5.load_index(full, path, device="cpu")
    assert (tl.num_indexed, tl.num_pending) == (jidx.n, 20)
    back = th5.save_index(tl, str(tmp_path / "pending_port.h5"))
    assert jh5.load_index(full, back).num_pending == 20

    jr = jindex.rebuild(jh5.load_index(full, path))
    tr = tindex.rebuild(tl)
    assert tr.num_pending == 0
    jh = np.asarray(jindex.unsort_hashes(jr.sorted_hash, jr.sorted_idx)).view(np.int32)
    th = tindex.unsort_hashes(tr.sorted_hash, tr.sorted_idx).numpy()
    np.testing.assert_array_equal(th[:, : jidx.n], jh[:, : jidx.n])
    np.testing.assert_array_equal(tr.sketches.numpy()[: jidx.n],
                                  np.asarray(jr.sketches).view(np.int32)[: jidx.n])


def test_errors(world, files, tmp_path):
    ds, _, _ = world
    with pytest.raises(SerializeError, match="same dataset"):
        th5.load_index(ds.train[:-1], files[1], device="cpu")
    with pytest.raises(SerializeError, match="not found"):
        th5.load_index(ds.train, str(tmp_path / "missing.h5"), device="cpu")
    with pytest.raises(SerializeError, match="not found"):
        th5.load_jaccard_index(str(tmp_path / "missing.h5"), device="cpu")
    bad = str(tmp_path / "v2.h5")
    with open(files[1], "rb") as src, open(bad, "wb") as dst:
        dst.write(src.read())
    with h5py.File(bad, "r+") as f:
        f["tpu_index"].attrs["format_version"] = 2
    with pytest.raises(SerializeError, match="version"):
        th5.load_index(ds.train, bad, device="cpu")
    with pytest.raises(SerializeError):  # not an HDF5 file
        (tmp_path / "junk.h5").write_bytes(b"not hdf5")
        th5.load_index(ds.train, str(tmp_path / "junk.h5"), device="cpu")


@pytest.fixture(scope="module")
def jaccard_world():
    data = JData(clustered_sets(300, 512, avg_size=12, n_modes=6, seed=0), 512)
    queries = data.tokens[:12]
    jidx = jjac.build_jaccard_index(data, JConfig(**JAC_CFG), clustered=True)
    tidx = tjac.jaccard_index_from_arrays(jaccard_index_arrays(jidx), TConfig(**JAC_CFG),
                                          device="cpu")
    return queries, jidx, tidx


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jaccard_files_load_in_both(jaccard_world, tmp_path, writer):
    queries, jidx, tidx = jaccard_world
    path = (jh5.save_jaccard_index(jidx, str(tmp_path / "j.h5")) if writer == "jax"
            else th5.save_jaccard_index(tidx, str(tmp_path / "j.h5")))
    jl = jh5.load_jaccard_index(path)
    tl = th5.load_jaccard_index(path, device="cpu")
    arrays = jaccard_index_arrays(jl)
    for f, t in tjac.JACCARD_FIELDS.items():
        if f in ("probs_table", "radii"):
            np.testing.assert_allclose(getattr(tl, f).numpy(), arrays[f], atol=0, err_msg=f)
        else:
            a = np.asarray(arrays[f])
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          a.view(np.int32) if a.dtype == np.uint32 else a,
                                          err_msg=f)
    assert (tl.universe, tl.table_hash, tl.sketch_hash, tl.sim_eps) == (
        jl.universe, jl.table_hash, jl.sketch_hash, jl.sim_eps)
    js, ji, jst = jjac.jaccard_search(jl, queries)
    ts, ti, tst = tjac.jaccard_search(tl, queries)
    assert_topk_match(ji, js, ti, ts, atol=0.0)
    np.testing.assert_array_equal(np.asarray(jst.distance_computations),
                                  tst.distance_computations)


def test_jaccard_files_match(jaccard_world, tmp_path):
    _, jidx, tidx = jaccard_world
    pj = jh5.save_jaccard_index(jidx, str(tmp_path / "j.h5"))
    pt = th5.save_jaccard_index(tidx, str(tmp_path))  # a directory: the jaccard name
    assert pt.endswith("index_jaccard_unknown_k0.50_L8.h5")
    with h5py.File(pj) as fj, h5py.File(pt) as ft:
        j, t = _walk(fj), _walk(ft)
    assert set(j) == set(t)
    for path, (kind, dtype, shape, value) in j.items():
        assert (dtype, shape) == t[path][1:3], path
        if path == "/config":
            assert json.loads(value) == json.loads(t[path][3])
        elif kind == "data":
            np.testing.assert_array_equal(value, t[path][3], err_msg=path)
        else:
            assert value == t[path][3], path


def _jax_params():
    """{name: JAX params} of every hash and sketch family the indexes use."""
    key = jax.random.PRNGKey(0)
    out = {}
    for fam in ("simhash", "fht_cross_polytope", "cross_polytope"):
        family = jhashing.make_hash_family(fam, 10)
        for src in ("independent", "pool", "tensor"):
            out[f"{fam}-{src}"] = jsources.make_hash_source(src, family, 4, 12).init(key).params
    out["sketch"] = JFilterer(10, 32, 64).init(key).params
    for cls in ("MinHash", "MinHash1Bit", "TabulationMinHash", "TabulationMinHash1Bit"):
        out[cls] = getattr(jminhash, cls)(100).sample(key, 8)
    return out


@pytest.mark.parametrize("family", list(_jax_params()))
def test_param_dtypes_round_trip(family):
    """JAX params -> the port's tensors -> params_numpy: JAX's dtypes and
    values, keys sorted; the port holds them as int32 / float32."""
    p = {k: np.asarray(v) for k, v in _jax_params()[family].items()}
    t = tindex._params(p, "cpu")
    assert all(v.dtype in (torch.int32, torch.float32) for v in t.values())
    back = tindex.params_numpy(t)
    assert list(back) == sorted(p)
    for k, v in p.items():
        assert back[k].dtype == v.dtype == tindex.PARAM_DTYPES[k], k
        np.testing.assert_array_equal(back[k], v, err_msg=k)

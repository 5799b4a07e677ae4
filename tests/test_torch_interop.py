"""The port's Rust-reference file interop (io/refcodec, io/interop) against
the JAX package's, on the CPU.

- the codec: the port's copy of codec.cpp is JAX's, byte for byte, built
  with g++ into build/codec/ (a failed build raises SerializeError); its
  parse of a JAX-written stream equals JAX's parse, field by field;
- export: for an index carried across from JAX (index_from_arrays), the
  port's reference blobs, clusters and config are byte-identical to JAX's,
  for every cosine family and the pool and tensor sources; a port-built
  index re-exports byte-identically after the port's faithful import;
- the faithful import: the port's and JAX's imports of one JAX-written
  file hold equal tables, geometry and per-cluster functions, and
  ops.query.search (the per-cluster branch) returns JAX's ids up to ties
  with equal distance computations; rebuild=True re-clusters as JAX does;
- the Jaccard reference pair: streams byte-identical to JAX's, imports
  equal, searches equal.
"""

import filecmp
import os

import h5py
import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.core import jaccard as jjac
from clann_tpu.data.setdata import JaccardData as JData
from clann_tpu.data.synthetic import clustered_sets, make_synthetic_dataset
from clann_tpu.io import interop as jio
from clann_tpu.io import refcodec as jcodec
from clann_tpu.ops.query import search as jsearch

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.core import jaccard as tjac
from clann_tpu_torch.errors import SerializeError
from clann_tpu_torch.io import interop as tio
from clann_tpu_torch.io import refcodec as tcodec
from clann_tpu_torch.ops.query import search as tsearch
from clann_tpu_torch.testing import assert_topk_match, index_arrays, jaccard_index_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(num_tables=6, num_clusters_factor=0.3, k=10, delta=0.9, dense_layout=False,
            lsh_engine="clustered")
EXPORTS = {
    "simhash": dict(hash_family="simhash"),
    "fht_cross_polytope": dict(hash_family="fht_cross_polytope"),
    "cross_polytope": dict(hash_family="cross_polytope"),
    "simhash-pool": dict(hash_family="simhash", hash_source="pool"),
    "fht-tensor": dict(hash_family="fht_cross_polytope", hash_source="tensor"),
}
JAC_CFG = dict(num_tables=8, max_hashbits=12, k=5, delta=0.8, candidate_chunk=64,
               filter_expand=4, gather_block=8, seed=3)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(n=2500, d=25, n_queries=30, k_gt=10, seed=8)


def _blobs(path):
    with h5py.File(path) as f:
        return {k: (np.asarray(f[k], np.uint8).tobytes() if k.startswith("index_")
                    else f[k][()].decode()) for k in f.keys()}


def test_codec_source_is_jax_copy():
    assert filecmp.cmp(os.path.join(REPO, "clann_tpu", "native", "codec.cpp"),
                       str(tcodec.CODEC_SOURCE), shallow=False)
    path = tcodec.build()
    assert path.parent == tcodec.BUILD_DIR and path.exists()
    assert os.path.dirname(tcodec.BUILD_DIR) == os.path.join(REPO, "build")


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcodec, "CODEC_SOURCE", bad)
    monkeypatch.setattr(tcodec, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(SerializeError, match="native codec build failed:\n.*error"):
        tcodec.build()


def _stream_args(family):
    """A small reference stream of `family` written by JAX's codec."""
    rng = np.random.default_rng(1)
    n, d, storage = 40, 20, 32
    q15 = lambda *s: jcodec.f32_to_q15(rng.standard_normal(s).astype(np.float32) * 0.1)  # noqa: E731
    r = jcodec.ReferenceIndexData()
    r.dims, r.storage_len = d, storage
    r.vectors_q15 = q15(n, storage)
    r.sketch_planes = q15(2048, storage)
    r.sketches = rng.integers(0, 2**63, (n, 32), dtype=np.uint64)
    r.sketch_hashers, r.sketch_fph = 32, 64
    r.map_hashes = [np.sort(rng.integers(0, 1 << 24, n).astype(np.uint32)) for _ in range(2)]
    r.map_indices = [rng.permutation(n).astype(np.uint32) for _ in range(2)]
    r.last_rebuild = n
    r.num_hashers, r.source_kind = 2, jcodec.SOURCE_INDEPENDENT
    if family == "simhash":
        r.family = jcodec.FAMILY_SIMHASH
        r.hash_planes = q15(48, storage)
        r.functions_per_hasher, r.bits_per_function = 24, 1
    else:
        r.family = jcodec.FAMILY_FHT_CROSS_POLYTOPE
        r.fht_signs = np.where(rng.random((9, 3, 32)) < 0.5, -1, 1).astype(np.int8)
        r.estimates = rng.random((7, 201)).astype(np.float32)
        r.est_reps, r.est_eps, r.num_rotations = 1000, 5e-3, 3
        r.functions_per_hasher, r.bits_per_function, r.bits_to_cut = 4, 6, 0
    return r


@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope"])
def test_parse_equals_jax(family):
    buf = jcodec.write_reference_stream_v2(_stream_args(family))
    fam = jcodec.FAMILY_SIMHASH if family == "simhash" else jcodec.FAMILY_FHT_CROSS_POLYTOPE
    j, t = jcodec.parse_reference_stream(buf, fam), tcodec.parse_reference_stream(buf, fam)
    for name, v in vars(j).items():
        w = getattr(t, name)
        if isinstance(v, list):
            assert len(v) == len(w), name
            for a, b in zip(v, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, w, err_msg=name)
        else:
            assert v == w, name
    # the port writes the same stream back
    assert tcodec.write_reference_stream_v2(t) == buf
    with pytest.raises(SerializeError):
        tcodec.parse_reference_stream(buf[:-7], fam)


@pytest.mark.parametrize("kind", list(EXPORTS))
def test_carried_export_is_byte_identical(ds, kind, tmp_path):
    cfg = dict(BASE, dataset_name=ds.name, **EXPORTS[kind])
    jidx = jindex.build_index(ds.train, JConfig(**cfg))
    tidx = tindex.index_from_arrays(index_arrays(jidx), TConfig(**cfg), device="cpu")
    j = _blobs(jio.save_reference_h5(jidx, str(tmp_path / "jax.h5")))
    t = _blobs(tio.save_reference_h5(tidx, str(tmp_path / "port.h5")))
    assert sorted(j) == sorted(t)
    assert sum(k.startswith("index_") for k in j) > 1
    for k in j:
        assert j[k] == t[k], k


@pytest.fixture(scope="module")
def imports(ds, tmp_path_factory):
    """{family: (JAX's faithful import, the port's)} of one JAX-written file."""
    out = {}
    for fam in ("simhash", "fht_cross_polytope"):
        cfg = JConfig(**dict(BASE, dataset_name=ds.name, hash_family=fam))
        path = str(tmp_path_factory.mktemp(fam) / "ref.h5")
        jio.save_reference_h5(jindex.build_index(ds.train, cfg), path)
        out[fam] = (path, jio.load_reference_h5(path, data=ds.train),
                    tio.load_reference_h5(path, data=ds.train, device="cpu"))
    return out


@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope"])
def test_faithful_import_equals_jax(imports, family):
    _, jimp, timp = imports[family]
    arrays = index_arrays(jimp)
    for f in ("sorted_hash", "sorted_idx", "sketches", "cluster_starts", "center_ids",
              "brute", "assignment", "maxdiff_table", "slot_records", "prefix_dir"):
        a = np.asarray(arrays[f])
        np.testing.assert_array_equal(getattr(timp, f).numpy(),
                                      a.view(np.int32) if a.dtype == np.uint32 else a,
                                      err_msg=f)
    for f in ("vectors", "radii", "probs_table"):
        np.testing.assert_allclose(getattr(timp, f).numpy(), arrays[f], atol=1e-6, err_msg=f)
    for f in ("pc_hash_params", "pc_sketch_params"):
        assert set(getattr(timp, f)) == set(arrays[f])
        for k, v in arrays[f].items():
            assert getattr(timp, f)[k].shape[0] == timp.n_clusters
            np.testing.assert_array_equal(getattr(timp, f)[k].numpy(), v, err_msg=f"{f}.{k}")
    assert timp.config.to_dict() == jimp.config.to_dict()
    assert (timp.max_seg_len, timp.dir_bits, timp.dir_iters) == (
        jimp.max_seg_len, jimp.dir_bits, jimp.dir_iters)


@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope"])
def test_faithful_import_searches_as_jax(ds, imports, family):
    """ops.query.search on the import runs the per-cluster branch: JAX's
    ids up to ties, equal distance computations; the per-cluster query
    hashes reproduce the stored table hashes of each cluster's points."""
    from clann_tpu_torch.ops.sources import hash_per_cluster

    _, jimp, timp = imports[family]
    jd, ji, js = jsearch(jimp, ds.test)
    td, ti, ts = tsearch(timp, ds.test)
    assert_topk_match(ji, jd, ti, td)
    for f in ("distance_computations", "candidates", "clusters_visited"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f), err_msg=f)

    source, _ = timp.rebuild_objects()
    pts = torch.arange(0, timp.n, 97)
    qh = hash_per_cluster(source, timp.pc_hash_params, timp.vectors[pts], cluster_block=3)
    own = qh[torch.arange(len(pts)), timp.assignment[pts].long()]  # (P, L)
    stored = tindex.unsort_hashes(timp.sorted_hash, timp.sorted_idx).T[pts]
    live = ~timp.brute[timp.assignment[pts].long()]
    assert float((own == stored)[live].float().mean()) > 0.99


@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope"])
def test_port_reexport_is_byte_stable(ds, family):
    """export -> faithful import -> export of a port-built index gives
    every blob back byte for byte (JAX's test_reexport_byte_stable)."""
    cfg = TConfig(**dict(BASE, dataset_name=ds.name, hash_family=family))
    tidx = tindex.build_index(ds.train, cfg, device="cpu")
    first = tio._reference_datasets(tidx)
    imp = tio._index_from_reference(first, data=ds.train, device="cpu")
    assert imp.pc_hash_params is not None
    again = tio._reference_datasets(imp)
    assert sorted(first) == sorted(again)
    for k in first:
        assert first[k] == again[k], k


def test_rebuild_import_reclusters_as_jax(ds, imports):
    path = imports["simhash"][0]
    jimp = jio.load_reference_h5(path, data=ds.train, rebuild=True)
    timp = tio.load_reference_h5(path, data=ds.train, rebuild=True, device="cpu")
    assert timp.pc_hash_params is None and timp.pc_sketch_params is None
    assert timp.config.hash_family == jimp.config.hash_family == "simhash"
    for f in ("center_ids", "assignment", "cluster_starts"):
        np.testing.assert_array_equal(getattr(timp, f).numpy(), np.asarray(getattr(jimp, f)))


def test_import_errors(ds, imports, tmp_path):
    path = imports["simhash"][0]
    with pytest.raises(SerializeError, match="not found"):
        tio.load_reference_h5(str(tmp_path / "missing.h5"), device="cpu")
    with pytest.raises(SerializeError, match="points"):
        tio.load_reference_h5(path, data=ds.train[:-1], device="cpu")
    # without the dataset the vectors come from the blobs' Q15 copies, and
    # brute-force clusters carry none: both packages refuse
    from clann_tpu.errors import SerializeError as JSerializeError

    assert bool(imports["simhash"][2].brute.any())
    with pytest.raises(SerializeError, match="brute-force"):
        tio.load_reference_h5(path, device="cpu")
    with pytest.raises(JSerializeError, match="brute-force"):
        jio.load_reference_h5(path)


@pytest.fixture(scope="module")
def jaccard_pair():
    data = JData(clustered_sets(300, 512, avg_size=12, n_modes=6, seed=0), 512)
    jidx = jjac.build_jaccard_index(data, JConfig(**JAC_CFG), table_hash="tabulation_minhash")
    tidx = tjac.jaccard_index_from_arrays(jaccard_index_arrays(jidx), TConfig(**JAC_CFG),
                                          device="cpu")
    return data.tokens[:12], jidx, tidx


def test_jaccard_reference_pair(jaccard_pair, tmp_path):
    queries, jidx, tidx = jaccard_pair
    buf = jio.jaccard_to_reference_stream(jidx)
    assert tio.jaccard_to_reference_stream(tidx) == buf
    path = tio.save_reference_jaccard(tidx, str(tmp_path / "jac.h5"))
    assert _blobs(path)["index_0"] == buf
    jl = jio.load_reference_jaccard(path)
    tl = tio.load_reference_jaccard(path, device="cpu")
    raw = str(tmp_path / "jac.bin")
    with open(raw, "wb") as f:
        f.write(buf)
    tr = tio.load_reference_jaccard(raw, device="cpu")  # a raw stream too
    arrays = jaccard_index_arrays(jl)
    for t in (tl, tr):
        for f in ("tokens", "set_sizes", "sorted_hash", "sorted_idx", "sketches",
                  "sketch_p1_table", "g_records"):
            a = np.asarray(arrays[f])
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          a.view(np.int32) if a.dtype == np.uint32 else a,
                                          err_msg=f)
        for f in ("hash_params", "sketch_params"):
            for k, v in arrays[f].items():
                np.testing.assert_array_equal(tindex.params_numpy(getattr(t, f))[k], v)
    assert (tl.table_hash, tl.sketch_hash, tl.universe) == (
        jl.table_hash, jl.sketch_hash, jl.universe)
    js, ji, jst = jjac.jaccard_search(jl, queries)
    ts, ti, tst = tjac.jaccard_search(tl, queries)
    assert_topk_match(ji, js, ti, ts, atol=0.0)
    np.testing.assert_array_equal(np.asarray(jst.distance_computations),
                                  tst.distance_computations)


@pytest.mark.parametrize("source", ["independent", "pool", "tensor"])
@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope", "cross_polytope"])
def test_hash_per_cluster_matches_jax_vmap(family, source):
    """The per-cluster query hashes and sketches (blocks of 2 of 5
    clusters) equal a loop of hash_with / sketch_with over the clusters
    bit for bit, and JAX's vmap of them over the same stacked parameters
    on >= 0.999 of the values (f32 sums in another order can move a
    cross-polytope argmax; the share test_torch_lsh_build.py holds the
    shared hashes to)."""
    import jax
    import jax.numpy as jnp

    from clann_tpu.ops.hashing import make_hash_family as jfamily
    from clann_tpu.ops.sketches import SketchFilterer as JFilterer
    from clann_tpu.ops.sources import make_hash_source as jsource

    from clann_tpu_torch.ops.hashing import make_hash_family as tfamily
    from clann_tpu_torch.ops.sketches import SketchFilterer as TFilterer
    from clann_tpu_torch.ops.sources import hash_per_cluster, make_hash_source as tsource

    C, d = 5, 32
    q = np.random.default_rng(4).standard_normal((300, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keys = jax.random.split(jax.random.PRNGKey(2), C)
    js = [jsource(source, jfamily(family, d), 4, 12).init(k) for k in keys]
    jf = [JFilterer(d, 4, 64).init(k) for k in keys]
    stack = lambda objs: {k: np.stack([np.asarray(o.params[k]) for o in objs])  # noqa: E731
                          for k in objs[0].params}
    pch, pcs = stack(js), stack(jf)
    jh = jax.vmap(lambda p: js[0].hash_with(p, jnp.asarray(q)))(
        {k: jnp.asarray(v) for k, v in pch.items()})  # (C, n, L)
    jsk = jax.vmap(lambda p: jf[0].sketch_with(p, jnp.asarray(q)))(
        {k: jnp.asarray(v) for k, v in pcs.items()})  # (C, n, S, W)

    ts = tsource(source, tfamily(family, d), 4, 12)
    tf = TFilterer(d, 4, 64)
    tpch, tpcs, tq = tindex._params(pch, "cpu"), tindex._params(pcs, "cpu"), torch.from_numpy(q)
    th = hash_per_cluster(ts, tpch, tq, cluster_block=2)
    tsk = hash_per_cluster(tf, tpcs, tq, cluster_block=2)
    loop_h = torch.stack([ts.hash_with({k: v[c] for k, v in tpch.items()}, tq)
                          for c in range(C)], dim=1)
    loop_s = torch.stack([tf.sketch_with({k: v[c] for k, v in tpcs.items()}, tq)
                          for c in range(C)], dim=1)
    assert torch.equal(th, loop_h) and torch.equal(tsk, loop_s)
    want_h = np.transpose(np.asarray(jh), (1, 0, 2)).view(np.int32)
    want_s = np.transpose(np.asarray(jsk), (1, 0, 2, 3)).view(np.int32)
    assert th.shape == want_h.shape and tsk.shape == want_s.shape
    assert float(np.mean(th.numpy() == want_h)) >= 0.999
    assert float(np.mean(tsk.numpy() == want_s)) >= 0.999

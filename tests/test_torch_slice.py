"""The ported slice as a whole against the JAX package, on the CPU:
cluster build, scan_search in every pull mode (kernel path pinned, plain
path, certified exact), the Clann facade's "scan" / "scan-pallas" modes,
the int8 rescore in five facade modes and the facade's error probes (the
block modes are in test_torch_block_scan.py).

Both packages search the SAME index: the JAX index's geometry fields are
carried across with index_from_arrays. The port's own build is compared
with JAX's separately. Tolerances: distances within 1e-5 (f32 sums in
another order), ids per query as sets up to boundary ties, bit-packed id
words identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import clann_tpu
from clann_tpu.config import Config as JConfig
from clann_tpu.ops import ivf as jivf

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import GEOMETRY_FIELDS, build_index, index_from_arrays
from clann_tpu_torch.data.synthetic import clustered_unit_vectors, random_unit_vectors
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.ops import ivf as tivf
from clann_tpu_torch.ops import scan_topk as tst
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

# the cheap build of tests/test_pallas_scan.py, with more than one cluster
CFG = dict(num_tables=2, num_clusters_factor=0.4, k=5, delta=0.9,
           dataset_name="slice", dense_layout=False, seed=0)


@pytest.fixture(scope="module")
def world():
    train = clustered_unit_vectors(3000, 20, n_modes=8, seed=0)
    queries = random_unit_vectors(40, 20, seed=1) * 2.5
    jidx = clann_tpu.init_with_config(train, JConfig(**CFG)).build().index
    arrays = {f: np.asarray(getattr(jidx, f)) for f in GEOMETRY_FIELDS}
    tidx = index_from_arrays(arrays, TConfig(**CFG), device="cpu")
    return train, queries, jidx, tidx


def test_build_geometry_matches_jax(world):
    train, _, jidx, _ = world
    own = clann_tpu_torch.init_with_config(
        train, TConfig(**CFG), device="cpu").build().index
    assert _same_geometry(own, build_index(train, TConfig(**CFG), device="cpu"))
    assert own.n_clusters == jidx.n_clusters == 21
    for f in ("center_ids", "assignment", "cluster_starts", "brute"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(jidx, f)), err_msg=f)
    for f in ("vectors", "centers"):
        np.testing.assert_allclose(getattr(own, f).numpy(),
                                   np.asarray(getattr(jidx, f)), atol=1e-6)
    np.testing.assert_allclose(own.radii.numpy(), np.asarray(jidx.radii), atol=1e-5)
    assert own.memory_usage() > own.vectors.numel() * 4
    assert own.cluster_starts.dtype == torch.int32


def _same_geometry(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in GEOMETRY_FIELDS)


@pytest.mark.parametrize("pull", ["packed", "ids", "ids-packed"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_scan_search_pull_modes(world, pull, use_pallas):
    _, queries, jidx, tidx = world
    kw = dict(k=5, pull=pull, use_pallas=use_pallas, pallas_auto_route=False,
              batch_q=16)
    launches = tst.KERNEL_LAUNCHES
    jd, ji, jst_ = jivf.scan_search(jidx, queries, **kw)
    td, ti, tst_ = tivf.scan_search(tidx, queries, **kw)
    assert tst.KERNEL_LAUNCHES == launches  # CPU tensors: plain version
    assert ti.dtype == np.int32 and ti.shape == (40, 5)
    if pull == "packed":
        assert_topk_match(ji, jd, ti, td)
    else:
        assert jd is None and td is None
        # ids only: compare through exact distances rebuilt on the host
        v = np.asarray(jidx.vectors)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        dist = lambda ids: 1.0 - np.einsum("qkd,qd->qk", v[ids], qn)  # noqa: E731
        assert_topk_match(ji, dist(ji), ti, dist(ti))
    for f in ("distance_computations", "clusters_visited", "uncertified"):
        np.testing.assert_array_equal(getattr(tst_, f), getattr(jst_, f))


def test_scan_search_exact_certified(world):
    _, queries, jidx, tidx = world
    jd, ji, js = jivf.scan_search(jidx, queries, k=5, exact=True, batch_q=16)
    td, ti, ts = tivf.scan_search(tidx, queries, k=5, exact=True, batch_q=16)
    assert_topk_match(ji, jd, ti, td)
    np.testing.assert_array_equal(ts.uncertified, js.uncertified)


def test_scan_search_certificate_fallback(world):
    """A huge eps fails every certificate: all queries take the direct
    sort and are counted, with the same results."""
    _, queries, jidx, tidx = world
    kw = dict(k=5, exact=True, exact_eps=10.0, batch_q=16)
    jd, ji, js = jivf.scan_search(jidx, queries, **kw)
    td, ti, ts = tivf.scan_search(tidx, queries, **kw)
    assert ts.uncertified.sum() == 40
    np.testing.assert_array_equal(ts.uncertified, js.uncertified)
    assert_topk_match(ji, jd, ti, td)


def test_ids_packed_words_bit_identical(world):
    rng = np.random.default_rng(5)
    for n, k in ((3000, 5), (1_183_514, 10), (7, 3)):
        bits, words = tivf._ids_pack_spec(n, k)
        assert (bits, words) == jivf._ids_pack_spec(n, k)
        ids = rng.integers(-1, n, size=(33, k)).astype(np.int32)
        jw = np.asarray(jivf._pack_ids_device(jnp.asarray(ids), n=n, bits=bits,
                                              words=words))
        tw = tivf._pack_ids_device(torch.from_numpy(ids).long(), n=n, bits=bits,
                                   words=words).numpy().view(np.uint32)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(
            tivf._unpack_ids_host(tw, n=n, bits=bits, k=k), ids)


def test_plan_and_routing_are_the_jax_ones():
    for n in (2000, 20_000, 290_000, 1_183_514, 10_000_000):
        for d in (None, 16, 100, 768):
            for k in (1, 10, 100):
                assert tivf.pallas_scan_plan(n, k, d) == jivf.pallas_scan_plan(n, k, d)
        assert tivf.pallas_scan_viable(n) == jivf.pallas_scan_viable(n)
    assert tivf.PALLAS_SCAN_MIN_N == jivf.PALLAS_SCAN_MIN_N


def test_pallas_base_layout_and_cache(world):
    _, _, jidx, tidx = world
    jb = np.asarray(jivf._pallas_base(jidx, 1024).astype(jnp.float32))
    tb = tivf._pallas_base(tidx, 1024)
    np.testing.assert_array_equal(tb.float().numpy(), jb)
    assert tivf._pallas_base(tidx, 1024) is tb  # cached, not re-padded


def test_scan_pallas_k_above_n_pads():
    """k > n: the kernel path pads with -1 ids and inf distances (the
    JAX path does too; its plain scan raises, as the port's does)."""
    v = random_unit_vectors(6, 8, seed=0)
    small = index_from_arrays(
        dict(vectors=v, cluster_starts=np.array([0, 6]), centers=v[:1],
             center_ids=np.array([0]), radii=np.array([1.0]),
             brute=np.array([True]), assignment=np.zeros(6)),
        TConfig(**CFG), device="cpu",
    )
    d, i, _ = tivf.scan_search(small, v[:3], k=9, use_pallas=True,
                               pallas_auto_route=False)
    assert (i[:, 6:] == -1).all() and np.isinf(d[:, 6:]).all()
    assert all(set(row[:6].tolist()) == set(range(6)) for row in i)
    assert (i[:, 0] == np.arange(3)).all()
    with pytest.raises(ValueError):
        tivf.scan_search(small, v[:3], k=9)


@pytest.mark.parametrize("mode", ["scan", "scan-pallas"])
def test_facade_modes_match(world, mode):
    train, queries, jidx, _ = world
    j = clann_tpu.init_with_config(train, JConfig(**CFG))
    j.index = jidx  # the module's JAX facade build
    t = clann_tpu_torch.init_with_config(train, TConfig(**CFG), device="cpu").build()
    jd, ji, _ = j.search_batch(queries, mode=mode)
    td, ti, _ = t.search_batch(queries, mode=mode)
    assert_topk_match(ji, jd, ti, td)


def test_facade_single_query_search(world):
    """search() runs the configured mode, as in the JAX facade."""
    train, queries, jidx, _ = world
    j = clann_tpu.init_with_config(train, JConfig(**CFG, search_mode="scan-pallas"))
    j.index = jidx
    t = clann_tpu_torch.init_with_config(
        train, TConfig(**CFG, search_mode="scan-pallas"), device="cpu").build()
    jh = clann_tpu.search(j, queries[3])
    th = clann_tpu_torch.search(t, queries[3])
    assert len(th) == 5
    assert_topk_match([[i for _, i in jh]], [[d for d, _ in jh]],
                      [[i for _, i in th]], [[d for d, _ in th]])


# each mode in a configuration where it reaches a part that is not ported:
# the clustered walk ("lsh" on a clustered build, "lsh-clustered") refuses
# an index with per-cluster hash functions (a faithful reference import,
# slice 14)
_UNPORTED = {
    "lsh": dict(lsh_engine="clustered"),
    "lsh-clustered": dict(lsh_engine="clustered"),
}


@pytest.mark.parametrize("mode", list(_UNPORTED))
def test_unported_modes_raise(world, mode):
    train = world[0]
    cfg = TConfig(**{**CFG, **_UNPORTED[mode]})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t = clann_tpu_torch.init_with_config(train[:200], cfg, device="cpu").build()
        t.index.pc_hash_params = dict(t.index.hash_params)
        t.search_batch(train[:3], mode=mode)


# the int8 rescore in every mode that the unported-mode probe once refused
# with it: the default mode and "auto" (the global engine here), "dense",
# "lsh-global" and "adaptive" (the dense modes build the int8 shadow and
# score in f32, as in JAX)
_INT8 = dict(rescore_dtype="int8")
_INT8_MODES = {
    None: _INT8, "auto": _INT8, "dense": dict(_INT8, dense_layout=True),
    "lsh-global": _INT8, "adaptive": dict(_INT8, dense_layout=True),
}


@pytest.mark.parametrize("mode", list(_INT8_MODES))
def test_int8_modes_match_jax(world, mode):
    """JAX's int8 build carried across (its vectors_q8 included), both
    facades searching it: distances within 1e-5, ids up to ties, counters
    identical."""
    train, queries = world[0][:600], world[1]
    cfg = {**CFG, **_INT8_MODES[mode]}
    j = clann_tpu.init_with_config(train, JConfig(**cfg)).build()
    assert j.index.vectors_q8 is not None
    t = clann_tpu_torch.init_with_config(train, TConfig(**cfg), device="cpu")
    t.index = index_from_arrays(index_arrays(j.index), TConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(t.index.vectors_q8.numpy(), np.asarray(j.index.vectors_q8))
    jd, ji, jst = j.search_batch(queries, mode=mode)
    td, ti, tst = t.search_batch(queries, mode=mode)
    assert_topk_match(ji, jd, ti, td)
    for f in ("distance_computations", "candidates", "clusters_visited"):
        np.testing.assert_array_equal(np.asarray(getattr(tst, f)), np.asarray(getattr(jst, f)),
                                      err_msg=f)


def test_facade_error_probes(world):
    train = world[0]
    with pytest.raises(DataError):
        clann_tpu_torch.init(np.zeros((0, 4), np.float32), device="cpu")
    t = clann_tpu_torch.init_with_config(train[:100], TConfig(**CFG), device="cpu")
    with pytest.raises(DataError):
        t.search_batch(train[:2], mode="scan")
    with pytest.raises(DataError, match="unknown search mode"):
        t.build().search_batch(train[:2], mode="nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            clann_tpu_torch.init(train[:10])  # default device is CUDA: no CPU fallback


@pytest.mark.parametrize("d", [100, 1040, 1041, 1500])
def test_int8_dots_exact_on_both_sides_of_the_f32_bound(d):
    """The int8 candidate dots (ops/query._int8_dots): an f32 bmm of the
    int8 values up to Q8_F32_EXACT_D = 1,040 dimensions, an int32
    multiply-and-sum above; both give the exact integer dot cast once to
    f32 (JAX's int32 contraction, then astype), at the largest magnitudes
    (+-127 everywhere, where partial f32 sums past 2^24 would round)."""
    from clann_tpu_torch.ops.query import Q8_F32_EXACT_D, _int8_dots

    assert Q8_F32_EXACT_D == 1040
    rng = np.random.default_rng(d)
    vecs = rng.integers(-127, 128, (3, 5, d)).astype(np.int8)
    vecs[0] = 127
    q = rng.integers(-127, 128, (3, d)).astype(np.int8)
    q[0] = 127
    q[1, : d // 2] = -127
    got = _int8_dots(torch.from_numpy(vecs), torch.from_numpy(q))
    want = np.einsum("qcd,qd->qc", vecs.astype(np.int64), q.astype(np.int64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))

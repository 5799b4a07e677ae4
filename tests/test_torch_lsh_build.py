"""The LSH build of the port (hashing, sources, collision tables, sketches,
prefix maps, global tables, build_index) against the JAX package on the
CPU, at the shape of tests/test_stream_map.py (4,000 x 32, L = 10,
gather_block 8).

Random draws differ between the packages (torch.Generator vs jax.random),
so every function is run on parameters carried across from JAX. Tolerances:

- hashes and sketch bits from carried parameters: >= 99.9% equal (the f32
  Hadamard / rotation / SimHash products sum in another order, so an argmax
  or a sign at a near-tie may flip; the share reached is printed);
- bit packing, hamming, `_combine_bits` (including the 33-bit wrap at
  d = 784), the collision table of the cross-polytope family, the prefix
  maps and directories on JAX's tables: exact;
- probability tables that pass through arccos (SimHash, the sketch
  thresholds' p_1): 1e-6;
- sorted tables: exact, with ids compared as sets inside runs of equal
  keys (JAX's sort is unstable there, the port's stable);
- the port's own build: the JAX index's field names, shapes and dtypes
  (uint32 words as int32), and recall@10 >= 0.8 * delta (ROADMAP item 8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clann_tpu.config import Config as JConfig
from clann_tpu.core import index as jindex
from clann_tpu.data.synthetic import make_synthetic_dataset
from clann_tpu.ops import collision as jcol
from clann_tpu.ops import global_query as jgq
from clann_tpu.ops import hashing as jhash
from clann_tpu.ops import prefixmap as jpm
from clann_tpu.ops import sketches as jsk
from clann_tpu.ops import sources as jsrc

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.metrics.recall import recall_values
from clann_tpu_torch.ops import collision as tcol
from clann_tpu_torch.ops import hashing as thash
from clann_tpu_torch.ops import prefixmap as tpm
from clann_tpu_torch.ops import sketches as tsk
from clann_tpu_torch.ops import sources as tsrc

torch.set_num_threads(1)

CFG = dict(num_tables=10, num_clusters_factor=0.4, k=10, delta=0.9,
           lsh_engine="global", dense_layout=False, gather_block=8)
HASH_SHARE = 0.999


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(n=4000, d=32, n_queries=48, k_gt=15, seed=3)


@pytest.fixture(scope="module")
def jidx(ds):
    return jindex.build_index(ds.train, JConfig(**CFG, dataset_name=ds.name))


def _i32(a):
    """JAX uint32 words (or int32) as an int32 tensor with the same bits."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _u32(t):
    return t.numpy().view(np.uint32)


def _params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax.tree_util.tree_map(np.asarray, p).items()}


def _share(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


# --- hash families and sources -------------------------------------------

@pytest.mark.parametrize("family", ["simhash", "fht_cross_polytope", "cross_polytope"])
@pytest.mark.parametrize("source", ["independent", "pool", "tensor"])
@pytest.mark.parametrize("d", [32, 100])
def test_hash_source_matches_jax(family, source, d):
    x = np.random.default_rng(d).standard_normal((300, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jfam = jhash.make_hash_family(family, d)
    js = jsrc.make_hash_source(source, jfam, 6, 24).init(jax.random.PRNGKey(1))
    ts = tsrc.make_hash_source(source, thash.make_hash_family(family, d), 6, 24)
    ts.params = _params(js.params)
    want = np.asarray(js.hash(jnp.asarray(x)))
    got = ts.hash(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    share = _share(_u32(got), want)
    print(f"{family}/{source}/d={d}: {share:.5f} of hashes equal")
    assert share >= HASH_SHARE


def test_combine_bits_keeps_the_uint32_wrap():
    """bpf * fph > 32 (d = 784: padded 1024, bpf 11, fph 3 = 33 bits): the
    top bit is lost before the cut, as in uint32."""
    h = np.random.default_rng(0).integers(0, 2**11, size=(500, 7, 3), dtype=np.uint32)
    want = np.asarray(jsrc._combine_bits(jnp.asarray(h), 3, 11, 9))
    got = tsrc._combine_bits(torch.from_numpy(h.astype(np.int32)), 3, 11, 9)
    np.testing.assert_array_equal(_u32(got), want)
    assert want.max() < 2**24


def test_fht_hash_at_d784_matches_jax():
    """The full source at the 33-bit width, with carried parameters."""
    x = np.random.default_rng(7).standard_normal((200, 784)).astype(np.float32)
    jfam = jhash.make_hash_family("fht_cross_polytope", 784)
    js = jsrc.make_hash_source("independent", jfam, 2, 24).init(jax.random.PRNGKey(2))
    ts = tsrc.make_hash_source("independent",
                               thash.make_hash_family("fht_cross_polytope", 784), 2, 24)
    assert ts.bits_to_cut == 9 and ts.functions_per_hasher == 3
    ts.params = _params(js.params)
    share = _share(_u32(ts.hash(torch.from_numpy(x))), np.asarray(js.hash(jnp.asarray(x))))
    print(f"fht d=784: {share:.5f} of hashes equal")
    assert share >= HASH_SHARE


def test_encode_closest_axis_tie_break():
    """Exact ties keep the reference's scan order: lowest axis, +v first."""
    v = np.array([[0.5, -0.5, 0.1, 0.0], [-0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                  [0.0, -0.0, 0.0, -0.0], [0.1, -0.3, 0.3, 0.2]], np.float32)
    want = np.asarray(jhash.encode_closest_axis(jnp.asarray(v), 2))
    np.testing.assert_array_equal(_u32(thash.encode_closest_axis(torch.from_numpy(v), 2)),
                                  want)


# --- sketches --------------------------------------------------------------

def test_pack_bits_and_hamming_exact():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(40, 5, 64), dtype=np.uint32)
    want = np.asarray(jsk.pack_bits_u32(jnp.asarray(bits)))
    got = tsk.pack_bits_u32(torch.from_numpy(bits.astype(np.int32)))
    np.testing.assert_array_equal(_u32(got), want)
    a = rng.integers(0, 2**32, size=(64, 3, 2), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(64, 3, 2), dtype=np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0  # every bit differs
    np.testing.assert_array_equal(
        tsk.SketchFilterer.hamming(_i32(a), _i32(b)).numpy(),
        np.asarray(jsk.SketchFilterer.hamming(jnp.asarray(a), jnp.asarray(b))))


def test_sketches_match_jax(ds):
    x = ds.train[:500]
    jf = jsk.SketchFilterer(32).init(jax.random.PRNGKey(4))
    tf = tsk.SketchFilterer(32)
    tf.params = _params(jf.params)
    want = np.asarray(jf.sketch(jnp.asarray(x)))
    got = _u32(tf.sketch(torch.from_numpy(x)))
    assert got.shape == want.shape == (500, 32, 2)
    bits = lambda w: np.unpackbits(w.view(np.uint8))  # noqa: E731
    share = _share(bits(got), bits(want))
    print(f"sketch bits: {share:.6f} equal")
    assert share >= HASH_SHARE


# --- collision tables -----------------------------------------------------

def test_cross_polytope_estimates_bit_identical():
    np.testing.assert_array_equal(tcol.cross_polytope_estimates(32, 200),
                                  jcol.cross_polytope_estimates(32, 200))


@pytest.mark.parametrize("family", ["fht_cross_polytope", "simhash"])
@pytest.mark.parametrize("source", ["independent", "tensor"])
def test_probs_tables_match_jax(family, source):
    jc = JConfig(**CFG, hash_family=family, hash_source=source)
    tc = TConfig(**CFG, hash_family=family, hash_source=source)
    jp, jmax = jindex.derive_probs_tables(jhash.make_hash_family(family, 32), jc)
    tp, tmax = tindex.derive_probs_tables(thash.make_hash_family(family, 32), tc)
    np.testing.assert_allclose(tp.table, jp.table, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tmax, jmax)
    np.testing.assert_array_equal(
        tcol.tensored_effective_table(jp.table, 10), jcol.tensored_effective_table(jp.table, 10))


def test_failure_probability_matches_jax():
    fam = jhash.make_hash_family("fht_cross_polytope", 32)
    jp = jcol.HashSourceProbs(fam, 24)
    tp = tcol.HashSourceProbs(thash.make_hash_family("fht_cross_polytope", 32), 24)
    sim = np.linspace(0, 1, 37, dtype=np.float32)
    depth = np.arange(37) % 25
    want = np.asarray(jp.failure_probability(depth, depth % 10, 10, sim))
    got = tp.failure_probability(torch.from_numpy(depth), torch.from_numpy(depth % 10), 10,
                                 torch.from_numpy(sim))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# --- prefix maps on JAX's tables ------------------------------------------

def _run_pairs(h, ids):
    """(key, id) pairs of each table, lexsorted: equal across packages iff
    the tables agree up to the order of ids inside runs of equal keys."""
    h, ids = np.asarray(h).astype(np.int64), np.asarray(ids).astype(np.int64)
    return np.stack([np.sort(hr * (1 << 32) + ir) for hr, ir in zip(h, ids)])


def test_sort_tables_segmented_matches_jax(jidx):
    hashes_T = _i32(jindex.unsort_hashes(jidx.sorted_hash, jidx.sorted_idx))
    th, ti = tpm.sort_tables_segmented(hashes_T, _i32(jidx.assignment))
    np.testing.assert_array_equal(_u32(th), np.asarray(jidx.sorted_hash))
    key = lambda h, i: np.asarray(jidx.assignment)[np.asarray(i)] * (1 << 24) + np.asarray(h)  # noqa: E731
    np.testing.assert_array_equal(_run_pairs(key(_u32(th), ti.numpy()), ti.numpy()),
                                  _run_pairs(key(jidx.sorted_hash, jidx.sorted_idx),
                                             jidx.sorted_idx))
    # the port's own order inside runs: ascending ids
    k = key(_u32(th), ti.numpy()).astype(np.int64) * (1 << 32) + ti.numpy()
    assert (np.diff(k, axis=1) > 0).all()


def test_unsort_hashes_matches_jax(jidx):
    want = np.asarray(jindex.unsort_hashes(jidx.sorted_hash, jidx.sorted_idx))
    got = tindex.unsort_hashes(_i32(jidx.sorted_hash), _i32(jidx.sorted_idx))
    np.testing.assert_array_equal(_u32(got), want)


def test_prefix_directories_match_jax(jidx):
    cfg = jidx.config
    tdir, bits, iters = tindex.derive_prefix_directory(
        _i32(jidx.sorted_hash), np.asarray(jidx.cluster_starts), TConfig(**CFG),
        jidx.max_seg_len)
    np.testing.assert_array_equal(tdir.numpy(), np.asarray(jidx.prefix_dir))
    assert (bits, iters) == (jidx.dir_bits, jidx.dir_iters)
    n = jidx.n
    gdir = tpm.build_prefix_directory(_i32(jidx.g_sorted_hash), torch.tensor([0, n]),
                                      cfg.global_dir_bits, int(np.ceil(np.log2(n))) + 1,
                                      cfg.max_hashbits)
    np.testing.assert_array_equal(gdir.numpy(), np.asarray(jidx.g_dir))


def test_masked_binary_search_matches_jax(jidx):
    rng = np.random.default_rng(5)
    L, n = jidx.sorted_hash.shape
    tids = rng.integers(0, L, size=(64, 3)).astype(np.int32)
    keys = rng.integers(0, 2**24 + 2, size=(64, 3)).astype(np.uint32)
    lo = rng.integers(0, n, size=(64, 3)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 2000, size=(64, 3)), n).astype(np.int32)
    want = np.asarray(jpm.masked_binary_search(
        jidx.sorted_hash, jnp.asarray(tids), jnp.asarray(keys), jnp.asarray(lo),
        jnp.asarray(hi), 12))
    got = tpm.masked_binary_search(_i32(jidx.sorted_hash), torch.from_numpy(tids),
                                   torch.from_numpy(keys.astype(np.int64)),
                                   torch.from_numpy(lo), torch.from_numpy(hi), 12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def query_state(ds, jidx):
    """JAX's hashed queries and prepared streams (the global engine's)."""
    source, filterer = jidx.rebuild_objects()
    qn = jnp.asarray(ds.test / np.linalg.norm(ds.test, axis=1, keepdims=True), jnp.float32)
    qh = source.hash(qn)
    streams = jax.jit(lambda i, q, h, s: jgq._prepare_streams(i, q, h, s, min_depth=1))(
        jidx, qn, qh, filterer.sketch(qn))
    return qh, {k: np.asarray(v) for k, v in streams.items()}


@pytest.mark.parametrize("directory", ["global", "segmented", "none"])
def test_depth_bounds_match_jax(jidx, query_state, directory):
    qh = query_state[0]
    Q = qh.shape[0]
    D = jidx.config.max_hashbits
    if directory == "global":
        tables, pdir, bits, iters = jidx.g_sorted_hash, jidx.g_dir, 13, jidx.g_dir_iters
        cl = np.zeros(Q, np.int32)
        lo_s, hi_s = np.zeros(Q, np.int32), np.full(Q, jidx.n, np.int32)
    else:
        tables = jidx.sorted_hash
        cl = np.arange(Q, dtype=np.int32) % jidx.n_clusters
        st = np.asarray(jidx.cluster_starts)
        lo_s, hi_s = st[cl], st[cl + 1]
        pdir, bits, iters = (jidx.prefix_dir, jidx.dir_bits, jidx.dir_iters) if \
            directory == "segmented" else (None, 0, int(np.ceil(np.log2(jidx.n))) + 1)
    for depth in (None, 17):
        want = jpm.depth_bounds(tables, qh, jnp.asarray(lo_s), jnp.asarray(hi_s), D, iters,
                                up_to_depth=depth, prefix_dir=pdir,
                                cluster=jnp.asarray(cl), dir_bits=bits)
        got = tpm.depth_bounds(_i32(tables), _i32(qh), torch.from_numpy(lo_s),
                               torch.from_numpy(hi_s), D, iters, up_to_depth=depth,
                               prefix_dir=None if pdir is None else _i32(pdir),
                               cluster=torch.from_numpy(cl), dir_bits=bits)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_candidate_and_block_streams_match_jax(jidx, query_state):
    qh, st = query_state
    cfg = jidx.config
    d_entry = jgq._entry_depth(jidx, 1)
    zero = jnp.zeros(qh.shape[0], jnp.int32)
    lo, hi = jpm.depth_bounds(jidx.g_sorted_hash, qh, zero, zero + jidx.n, cfg.max_hashbits,
                              jidx.g_dir_iters, up_to_depth=d_entry, prefix_dir=jidx.g_dir,
                              cluster=zero, dir_bits=cfg.global_dir_bits)
    starts, sizes = tpm.candidate_stream(_i32(lo), _i32(hi), _i32(qh), cfg.max_hashbits, 1,
                                         start_depth=d_entry)
    np.testing.assert_array_equal(starts.numpy(), st["starts"])
    np.testing.assert_array_equal(sizes.numpy(), st["sizes"])
    bstarts, bcounts = tpm.block_stream(starts, sizes, 3)
    np.testing.assert_array_equal(bstarts.numpy(), st["bstarts"])
    np.testing.assert_array_equal(np.cumsum(bcounts.numpy(), axis=1), st["fc"])


def test_window_maps_match_jax(jidx, query_state):
    _, st = query_state
    fc, bstarts, starts, sizes = (torch.from_numpy(st[k]) for k in
                                  ("fc", "bstarts", "starts", "sizes"))
    Q, WB, g, L = fc.shape[0], 16, 3, jidx.num_tables
    total = st["total"]
    for off0 in (0, 1, 7, int(total.min()), int(total.max())):
        off = np.full(Q, off0, np.int32)
        want = jpm.blocked_window(jnp.asarray(st["fc"]), jnp.asarray(off), WB,
                                  jnp.asarray(st["bstarts"]), jnp.asarray(st["starts"]),
                                  jnp.asarray(st["sizes"]), g)
        for dense in (False, True):
            got = tpm.blocked_window(fc, torch.from_numpy(off), WB, bstarts, starts, sizes, g,
                                     dense_index=dense)
            for w, t in zip(want, got):
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            tpm.count_leq(fc, torch.from_numpy(off)[:, None] + torch.arange(5)).numpy(),
            np.asarray(jpm.count_leq(jnp.asarray(st["fc"]),
                                     jnp.asarray(off)[:, None] + jnp.arange(5))))
    for tb in (int(total.max()) + WB + 1, 1024):
        want = np.asarray(jpm.stream_block_map(jnp.asarray(st["fc"]), jnp.asarray(st["bstarts"]),
                                               jnp.asarray(st["starts"]),
                                               jnp.asarray(st["sizes"]), g, L, tb))
        got = tpm.stream_block_map(fc, bstarts, starts, sizes, g, L, tb)
        np.testing.assert_array_equal(got.numpy(), want)


def test_stream_map_lane_masks_at_32_lanes():
    """G = 32: a fully valid block is the all-ones word (uint32 0xFFFFFFFF)."""
    starts = np.array([[0, 64, 100]], np.int32)
    sizes = np.array([[64, 7, 33]], np.int32)
    bst, bct = jpm.block_stream(jnp.asarray(starts), jnp.asarray(sizes), 5)
    fc = jnp.cumsum(bct, axis=1)
    want = np.asarray(jpm.stream_block_map(fc, bst, jnp.asarray(starts), jnp.asarray(sizes),
                                           5, 2, 16))
    tb_, tc_ = tpm.block_stream(torch.from_numpy(starts), torch.from_numpy(sizes), 5)
    got = tpm.stream_block_map(torch.cumsum(tc_, 1, dtype=torch.int32), tb_,
                               torch.from_numpy(starts), torch.from_numpy(sizes), 5, 2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, :2, 2].view(np.uint32) == 0xFFFFFFFF).all()


# --- global tables, slot records, build_index -----------------------------

def test_global_tables_match_jax(jidx):
    hashes_T = jindex.unsort_hashes(jidx.sorted_hash, jidx.sorted_idx)
    th, trec = tindex.make_global_tables(_i32(hashes_T), _i32(jidx.sketches),
                                         _i32(jidx.assignment), pad_to=8)
    np.testing.assert_array_equal(_u32(th), np.asarray(jidx.g_sorted_hash))
    jrec = np.asarray(jidx.g_records)
    trec = _u32(trec)
    assert trec.shape == jrec.shape
    n = jidx.n
    # records are functions of their id: compare them in (hash, id) order
    for t in range(trec.shape[0]):
        jo = np.lexsort((jrec[t, :n, 0], np.asarray(jidx.g_sorted_hash)[t]))
        np.testing.assert_array_equal(trec[t, :n], jrec[t, jo])
    np.testing.assert_array_equal(trec[:, n:], jrec[:, n:])  # zero pad slots


def test_slot_records_match_jax(jidx):
    want = np.asarray(jindex.make_slot_records(jidx.sorted_idx, jidx.sketches, pad_to=8))
    got = tindex.make_slot_records(_i32(jidx.sorted_idx), _i32(jidx.sketches), pad_to=8)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.fixture(scope="module")
def own_build(ds):
    return clann_tpu_torch.init_with_config(
        ds.train, TConfig(**CFG, dataset_name=ds.name), device="cpu").build()


def test_build_index_fields_match_jax(jidx, own_build):
    tidx = own_build.index
    for f in tindex.GEOMETRY_FIELDS + tuple(tindex.LSH_FIELDS):
        j, t = getattr(jidx, f), getattr(tidx, f)
        assert (j is None) == (t is None), f
        if j is None:
            continue
        assert tuple(t.shape) == tuple(j.shape), f
        jd = np.asarray(j).dtype
        want = {np.dtype(np.uint32): torch.int32, np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool}[jd]
        assert t.dtype == want, f
    for p in ("hash_params", "sketch_params"):
        jp = jax.tree_util.tree_map(np.asarray, getattr(jidx, p))
        tp = getattr(tidx, p)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, (p, k)
    assert (tidx.max_seg_len, tidx.dir_bits, tidx.sim_eps) == (
        jidx.max_seg_len, jidx.dir_bits, jidx.sim_eps)
    np.testing.assert_array_equal(tidx.assignment.numpy(), np.asarray(jidx.assignment))
    # JAX's count: the collision tables and the dense layout are left out
    nbytes = tidx.array_bytes()
    assert tidx.memory_usage() == jidx.memory_usage() == sum(
        b for f, b in nbytes.items()
        if f not in ("probs_table", "maxdiff_table", *tindex.DENSE_FIELDS))
    # the port's tables are consistent with its own hashes
    source, _ = tidx.rebuild_objects()
    h = source.hash(tidx.vectors).T
    np.testing.assert_array_equal(
        tindex.unsort_hashes(tidx.sorted_hash, tidx.sorted_idx).numpy(), h.numpy())


def test_own_build_meets_the_delta_contract(ds, own_build):
    """The port's own draws, held to the PUFFINN contract recall >= 0.8 * delta."""
    d, _, stats = own_build.search_batch(ds.test, mode="lsh")
    rec = recall_values(ds.distances, d, 10)[0]
    print(f"own build recall@10 {rec:.4f}, dc/query {stats.distance_computations.mean():.0f}")
    assert rec >= 0.8 * CFG["delta"]
    assert (stats.distance_computations < ds.train.shape[0]).all()


def test_build_refuses_int8_rescore(ds):
    """(Named when the port refused rescore_dtype="int8".) The int8 build
    keeps vectors_q8 = quantize_q8(vectors), JAX's values; the f32 build
    taken through with_rescore_dtype is the same index, field for field;
    memory_usage leaves the shadow out, as JAX's does."""
    own = tindex.build_index(ds.train[:300], TConfig(**CFG, rescore_dtype="int8"), device="cpu")
    f32 = tindex.build_index(ds.train[:300], TConfig(**CFG), device="cpu")
    assert f32.vectors_q8 is None and own.vectors_q8.dtype == torch.int8
    np.testing.assert_array_equal(
        own.vectors_q8.numpy(), np.asarray(jindex.quantize_q8(jnp.asarray(own.vectors.numpy()))))
    derived = tindex.with_rescore_dtype(f32, "int8")
    assert derived.config == own.config
    fields = tindex.GEOMETRY_FIELDS + tuple(tindex.LSH_FIELDS) + tuple(tindex.DENSE_FIELDS)
    got, want = dict(derived._tensors(fields)), dict(own._tensors(fields))
    assert got.keys() == want.keys() and "vectors_q8" in got
    for f, t in want.items():
        assert torch.equal(got[f], t), f
    assert own.memory_usage() == f32.memory_usage()
    assert tindex.with_rescore_dtype(own, "float32").vectors_q8 is None


def test_quantize_q8_matches_jax():
    """round(clip(x * 127, -127, 127)) to int8, halves to even: exact
    half-integer products, +-1, beyond +-1, zeros and random values."""
    halves = np.float32(np.arange(-127, 127) + 0.5) / np.float32(127)
    cands = np.concatenate([halves, np.nextafter(halves, np.float32(2)),
                            np.nextafter(halves, np.float32(-2))]).astype(np.float32)
    exact = cands[(cands * np.float32(127)) % 1 == 0.5]
    assert exact.size > 50  # products that land exactly on a half
    rng = np.random.default_rng(0)
    x = np.concatenate([exact, cands, [1, -1, 1.5, -1.5, 0, -0.0],
                        rng.uniform(-1, 1, 1000)]).astype(np.float32)
    got = tindex.quantize_q8(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jindex.quantize_q8(jnp.asarray(x))))
    assert got[-1006 + 0].item() == 127 and got[-1006 + 1].item() == -127

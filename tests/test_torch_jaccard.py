"""The Jaccard set index of the port (data/setdata, ops/minhash,
core/jaccard, data/synthetic.clustered_sets) against the JAX package's on
the CPU, at the shape of tests/test_jaccard_levers.py (a few hundred sets,
universe 512, L = 8 tables of 12 bits, chunk 64, filter_expand 4,
gather_block 8).

The port's own draws (torch.Generator) differ from JAX's, so parity runs on
JAX's parameters: the hash families on JAX's params, the build's steps on
JAX's params, and the searches on a JAX-built index carried across whole
with jaccard_index_from_arrays. Tolerances:

- MinHash values, the murmur mix, set padding, multi-hots, bitmaps,
  sketches, packed records, the set GMM (centers, assignment, radii) and
  the probability tables: exact;
- similarities: exact (integer counts divided in f32 on both sides);
- sorted tables: hashes exact, ids compared as sets inside runs of equal
  hashes (JAX's sort is unstable there, the port's stable);
- searches: ids per query as sets up to boundary ties, similarities
  exact, distance_computations, candidates and clusters_visited identical;
- the port's own build: threshold recall@k >= 0.8 * delta against the
  port's brute force.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clann_tpu.config import Config as JConfig
from clann_tpu.core import jaccard as jj
from clann_tpu.data import setdata as jsd
from clann_tpu.data import synthetic as jsyn
from clann_tpu.ops import minhash as jmh
from clann_tpu.ops.sources import IndependentHashSource as JSource

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import jaccard as tj
from clann_tpu_torch.data import setdata as tsd
from clann_tpu_torch.data import synthetic as tsyn
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.ops import gather as tg
from clann_tpu_torch.ops import minhash as tmh
from clann_tpu_torch.ops.sources import IndependentHashSource as TSource
from clann_tpu_torch.testing import assert_topk_match, jaccard_index_arrays

torch.set_num_threads(1)

U = 512
CFG = dict(num_tables=8, max_hashbits=12, k=5, delta=0.8, candidate_chunk=64,
           filter_expand=4, gather_block=8, seed=3)
FAMILIES = ["MinHash", "MinHash1Bit", "TabulationMinHash", "TabulationMinHash1Bit"]


def _i32(a):
    """A JAX array (uint32 words as their int32 bit patterns) as a tensor."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _params(p):
    return {k: _i32(v) for k, v in jax.tree_util.tree_map(np.asarray, dict(p)).items()}


def _stats(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _sets(universe, n, seed, empty=()):
    rng = np.random.default_rng(seed)
    sets = [rng.choice(universe, size=rng.integers(1, 24), replace=False).tolist()
            for _ in range(n)]
    for i in empty:
        sets[i] = []
    return sets


@pytest.fixture(scope="module")
def data():
    sets = tsyn.clustered_sets(600, U, avg_size=12, n_modes=8, seed=0)
    qsets = tsyn.clustered_sets(24, U, avg_size=12, n_modes=8, seed=1)
    jdata = jsd.JaccardData(sets, U)
    q = jsd.pad_sets(qsets, U, jdata.tokens.shape[1])
    return dict(sets=sets, jdata=jdata, tdata=tsd.JaccardData(sets, U), q=q, built={})


def _built(data, clustered=False, table_hash="minhash"):
    """(JAX index, the port's carried copy), cached per variant."""
    key = (clustered, table_hash)
    if key not in data["built"]:
        jidx = jj.build_jaccard_index(data["jdata"], JConfig(**CFG), clustered=clustered,
                                      table_hash=table_hash)
        tidx = tj.jaccard_index_from_arrays(jaccard_index_arrays(jidx), TConfig(**CFG),
                                            device="cpu")
        data["built"][key] = (jidx, tidx)
    return data["built"][key]


# ---------------------------------------------------------------------------
# hash families


def test_fmix32_matches_jax():
    words = np.concatenate([np.arange(64), np.random.default_rng(0).integers(
        0, 1 << 32, 4096), [0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]]).astype(np.uint32)
    want = np.asarray(jmh.fmix32(jnp.asarray(words)))
    got = tmh.fmix32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("universe", [512, 70_000])
@pytest.mark.parametrize("family", FAMILIES)
def test_minhash_families_match_jax(family, universe):
    """Bit-exact on JAX's params, empty sets included; at 70,000 tokens
    byte 2 of the tabulation tables is live and tokens pass 2^16."""
    sets = _sets(universe, 150, seed=universe, empty=(3, 40))
    if universe > 65_536:
        sets[5] = [universe - 1, 65_536, 65_535, 0]
    tok = jsd.pad_sets(sets, universe)
    jf, tf = getattr(jmh, family)(universe), getattr(tmh, family)(universe)
    assert tf.bits_per_function == jf.bits_per_function
    params = jf.sample(jax.random.PRNGKey(7), 33)
    want = np.asarray(jf.hash(params, jnp.asarray(tok)))
    got = tf.hash(_params(params), torch.from_numpy(tok))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if "Tabulation" in family:  # words >= 2^31 in the tables decide some minima
        assert (np.asarray(params["tab_hi"]) >= 1 << 31).any()
    sims = np.arange(201, dtype=np.float32) * 5e-3
    for b in range(tf.bits_per_function + 1):
        np.testing.assert_array_equal(tf.collision_probability(sims, b).numpy(),
                                      np.asarray(jf.collision_probability(sims, b)))


@pytest.mark.parametrize("family", FAMILIES)
def test_own_draws_have_jax_shapes(family):
    jf, tf = getattr(jmh, family)(U), getattr(tmh, family)(U)
    want = jf.sample(jax.random.PRNGKey(0), 10)
    got = tf.sample(torch.Generator().manual_seed(0), 10)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == np.asarray(want[k]).shape and v.dtype == torch.int32, k
    if "perm" in got:  # each function's permutation is one
        assert (torch.sort(got["perm"], dim=1).values == torch.arange(16)).all()


def test_hash_source_on_sets_matches_jax():
    """The tables' source: L x fph MinHash functions combined into 12 bits."""
    tok = jsd.pad_sets(_sets(U, 100, seed=2, empty=(0,)), U)
    js = JSource(jmh.MinHash(U), 8, 12).init(jax.random.PRNGKey(1))
    ts = TSource(tmh.MinHash(U), 8, 12)
    ts.params = _params(js.params)
    np.testing.assert_array_equal(ts.hash(torch.from_numpy(tok)).numpy(),
                                  np.asarray(js.hash(jnp.asarray(tok))).astype(np.int64))


# ---------------------------------------------------------------------------
# set data


def test_pad_sets_matches_jax():
    sets = [[5, 1, 5, 3], [], [511], [0, 2]]
    np.testing.assert_array_equal(tsd.pad_sets(sets, U), jsd.pad_sets(sets, U))
    np.testing.assert_array_equal(tsd.pad_sets(sets, U, 7), jsd.pad_sets(sets, U, 7))
    for bad in ([[512]], [[-1]]):
        with pytest.raises(DataError, match="universe"):
            tsd.pad_sets(bad, U)


def test_clustered_sets_is_jax_verbatim():
    for kw in (dict(), dict(hub_tokens=3, pool_factor=1.0, core_share=0.8)):
        assert tsyn.clustered_sets(50, 300, seed=4, **kw) == jsyn.clustered_sets(
            50, 300, seed=4, **kw)


def test_similarities_match_jax():
    a = jsd.pad_sets(_sets(U, 30, seed=5, empty=(2,)), U, 24)
    b = jsd.pad_sets(_sets(U, 30, seed=6, empty=(2, 7)), U, 24)
    want = np.asarray(jsd.jaccard_similarity_block(a, b))
    got = tsd.jaccard_similarity_block(a, b, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsd.jaccard_similarity_rowwise(a, b, device="cpu").numpy(),
                                  np.asarray(jsd.jaccard_similarity_rowwise(a, b)))
    np.testing.assert_array_equal(tsd.jaccard_similarity_rowwise(a, a, device="cpu").numpy(),
                                  np.where((a >= 0).any(axis=1), 1.0, 0.0))
    jdata, tdata = jsd.JaccardData(a, U), tsd.JaccardData(a, U)
    np.testing.assert_array_equal(tdata.similarities_to(b, device="cpu"),
                                  jdata.similarities_to(b))
    assert tdata.distance(0, 1, device="cpu") == jdata.distance(0, 1)
    np.testing.assert_array_equal(tdata.subset([3, 1]).tokens, jdata.subset([3, 1]).tokens)
    np.testing.assert_array_equal(tdata.get_point(4), jdata.get_point(4))


def test_multi_hot_and_bitmaps_match_jax():
    tok = jsd.pad_sets(_sets(600, 20, seed=8, empty=(1,)), 600)
    want = np.asarray(jsd._multi_hot(jnp.asarray(tok), 600).astype(jnp.float32))
    got = tsd._multi_hot(torch.from_numpy(tok), 600)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    np.testing.assert_array_equal(tj._set_bitmaps(torch.from_numpy(tok), 600).numpy(),
                                  np.asarray(jj._query_bitmaps(jnp.asarray(tok), 600))
                                  .view(np.int32))


def test_multi_hot_counts_past_bf16_integers():
    """Counts above 256, which bf16 cannot hold, take f32 operands: exact."""
    tok = torch.arange(300, dtype=torch.int32)[None].expand(2, -1).contiguous()
    mh = tsd._multi_hot(tok, 400)
    assert tsd.multi_hot_counts(mh, mh, 300).tolist() == [[300.0, 300.0]] * 2


def test_brute_force_matches_jax(data):
    want = jsd.brute_force_jaccard_topk(data["jdata"], data["q"], 7, block=256)
    got = tsd.brute_force_jaccard_topk(data["tdata"], data["q"], 7, block=256, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the build


def test_set_gmm_matches_jax(data):
    tok = data["jdata"].tokens
    want = jj._set_gmm_jit(jnp.asarray(tok), k=9, universe=U)
    got = tj._set_gmm(torch.from_numpy(tok), 9, U)
    for a, b, name in zip(got, want, ("centers", "assignment", "radii")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _runs(keys, ids):
    """ids as a set per run of equal keys, per table."""
    out = []
    for k, i in zip(np.asarray(keys), np.asarray(ids)):
        cuts = np.flatnonzero(np.diff(k)) + 1
        out.append([frozenset(r.tolist()) for r in np.split(i, cuts)])
    return out


@pytest.mark.parametrize("table_hash", ["minhash", "1bit_minhash", "tabulation_minhash"])
def test_built_tables_match_jax(data, table_hash):
    """The build's hashing steps on JAX's parameters: sorted tables,
    sketches and the probability tables of each table family."""
    jidx, tidx = _built(data, False, table_hash)
    cfg = TConfig(**CFG)
    family = tj.jaccard_table_family(table_hash, U)
    sketch_family = tj.jaccard_sketch_family(jidx.sketch_hash, U)
    source = TSource(family, cfg.num_tables, cfg.max_hashbits)
    source.params = tidx.hash_params
    sh, si, sk = tj.hash_tables(torch.from_numpy(data["jdata"].tokens), source, sketch_family,
                                tidx.sketch_params, cfg)
    np.testing.assert_array_equal(sh.numpy(), _i32(jidx.sorted_hash).numpy())
    assert _runs(sh, si) == _runs(_i32(jidx.sorted_hash), jidx.sorted_idx)
    np.testing.assert_array_equal(sk.numpy(), _i32(jidx.sketches).numpy())
    probs, maxdiff = tj.jaccard_probs_tables(family, sketch_family, cfg)
    np.testing.assert_array_equal(probs.table, np.asarray(jidx.probs_table))
    np.testing.assert_array_equal(maxdiff, np.asarray(jidx.sketch_p1_table))


@pytest.mark.parametrize("clustered", [False, True], ids=["flat", "clustered"])
def test_built_records_match_jax(data, clustered):
    """[id, sketch words, cluster] records, zeros in the cluster column of
    a flat index, the slot axis padded to gather_block."""
    jidx, _ = _built(data, clustered)
    assign = None if jidx.assignment is None else _i32(jidx.assignment)
    rec = tj._pack_jaccard_records(_i32(jidx.sorted_idx), _i32(jidx.sketches), assign,
                                   pad_to=8)
    assert rec.dtype == torch.int32 and rec.shape[1] % 8 == 0
    np.testing.assert_array_equal(rec.numpy(), _i32(jidx.g_records).numpy())


def test_own_build_has_jax_fields(data):
    """The port's own clustered build: JAX's fields, shapes and dtypes
    (uint32 words as int32), and JAX's deterministic GMM geometry."""
    jidx, _ = _built(data, True)
    own = tj.build_jaccard_index(data["tdata"], TConfig(**CFG), clustered=True, device="cpu")
    assert own.sketch_hash == jidx.sketch_hash and own.universe == U
    for f in tj.JACCARD_FIELDS:
        want, got = getattr(jidx, f), getattr(own, f)
        assert (want is None) == (got is None), f
        if want is not None:
            assert tuple(got.shape) == want.shape and got.dtype == tj.JACCARD_FIELDS[f], f
    for name in ("hash_params", "sketch_params"):
        assert {k: tuple(v.shape) for k, v in getattr(own, name).items()} == {
            k: np.asarray(v).shape for k, v in getattr(jidx, name).items()}
    for f in ("center_ids", "assignment", "radii"):
        np.testing.assert_array_equal(getattr(own, f).numpy(), np.asarray(getattr(jidx, f)))


def test_index_from_arrays_refuses_missing_arrays(data):
    arrays = jaccard_index_arrays(_built(data)[0])
    arrays["sorted_hash"] = None
    with pytest.raises(DataError, match="sorted_hash"):
        tj.jaccard_index_from_arrays(arrays, TConfig(**CFG), device="cpu")


# ---------------------------------------------------------------------------
# the search


def _jax_queries(jidx, q):
    family = jj.jaccard_table_family(jidx.table_hash, U)
    source = JSource(family, CFG["num_tables"], CFG["max_hashbits"])
    source.params = jidx.hash_params
    qt = jnp.asarray(q)
    bits = jj.jaccard_sketch_family(jidx.sketch_hash, U).hash(jidx.sketch_params, qt)
    from clann_tpu.ops.sketches import pack_bits_u32

    return qt, source.hash(qt), pack_bits_u32(bits.reshape(qt.shape[0], 32, 64))


@pytest.mark.parametrize("filter_type", ["default", "none"])
@pytest.mark.parametrize("mapped", [True, False], ids=["mapped", "unmapped"])
@pytest.mark.parametrize("clustered", [False, True], ids=["flat", "clustered"])
def test_jaccard_search_matches_jax(data, clustered, mapped, filter_type):
    jidx, tidx = _built(data, clustered)
    if mapped:
        js, ji, jst = jj.jaccard_search(jidx, data["q"], filter_type=filter_type)
        ts, ti, tst = tj.jaccard_search(tidx, data["q"], filter_type=filter_type)
    else:
        kw = dict(k=5, chunk=64, filter_type=filter_type, filter_expand=4)
        js, ji, jst = jj.jaccard_search_batch(jidx, *_jax_queries(jidx, data["q"]),
                                              jnp.float32(0.8), **kw)
        qt = torch.from_numpy(data["q"])
        ts, ti, tst = tj.jaccard_search_batch(tidx, qt, *tj.hash_queries(tidx, qt), 0.8, **kw)
        ts, ti = ts.numpy(), ti.numpy()
        tst = tj.SearchStats(*(f.numpy() for f in tst))
    assert ti.dtype == np.int32 and ts.shape == (24, 5)
    assert_topk_match(np.asarray(ji), np.asarray(js), ti, ts, atol=0.0)
    for f, want in _stats(jst).items():
        np.testing.assert_array_equal(getattr(tst, f), want, err_msg=f)


@pytest.mark.parametrize("table_hash", ["1bit_minhash", "tabulation_minhash"])
def test_jaccard_search_table_hashes_match_jax(data, table_hash):
    jidx, tidx = _built(data, False, table_hash)
    js, ji, jst = jj.jaccard_search(jidx, data["q"])
    ts, ti, tst = tj.jaccard_search(tidx, data["q"])
    assert_topk_match(np.asarray(ji), np.asarray(js), ti, ts, atol=0.0)
    for f, want in _stats(jst).items():
        np.testing.assert_array_equal(getattr(tst, f), want, err_msg=f)


@pytest.mark.parametrize("knob", [dict(dead_block_routing=False), dict(stream_map_blocks=1),
                                  dict(stream_map=False)])
def test_jaccard_search_knobs_do_not_change_results(data, knob):
    """Routing, a map too short for the deepest cursors and no map at all
    give the JAX results (which do not depend on them)."""
    jidx, tidx = _built(data, True)
    js, ji, jst = jj.jaccard_search(jidx, data["q"])
    t = dataclasses.replace(tidx, config=tidx.config.replace(**knob))
    ls = tj.LoopStats()
    ts, ti, tst = tj.jaccard_search(t, data["q"], loop_stats=ls)
    assert_topk_match(np.asarray(ji), np.asarray(js), ti, ts, atol=0.0)
    for f, want in _stats(jst).items():
        np.testing.assert_array_equal(getattr(tst, f), want, err_msg=f)
    assert ls.batches == 1 and ls.iterations >= 1


def test_clustered_equals_flat_and_uses_k7_plainly(data):
    """The ball filter only prunes: clustered ids and similarities are the
    flat index's; records without packing are packed for the call; CPU
    tensors take K7's plain version (no launch counted)."""
    _, flat = _built(data, False)
    _, clus = _built(data, True)
    launches = tg.ROWS_LAUNCHES
    fs, fi, fst = tj.jaccard_search(flat, data["q"])
    cs, ci, cst = tj.jaccard_search(clus, data["q"])
    assert tg.ROWS_LAUNCHES == launches
    np.testing.assert_array_equal(ci, fi)
    np.testing.assert_array_equal(cs, fs)
    assert (cst.distance_computations <= fst.distance_computations).all()
    ns, ni, _ = tj.jaccard_search(dataclasses.replace(clus, g_records=None), data["q"])
    np.testing.assert_array_equal(ni, ci)


@pytest.mark.parametrize("k,block", [(5, 0), (9, 128), (700, 1024)])
def test_jaccard_scan_matches_jax(data, k, block):
    """The exact scan: equal to JAX's (k past n pads with -inf / -1) and,
    below n, to the brute force."""
    jidx, tidx = _built(data)
    js, ji, jst = jj.jaccard_scan(jidx, data["q"], k=k, block=block)
    ts, ti, tst = tj.jaccard_scan(tidx, data["q"], k=k, block=block)
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    for f, want in _stats(jst).items():
        np.testing.assert_array_equal(getattr(tst, f), want, err_msg=f)
    if k < 600:
        bs, bi = tsd.brute_force_jaccard_topk(data["tdata"], data["q"], k, device="cpu")
        np.testing.assert_array_equal(ti, bi)


def test_own_build_meets_the_delta_contract():
    """The port's own draws on a bigger corpus: threshold recall@10 (the
    exact Jaccard of the returned ids against the true 10th, less 1e-3, as
    scripts/jaccard_baseline.py) >= 0.8 * delta, flat and clustered with
    equal ids, the clustered index computing no more distances."""
    sets = tsyn.clustered_sets(1500, 4000, avg_size=24, n_modes=40, core_share=0.8, seed=0)
    qsets = tsyn.clustered_sets(40, 4000, avg_size=24, n_modes=40, core_share=0.8, seed=1)
    tdata = tsd.JaccardData(sets, 4000)
    q = tsd.pad_sets(qsets, 4000, tdata.tokens.shape[1])
    # 8 sketches of 64 bits (the default 32) keep the build's hashing small
    cfg = TConfig(num_tables=20, k=10, delta=0.9, num_clusters_factor=0.4, num_sketches=8,
                  seed=0)
    gt_s, _ = tsd.brute_force_jaccard_topk(tdata, q, 10, device="cpu")
    ids = {}
    for clustered in (False, True):
        idx = tj.build_jaccard_index(tdata, cfg, clustered=clustered, device="cpu")
        s, i, st = tj.jaccard_search(idx, q)
        got = tsd.jaccard_similarity_rowwise(
            tdata.tokens[np.maximum(i, 0).reshape(-1)], np.repeat(q, 10, axis=0),
            device="cpu").numpy().reshape(i.shape)
        recall = float(np.mean(np.where(i >= 0, got, -1.0) >= gt_s[:, 9:10] - 1e-3))
        print(f"clustered={clustered}: threshold recall@10 {recall:.4f}, dc/query "
              f"{st.distance_computations.mean():.0f}")
        assert recall >= 0.8 * 0.9
        np.testing.assert_array_equal(s, np.where(i >= 0, got, 0.0))
        ids[clustered] = i, st.distance_computations
    np.testing.assert_array_equal(ids[True][0], ids[False][0])
    assert (ids[True][1] <= ids[False][1]).all()

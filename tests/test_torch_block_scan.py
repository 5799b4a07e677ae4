"""The block-probed scan (ops/block_scan.py) against the JAX package's
clann_tpu.ops.pallas.block_scan run with interpret=True, on the CPU, at the
shapes of tests/test_block_scan.py (8,192 x 32, block_n 512, q_tile 64).

The layout's random draws differ between the packages (torch.Generator vs
jax.random), so every comparison that depends on them runs on a JAX layout
carried across with layout_from_arrays; the port's own layout is held to the
JAX layout's draw-free fields and to the JAX tests' recall bars.

Tolerances: K3's plain version vs the JAX pallas_call >= 99% same winner row
on live slots and decoded values within one quantization step (pg * 2^-22)
+ 1e-6 (the two CPU products sum the same exact bf16 products in another
order); end to end sims within 1e-5, ids per query as sets up to boundary
ties, dc exact, uncertified exact except where a block's bound lies within
1e-5 of the k-th similarity; centroids and radii within 1e-6.

The CUDA kernel itself has no CPU mode; chip_smoke.py holds it against the
plain version on the card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import clann_tpu
from clann_tpu.config import Config as JConfig
from clann_tpu.ops import ivf as jivf
from clann_tpu.ops.gmm import greedy_minimum_maximum as jgmm
from clann_tpu.ops.pallas import block_scan as jbs
from clann_tpu.ops.pallas.scan_topk import _scan_kernel_packed

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.index import GEOMETRY_FIELDS, index_from_arrays
from clann_tpu_torch.data.synthetic import clustered_unit_vectors
from clann_tpu_torch.metrics.recall import recall_by_ids
from clann_tpu_torch.ops import block_scan as tbs
from clann_tpu_torch.ops import ivf as tivf
from clann_tpu_torch.ops.distances import brute_force_topk
from clann_tpu_torch.testing import assert_topk_match, packed_agreement, quant_step

torch.set_num_threads(1)

BLOCK_N, Q_TILE = 512, 64


def _copy_layout(jlay, block_n=BLOCK_N):
    return tbs.layout_from_arrays(
        {f: np.asarray(getattr(jlay, f)) for f in tbs.LAYOUT_FIELDS}, block_n, "cpu")


@pytest.fixture(scope="module")
def small_world():
    x = clustered_unit_vectors(8192, 32, n_modes=16, seed=0)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = clustered_unit_vectors(200, 32, n_modes=16, seed=1)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    _, assign, _ = jgmm(jnp.asarray(x), 40)
    assign = np.asarray(assign)
    jlay = jbs.build_block_layout(x, assign, BLOCK_N)
    own = tbs.build_block_layout(x, assign, BLOCK_N, device="cpu")
    _, gt = brute_force_topk(x, qn, k=10, device="cpu")
    return x, qn, assign, jlay, _copy_layout(jlay), own, gt.numpy()


def _recall(ids, gt):
    return recall_by_ids(gt, np.asarray(ids), gt.shape[1])


# ---------------------------------------------------------------- layout


def test_layout_draw_free_fields_match_jax(small_world):
    x, _, _, jlay, _, own, _ = small_world
    assert own.n_blocks == jlay.n_blocks == 16 and own.d == jlay.d == 32
    assert own.block_n == BLOCK_N
    np.testing.assert_array_equal(own.block_rows.numpy(), np.asarray(jlay.block_rows))
    np.testing.assert_allclose(own.centroids.numpy(), np.asarray(jlay.centroids), atol=1e-6)
    np.testing.assert_allclose(own.radii.numpy(), np.asarray(jlay.radii), atol=1e-6)
    tg = own.gids.numpy().reshape(16, BLOCK_N)
    jg = np.asarray(jlay.gids).reshape(16, BLOCK_N)
    for b in range(16):  # same members per block, in another shuffled order
        assert set(tg[b].tolist()) == set(jg[b].tolist()), b
    # the stable cluster-major cut: block b holds the rows
    # [b * block_n, (b + 1) * block_n) of the stable argsort of the assignment
    order = np.argsort(small_world[2], kind="stable")
    for b in range(16):
        assert set(tg[b].tolist()) == set(order[b * BLOCK_N : (b + 1) * BLOCK_N].tolist())


def test_layout_rows_and_bias_column(small_world):
    x, _, _, _, _, own, _ = small_world
    gids = own.gids.numpy()
    real = gids >= 0
    assert sorted(gids[real].tolist()) == list(range(8192))
    np.testing.assert_array_equal(own.base_f32.numpy()[real], x[gids[real]])
    assert (own.base_f32.numpy()[~real] == 0).all()
    bb = own.base_bf16.float().numpy()
    assert bb.shape == (8192, 128) and own.base_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bb[:, :32], own.base_f32.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(bb[:, 32], real.astype(np.float32))
    assert (bb[:, 33:] == 0).all()
    # every member lies inside its block's centroid ball
    xb = own.base_f32.numpy().reshape(16, BLOCK_N, 32)
    dist = np.linalg.norm(xb - own.centroids.numpy()[:, None, :], axis=-1)
    assert (np.where(real.reshape(16, BLOCK_N), dist, 0) <= own.radii.numpy()[:, None] + 1e-5).all()


def test_layout_reps_are_real_rows_of_their_block(small_world):
    x, _, _, _, _, own, _ = small_world
    gids = own.gids.numpy().reshape(16, BLOCK_N)
    reps = own.reps.numpy()
    assert reps.shape == (16, 64, 32)
    for b in range(16):
        members = x[gids[b][gids[b] >= 0]]
        d2 = ((reps[b][:, None, :] - members[None, :, :]) ** 2).sum(-1)
        assert d2.min(axis=1).max() == 0.0, b


def test_layout_draws_follow_the_seed(small_world):
    x, _, assign, _, _, own, _ = small_world
    again = tbs.build_block_layout(x, assign, BLOCK_N, device="cpu")
    other = tbs.build_block_layout(x, assign, BLOCK_N, seed=5, device="cpu")
    for f in tbs.LAYOUT_FIELDS:
        assert torch.equal(getattr(again, f), getattr(own, f)), f
    assert not torch.equal(other.reps, own.reps)
    assert not torch.equal(other.gids, own.gids)
    assert torch.equal(other.block_rows, own.block_rows)
    np.testing.assert_allclose(other.radii.numpy(), own.radii.numpy(), atol=1e-6)


def test_layout_from_arrays_carries_the_jax_layout(small_world):
    _, _, _, jlay, lay, _, _ = small_world
    for f in tbs.LAYOUT_FIELDS:
        np.testing.assert_array_equal(
            getattr(lay, f).float().numpy(),
            np.asarray(getattr(jlay, f)).astype(np.float32), err_msg=f)
    assert lay.base_bf16.dtype == torch.bfloat16 and lay.gids.dtype == torch.int32
    assert (lay.block_n, lay.d, lay.n_blocks) == (BLOCK_N, 32, 16)
    with pytest.raises(ValueError, match="missing"):
        tbs.layout_from_arrays({"gids": np.zeros(4)}, BLOCK_N, "cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 37, 153, 400])
def test_auto_block_probe_is_the_jax_rule(n):
    assert tbs.auto_block_probe(n) == jbs.auto_block_probe(n)
    assert tbs._VALID_FLOOR == int(jbs._valid_floor())


# ---------------------------------------------------------------- K3


def _operands(lay, qn, B, q_tile=Q_TILE):
    qt = tbs._normalize_queries(torch.from_numpy(qn))
    wants, _ = tbs.rank_blocks(lay, qt, B)
    ipos, tile_block, qg, _ = tbs.pair_tiles(wants, qt, n_blocks=lay.n_blocks,
                                             q_tile=q_tile, dpad=lay.base_bf16.shape[1])
    return qt, wants, ipos, tile_block, qg


def _jax_k3(tile_block, qg, base_bf16, *, num_bins, block_n, q_tile):
    """The pallas_call of the JAX block_scan_topk_e2e, on given operands."""
    kernel = functools.partial(_scan_kernel_packed, nb=num_bins, block_n=block_n,
                               biased=True)

    def wrapped(tb_ref, q_ref, b_ref, out_ref):
        del tb_ref
        kernel(q_ref, b_ref, out_ref)

    T, dpad = tile_block.shape[0], qg.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(T,),
        in_specs=[pl.BlockSpec((q_tile, dpad), lambda i, tb: (i, 0)),
                  pl.BlockSpec((block_n, dpad), lambda i, tb: (tb[i], 0))],
        out_specs=pl.BlockSpec((num_bins, q_tile), lambda i, tb: (i, 0)),
    )
    out = pl.pallas_call(
        wrapped, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T * num_bins, q_tile), jnp.int32),
        interpret=True,
    )(jnp.asarray(tile_block.numpy()), jnp.asarray(qg.float().numpy(), jnp.bfloat16),
      base_bf16)
    return np.asarray(out)


@pytest.mark.parametrize("num_bins,B", [(128, 2), (512, 8), (32, 3)])
def test_k3_plain_vs_jax_kernel(small_world, num_bins, B):
    _, qn, _, jlay, lay, _, _ = small_world
    _, _, _, tile_block, qg = _operands(lay, qn[:90], B)
    per_bin = BLOCK_N // num_bins
    got = tbs.block_scan_candidates_packed(lay.base_bf16, qg, tile_block,
                                           block_n=BLOCK_N, q_tile=Q_TILE, per_bin=per_bin)
    ref = _jax_k3(tile_block, qg, jlay.base_bf16, num_bins=num_bins, block_n=BLOCK_N,
                  q_tile=Q_TILE)
    assert got.shape == ref.shape == (tile_block.shape[0] * num_bins, Q_TILE)
    got = got.numpy()
    live = ref >= tbs._VALID_FLOOR
    np.testing.assert_array_equal(got >= tbs._VALID_FLOOR, live)
    assert 0 < live.mean() < 1  # dead slots and trailing tiles are present
    agree = packed_agreement(got[live], ref[live], per_bin)
    assert agree["same_winner"] >= 0.99, agree
    assert agree["max_abs_err"] <= quant_step(per_bin) + 1e-6, agree


@pytest.mark.parametrize("B", [1, 3, 16])
def test_pair_tiles_bookkeeping(small_world, B):
    _, qn, _, _, lay, _, _ = small_world
    Q = 150
    qt, wants, ipos, tile_block, qg = _operands(lay, qn[:Q], B)
    T = Q * B // Q_TILE + 16
    assert tile_block.shape == (T,) and qg.shape == (T * Q_TILE, 128)
    assert tile_block.dtype == torch.int32 and qg.dtype == torch.bfloat16
    slots = ipos.numpy()
    assert len(np.unique(slots)) == Q * B  # every pair has its own slot
    tiles = tile_block.numpy()
    # each pair's slot lies in a tile that streams the pair's block
    np.testing.assert_array_equal(tiles[slots // Q_TILE], wants.numpy())
    assert (np.diff(tiles) >= 0).all()  # tiles sorted by block
    g = qg.float().numpy()
    live = np.zeros(T * Q_TILE, bool)
    live[slots.ravel()] = True
    np.testing.assert_array_equal(g[:, 32], np.where(live, 3.0, 0.0))
    assert (g[~live] == 0).all()
    qb = qt.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(g[slots, :32], np.broadcast_to(qb[:, None, :], (Q, B, 32)))


@pytest.mark.parametrize("Q,B,q_tile", [(150, 1, Q_TILE), (150, 3, Q_TILE), (150, 16, Q_TILE),
                                        (77, 2, 32), (200, 5, 128)])
def test_pair_tiles_tile_live_counts_live_slots(small_world, Q, B, q_tile):
    """tile_live[t] is the count of tile t's live slots (slot_q >= 0, the
    slots some pair owns), and they are the tile's first tile_live[t]."""
    _, qn, _, _, lay, _, _ = small_world
    qt = tbs._normalize_queries(torch.from_numpy(qn[:Q]))
    wants, _ = tbs.rank_blocks(lay, qt, B)
    ipos, tile_block, qg, tile_live = tbs.pair_tiles(
        wants, qt, n_blocks=lay.n_blocks, q_tile=q_tile, dpad=lay.base_bf16.shape[1])
    T = tile_block.shape[0]
    assert tile_live.dtype == torch.int32 and tile_live.shape == (T,)
    live = np.zeros(T * q_tile, bool)
    live[ipos.numpy().ravel()] = True
    per_tile = live.reshape(T, q_tile)
    np.testing.assert_array_equal(tile_live.numpy(), per_tile.sum(axis=1))
    prefix = np.arange(q_tile)[None, :] < tile_live.numpy()[:, None]
    np.testing.assert_array_equal(per_tile, prefix)
    # the bias column agrees: 3.0 exactly on live slots
    np.testing.assert_array_equal(qg.float().numpy()[:, 32] == 3.0, live)
    assert tile_live.numpy()[-1] == 0  # the bound T leaves tiles past the last run


@pytest.mark.parametrize("num_bins", [512, 128, 16, 1])
def test_k3_plain_gives_dead_slots_the_skipped_winner(small_world, num_bins):
    """Every dead slot's winner in the plain version is the constant the
    kernel writes for the groups of slots it skips, and so is every winner
    of a block outside the base."""
    _, qn, _, _, lay, _, _ = small_world
    per_bin = BLOCK_N // num_bins
    qt = tbs._normalize_queries(torch.from_numpy(qn[:90]))
    wants, _ = tbs.rank_blocks(lay, qt, 3)
    _, tile_block, qg, tile_live = tbs.pair_tiles(
        wants, qt, n_blocks=lay.n_blocks, q_tile=Q_TILE, dpad=lay.base_bf16.shape[1])
    tile_block = torch.cat([tile_block, tile_block.new_tensor([-1, lay.n_blocks])])
    tile_live = torch.cat([tile_live, tile_live.new_tensor([Q_TILE, Q_TILE])])
    qg = torch.cat([qg, qg[:Q_TILE], qg[:Q_TILE]])
    out = tbs.block_scan_candidates_packed(lay.base_bf16, qg, tile_block, block_n=BLOCK_N,
                                           q_tile=Q_TILE, per_bin=per_bin, tile_live=tile_live)
    out = out.numpy().reshape(tile_block.shape[0], num_bins, Q_TILE)
    slot = np.arange(Q_TILE)[None, None, :]
    dead = np.broadcast_to(slot >= tile_live.numpy()[:, None, None], out.shape).copy()
    dead[-2:] = True  # blocks -1 and n_blocks hold no rows
    assert dead.any() and (~dead).any()
    assert (out[dead] == tbs.dead_slot_winner(per_bin)).all()
    assert (out[~dead] >= tbs._VALID_FLOOR).all()


def test_k3_plain_reads_out_of_range_blocks_as_zero(small_world):
    _, qn, _, _, lay, _, _ = small_world
    _, _, _, _, qg = _operands(lay, qn[:64], 1)
    qg = qg[:2 * Q_TILE]
    out = tbs.block_candidates_plain(lay.base_bf16, qg, torch.tensor([-1, 16], dtype=torch.int32),
                                     block_n=BLOCK_N, q_tile=Q_TILE, per_bin=4)
    # every score is 0.0: each bin's winner is its last row, below the floor
    assert (out == 3).all()


def test_k3_wrapper_keeps_cpu_off_the_counter(small_world):
    _, qn, _, _, lay, _, _ = small_world
    _, _, _, tile_block, qg = _operands(lay, qn[:40], 2)
    before = tbs.KERNEL_LAUNCHES
    tbs.block_scan_candidates_packed(lay.base_bf16, qg, tile_block, block_n=BLOCK_N,
                                     q_tile=Q_TILE, per_bin=4)
    assert tbs.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "table_dtype", "tiles", "per_bin", "device",
                                  "live_dtype", "live_shape", "tma_base_rows",
                                  "tma_query_rows"])
def test_k3_wrapper_rejects_bad_input(case):
    b = torch.zeros((1024, 128), dtype=torch.bfloat16)
    q = torch.zeros((2 * Q_TILE, 128), dtype=torch.bfloat16)
    tb = torch.zeros(2, dtype=torch.int32)
    kw = dict(block_n=BLOCK_N, q_tile=Q_TILE, per_bin=4)
    if case == "live_dtype":
        kw["tile_live"] = torch.zeros(2, dtype=torch.int64)
    elif case == "live_shape":
        kw["tile_live"] = torch.zeros(3, dtype=torch.int32)
    elif case == "tma_base_rows":  # TMA row coordinates are int32
        b = torch.empty(((1 << 31) - 256, 128), dtype=torch.bfloat16, device="meta")
        q, tb = q.to("meta"), tb.to("meta")
    elif case == "tma_query_rows":
        kw["q_tile"] = 1 << 30
        q = torch.empty((2 << 30, 128), dtype=torch.bfloat16, device="meta")
        b, tb = b.to("meta"), tb.to("meta")
    elif case == "dtype":
        q = q.float()
    elif case == "table_dtype":
        tb = tb.long()
    elif case == "tiles":
        tb = torch.zeros(3, dtype=torch.int32)
    elif case == "per_bin":
        kw["per_bin"] = 6
    else:  # neither CPU nor CUDA: no silent plain-version fallback
        b, q, tb = b.to("meta"), q.to("meta"), tb.to("meta")
    with pytest.raises(ValueError, match="TMA" if case.startswith("tma") else None):
        tbs.block_scan_candidates_packed(b, q, tb, **kw)


# ---------------------------------------------------------------- e2e


@pytest.mark.parametrize("num_bins,B", [(128, 2), (128, 8), (128, 16), (512, 8)])
def test_e2e_vs_jax(small_world, num_bins, B):
    _, qn, _, jlay, lay, _, _ = small_world
    kw = dict(k=10, n_probe=B, rescore_m=64, num_bins=num_bins, block_n=BLOCK_N,
              q_tile=Q_TILE)
    js, ji, jdc, junc = jbs.block_scan_topk_e2e(jlay, jnp.asarray(qn * 2.0),
                                                interpret=True, **kw)
    ts, ti, tdc, tunc = tbs.block_scan_topk_e2e(lay, torch.from_numpy(qn * 2.0), **kw)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int64
    assert_topk_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy())
    np.testing.assert_array_equal(tdc.numpy(), np.asarray(jdc))
    # the certificate counts may differ only where a bound ties the k-th sim
    qt = torch.from_numpy(qn)
    ub = (qt @ lay.centroids.T + lay.radii).numpy()
    near = np.abs(ub - ts.numpy()[:, -1:]).min(axis=1) < 1e-5
    diff = tunc.numpy() != np.asarray(junc)
    assert not (diff & ~near).any(), np.nonzero(diff & ~near)


def test_e2e_own_layout_recall_scales_with_probes(small_world):
    """The JAX test's bars on the port's own layout."""
    _, qn, _, _, _, own, gt = small_world
    recalls = []
    for B in (2, 8, 16):
        _, ids, dc, _ = tbs.block_scan_topk_e2e(
            own, torch.from_numpy(qn), k=10, n_probe=B, rescore_m=64, num_bins=128,
            block_n=BLOCK_N, q_tile=Q_TILE)
        recalls.append(_recall(ids.numpy(), gt))
        assert (dc.numpy() == B * BLOCK_N).all()
    assert recalls[0] < recalls[-1]
    assert recalls[1] >= 0.9 and recalls[2] >= 0.95, recalls


def test_e2e_full_probe_certifies_with_exact_values(small_world):
    x, qn, _, _, _, own, _ = small_world
    sims, ids, _, unc = tbs.block_scan_topk_e2e(
        own, torch.from_numpy(qn), k=10, n_probe=16, rescore_m=64, num_bins=128,
        block_n=BLOCK_N, q_tile=Q_TILE)
    sims, ids = sims.numpy(), ids.numpy()
    assert (unc.numpy() == 0).all()
    np.testing.assert_allclose(sims, np.einsum("qd,qkd->qk", qn, x[ids]), atol=1e-5)
    assert (np.diff(sims, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("B", [8, 16])
def test_e2e_certified_queries_are_exact(small_world, B):
    """per_bin 1 has no binning loss, so a certified query is exact."""
    _, qn, _, _, _, own, gt = small_world
    _, ids, _, unc = tbs.block_scan_topk_e2e(
        own, torch.from_numpy(qn), k=10, n_probe=B, rescore_m=64, num_bins=512,
        block_n=BLOCK_N, q_tile=Q_TILE)
    ids, unc = ids.numpy(), unc.numpy()
    if B == 16:
        assert (unc == 0).all()  # every block probed
    for qi in np.nonzero(unc == 0)[0]:
        assert set(ids[qi]) == set(gt[qi]), qi


# ------------------------------------------------------ index level and facade

CFG = dict(num_tables=2, num_clusters_factor=0.5, k=10, delta=0.9,
           dataset_name="bs", dense_layout=False, seed=3)


def _plan_512(n, k, d=None):
    """A plan with several 512-row blocks at these small n."""
    del n, d
    return 512, 128, max(64, k), 64


@pytest.fixture(scope="module")
def index_world():
    data = clustered_unit_vectors(6000, 32, n_modes=12, seed=3)
    q = clustered_unit_vectors(64, 32, n_modes=12, seed=4)
    jidx = clann_tpu.init_with_config(data, JConfig(**CFG)).build().index
    tidx = index_from_arrays({f: np.asarray(getattr(jidx, f)) for f in GEOMETRY_FIELDS},
                             TConfig(**CFG), device="cpu")
    # the port's index searches the JAX index's layout (its cache holds it)
    tidx.block_layout_cache[(id(tidx.vectors), 512)] = (
        tidx.vectors, _copy_layout(jbs.get_block_layout(jidx, 512)))
    return data, q, jidx, tidx


def _assert_search_match(j, t):
    (jd, ji, js), (td, ti, ts) = j, t
    assert ti.dtype == np.int32 and td.shape == jd.shape
    assert_topk_match(ji, jd, ti, td)
    for f in ("distance_computations", "clusters_visited"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    return ts


@pytest.mark.parametrize("n_probe", [None, 1, 5])
def test_block_scan_search_vs_jax(index_world, n_probe):
    _, q, jidx, tidx = index_world
    kw = dict(k=10, n_probe=n_probe, block_n=512, batch_q=40)
    ts = _assert_search_match(jbs.block_scan_search(jidx, q, interpret=True, **kw),
                              tbs.block_scan_search(tidx, q, **kw))
    B = n_probe or tbs.auto_block_probe(12)
    assert (ts.clusters_visited == B).all()
    assert tbs.get_block_layout(tidx, 512) is tidx.block_layout_cache[
        (id(tidx.vectors), 512)][1]  # served from the cache


@pytest.mark.parametrize("n_probe0", [None, 2])
def test_block_scan_search_adaptive_vs_jax(index_world, monkeypatch, n_probe0):
    """Both packages run every round at the plan's block_n, so the plan is
    pinned to 512-row blocks here: then block_n means the same to both."""
    data, q, jidx, tidx = index_world
    monkeypatch.setattr(jivf, "pallas_scan_plan", _plan_512)
    monkeypatch.setattr(tivf, "pallas_scan_plan", _plan_512)
    kw = dict(k=10, n_probe0=n_probe0, block_n=512)
    j = jbs.block_scan_search_adaptive(jidx, q, interpret=True, **kw)
    t = tbs.block_scan_search_adaptive(tidx, q, **kw)
    ts = _assert_search_match(j, t)
    np.testing.assert_array_equal(ts.uncertified, j[2].uncertified)
    assert ((ts.uncertified == 0) | (ts.clusters_visited == 12)).all()
    assert (ts.clusters_visited >= (n_probe0 or 2)).all()
    _, gt = brute_force_topk(data, q, k=10, device="cpu")
    assert recall_by_ids(gt.numpy(), t[1], 10) >= 0.9


@pytest.mark.parametrize("mode", ["scan-block", "scan-block-adaptive"])
def test_facade_block_modes_match_jax(index_world, monkeypatch, mode):
    data, q, jidx, tidx = index_world
    monkeypatch.setattr(jivf, "pallas_scan_plan", _plan_512)
    monkeypatch.setattr(tivf, "pallas_scan_plan", _plan_512)
    j = clann_tpu.init_with_config(data, JConfig(**CFG))
    j.index = jidx
    t = clann_tpu_torch.init_with_config(data, TConfig(**CFG), device="cpu")
    t.index = tidx
    _assert_search_match(j.search_batch(q, mode=mode, n_probe=3),
                         t.search_batch(q, mode=mode, n_probe=3))


@pytest.fixture(scope="module")
def own_handle():
    data = clustered_unit_vectors(4096, 32, n_modes=16, seed=3)
    cfg = TConfig(num_tables=4, k=10, num_clusters_factor=0.5, dataset_name="bs")
    return data, clann_tpu_torch.init_with_config(data, cfg, device="cpu").build()


def test_facade_scan_block_recall_on_own_layout(own_handle):
    data, h = own_handle
    q = clustered_unit_vectors(32, 32, n_modes=16, seed=4)
    d, i, st = h.search_batch(q, mode="scan-block")
    _, gt = brute_force_topk(h.index.vectors, q, k=10, device="cpu")
    assert recall_by_ids(gt.numpy(), i, 10) >= 0.95
    assert d.shape == (32, 10) and (np.diff(d, axis=1) >= -1e-6).all()
    assert st.distance_computations.shape == (32,)


def test_facade_n_probe_is_honoured(own_handle, monkeypatch):
    data, h = own_handle
    monkeypatch.setattr(tivf, "pallas_scan_plan", _plan_512)
    q = clustered_unit_vectors(16, 32, n_modes=16, seed=6)
    _, _, st = h.search_batch(q, mode="scan-block", n_probe=3)
    assert (st.clusters_visited == 3).all()
    assert (st.distance_computations == 3 * 512).all()  # 8 full blocks
    _, _, st = h.search_batch(q, mode="scan-block-adaptive", n_probe=3)
    assert (st.clusters_visited >= 3).all()
    assert ((st.uncertified == 0) | (st.clusters_visited == 8)).all()


def test_single_query_and_overshoot(own_handle):
    data, h = own_handle
    d, i, _ = tbs.block_scan_search(h.index, data[3], k=5)
    assert i[0, 0] == 3 and d[0, 0] < 1e-5
    d2, i2, st = tbs.block_scan_search(h.index, data[:4], k=5, n_probe=10**6)
    assert i2.shape == (4, 5) and (st.clusters_visited == 1).all()
    assert (i2[:, 0] == np.arange(4)).all()

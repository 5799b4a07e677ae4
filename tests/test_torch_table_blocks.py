"""The build's table passes in blocks of tables (ops/prefixmap
.sort_tables_segmented, core/index.make_global_tables, in blocks of
prefixmap.TABLE_BLOCK tables) and the δ engines' scale counters
(LoopStats.unmapped_iterations, LoopStats.lanes), on the CPU.

A block of a few tables (TABLE_BLOCK set to 3 or 5 of L = 16, so the last
block is short) at 20,011 x 96 (n not a multiple of gather_block 32) builds the
one-block index bit for bit, in every array of ClusteredIndex: the global,
the clustered (slot records, dense layout) and the int8 index, through
insert / rebuild and the sharded build too. The blocked index answers as
the one-block index does, and its recall against the plain exact k-NN of
benchmark/reference clears the PUFFINN contract 0.8 * delta.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference.knn import exact_knn, recall_matches
from clann_tpu_torch.config import Config
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.data.synthetic import clustered_unit_vectors
from clann_tpu_torch.metrics.trace import LoopStats
from clann_tpu_torch.ops import global_query as tgq
from clann_tpu_torch.ops import prefixmap as tpm
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

N, D, Q = 20_011, 96, 96
BASE = dict(num_tables=16, num_clusters_factor=0.4, k=10, delta=0.95, seed=0, gather_block=32,
            candidate_chunk=256, filter_expand=8, dense_layout=False)
KINDS = {
    "global": dict(lsh_engine="global"),
    "clustered": dict(lsh_engine="clustered", pack_slot_records=True, dense_layout=True),
    "int8": dict(lsh_engine="both", rescore_dtype="int8"),
}
DERIVED = ("pallas_base_cache", "block_layout_cache")


@pytest.fixture(scope="module")
def data():
    x = clustered_unit_vectors(N + Q, D, n_modes=48, spread=0.7, seed=11)
    return x[:N], x[N:]


ONE_BLOCK = 1 << 30


@pytest.fixture(scope="module")
def one_block(data):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpm, "TABLE_BLOCK", ONE_BLOCK)
        return {kind: tindex.build_index(data[0], Config(**{**BASE, **extra}), device="cpu")
                for kind, extra in KINDS.items()}


def _same_index(a, b):
    """Every field of two ClusteredIndexes equal, tensors bit for bit."""
    for f in dataclasses.fields(a):
        if f.name in DERIVED:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif isinstance(x, dict):
            assert sorted(x) == sorted(y), f.name
            assert all(torch.equal(x[k], y[k]) for k in x), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", list(KINDS))
def test_blocked_build_equals_one_block(data, one_block, kind, monkeypatch):
    monkeypatch.setattr(tpm, "TABLE_BLOCK", 3)
    blocked = tindex.build_index(data[0], Config(**{**BASE, **KINDS[kind]}), device="cpu")
    _same_index(blocked, one_block[kind])
    assert blocked.n % BASE["gather_block"] and blocked.num_tables == 16
    if blocked.g_records is not None:  # padded in place: zero records past n
        assert blocked.g_records.shape[1] % BASE["gather_block"] == 0
        assert not blocked.g_records[:, N:].any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_blocked_rebuild_equals_one_block(data, kind, monkeypatch):
    cfg = Config(**{**BASE, **KINDS[kind]})
    monkeypatch.setattr(tpm, "TABLE_BLOCK", 5)
    old = tindex.build_index(data[0][:15_000], cfg, device="cpu")
    pending = tindex.insert(old, data[0][15_000:])
    blocked = tindex.rebuild(pending)
    assert blocked.num_pending == 0 and blocked.n == N
    monkeypatch.setattr(tpm, "TABLE_BLOCK", ONE_BLOCK)
    _same_index(blocked, tindex.rebuild(pending))


def test_blocked_sharded_build_equals_one_block(data, monkeypatch):
    """build_sharded's shards sort and gather in the same blocks."""
    cfg = Config(**{**BASE, **KINDS["global"]})
    mesh = tmesh.make_mesh(2, devices=["cpu"] * 2)
    monkeypatch.setattr(tpm, "TABLE_BLOCK", ONE_BLOCK)
    want = tsh.build_sharded(data[0], cfg, mesh=mesh)
    passes = []
    blocks_of = tpm.table_blocks

    def counted(num_tables):
        passes.append(blocks_of(num_tables))
        return passes[-1]

    monkeypatch.setattr(tpm, "TABLE_BLOCK", 3)
    monkeypatch.setattr(tpm, "table_blocks", counted)
    monkeypatch.setattr(tindex, "table_blocks", counted)
    got = tsh.build_sharded(data[0], cfg, mesh=mesh)
    # two passes (sort, global tables) a shard, each in 6 blocks
    assert [len(p) for p in passes] == [6] * 4
    for f in ("sorted_hash", "sorted_idx", "g_sorted_hash", "g_records", "g_dir"):
        for x, y in zip(getattr(got, f), getattr(want, f)):
            assert torch.equal(x, y), f


def test_traced_build_reports_its_blocks(data, monkeypatch):
    """build/table_sort and build/global_tables wrap their blocked loops;
    each block is a build/table_block span."""
    from clann_tpu_torch.metrics import trace

    tracer = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "TRACER", tracer)
    monkeypatch.setattr(tpm, "TABLE_BLOCK", 3)
    tindex.build_index(data[0][:4000], Config(**{**BASE, **KINDS["global"]}), device="cpu")
    blocks = -(-BASE["num_tables"] // 3)
    assert tracer.counts["build/table_sort"] == tracer.counts["build/global_tables"] == 1
    assert tracer.counts["build/table_sort/build/table_block"] == blocks
    assert tracer.counts["build/global_tables/build/table_block"] == blocks
    assert tracer.named("build/table_block")[2] == 2 * blocks


def test_table_blocks(monkeypatch):
    """Blocks of TABLE_BLOCK tables cover every table once, in order; the
    last one may be short."""
    for L in (1, 7, 8, 16, 50, 128):
        blocks = tpm.table_blocks(L)
        assert len(blocks) == -(-L // tpm.TABLE_BLOCK)
        assert torch.cat([torch.arange(L)[b] for b in blocks]).tolist() == list(range(L))
    monkeypatch.setattr(tpm, "TABLE_BLOCK", 3)
    assert [torch.arange(16)[b].tolist()[0] for b in tpm.table_blocks(16)] == [0, 3, 6, 9, 12, 15]


def test_blocked_index_answers_as_one_block(data, one_block, monkeypatch):
    cfg = Config(**{**BASE, **KINDS["global"]})
    monkeypatch.setattr(tpm, "TABLE_BLOCK", 3)
    blocked = tindex.build_index(data[0], cfg, device="cpu")
    dists, ids, stats = tgq.global_search(blocked, data[1])
    want = tgq.global_search(one_block["global"], data[1])
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_array_equal(dists, want[0])
    true_d, _ = exact_knn(torch.as_tensor(data[0]), torch.as_tensor(data[1]), cfg.k)
    recall = recall_matches(true_d.numpy(), dists, cfg.k).sum() / (Q * cfg.k)
    assert recall >= 0.8 * cfg.delta, recall
    assert (stats.distance_computations < N).all()


def test_loop_stats_count_unmapped_iterations_and_lanes(data):
    # blocks of 8 slots: the queries' streams run past a map of 1,024 blocks
    cfg = Config(**{**BASE, **KINDS["global"], "gather_block": 8})
    index = tindex.build_index(data[0], cfg, device="cpu")
    full = LoopStats()
    want = tgq.global_search(index, data[1], loop_stats=full)
    assert full.unmapped_iterations == 0 < full.iterations  # every window in the map
    assert full.lanes == int(want[2].candidates.sum()) > 0
    # the map at the sizing rule's floor, 1,024 blocks, which the streams outrun
    short = index.replace(config=cfg.replace(stream_map_blocks=1))
    counted = LoopStats()
    got = tgq.global_search(short, data[1], loop_stats=counted)
    assert 0 < counted.unmapped_iterations < counted.iterations == full.iterations
    assert counted.lanes == int(got[2].candidates.sum()) == full.lanes
    for a, b in zip(got, want):  # the derivation gives the map's windows
        np.testing.assert_array_equal(a, b)
    # no map at all: every window derived in the loop
    unmapped = LoopStats()
    tgq.global_search(index.replace(config=cfg.replace(stream_map=False)), data[1],
                      loop_stats=unmapped)
    assert unmapped.unmapped_iterations == unmapped.iterations > 0

"""The SQLite metrics sink (metrics/schema, metrics/run, metrics/csv), the
facade's metrics run (Config(metrics_output=DB), reset_metrics,
save_metrics) and the capacity model (parallel/capacity.plan_capacity) of
the port against the JAX package's, on the CPU.

- plan_capacity: per-structure bytes, totals and the device counts equal
  JAX's for several (n, d, config), with hbm_bytes passed explicitly (the
  port's default is its card's, JAX's a TPU's).
- The same index and stats written by both packages give the same SQLite
  rows and CSV lines, leaving out times, timestamps and the commit hash;
  the port's stats may be device tensors (RunMetrics brings them over).
- metrics_output=DB through the port's facade: one build row whose
  memory_used_bytes is index.memory_usage(), one cluster row per cluster,
  one query row per query searched since reset_metrics.
"""

import csv
import sqlite3

import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.config import MetricsGranularity as JGran
from clann_tpu.core import index as jindex
from clann_tpu.metrics import csv as jcsv
from clann_tpu.metrics import run as jrun
from clann_tpu.metrics.schema import SCHEMA as JSCHEMA
from clann_tpu.ops.ivf import dense_search as jdense
from clann_tpu.parallel.capacity import HBM_V5E
from clann_tpu.parallel.capacity import plan_capacity as jplan

import clann_tpu_torch
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.config import MetricsGranularity, MetricsOutput
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.metrics import csv as tcsv
from clann_tpu_torch.metrics import run as trun
from clann_tpu_torch.metrics.schema import SCHEMA as TSCHEMA
from clann_tpu_torch.data.synthetic import make_synthetic_dataset
from clann_tpu_torch.metrics.schema import create_schema
from clann_tpu_torch.parallel.capacity import HBM_H100, CapacityPlan
from clann_tpu_torch.parallel.capacity import plan_capacity as tplan
from clann_tpu_torch.testing import index_arrays

torch.set_num_threads(1)

# --- plan_capacity ---------------------------------------------------------

_PLANS = [
    (1_183_514, 100, dict(num_tables=50, k=10)),
    (1_183_514, 100, dict(num_tables=128, k=10, lsh_engine="global", dense_layout=False,
                          pack_slot_records=False, gather_block=32)),
    (20_000, 32, dict(num_tables=8, num_clusters_factor=0.4, k=10, seed=1)),
    (100_000_000, 96, dict(num_tables=50, k=10)),
    (1_560_000, 768, dict(num_tables=16, lsh_engine="both", k=100)),
    (999, 25, dict(num_tables=3, lsh_engine="clustered", prefix_dir_bits=6)),
]


@pytest.mark.parametrize("n, d, kw", _PLANS)
@pytest.mark.parametrize("hbm", [HBM_V5E, HBM_H100, 4 * 1024**3])
def test_plan_capacity_matches_jax(n, d, kw, hbm):
    t = tplan(n, d, TConfig(**kw), hbm_bytes=hbm, headroom=0.25)
    j = jplan(n, d, JConfig(**kw), hbm_bytes=hbm, headroom=0.25)
    assert t.per_structure == j.per_structure
    assert (t.total_bytes, t.shardable_bytes, t.replicated_bytes) == (
        j.total_bytes, j.shardable_bytes, j.replicated_bytes)
    assert (t.usable_bytes, t.fits_single_chip, t.min_devices, t.recommended_devices) == (
        j.usable_bytes, j.fits_single_chip, j.min_devices, j.recommended_devices)


def test_plan_capacity_defaults_to_the_card():
    """The default device memory is the H100 80GB's; the structures do not
    depend on it."""
    plan = tplan(1_183_514, 100, TConfig(num_tables=50, k=10))
    assert isinstance(plan, CapacityPlan)
    assert plan.hbm_bytes == HBM_H100 == 85_017_493_504
    assert plan.per_structure == jplan(1_183_514, 100, JConfig(num_tables=50, k=10)).per_structure
    assert plan.fits_single_chip and plan.min_devices == 1
    big = tplan(100_000_000, 96, TConfig(num_tables=50, k=10))
    assert not big.fits_single_chip
    assert big.recommended_devices >= big.min_devices
    assert big.recommended_devices & (big.recommended_devices - 1) == 0


def test_plan_capacity_tracks_the_build():
    """The plan models the dominant structures of a real port build: within
    0.8-2x of its memory_usage (JAX's bar, tests/test_capacity.py)."""
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors

    n, d = 20000, 32
    cfg = TConfig(num_tables=8, num_clusters_factor=0.4, k=10, seed=1)
    idx = tindex.build_index(clustered_unit_vectors(n, d, seed=1), cfg, device="cpu")
    plan = tplan(n, d, cfg)
    assert 0.8 * idx.memory_usage() <= plan.total_bytes <= 2.0 * idx.memory_usage()


# --- the same metrics written by both packages ------------------------------

CFG = dict(num_tables=6, num_clusters_factor=0.4, k=5, delta=0.9, hash_family="simhash",
           dataset_name="metrics-parity", seed=9)
_VOLATILE = {"created_at", "git_commit_hash", "build_time_s", "search_time_ms",
             "queries_per_second", "query_time_ms", "total_time_ms", "cluster_time_ms"}


@pytest.fixture(scope="module")
def world():
    """A JAX index, the same index in the port, and the stats of one JAX
    dense search (per-probe cluster ids included) on it."""
    from clann_tpu.data.synthetic import make_synthetic_dataset as jdata

    ds = jdata(n=1500, d=16, n_queries=24, k_gt=10, seed=4)
    jidx = jindex.build_index(ds.train, JConfig(**CFG))
    tidx = tindex.index_from_arrays(index_arrays(jidx), TConfig(**CFG), device="cpu")
    dists, _, stats = jdense(jidx, ds.test, k=5)
    return ds, jidx, tidx, np.asarray(dists), stats


def _rows(db):
    conn = sqlite3.connect(db)
    out = {}
    for (table,) in conn.execute("SELECT name FROM sqlite_master WHERE type='table' "
                                 "ORDER BY name"):
        cur = conn.execute(f"SELECT * FROM {table}")
        cols = [c[0] for c in cur.description]
        keep = [i for i, c in enumerate(cols) if c not in _VOLATILE]
        out[table] = ([cols[i] for i in keep],
                      sorted(tuple(r[i] for i in keep) for r in cur.fetchall()))
    conn.close()
    return out


def _metrics(run_mod, config, index, stats, ds, dists):
    m = run_mod.RunMetrics(config, index.n)
    m.log_index_building_time(1.25)
    m.ingest_build(index)
    m.ingest_search(stats, 0.5)
    m.ingest_search(stats, 0.25)
    m.compute_run_statistics(ds.distances, dists)
    return m


@pytest.mark.parametrize("granularity", ["RUN", "QUERY", "CLUSTER"])
def test_sqlite_rows_match_jax(world, tmp_path, granularity):
    ds, jidx, tidx, dists, stats = world
    # the port's stats as CPU tensors: RunMetrics brings tensors to numpy
    tstats = type(stats)(*(None if f is None else torch.as_tensor(np.asarray(f))
                           for f in stats))
    jm = _metrics(jrun, JConfig(**CFG), jidx, stats, ds, dists)
    tm = _metrics(trun, TConfig(**CFG), tidx, tstats, ds, dists)
    assert tm.timing_mode == jm.timing_mode == "batched-amortized"
    assert tm.queries_per_second == jm.queries_per_second
    jm.save_metrics(str(tmp_path / "j.db"), getattr(JGran, granularity))
    tm.save_metrics(str(tmp_path / "t.db"), getattr(MetricsGranularity, granularity))
    jr, tr = _rows(str(tmp_path / "j.db")), _rows(str(tmp_path / "t.db"))
    assert tr == jr
    assert len(tr["build_metrics"][1]) == 1
    assert len(tr["build_metrics_cluster"][1]) == tidx.n_clusters
    n_q = {"RUN": 0, "QUERY": 2 * len(ds.test), "CLUSTER": 2 * len(ds.test)}[granularity]
    assert len(tr["search_metrics_query"][1]) == n_q
    assert (len(tr["search_metrics_cluster"][1]) > 0) == (granularity == "CLUSTER")


def test_csv_lines_match_jax(world, tmp_path):
    ds, jidx, tidx, dists, stats = world
    jm = _metrics(jrun, JConfig(**CFG), jidx, stats, ds, dists)
    tm = _metrics(trun, TConfig(**CFG), tidx, stats, ds, dists)
    for mod, m, tag in ((jcsv, jm, "j"), (tcsv, tm, "t")):
        for _ in range(2):  # the header once, then one line per call
            mod.save_build_metrics_csv(m, str(tmp_path / f"{tag}_build.csv"))
            mod.save_search_metrics_csv(m, str(tmp_path / f"{tag}_search.csv"))

    def lines(path):
        with open(path) as f:
            rows = list(csv.reader(f))
        keep = [i for i, c in enumerate(rows[0]) if c not in _VOLATILE]
        return [[r[i] for i in keep] for r in rows]

    for kind in ("build", "search"):
        t = lines(str(tmp_path / f"t_{kind}.csv"))
        assert t == lines(str(tmp_path / f"j_{kind}.csv"))
        assert len(t) == 3


def test_puffinn_baseline_rows_match_jax(tmp_path):
    for mod, cfg, tag in ((jrun, JConfig(num_tables=50, dataset_name="glove-25-angular"), "j"),
                          (trun, TConfig(num_tables=50, dataset_name="glove-25-angular"), "t")):
        mod.save_puffinn_baseline(str(tmp_path / f"{tag}.db"), cfg, dataset_len=1000,
                                  memory_used_bytes=12345, total_time_s=1.5, recall_mean=0.92,
                                  recall_std=0.01, distance_computations=np.arange(10))
    assert _rows(str(tmp_path / "t.db")) == _rows(str(tmp_path / "j.db"))
    assert len(_rows(str(tmp_path / "t.db"))["puffinn_results_query"][1]) == 10


def test_schema_is_jax_schema(tmp_path):
    """The same tables and columns as JAX's (the reference's seven, plus
    clann_timing_mode)."""
    def tables(schema, path):
        conn = sqlite3.connect(path)
        conn.executescript(schema)
        out = {t: [c[1:] for c in conn.execute(f"PRAGMA table_info({t})")]
               for (t,) in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")}
        conn.close()
        return out

    got, want = tables(TSCHEMA, tmp_path / "t.db"), tables(JSCHEMA, tmp_path / "j.db")
    assert got == want and len(got) == 8 and "clann_timing_mode" in got


# --- the port's facade with metrics_output=DB --------------------------------


@pytest.fixture(scope="module")
def handle():
    ds = make_synthetic_dataset(n=2000, d=16, n_queries=30, k_gt=10, seed=7, device="cpu")
    cfg = TConfig(num_tables=8, num_clusters_factor=0.3, k=10, delta=0.9,
                  dataset_name="synthetic-test", metrics_output=MetricsOutput.DB,
                  hash_family="simhash", candidate_chunk=256, seed=9)
    h = clann_tpu_torch.init_with_config(ds.train, cfg, device="cpu")
    clann_tpu_torch.build(h)
    return h, ds


def _count(db, table):
    conn = sqlite3.connect(db)
    (n,) = conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()
    conn.close()
    return n


def test_metrics_db_through_the_facade(handle, tmp_path):
    h, ds = handle
    assert h.metrics is not None and h.metrics.build.build_time_s > 0
    h.reset_metrics()
    dists, _, _ = h.search_batch(ds.test[:20], mode="lsh")
    h.search_batch(ds.test[20:], mode="scan")
    db = str(tmp_path / "results.db")
    clann_tpu_torch.save_metrics(h, db, MetricsGranularity.QUERY,
                                 ground_truth_distances=ds.distances[:20], run_distances=dists)
    conn = sqlite3.connect(db)
    mem, L, nc = conn.execute(
        "SELECT memory_used_bytes, num_tables, num_clusters FROM build_metrics").fetchone()
    recall = conn.execute("SELECT recall_mean FROM search_metrics").fetchone()[0]
    conn.close()
    assert mem == h.index.memory_usage() and L == 8 and nc == h.index.n_clusters
    assert _count(db, "build_metrics") == 1
    assert _count(db, "build_metrics_cluster") == h.index.n_clusters
    assert _count(db, "search_metrics_query") == len(ds.test)
    assert 0.72 <= recall <= 1.0
    # the same run saved again: UNIQUE tolerated as already recorded
    h.save_metrics(db)
    assert _count(db, "search_metrics") == 1


def test_reset_and_accumulate(handle):
    h, ds = handle
    h.reset_metrics()
    h.search_batch(ds.test[:7], mode="scan")
    h.search_batch(ds.test[7:12], mode="scan")
    m = h.metrics
    assert len(m.distance_computations) == 12 and len(m.query_time_ms) == 12
    assert m.total_search_time_s > 0
    h.reset_metrics()
    assert m.distance_computations is None and m.total_search_time_s == 0.0
    h.search_batch(ds.test[:1], mode="scan")
    assert m.timing_mode == "single-query"
    h.search_batch(ds.test[:8], mode="scan")
    assert m.timing_mode == "batched-amortized"


def test_cluster_rows_from_the_dense_path(tmp_path):
    ds = make_synthetic_dataset(n=1500, d=16, n_queries=12, k_gt=10, seed=3, device="cpu")
    cfg = TConfig(num_tables=4, num_clusters_factor=0.3, k=10, dataset_name="dense",
                  metrics_output="DB", seed=1)
    h = clann_tpu_torch.init_with_config(ds.train, cfg, device="cpu").build()
    dists, _, stats = h.search_batch(ds.test, mode="dense")
    assert stats.probed_clusters is not None
    db = str(tmp_path / "cluster.db")
    h.save_metrics(db, MetricsGranularity.CLUSTER, ground_truth_distances=ds.distances)
    assert _count(db, "search_metrics_cluster") > 0
    conn = sqlite3.connect(db)
    for ci, cnt in conn.execute("SELECT cluster_idx, n_candidates FROM search_metrics_cluster"):
        assert 0 <= ci < h.index.n_clusters and cnt > 0
    conn.close()


def test_metrics_errors(tmp_path):
    ds = make_synthetic_dataset(n=300, d=8, n_queries=4, k_gt=5, seed=1, device="cpu")
    h = clann_tpu_torch.init_with_config(ds.train, TConfig(num_tables=2), device="cpu")
    assert h.metrics is None
    h.reset_metrics()  # a no-op without the sink
    with pytest.raises(DataError, match="metrics"):
        h.save_metrics(str(tmp_path / "x.db"))
    m = trun.RunMetrics(TConfig(), 10)
    with pytest.raises(TypeError, match="granularity"):
        m.save_metrics(str(tmp_path / "x.db"), np.zeros(3))
    with pytest.raises(clann_tpu_torch.ResultDBError):
        m.save_metrics(str(tmp_path / "missing.db"), create=False)
    assert not trun.db_exists(str(tmp_path / "missing.db"))
    conn = sqlite3.connect(str(tmp_path / "s.db"))
    create_schema(conn)
    conn.close()
    assert trun.db_exists(str(tmp_path / "s.db"))
    assert len(trun.git_commit_hash()) in (40, len("NO_COMMIT"))

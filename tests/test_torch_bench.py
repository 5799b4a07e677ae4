"""Slice 14c of the port (data/hdf5, bench/ann_adapter, bench/harness, the
CLI) against the JAX package's, on the CPU.

Hash-dependent answers differ between the packages (each draws its own
functions), so every comparison either runs a mode whose answers do not
depend on the draws ("scan", and the dense IVF default of `minibench`,
which depends on the deterministic clustering only), or carries JAX's
index across with `index_from_arrays` (the flat baseline). Equal means:
ids per query as sets up to boundary ties, distances within 1e-5, recall
and distance computations equal, SQLite rows equal except their timings.
"""

import dataclasses
import io
import os
import re
import sqlite3
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from clann_tpu import __main__ as jcli
from clann_tpu.bench import ann_adapter as jad
from clann_tpu.bench import harness as jh
from clann_tpu.config import Config as JConfig
from clann_tpu.core.index import build_lsh_index as jbuild_lsh
from clann_tpu.data import hdf5 as jhdf5
from clann_tpu.data.synthetic import make_synthetic_dataset

from clann_tpu_torch import __main__ as tcli
from clann_tpu_torch.bench import ann_adapter as tad
from clann_tpu_torch.bench import harness as th
from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core import index as tindex
from clann_tpu_torch.data import hdf5 as thdf5
from clann_tpu_torch.data import synthetic as tsyn
from clann_tpu_torch.errors import DataError
from clann_tpu_torch.testing import assert_topk_match, index_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_tables=6, num_clusters_factor=0.3, k=5, delta=0.8, dataset_name="bench-test",
             hash_family="simhash", candidate_chunk=128, seed=2)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_dataset(n=1500, d=16, n_queries=40, k_gt=20, clustered=True,
                                  seed=21, name="bench-test")


# --- data/hdf5 ---------------------------------------------------------------

def test_anndataset_lives_in_hdf5():
    assert tsyn.AnnDataset is thdf5.AnnDataset


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hdf5_files_cross_load(ds, tmp_path, writer):
    path = str(tmp_path / "glove-test.hdf5")
    save, load = ((jhdf5.save_hdf5_dataset, thdf5.load_hdf5_dataset) if writer == "jax"
                  else (thdf5.save_hdf5_dataset, jhdf5.load_hdf5_dataset))
    src = (ds if writer == "jax" else
           thdf5.AnnDataset(ds.train, ds.test, ds.distances, ds.neighbors, ds.name))
    save(path, src)
    got = load(path)
    assert got.name == "glove-test"
    for f in ("train", "test", "distances", "neighbors"):
        a, b = getattr(got, f), getattr(ds, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # the optional sets may be missing
    save(path, dataclasses.replace(src, distances=None, neighbors=None))
    got = load(path, name="x")
    assert got.name == "x" and got.distances is None and got.neighbors is None


def test_hdf5_errors(tmp_path):
    import h5py

    with pytest.raises(DataError, match="not found"):
        thdf5.load_hdf5_dataset(str(tmp_path / "missing.hdf5"))
    path = str(tmp_path / "no-test.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=np.zeros((3, 2), np.float32))
    with pytest.raises(DataError, match="'test'"):
        thdf5.load_hdf5_dataset(path)


# --- bench/ann_adapter -------------------------------------------------------

def test_adapter_matches_jax(ds):
    x = ds.train
    j = jad.ClannTPU(metric="angular", num_tables=8, num_clusters_factor=0.5, mode="scan")
    t = tad.ClannTPU(metric="angular", num_tables=8, num_clusters_factor=0.5, mode="scan",
                     device="cpu")
    assert str(t) == str(j)
    for algo in (j, t):
        algo.fit(x)
        algo.set_query_arguments(0.9)
        algo.batch_query(ds.test, 10)
    jr, tr = j.get_batch_results(), t.get_batch_results()
    qn = ds.test / np.linalg.norm(ds.test, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    sims = qn @ xn.T
    for q in range(len(jr)):
        assert_topk_match(tr[q][None], sims[q, tr[q]][None], jr[q][None], sims[q, jr[q]][None],
                          atol=1e-5)
    np.testing.assert_array_equal(t.query(ds.test[3], 10), tr[3])
    # kB of the index, the same structures counted as JAX's
    assert t.get_memory_usage() == j.get_memory_usage() > 0
    t.done()
    assert t.get_memory_usage() == 0
    with pytest.raises(NotImplementedError):
        tad.ClannTPU(metric="euclidean")


# --- bench/harness -------------------------------------------------------------

def _cfg_dicts(cfgs):
    return [c.to_dict() for c in cfgs]


def test_configs_match_jax():
    path = os.path.join(REPO, "clann_tpu", "bench", "configs.json")
    assert _cfg_dicts(th.load_configs(path)) == _cfg_dicts(jh.load_configs(path))
    assert (_cfg_dicts(th.default_sweep_configs("x"))
            == _cfg_dicts(jh.default_sweep_configs("x")))
    assert len(th.default_sweep_configs("x")) == 14


def _rows(db, table, drop=()):
    conn = sqlite3.connect(db)
    try:
        cur = conn.execute(f"SELECT * FROM {table}")
        cols = [c[0] for c in cur.description]
        keep = [i for i, c in enumerate(cols) if c not in drop]
        return [tuple(r[i] for i in keep) for r in cur.fetchall()]
    finally:
        conn.close()


def test_clann_runs_match_jax_and_cache(ds, tmp_path):
    jdb, tdb = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    jres = jh.run_benchmark_config_clann(JConfig(**SMALL), ds, jdb, str(tmp_path / "jc"),
                                         mode="scan")
    tres = th.run_benchmark_config_clann(TConfig(**SMALL), ds, tdb, str(tmp_path / "tc"),
                                         mode="scan", device="cpu")
    assert tres.recall == pytest.approx(jres.recall, abs=1e-9)
    assert tres.distance_computations == jres.distance_computations == 1500
    assert tres.mode == "scan" and tres.build_seconds > 0
    # a second run loads the cached index (native h5) instead of building
    again = th.run_benchmark_config_clann(TConfig(**SMALL), ds, None, str(tmp_path / "tc"),
                                          mode="scan", device="cpu")
    assert again.build_seconds == 0.0 and again.recall == tres.recall
    # config_already_recorded reads a DB either package wrote
    n_c = TConfig(**SMALL).num_clusters(1500)
    for db in (jdb, tdb):
        assert th.config_already_recorded(db, TConfig(**SMALL), n_c)
        assert jh.config_already_recorded(db, JConfig(**SMALL), n_c)
        assert not th.config_already_recorded(db, TConfig(**SMALL), n_c + 1)
    assert not th.config_already_recorded(str(tmp_path / "none.db"), TConfig(**SMALL), n_c)


def test_flat_baseline_rows_match_jax(ds, tmp_path, monkeypatch):
    """JAX's C = 1 index carried into the port: the puffinn_results rows
    are equal except the timings."""
    jdb, tdb = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    jflat = jbuild_lsh(ds.train, JConfig(**SMALL))
    carried = tindex.index_from_arrays(index_arrays(jflat), TConfig(**SMALL), device="cpu")
    monkeypatch.setattr(tindex, "build_lsh_index", lambda *a, **kw: carried)
    jres = jh.run_benchmark_config_puffinn(JConfig(**SMALL), ds, jdb)
    tres = th.run_benchmark_config_puffinn(TConfig(**SMALL), ds, tdb, device="cpu")
    assert tres.recall == pytest.approx(jres.recall, abs=1e-9)
    assert tres.distance_computations == jres.distance_computations
    assert tres.mode == jres.mode == "flat-lsh"
    timing = ("total_time_ms", "queries_per_second", "query_time_ms", "id", "created_at")
    for table in ("puffinn_results", "puffinn_results_query"):
        want = _rows(jdb, table, timing)
        assert want and _rows(tdb, table, timing) == want, table


def test_minibench_rows_match_jax(ds, tmp_path):
    jdb, tdb = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    jrow = jh.minibench(ds, jdb, cfg=JConfig(**SMALL))
    trow = th.minibench(ds, tdb, cfg=TConfig(**SMALL), device="cpu")
    assert trow["recall"] == pytest.approx(jrow["recall"], abs=1e-9) and trow["recall"] > 0
    timing = ("index_points_per_sec", "qps", "created_at")
    assert _rows(tdb, "minibench", timing) == _rows(jdb, "minibench", timing)


def test_compare_implementations(ds, tmp_path):
    t = th.compare_implementations_time(TConfig(**SMALL), ds, sample_queries=4, repetitions=2,
                                        device="cpu")
    assert set(t) == {"clustered_s", "base_puffinn_s", "speedup"}
    assert t["clustered_s"] > 0 and t["base_puffinn_s"] > 0
    db = str(tmp_path / "sweep.db")
    cfgs = [TConfig(**SMALL), TConfig(**{**SMALL, "num_clusters_factor": 0.5})]
    res = th.compare_implementations_distance(cfgs, ds, db, str(tmp_path / "c"), device="cpu")
    assert [r.mode for r in res] == ["lsh", "flat-lsh"] * 2
    # recorded configs are skipped on the next sweep
    assert th.compare_implementations_distance(cfgs, ds, db, str(tmp_path / "c"),
                                               device="cpu") == []


# --- the CLI --------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_options_match_jax(capsys):
    opts = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        with pytest.raises(SystemExit):
            main(["--help"])
        help_text = capsys.readouterr().out
        opts[name] = set(re.findall(r"(?<![\w-])(--?[a-zA-Z][\w-]*)", help_text))
    assert opts["torch"] - opts["jax"] == {"--device"}
    assert opts["jax"] <= opts["torch"]
    assert tcli.MODES == ["auto", "lsh", "lsh-global", "lsh-clustered", "dense", "scan",
                          "scan-pallas", "scan-block", "scan-block-adaptive", "adaptive"]


def test_cli_plan_matches_jax():
    argv = ["--plan", "--synthetic-n", "2000000", "--synthetic-d", "100", "-L", "50"]
    rc_j, j = _run(jcli.main, argv)
    rc_t, t = _run(tcli.main, argv)
    assert rc_j == rc_t == 0

    def per_structure(text):
        return [ln for ln in text.splitlines() if re.match(r"^  \w+ +[\d.]+ GB$", ln)]

    assert per_structure(t) and per_structure(t) == per_structure(j)


def test_cli_run_prints_jax_recall_and_saves(tmp_path):
    argv = ["--synthetic-n", "2000", "--synthetic-d", "16", "--queries", "50", "-L", "4",
            "--mode", "scan", "--no-cache"]
    _, j = _run(jcli.main, argv)
    db = str(tmp_path / "cli.db")
    rc, t = _run(tcli.main, argv + ["--device", "cpu", "--save", db])
    assert rc == 0

    def line(text, key):
        return next(ln for ln in text.splitlines() if ln.startswith(key))

    assert line(t, "recall@10") == line(j, "recall@10")
    assert line(t, "queries:") == line(j, "queries:") == "queries:    50"
    assert line(t, "distance computations") == line(j, "distance computations")
    assert f"metrics saved to {db}" in t
    assert len(_rows(db, "search_metrics")) == 1
    assert len(_rows(db, "search_metrics_query")) == 50

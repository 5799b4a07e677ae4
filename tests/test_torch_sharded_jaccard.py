"""The port's sharded Jaccard index (parallel/jaccard) against the JAX
package's, live, on the conftest's 8-device virtual CPU mesh, and the
multi-process runtime (parallel/distributed) on the CPU with gloo.

- shard_jaccard_index of a JAX-built index carried into the port: every
  per-shard array equal to JAX's as uint32 (ids inside runs of equal hashes
  compared in (hash, id) order: the port's sort is stable, JAX's is not);
- sharded_jaccard_search: similarities within 1e-6, ids per query as sets
  up to boundary ties, distance computations equal;
- build_jaccard_sharded equals shard_jaccard_index(build_jaccard_index)
  byte for byte (the port's own draws), blocked hashing included;
- a 2-rank gloo run (2 CPU shards per process, file:// rendezvous) equals
  the 1-process 4-shard run exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from clann_tpu.config import Config as JConfig
from clann_tpu.core.jaccard import build_jaccard_index as jbuild_jac
from clann_tpu.data.setdata import JaccardData as JData
from clann_tpu.parallel import jaccard as jpj
from clann_tpu.parallel import mesh as jmesh

from clann_tpu_torch.config import Config as TConfig
from clann_tpu_torch.core.jaccard import build_jaccard_index, jaccard_index_from_arrays
from clann_tpu_torch.data.setdata import JaccardData as TData
from clann_tpu_torch.parallel import distributed as tdist
from clann_tpu_torch.parallel import jaccard as tpj
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.testing import assert_topk_match, jaccard_index_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dict(num_tables=12, k=5, delta=0.8, candidate_chunk=128, max_hashbits=16, seed=9)


def _cpu_mesh(D):
    return tmesh.make_mesh(D, devices=["cpu"] * D)


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.fixture(scope="module")
def jac():
    rng = np.random.default_rng(11)
    universe = 400
    sets = [rng.choice(universe, size=min(max(2, rng.poisson(10)), universe), replace=False)
            for _ in range(900)]
    jidx = jbuild_jac(JData(sets, universe), JConfig(**JCFG))
    tidx = jaccard_index_from_arrays(jaccard_index_arrays(jidx), TConfig(**JCFG), device="cpu")
    return sets, universe, jidx, tidx


@pytest.mark.parametrize("D", (4, 8))
def test_shard_jaccard_index_matches_jax(jac, D):
    _, _, jidx, tidx = jac
    js = jpj.shard_jaccard_index(jidx, D)
    ts = tpj.shard_jaccard_index(tidx, D, mesh=_cpu_mesh(D))
    assert ts.n_devices == D
    for f in ("tokens", "set_sizes", "sketches", "global_ids", "sorted_hash"):
        np.testing.assert_array_equal(_u32(ts.stacked(f)), _u32(getattr(js, f)), err_msg=f)
    jh, ji, ti = _u32(js.sorted_hash), np.asarray(js.sorted_idx), ts.stacked("sorted_idx")
    for s in range(D):
        for t in range(jh.shape[1]):
            np.testing.assert_array_equal(ti[s, t], ji[s, t][np.lexsort((ji[s, t], jh[s, t]))])


@pytest.mark.parametrize("D", (4, 8))
def test_sharded_jaccard_search_matches_jax(jac, D):
    sets, universe, jidx, tidx = jac
    queries = np.asarray(jidx.tokens)[:40]
    js_, ji_, jst = jpj.sharded_jaccard_search(jpj.shard_jaccard_index(jidx, D), queries,
                                               k=5, delta=0.8, mesh=jmesh.make_mesh(D))
    mesh = _cpu_mesh(D)
    ts_, ti_, tst = tpj.sharded_jaccard_search(tpj.shard_jaccard_index(tidx, D, mesh=mesh),
                                               queries, k=5, delta=0.8, mesh=mesh)
    assert_topk_match(ti_, ts_, np.asarray(ji_), np.asarray(js_), atol=1e-6)
    for f in tst._fields:
        np.testing.assert_array_equal(getattr(tst, f), np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.distance_computations.sum() > 0


def test_build_jaccard_sharded_equals_shard_of_built_index(jac):
    sets, universe, _, _ = jac
    cfg = TConfig(**JCFG)
    mesh = _cpu_mesh(8)
    via_flat = tpj.shard_jaccard_index(
        build_jaccard_index(TData(sets, universe), cfg, device="cpu"), 8, mesh=mesh)
    direct = tpj.build_jaccard_sharded(sets, universe, cfg, mesh=mesh)
    blocked = tpj.build_jaccard_sharded(sets, universe, cfg, mesh=mesh,
                                        hash_budget_bytes=64 << 10)
    for f in tpj.SHARD_FIELDS:
        for other in (direct, blocked):
            for s in range(8):
                assert torch.equal(getattr(via_flat, f)[s], getattr(other, f)[s]), f
    for p in ("hash_params", "sketch_params"):
        for k, v in getattr(via_flat, p).items():
            assert torch.equal(v, getattr(direct, p)[k])
    qs = sets[:16]
    a = tpj.sharded_jaccard_search(via_flat, qs, mesh=mesh)
    b = tpj.sharded_jaccard_search(direct, qs, mesh=mesh)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


# --- the multi-process runtime ---------------------------------------------

def test_initialize_distributed_is_gated(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert tdist.initialize_distributed() is False
    assert tdist.host_local_slice(10) == slice(0, 10)
    with pytest.raises(ValueError, match="process count"):
        tdist.initialize_distributed("localhost:1234")


def test_world_size_one_group(tmp_path):
    import torch.distributed as dist

    assert tdist.initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, backend="gloo")
    try:
        mesh = tdist.global_mesh(local_devices=["cpu"] * 4)
        assert mesh.shape == {"cluster": 4} and not mesh.multiprocess
        assert tdist.host_local_slice(10) == slice(0, 10)
        got = _results(mesh)
        want = _results(_cpu_mesh(4))
        for key in want:
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
    finally:
        dist.destroy_process_group()


_RUN = '''
import numpy as np, torch
torch.set_num_threads(1)


def run(mesh):
    """sharded GMM + shard + walk / global / scans / join on `mesh`."""
    from clann_tpu_torch.config import Config
    from clann_tpu_torch.core.index import build_index
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors, random_unit_vectors
    from clann_tpu_torch.parallel import join, sharded

    cfg = Config(num_tables=8, num_clusters_factor=0.5, k=5, delta=0.9,
                 hash_family="simhash", candidate_chunk=128, brute_force_threshold=20,
                 seed=4, lsh_engine="both")
    train = clustered_unit_vectors(1500, 16, n_modes=24, seed=2)
    q = random_unit_vectors(24, 16, seed=3)
    idx = build_index(train, cfg, device="cpu", gmm_mesh=mesh)
    sh = sharded.shard_index(idx, 4, mesh=mesh)
    out = {"assignment": (idx.assignment.numpy(),)}
    out["walk"] = sharded.sharded_search(sh, q, mesh=mesh)
    out["global"] = sharded.sharded_global_search(sh, q, mesh=mesh)
    out["exact"] = sharded.sharded_scan_search(sh, q, exact=True, mesh=mesh)
    out["pallas"] = sharded.sharded_scan_search(sh, q, use_pallas=True, mesh=mesh)
    out["join"] = join.sharded_closest_pairs(idx, 10, delta=0.8, mesh=mesh)
    return {k: [np.asarray(a) for a in v[:2]] + [np.asarray(s) for s in
                                                 (v[2] if len(v) > 2 else ())]
            for k, v in out.items()}
'''

_RANK = _RUN + '''
import sys
from clann_tpu_torch.parallel.distributed import global_mesh, initialize_distributed

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert initialize_distributed(init, 2, rank, backend="gloo")
mesh = global_mesh(local_devices=["cpu"] * 2)
assert mesh.multiprocess and mesh.ranks.tolist() == [0, 0, 1, 1]
res = run(mesh)
if rank == 0:
    np.savez(out, **{f"{k}:{i}": a for k, v in res.items() for i, a in enumerate(v)})
torch.distributed.destroy_process_group()
'''


def _results(mesh):
    ns = {}
    exec(_RUN, ns)
    return ns["run"](mesh)


def test_two_processes_equal_one_process(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO
    out = tmp_path / "rank0.npz"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), f"file://{tmp_path}/rdv",
                               str(out)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    got = np.load(out)
    want = _results(_cpu_mesh(4))
    for key, arrays in want.items():
        for i, a in enumerate(arrays):
            np.testing.assert_array_equal(got[f"{key}:{i}"], a, err_msg=f"{key}:{i}")

"""The port's runtime on several cards, checked on the CPU.

What one card hides, pinned where the CPU can see it:

- parallel/distributed: a process that is one of several on its host
  (LOCAL_RANK, LOCAL_WORLD_SIZE) takes the card cuda:{LOCAL_RANK} alone in
  global_mesh, explicit local devices still win, and initialize_distributed
  makes that card current before it opens an NCCL group (and only then);
- the kernel launches (csrc/) switch cards only through DeviceScope, which
  gives the caller's current device back on every return path;
- build_sharded normalizes each shard's rows on its own device: no call
  ever sees the whole dataset;
- parallel.mesh.shard_span records CUDA events only on CUDA devices;
- probes/multicard: its comparisons, its placement check, and its
  one-process-per-card run, whose rank 0 must equal the single-controller
  run (here over gloo, one CPU shard per process); the sharded functions
  themselves are held to the JAX package in the test_torch_sharded*.py
  files.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from clann_tpu_torch.config import Config
from clann_tpu_torch.data.synthetic import clustered_unit_vectors
from clann_tpu_torch.ops.query import SearchStats
from clann_tpu_torch.parallel import distributed as tdist
from clann_tpu_torch.parallel import mesh as tmesh
from clann_tpu_torch.parallel import sharded as tsh
from clann_tpu_torch.probes import multicard as mc

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "clann_tpu_torch" / "csrc"
FOUR_CARDS = [torch.device("cuda", i) for i in range(4)]


@pytest.fixture
def four_processes(monkeypatch):
    """A process group of 4 with this process as rank 2 on a 4-card host."""
    for v in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(tdist, "_world", lambda: (2, 4))
    monkeypatch.setattr(tdist, "visible_devices", lambda: list(FOUR_CARDS))

    def all_gather_object(out, obj):
        out[:] = [obj] * len(out)

    monkeypatch.setattr(torch.distributed, "all_gather_object", all_gather_object)
    return monkeypatch


def test_global_mesh_takes_the_local_rank_card(four_processes):
    four_processes.setenv("LOCAL_RANK", "2")
    four_processes.setenv("LOCAL_WORLD_SIZE", "4")
    assert tdist.default_local_devices() == [torch.device("cuda", 2)]
    mesh = tdist.global_mesh()
    assert mesh.shape == {"cluster": 4} and mesh.ranks.tolist() == [0, 1, 2, 3]
    # this process's card in every rank's place: its merges land on it
    assert mesh.cluster_devices() == [torch.device("cuda", 2)] * 4


@pytest.mark.parametrize("env", [{"LOCAL_RANK": "1"}, {"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "8"}])
def test_local_rank_alone_names_the_card(four_processes, env):
    for k, v in env.items():
        four_processes.setenv(k, v)
    assert tdist.default_local_devices() == [torch.device("cuda", int(env["LOCAL_RANK"]))]


def test_explicit_local_devices_win(four_processes):
    four_processes.setenv("LOCAL_RANK", "2")
    mesh = tdist.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.cluster_devices() == [torch.device("cpu")] * 8
    assert mesh.ranks.tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("case", ["one process", "one process per host", "no local rank"])
def test_every_visible_card_otherwise(four_processes, case):
    if case == "one process":
        four_processes.setattr(tdist, "_world", lambda: (0, 1))
        four_processes.setenv("LOCAL_RANK", "0")
    elif case == "one process per host":
        four_processes.setenv("LOCAL_RANK", "0")
        four_processes.setenv("LOCAL_WORLD_SIZE", "1")
    assert tdist.default_local_devices() == FOUR_CARDS


def _record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw["rank"])))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    return calls


@pytest.mark.parametrize("backend,local_rank,want", [
    ("nccl", "3", [("set_device", 3), ("init", "nccl", 3)]),
    ("nccl", None, [("init", "nccl", 3)]),
    ("gloo", "3", [("init", "gloo", 3)]),
])
def test_initialize_distributed_sets_the_card_first(monkeypatch, backend, local_rank, want):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    calls = _record_init(monkeypatch)
    assert tdist.initialize_distributed("localhost:1234", 4, 3, backend=backend)
    assert calls == want


def test_kernel_launches_keep_the_callers_device():
    """Only DeviceScope switches cards, and every launch path goes through
    it: K1-K3 (launch_scan), K4 / K5 (launch_bulk), K6 / K7
    (clann_gather_warp)."""
    scope = (CSRC / "device_scope.cuh").read_text()
    assert re.search(r"cudaGetDevice\(&prev_\)", scope)
    assert re.search(r"~DeviceScope\(\) \{\s*if \(switched_\) cudaSetDevice\(prev_\);", scope)
    for src in CSRC.glob("*.cu*"):
        if src.name != "device_scope.cuh":
            assert "cudaSetDevice" not in src.read_text(), src.name
    hopper, gather = (CSRC / "scan_hopper.cuh").read_text(), (CSRC / "gather.cu").read_text()
    assert hopper.count("DeviceScope scope(device);") == 1
    assert gather.count("DeviceScope scope(device);") == 2
    for text in (hopper, gather):
        assert '#include "device_scope.cuh"' in text


def test_build_sharded_never_normalizes_the_whole_set(monkeypatch):
    import clann_tpu_torch.ops.distances as dist_ops

    rows = []
    real = dist_ops.l2_normalize

    def counting(x):
        rows.append(x.shape[0])
        return real(x)

    monkeypatch.setattr(dist_ops, "l2_normalize", counting)
    cfg = Config(num_tables=4, num_clusters_factor=0.5, k=5, hash_family="simhash",
                 candidate_chunk=64, seed=1)
    n = 1200
    x = clustered_unit_vectors(n, 16, n_modes=12, seed=5)
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    built = tsh.build_sharded(x, cfg, mesh=mesh)
    # the sharded GMM's slices, then per shard its rows and its centers
    assert max(rows) < n
    assert rows[-8::2] == list(built.shard_points) and sum(built.shard_points) == n
    assert rows[-7::2] == list(built.shard_clusters)


def test_shard_spans_only_on_cuda(monkeypatch):
    assert tmesh.SHARD_SPANS is None
    with tmesh.shard_span("cpu"):
        pass
    monkeypatch.setattr(tmesh, "SHARD_SPANS", [])
    with tmesh.shard_span(torch.device("cpu")):
        pass
    assert tmesh.SHARD_SPANS == []


def _stats(dc):
    dc = np.asarray(dc, np.int32)
    return SearchStats(dc, dc, np.ones_like(dc))


def test_same_search_allows_boundary_ties_only():
    d = np.array([[0.1, 0.2, 0.3], [0.1, 0.2, 0.3]])
    a = (d, np.array([[1, 2, 3], [4, 5, 6]]), _stats([10, 20]))
    tie = (d, np.array([[1, 2, 9], [4, 5, 6]]), _stats([10, 20]))
    assert mc.same_search(a, tie, "tie") == pytest.approx(5 / 6)
    swap = (d, np.array([[1, 9, 3], [4, 5, 6]]), _stats([10, 20]))
    with pytest.raises(AssertionError, match="differ beyond ties"):
        mc.same_search(a, swap, "swap")
    with pytest.raises(AssertionError, match="distance computations differ"):
        mc.same_search(a, (d, a[1], _stats([10, 21])), "dc")


def test_shards_on_cards_names_a_stray_tensor():
    x = clustered_unit_vectors(600, 8, n_modes=6, seed=2)
    cfg = Config(num_tables=2, num_clusters_factor=0.5, k=3, hash_family="simhash", seed=0)
    cpu = [torch.device("cpu")] * 2
    built = tsh.build_sharded(x, cfg, mesh=tmesh.make_mesh(2, devices=cpu))
    mc.shards_on_cards(built, cpu, "build")
    built.radii[1] = built.radii[1].to("meta")
    with pytest.raises(AssertionError, match=r"radii\[1\] lies on meta"):
        mc.shards_on_cards(built, cpu, "build")


def test_timed_reads_launches_and_spans_on_the_cpu():
    r = mc.timed(lambda: 7)
    assert r.out == 7 and r.seconds >= 0 and r.busy == {} and r.k1 == {} and r.k7 == {}
    assert tmesh.SHARD_SPANS is None
    assert "busy share none recorded" in r.line()


def test_one_process_per_shard_equals_the_controller(tmp_path, monkeypatch):
    """nccl_ranks' layout over gloo: 4 processes of one CPU shard each run
    build_sharded, the global engine and the fused scan (K1's plain
    version); rank 0 must equal one controller over a 4-shard CPU mesh."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = Config(num_tables=8, num_clusters_factor=0.5, k=10, delta=0.95, seed=0,
                 hash_family="simhash", gather_block=32, candidate_chunk=128,
                 filter_expand=8, lsh_engine="global", dense_layout=False,
                 pack_slot_records=False)
    n, queries, lsh_queries = 3000, 48, 32
    train = clustered_unit_vectors(n, mc.GLOVE_D, n_modes=mc.GLOVE_MODES,
                                   spread=mc.GLOVE_SPREAD, seed=0)
    test = clustered_unit_vectors(queries, mc.GLOVE_D, n_modes=mc.GLOVE_MODES,
                                  spread=mc.GLOVE_SPREAD, seed=1)
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    _, ref = mc.controller_run(train, test, cfg, mesh, lsh_queries, 0.95)
    mc.nccl_ranks(cfg, ref, "CPU", str(tmp_path / "work"), world=4, timeout_s=240, n=n,
                  queries=queries, lsh_queries=lsh_queries, delta=0.95, device_type="cpu")
    got = np.load(tmp_path / "work" / "rank0.npz")
    for key in ("global", "scan"):
        np.testing.assert_array_equal(got[f"{key}_i"], ref[key][1])
        np.testing.assert_array_equal(got[f"{key}_d"], ref[key][0])
        np.testing.assert_array_equal(got[f"{key}_distance_computations"],
                                      ref[key][2].distance_computations)
    for r in range(4):
        assert (tmp_path / "work" / f"rank{r}.json").exists()

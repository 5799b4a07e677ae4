"""The port's runtime on several cards, checked on the CPU.

What one card hides, pinned where the CPU can see it:

- parallel/distributed: a process that is one of several on its host
  (LOCAL_RANK, LOCAL_WORLD_SIZE) takes the card cuda:{LOCAL_RANK} alone in
  global_mesh (cuda:0 when it sees one card, an error when LOCAL_RANK is
  beyond several), explicit local devices still win, and
  initialize_distributed makes that card current before it opens an NCCL
  group (and only then);
- parallel.mesh.run_shards, the single controller's shard_map: the shards
  of distinct devices run at once, one worker per device (CPU devices
  cpu:0-3 stand for cards here), and give what the in-order run gives, bit
  for bit, on every sharded path; a worker's exception reaches the caller
  once every worker has stopped; the launch counters and the tracer's
  spans count exactly from several threads;
- the kernel launches (csrc/) switch cards only through DeviceScope, which
  gives the caller's current device back on every return path;
- build_sharded normalizes each shard's rows on its own device: no call
  ever sees the whole dataset;
- parallel.mesh.run_shards marks its workers traced while the caller is
  traced, so their shard bodies and turn waits are recorded;
- probes/multicard: its comparisons, its placement check, and its
  one-process-per-card run, whose rank 0 must equal the single-controller
  run (here over gloo, one CPU shard per process); the sharded functions
  themselves are held to the JAX package in the test_torch_sharded*.py
  files.
"""

import collections
import contextlib
import dataclasses
import re
import sys
import threading
import time
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


def test_one_visible_card_is_cuda_0(four_processes):
    """A launcher that gives each process only its own card
    (CUDA_VISIBLE_DEVICES) leaves LOCAL_RANK 2 with one card: cuda:0; with
    several cards and LOCAL_RANK beyond them, no card is guessed."""
    four_processes.setenv("LOCAL_RANK", "2")
    four_processes.setenv("LOCAL_WORLD_SIZE", "4")
    four_processes.setattr(tdist, "visible_devices", tmesh.visible_devices)
    four_processes.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdist.default_local_devices() == [torch.device("cuda", 0)]
    assert tdist.global_mesh().cluster_devices() == [torch.device("cuda", 0)] * 4
    four_processes.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="LOCAL_RANK 2 names no card of the 2"):
        tdist.default_local_devices()


def _record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(tdist, "visible_devices", lambda: list(FOUR_CARDS))
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


@pytest.mark.parametrize("cards,want", [(1, [("set_device", 0), ("init", "nccl", 3)]),
                                        (2, None)])
def test_initialize_distributed_takes_a_visible_card(monkeypatch, cards, want):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    calls = _record_init(monkeypatch)
    monkeypatch.setattr(tdist, "visible_devices", lambda: FOUR_CARDS[:cards])
    if want is None:
        with pytest.raises(ValueError, match="LOCAL_RANK 3 names no card of the 2"):
            tdist.initialize_distributed("localhost:1234", 4, 3, backend="nccl")
        assert calls == []  # nothing set, no group opened
    else:
        assert tdist.initialize_distributed("localhost:1234", 4, 3, backend="nccl")
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


def test_run_shards_marks_its_workers_traced(monkeypatch):
    """Under a profiler (which reaches the calling thread only) the workers
    record their `shards/body` and `shards/turn_wait` spans; without one,
    nothing is recorded and the workers are left unmarked."""
    from torch.profiler import ProfilerActivity, profile

    from clann_tpu_torch.metrics.trace import Tracer

    tracer = Tracer(enabled=False)
    monkeypatch.setattr(tmesh, "TRACER", tracer)
    seen = []

    def body(i):
        seen.append(tracer.active())
        with tmesh.taking_turns():
            return tmesh.host_read(lambda: i)

    assert tmesh.run_shards(CPU_CARDS, body) == [0, 1, 2, 3]
    assert tracer.totals == {} and seen == [False] * 4
    with profile(activities=[ProfilerActivity.CPU]):
        assert tmesh.run_shards(CPU_CARDS, body) == [0, 1, 2, 3]
    assert seen[4:] == [True] * 4
    assert tracer.named("shards/body")[2] == 4
    # each worker waits for the turn once on entry and once after its read
    assert tracer.named("shards/turn_wait")[2] == 8
    assert set(tracer.totals) == {"shards/body", "shards/body/shards/turn_wait"}
    seen.clear()
    tmesh.run_shards(CPU_CARDS, body)
    assert seen == [False] * 4 and tracer.named("shards/body")[2] == 4


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
    assert r.out == 7 and r.seconds >= 0 and r.k1 == {} and r.k7 == {} and r.wf == {}
    assert r.sm == {}
    assert r.line() == f"{r.seconds:.3f} s"
    r, spans = mc.timed_spans(lambda: tsh.build_sharded(
        clustered_unit_vectors(600, 8, n_modes=6, seed=2),
        Config(num_tables=2, num_clusters_factor=0.5, k=3, hash_family="simhash", seed=0),
        mesh=tmesh.make_mesh(2, devices=[torch.device("cpu")] * 2)))
    assert {"sharded_build/gmm", "sharded_build/partition", "sharded_build/shards"} <= set(spans)
    assert all(v >= 0 for v in spans.values())


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


# --- the single controller's runner (parallel.mesh.run_shards) ----------------

CPU_CARDS = [torch.device("cpu", i) for i in range(4)]  # four devices, four workers


def test_runner_runs_the_devices_at_once():
    """One worker per device, the devices' workers at once (shard 0 waits
    for shard 3, on another device), one device's shards in shard order;
    in order, or on one device, every body runs in the calling thread."""
    met, seen = threading.Event(), {}

    def body(i):
        seen[i] = threading.get_ident()
        if i == 0:
            assert met.wait(20), "shard 3 never ran beside shard 0"
        if i == 3:
            met.set()
        return 10 * i

    devs = [CPU_CARDS[0], CPU_CARDS[1], CPU_CARDS[0], CPU_CARDS[2], None]
    assert tmesh.run_shards(devs, body) == [0, 10, 20, 30, None]
    me = threading.get_ident()
    assert seen[0] == seen[2] and len({seen[0], seen[1], seen[3], me}) == 4
    for devices, forced in ((CPU_CARDS, True), ([torch.device("cpu")] * 4, False)):
        order = []
        with tmesh._shards_in_order() if forced else contextlib.nullcontext():
            tmesh.run_shards(devices, lambda i: order.append((i, threading.get_ident())))
        assert order == [(i, me) for i in range(4)]


def test_runner_raises_once_every_worker_stopped():
    stopped = []

    def body(i):
        if i in (1, 2):
            raise (KeyError if i == 1 else ValueError)(f"shard {i}")
        time.sleep(0.3)
        stopped.append(i)

    with pytest.raises(KeyError, match="shard 1") as err:
        tmesh.run_shards(CPU_CARDS, body)
    assert sorted(stopped) == [0, 3]  # the other workers ran to their end first
    assert any("ValueError: shard 2" in note for note in err.value.__notes__)


class Yielding(collections.Counter):
    """A by-card count that lets other threads in between its read and its
    write back, so that an unguarded `c[card] += 1` loses counts."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_counts_are_exact_from_several_threads(monkeypatch):
    """K1's and K7's launch counts (total and by card) and the tracer's
    spans, written from four workers with the interpreter switching threads
    as often as it can."""
    from clann_tpu_torch.metrics.trace import Tracer
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops import scan_topk as st

    tracer = Tracer(enabled=True)
    monkeypatch.setattr(tmesh, "TRACER", tracer)
    monkeypatch.setattr(st, "KERNEL_LAUNCHES", 0)
    monkeypatch.setattr(st, "KERNEL_DEVICE_LAUNCHES", Yielding())
    monkeypatch.setattr(tg, "ROWS_LAUNCHES", 0)
    monkeypatch.setattr(tg, "ROWS_DEVICE_LAUNCHES", Yielding())
    n = 2000

    def body(i):  # two workers share each count by card
        for _ in range(n):
            tg._count_launch("ROWS_LAUNCHES", i // 2)
            st._count_launch("KERNEL_LAUNCHES", i // 2)
            with tracer.span("shards/step"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tmesh.run_shards(CPU_CARDS, body)
    finally:
        sys.setswitchinterval(interval)
    assert tg.ROWS_LAUNCHES == st.KERNEL_LAUNCHES == 4 * n
    want = {0: 2 * n, 1: 2 * n}
    assert dict(tg.ROWS_DEVICE_LAUNCHES) == dict(st.KERNEL_DEVICE_LAUNCHES) == want
    # each worker's steps nest in its own body: the stacks are per thread
    assert tracer.counts == {"shards/body": 4, "shards/body/shards/step": 4 * n}


def _same(a, b):
    """Two results equal bit for bit: arrays, tensors, tuples of them."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _index_parts(sharded):
    return [getattr(sharded, f.name) for f in dataclasses.fields(sharded)
            if isinstance(getattr(sharded, f.name), list)]


@pytest.fixture(scope="module")
def runner_world():
    from clann_tpu_torch.core.index import build_index
    from clann_tpu_torch.data.synthetic import clustered_sets, random_unit_vectors

    cfg = Config(num_tables=4, num_clusters_factor=1.0, k=5, delta=0.8, hash_family="simhash",
                 candidate_chunk=64, brute_force_threshold=8, seed=0, lsh_engine="both")
    train = clustered_unit_vectors(800, 16, n_modes=12, seed=0)
    jcfg = Config(num_tables=4, k=3, delta=0.8, candidate_chunk=32, max_hashbits=12, seed=0)
    return {"cfg": cfg, "train": train, "queries": random_unit_vectors(31, 16, seed=1),
            "index": build_index(train, cfg, device="cpu"), "jcfg": jcfg,
            "sets": clustered_sets(160, 300, avg_size=8, n_modes=8, seed=0)}


@pytest.mark.parametrize("path", ["global", "walk", "walk 2x2", "build", "join", "jaccard"])
def test_at_once_equals_in_order(runner_world, path, monkeypatch):
    """Every path moved onto run_shards returns, over four workers, what it
    returns run in order and on a one-device mesh, bit for bit."""
    from clann_tpu_torch.parallel import jaccard as pj
    from clann_tpu_torch.parallel.join import sharded_closest_pairs

    w = runner_world
    q = w["queries"]

    def run(devices):
        if path == "walk 2x2":
            half = tsh.shard_index(w["index"], 2, mesh=tmesh.make_mesh(2, devices=devices[:2]))
            return tsh.sharded_search(half, q, mesh=tmesh.make_mesh_2d(2, 2, devices=devices))
        mesh = tmesh.make_mesh(4, devices=devices)
        if path == "build":
            return _index_parts(tsh.build_sharded(w["train"], w["cfg"], mesh=mesh))
        if path == "join":
            return sharded_closest_pairs(w["index"], k=5, delta=0.8, mesh=mesh)
        if path == "jaccard":
            sh = pj.build_jaccard_sharded(w["sets"], 300, w["jcfg"], mesh=mesh)
            return _index_parts(sh), pj.sharded_jaccard_search(sh, w["sets"][:8], mesh=mesh)
        sharded = tsh.shard_index(w["index"], 4, mesh=mesh)
        fn = tsh.sharded_global_search if path == "global" else tsh.sharded_search
        return fn(sharded, q, mesh=mesh)

    used = collections.Counter()
    worker = tmesh._worker

    def counting(dev):
        used[dev] += 1
        return worker(dev)

    monkeypatch.setattr(tmesh, "_worker", counting)
    at_once = run(CPU_CARDS)
    assert set(used) == set(CPU_CARDS)  # every device had its worker
    with tmesh._shards_in_order():
        in_order = run(CPU_CARDS)
    one_device = run([torch.device("cpu")] * 4)
    assert sum(used.values()) == used[CPU_CARDS[0]] * 4
    assert _same(at_once, in_order) and _same(at_once, one_device)


def test_probe_pairs_in_order_and_at_once(runner_world):
    """probes/multicard's paired readings: the search and the build read in
    order, then at once, pass same_bits / same_index; a changed id, stat,
    launch count or shard tensor fails them."""
    w = runner_world
    mesh = tmesh.make_mesh(4, devices=CPU_CARDS)
    sharded = tsh.shard_index(w["index"], 4, mesh=mesh)
    first, second = mc.in_order_and_at_once(
        lambda: tsh.sharded_global_search(sharded, w["queries"], mesh=mesh))
    mc.same_bits(first, second, "global")
    assert "QPS" in mc._pair(first, second, 31) and "QPS" not in mc._pair(first, second)
    d, i, st = second.out
    i2 = i.copy()
    i2[0, 0] = i[0, 1]  # a swap within a row: beyond a boundary tie
    with pytest.raises(AssertionError):
        mc.same_bits(first, dataclasses.replace(second, out=(d, i2, st)), "ids")
    st2 = st._replace(candidates=st.candidates + 1)
    with pytest.raises(AssertionError, match="differ in their bits"):
        mc.same_bits(first, dataclasses.replace(second, out=(d, i, st2)), "stats")
    with pytest.raises(AssertionError, match="launches"):
        mc.same_bits(first, dataclasses.replace(second, k7={0: 1}), "launches")
    with pytest.raises(AssertionError, match="window filter"):
        mc.same_bits(first, dataclasses.replace(second, wf={0: 1}), "launches")
    (b1, spans1), (b2, _) = mc.in_order_and_at_once(
        lambda: tsh.build_sharded(w["train"], w["cfg"], mesh=mesh), spans=True)
    mc.same_index(b1.out, b2.out, "build")
    b2.out.sketches[2] = b2.out.sketches[2] ^ 1
    with pytest.raises(AssertionError, match=r"sketches differs on shards \[2\]"):
        mc.same_index(b1.out, b2.out, "build")


def test_covered_is_the_union_length():
    assert mc._covered([]) == 0.0
    assert mc._covered([(5, 7), (0, 2), (1, 3), (6, 6.5)]) == 5.0


def test_profile_overlap_reads_both_runs(runner_world, capsys):
    w = runner_world
    mesh = tmesh.make_mesh(4, devices=CPU_CARDS)
    sharded = tsh.shard_index(w["index"], 4, mesh=mesh)
    mc.profile_overlap(lambda: tsh.sharded_global_search(sharded, w["queries"][:8], mesh=mesh),
                       "the CPU mesh")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[cards] profile of the CPU mesh: in order ")
    assert "Python between them" in line and "at once" in line


def test_thread_ops_reads_the_host_cost(capsys):
    mc.thread_ops("the CPU", ops=200, sync_every=16, kinds=("cpu",))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[cards] host cost per torch op on 4 cpu devices")


def test_workers_take_turns_between_host_reads():
    """Inside taking_turns one worker at a time issues; the turn passes on
    at every host_read, so reads overlap another worker's issuing; a body
    that raises gives the turn back; outside a worker both do nothing."""
    lock, active, peak, overlapped = threading.Lock(), [0], [0], [0]

    def read():
        time.sleep(0.001)  # the device work a host sync waits for
        with lock:
            overlapped[0] += active[0] > 0

    def body(i):
        with tmesh.taking_turns():
            for _ in range(30):
                with lock:
                    active[0] += 1
                    peak[0] = max(peak[0], active[0])
                time.sleep(0.0005)  # issuing ops
                with lock:
                    active[0] -= 1
                tmesh.host_read(read)
            if i == 2:
                raise KeyError("shard 2")
        return i

    with pytest.raises(KeyError, match="shard 2"):
        tmesh.run_shards(CPU_CARDS, body)
    assert peak[0] == 1 and overlapped[0] > 0
    assert tmesh.run_shards(CPU_CARDS, lambda i: tmesh.host_read(lambda: i)) == [0, 1, 2, 3]
    with tmesh.taking_turns():
        assert tmesh.host_read(lambda: 5) == 5
    assert not tmesh._TURN.locked()

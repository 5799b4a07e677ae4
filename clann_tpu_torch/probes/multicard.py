"""The sharded layer on several CUDA cards: checks and readings.

The JAX package runs its sharded paths in two forms: one controller
driving a mesh over every chip (`shard_map`), and one process per host
joined by `jax.distributed`. This module holds the port's counterparts of
its multichip checks on four cards, in both forms:

- `still_on_card_0`, `clann_lands_on_card_0`: a kernel launched on another
  card leaves the caller's current device as it was (the launches go
  through csrc/device_scope.cuh), so "cuda" still means cuda:0;
- `collectives`: the default meshes span every card, and all_gather /
  owner_row (once per sharded GMM iteration) over the cards return what
  they return on one card, timed beside it;
- `glove_scan`, `glove_lsh`, `glove_walk`, `glove_jaccard`: every sharded
  path with its shards on cuda:0-3 (`make_mesh(4)`, one controller) held
  to the same call on a one-card 4-shard mesh: ids per query up to ties,
  distance computations and kernel launches equal; each shard's tensors on
  its own card, each K1 / K7 / window filter launch on its shard's card
  (the global engine launches the window filter). The global engine,
  the walk, Jaccard and build_sharded are read twice on the cards, the
  shard bodies forced in order (`parallel.mesh._shards_in_order`), then at
  once (`parallel.mesh.run_shards`, one worker per card), and the two
  readings must agree bit for bit (`same_bits`, `same_index`);
- `dryruns`: `parallel.sharded.dryrun` and `dryrun_large` over the cards;
- `nccl_ranks`: one process per card (`parallel/distributed`, NCCL, a
  file:// rendezvous) runs `build_sharded` and two searches; rank 0's
  results must equal the single-controller run's;
- `past_one_card`: an index larger than one card's memory, built with
  `build_sharded` across the cards and searched, against ground truth from
  one card's brute force.

Each prints one line per reading, prefixed "[cards]", and raises
AssertionError on a failed gate (nothing is caught). Readings: seconds or
QPS beside the one-card mesh and the single-device path, each card's peak
memory (`torch.cuda.max_memory_allocated(card)`); each card's device
busy share comes from the profiler (`profile_overlap`). chip_smoke.py
--cards 4 drives them. A rank of `nccl_ranks` is this module run as

    python -m clann_tpu_torch.probes.multicard --rank R --world W --init URL --work DIR
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# bench.py's gates: the scans' recall@10 and id-recall; the LSH engines'
# recall@10 >= LSH_GATE * delta (the PUFFINN contract)
RECALL_GATE, ID_RECALL_GATE, LSH_GATE = 0.9, 0.8, 0.8
K = 10
# the glove-100-angular shape of bench.py (clustered_unit_vectors' knobs)
GLOVE_N, GLOVE_D, GLOVE_QUERIES, GLOVE_MODES, GLOVE_SPREAD = 1_183_514, 100, 10_000, 1024, 0.7
GLOVE_LSH_QUERIES, GLOVE_DELTA = 2_048, 0.95
# an index past one card: 20,000,000 x 100 at the lsh configuration
PAST_N = 20_000_000
PAST_GT_BLOCK = 128  # brute-force query block: a (128, n) f32 tile is 10 GB at PAST_N
# the cards this process synchronizes and reads (None: every visible card);
# a rank of the NCCL run touches only its own
LOCAL_CARDS: Optional[List[int]] = None


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"[cards] {what}")


def cards(n: int) -> List[torch.device]:
    """cuda:0 .. cuda:n-1; fails when fewer are visible."""
    check(torch.cuda.device_count() >= n,
          f"{n} cards asked for, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(n)]


def cards_mesh(n: int):
    """A mesh of n shards, shard s on cuda:s."""
    from clann_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=cards(n))


def one_card_mesh(n: int):
    """A mesh of n shards, all on cuda:0 (the shape of chip_smoke's [sharded])."""
    from clann_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def _local_cards() -> List[int]:
    return list(range(torch.cuda.device_count())) if LOCAL_CARDS is None else LOCAL_CARDS


def sync_all() -> None:
    for i in _local_cards():
        torch.cuda.synchronize(i)


def reset_peaks() -> None:
    for i in _local_cards():
        torch.cuda.reset_peak_memory_stats(i)


def peaks_gb() -> List[float]:
    """Each card's peak allocated memory since reset_peaks, GB."""
    return [round(torch.cuda.max_memory_allocated(i) / 1e9, 3) for i in _local_cards()]


def still_on_card_0(what: str) -> None:
    check(torch.cuda.current_device() == 0,
          f"{what} left the current device at cuda:{torch.cuda.current_device()}")


@dataclasses.dataclass
class Reading:
    """One timed call: its result, wall seconds and the K1 / K7 / window
    filter / score-and-merge launches by card (the global engine launches
    the window filter and the score-and-merge, the walk and Jaccard's
    engine K7)."""

    out: object
    seconds: float
    k1: Dict[int, int]
    k7: Dict[int, int]
    wf: Dict[int, int]
    sm: Dict[int, int]

    def line(self) -> str:
        return f"{self.seconds:.3f} s"


def timed(fn: Callable[[], object]) -> Reading:
    """Run fn with the launch counts at 0, every card synchronized before
    and after."""
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops import scan_topk as st
    from clann_tpu_torch.ops import score_merge as tsm
    from clann_tpu_torch.ops import window_filter as twf

    sync_all()
    st.KERNEL_LAUNCHES = 0
    st.KERNEL_DEVICE_LAUNCHES.clear()
    tg.reset_launches()
    twf.reset_launches()
    tsm.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return Reading(out, time.perf_counter() - t0, dict(st.KERNEL_DEVICE_LAUNCHES),
                   dict(tg.ROWS_DEVICE_LAUNCHES), dict(twf.FILTER_DEVICE_LAUNCHES),
                   dict(tsm.SCORE_DEVICE_LAUNCHES))


def timed_spans(fn: Callable[[], object]):
    """timed(fn) with the package tracer on: (the reading, {span: seconds})
    (build_sharded's stages synchronize their cards)."""
    from clann_tpu_torch.metrics.trace import TRACER

    TRACER.clear()
    TRACER.enabled = True
    try:
        r = timed(fn)
    finally:
        TRACER.enabled = False
    return r, dict(TRACER.totals)


def _spans(spans: Dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(spans.items()))


def median_qps(fn: Callable[[], object], n_queries: int, reps: int = 3):
    """(QPS of the median call, per-call seconds) over `reps` synchronized
    calls."""
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append(time.perf_counter() - t0)
    return n_queries / float(np.median(times)), times


def _fmt_times(times: Sequence[float]) -> str:
    return ", ".join(f"{t:.4f}" for t in times)


def shards_on_cards(sharded, devices: Sequence[torch.device], what: str) -> None:
    """Every per-shard tensor of a sharded index lies on its shard's card."""
    for f in dataclasses.fields(sharded):
        parts = getattr(sharded, f.name)
        if not isinstance(parts, list):
            continue
        for s, t in enumerate(parts):
            if isinstance(t, torch.Tensor):
                check(t.device == devices[s],
                      f"{what}: {f.name}[{s}] lies on {t.device}, not on {devices[s]}")


def same_search(a, b, what: str, atol: float = 1e-5) -> float:
    """Two sharded searches' (dists, ids, stats): ids per query equal up to
    boundary ties, values within atol, distance computations equal. Returns
    the share of identical ids."""
    from clann_tpu_torch.testing import assert_topk_match

    assert_topk_match(a[1], a[0], b[1], b[0], atol=atol)
    check(np.array_equal(a[2].distance_computations, b[2].distance_computations),
          f"{what}: distance computations differ")
    return float(np.mean(np.asarray(a[1]) == np.asarray(b[1])))


def in_order_and_at_once(fn: Callable[[], object], spans: bool = False):
    """fn read twice: its shard bodies forced in order, then at once (the
    default). Returns the two readings (with the tracer's stage seconds
    when `spans`)."""
    from clann_tpu_torch.parallel import mesh as pm

    read = timed_spans if spans else timed
    with pm._shards_in_order():
        first = read(fn)
    return first, read(fn)


def same_bits(a: Reading, b: Reading, what: str, by_card: bool = True) -> None:
    """Two readings of one search: distances, ids and every stat equal bit
    for bit (same_search at atol 0 first, for its message), and the same
    K1 / K7 / window filter launches, by card (or in all, for two layouts
    of the cards)."""
    same_search(a.out, b.out, what, atol=0.0)
    check(all(np.array_equal(x, y) for x, y in zip(a.out[:2], b.out[:2]))
          and all(np.array_equal(x, y) for x, y in zip(a.out[2], b.out[2])),
          f"{what}: the results differ in their bits")
    count = (lambda c: c) if by_card else (lambda c: sum(c.values()))
    check(count(a.k1) == count(b.k1) and count(a.k7) == count(b.k7)
          and count(a.wf) == count(b.wf),
          f"{what}: launches K1 {a.k1} / {b.k1}, K7 {a.k7} / {b.k7}, window filter "
          f"{a.wf} / {b.wf}")


def same_index(a, b, what: str) -> None:
    """Two sharded indexes equal shard for shard, every tensor bit for bit
    (on the same cards) and every other field equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            bad = [s for s, (u, v) in enumerate(zip(x, y))
                   if not (u is None and v is None) and not torch.equal(u, v.to(u.device))]
            check(len(x) == len(y) and not bad, f"{what}: {f.name} differs on shards {bad}")
        elif isinstance(x, torch.Tensor):
            check(torch.equal(x, y.to(x.device)), f"{what}: {f.name} differs")
        elif not isinstance(x, dict):
            check(x == y, f"{what}: {f.name} differs")


def _pair(first: Reading, second: Reading, n_queries: int = 0) -> str:
    """The in-order and at-once readings side by side."""
    qps = (lambda r: f"{n_queries / r.seconds:.1f} QPS, ") if n_queries else (lambda r: "")
    return (f"in order {qps(first)}{first.line()}; at once {qps(second)}{second.line()}; "
            f"{first.seconds / second.seconds:.2f}x")


def _covered(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _is_span(e) -> bool:
    """A range of the package tracer (`engine/body`, ...), not a torch op."""
    return "/" in e.name and "::" not in e.name


def _outside_ops(e) -> bool:
    """No torch op encloses the profiler event `e` (tracer ranges may)."""
    p = e.cpu_parent
    while p is not None and _is_span(p):
        p = p.cpu_parent
    return p is None


def profile_overlap(fn: Callable[[], object], what: str) -> None:
    """fn under torch.profiler, its shard bodies in order and then at once
    (the second of two sessions each): each card's device busy share (the
    union of its kernels and copies over the wall; the profiler sees every
    thread's device work) and, in order, the calling thread's time inside
    torch ops (the union of its outermost ops, host syncs included, the
    package tracer's ranges not counted as ops; the profiler records the
    ops of that thread only). The rest of the in-order
    wall is Python between the ops, which holds the interpreter lock: the
    at-once run cannot take less than it, so wall / Python bounds its
    speed-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clann_tpu_torch.parallel import mesh as pm

    def session():
        for _ in range(2):  # the first session pays the profiler's start-up
            sync_all()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync_all()
                wall_us = (time.perf_counter() - t0) * 1e6
        cards_iv: Dict[int, list] = collections.defaultdict(list)
        ops_iv = []
        for e in prof.events():
            iv = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                cards_iv[e.device_index].append(iv)
            elif not _is_span(e) and _outside_ops(e):
                ops_iv.append(iv)
        busy = ", ".join(f"cuda:{c} {_covered(v) / wall_us:.3f}"
                         for c, v in sorted(cards_iv.items()))
        return wall_us, busy, _covered(ops_iv)

    with pm._shards_in_order():
        wall_o, busy_o, ops_o = session()
    wall_a, busy_a, _ = session()
    glue = wall_o - ops_o
    log(f"[cards] profile of {what}: in order {wall_o / 1e3:.1f} ms under the profiler, "
        f"device busy share per card {busy_o}; the thread inside torch ops "
        f"{ops_o / 1e3:.1f} ms, Python between them {glue / 1e3:.1f} ms ({glue / wall_o:.3f} "
        f"of the wall: a bound of {wall_o / max(glue, 1.0):.2f}x on running the bodies at "
        f"once under one interpreter lock); at once {wall_a / 1e3:.1f} ms "
        f"({wall_o / wall_a:.2f}x), device busy share per card {busy_a}")


def _recall(gt_d, gt_i, d, i):
    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values

    return recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, i, K)


def _launch_line(counts: Dict[int, int]) -> str:
    return "{" + ", ".join(f"cuda:{i} {n}" for i, n in sorted(counts.items())) + "}"


def _every_card(counts: Dict[int, int], n: int, what: str, per_card: Optional[int] = None):
    """A path on n cards launched its kernel on each card (exactly
    per_card times each when given) and on no other."""
    check(sorted(counts) == list(range(n)) and all(v > 0 for v in counts.values()),
          f"{what}: launches by card {counts}, not on each of cuda:0-{n - 1}")
    if per_card is not None:
        check(all(v == per_card for v in counts.values()),
              f"{what}: launches by card {counts}, not {per_card} on each")


def _only_card_0(counts: Dict[int, int], what: str, total: Optional[int] = None):
    """A path on the one-card mesh launched its kernel on cuda:0 alone
    (`total` times when given)."""
    check(list(counts) == [0] and (total is None or counts[0] == total),
          f"{what}: launches by card {counts}")


# --- device hygiene ---------------------------------------------------------

def clann_lands_on_card_0(train: np.ndarray, label: str) -> None:
    """After a launch on the last card, Clann(device="cuda") and a plain
    "cuda" tensor land on cuda:0 (the current device)."""
    import clann_tpu_torch
    from clann_tpu_torch.ops.distances import resolve_device

    still_on_card_0("the launches before Clann(device='cuda')")
    cfg = clann_tpu_torch.Config(num_tables=8, num_clusters_factor=0.4, k=K, seed=0,
                                 dense_layout=False)
    h = clann_tpu_torch.Clann(train[:20_000], config=cfg, device="cuda")
    h.build()
    on = h.index.vectors.device
    plain = torch.empty(1, device=resolve_device("cuda")).device
    log(f"[cards] Clann(device='cuda') after the launches on cuda:1-3: index on {on}; a "
        f"'cuda' tensor on {plain}; current device cuda:{torch.cuda.current_device()} on "
        f"{label}")
    check(on == torch.device("cuda", 0) and plain == torch.device("cuda", 0),
          f"Clann(device='cuda') built on {on}, a 'cuda' tensor on {plain}, not cuda:0")


def collectives(label: str, n_cards: int = 4, d: int = GLOVE_D, calls: int = 200) -> None:
    """make_mesh() and make_mesh_2d(2, 2) with no devices span cuda:0-3;
    owner_row (the sharded GMM's center row, once per iteration) and
    all_gather over the cards give what they give on the one-card mesh,
    each call timed beside it; whether each card reaches cuda:0 by peer
    access (torch then copies peer to peer, with no host round trip)."""
    from clann_tpu_torch.parallel.mesh import all_gather, make_mesh, make_mesh_2d, owner_row

    devs = cards(n_cards)
    spans = make_mesh().cluster_devices()
    check(len(spans) == torch.cuda.device_count() and spans[:n_cards] == devs
          and make_mesh_2d(2, 2).devices.reshape(-1).tolist() == devs[:4],
          f"make_mesh() spans {spans}, not every visible card")
    peer = [torch.cuda.can_device_access_peer(0, i) for i in range(1, n_cards)]
    times = {}
    for name, mesh in (("four cards", cards_mesh(n_cards)), ("one card", one_card_mesh(n_cards))):
        ds = mesh.cluster_devices()
        lead = ds[0]
        g = torch.Generator().manual_seed(0)
        rows = [torch.randn(d, generator=g).to(dv) for dv in ds]
        owns = [torch.tensor(s == n_cards - 1, device=dv) for s, dv in enumerate(ds)]
        vals = [torch.tensor(float(s), device=dv) for s, dv in enumerate(ds)]
        check(torch.equal(owner_row(mesh, rows, owns, lead), rows[-1].to(lead))
              and all_gather(mesh, vals, lead).tolist() == [float(s) for s in range(n_cards)],
              f"owner_row / all_gather on {name} give other values")
        for what, fn in (("owner_row", lambda: owner_row(mesh, rows, owns, lead)),
                         ("all_gather", lambda: all_gather(mesh, vals, lead))):
            sync_all()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync_all()
            times[(what, name)] = (time.perf_counter() - t0) / calls * 1e6
    log(f"[cards] make_mesh() spans {[str(x) for x in spans]}; "
        f"cuda:0 reaches cuda:1-{n_cards - 1} by peer access {peer}; owner_row of a "
        f"{d}-float row over cuda:0-{n_cards - 1} {times[('owner_row', 'four cards')]:.1f} us "
        f"per call (one card {times[('owner_row', 'one card')]:.1f}), all_gather of 0-d "
        f"parts {times[('all_gather', 'four cards')]:.1f} us (one card "
        f"{times[('all_gather', 'one card')]:.1f}), {calls} synchronized calls each; values "
        f"equal to the one-card mesh's on {label}")


def thread_ops(label: str, n_cards: int = 4, ops: int = 20_000, sync_every: int = 64,
               kinds: Sequence[str] = ("cuda", "cpu")) -> None:
    """The host's cost per torch op when one worker thread per device
    issues (run_shards) against one thread in order: each of n_cards
    bodies adds 1 to a 16-float tensor `ops` times, reading a sum back
    every `sync_every` ops (a loop body's host sync), on cuda:0-3 and on
    four CPU devices (no CUDA at all: the interpreter lock alone); at once
    both side by side and taking turns (parallel.mesh.taking_turns, the
    turn passed on at each read, as the LSH loops run)."""
    from clann_tpu_torch.parallel import mesh as pm

    for kind in kinds:
        devs = [torch.device(kind, i) for i in range(n_cards)]
        xs = [torch.zeros(16, device=d) for d in devs]

        def body(i, turns):
            with pm.taking_turns() if turns else contextlib.nullcontext():
                x = xs[i]
                for j in range(ops):
                    x = x + 1
                    if (j + 1) % sync_every == 0:
                        pm.host_read(x.sum().item)
                return x

        times = []
        for forced, turns in ((True, False), (False, False), (False, True)):
            sync_all()
            t0 = time.perf_counter()
            with pm._shards_in_order() if forced else contextlib.nullcontext():
                out = pm.run_shards(devs, lambda i: body(i, turns))
            sync_all()
            times.append(time.perf_counter() - t0)
            check(all(float(x[0]) == ops for x in out), f"thread_ops on {kind}: wrong sums")
        per_op = [t / (n_cards * ops) * 1e6 for t in times]
        log(f"[cards] host cost per torch op on {n_cards} {kind} devices ({ops} one-element "
            f"additions each, a host sync every {sync_every}): in order {per_op[0]:.2f} us, at "
            f"once side by side {per_op[1]:.2f} us ({times[0] / times[1]:.2f}x), taking turns "
            f"{per_op[2]:.2f} us ({times[0] / times[2]:.2f}x), per op over the {n_cards} "
            f"workers on {label}")


# --- the glove shape, one controller -----------------------------------------

def glove_scan(handle, train, test, gt_d, gt_i, label: str, n_cards: int = 4) -> int:
    """The main-path index over n_cards cards: shard_index, the fused scan
    per card (K1) and the exact scan on the 10,000 queries, build_sharded
    with the index's config; each against the one-card mesh. Returns the
    K1 launches of the four-card fused scan (one call)."""
    from clann_tpu_torch.parallel import sharded as sh
    from clann_tpu_torch.testing import sharded_real_slot_mismatches

    devs, four, one = cards(n_cards), cards_mesh(n_cards), one_card_mesh(n_cards)
    idx = handle.index
    sync_all()
    reset_peaks()
    r1 = timed(lambda: sh.shard_index(idx, n_cards, mesh=one))
    r4 = timed(lambda: sh.shard_index(idx, n_cards, mesh=four))
    s1, s4 = r1.out, r4.out
    shards_on_cards(s4, devs, "shard_index")
    still_on_card_0("shard_index")
    log(f"[cards] shard_index of the main-path index over cuda:0-{n_cards - 1}: "
        f"{r4.seconds:.3f} s (one card {r1.seconds:.3f} s); every shard tensor on its card; "
        f"peak memory per card {peaks_gb()} GB on {label}")

    def fused(s, m):
        return lambda: sh.sharded_scan_search(s, test, k=K, use_pallas=True, mesh=m)

    reset_peaks()
    a1, a4 = timed(fused(s1, one)), timed(fused(s4, four))  # the first calls build the bases
    still_on_card_0("the sharded fused scan")
    same = same_search(a4.out, a1.out, "sharded scan-pallas")
    rec, idr = _recall(gt_d, gt_i, a4.out[0], a4.out[1])
    _every_card(a4.k1, n_cards, "the four-card fused scan", per_card=1)
    _only_card_0(a1.k1, "the one-card fused scan", total=n_cards)
    check(rec >= RECALL_GATE and idr >= ID_RECALL_GATE,
          f"four-card scan-pallas recall@10 {rec:.4f} / id-recall {idr:.4f} below the gates")
    b4 = timed(fused(s4, four))
    q4, t4 = median_qps(fused(s4, four), len(test))
    q1, t1 = median_qps(fused(s1, one), len(test))
    qs, ts = median_qps(lambda: handle.search_batch(test, mode="scan-pallas"), len(test))
    log(f"[cards] sharded_scan_search(use_pallas=True), {len(test)} queries on "
        f"cuda:0-{n_cards - 1}: recall@10 {rec:.4f} (gate {RECALL_GATE}), id-recall {idr:.4f} "
        f"(gate {ID_RECALL_GATE}); ids equal to the one-card 4-shard mesh up to ties ({same:.5f} "
        f"identical), dc equal; K1 launches {_launch_line(a4.k1)} (one card "
        f"{_launch_line(a1.k1)}); first call {a4.seconds:.3f} s (bases built; one card "
        f"{a1.seconds:.3f} s); {q4:.0f} QPS (median of 3: {_fmt_times(t4)}) beside the one-card "
        f"mesh {q1:.0f} ({_fmt_times(t1)}) and the single device {qs:.0f} "
        f"({_fmt_times(ts)}); one call {b4.line()}; peak memory per card {peaks_gb()} GB on "
        f"{label}")

    e1 = timed(lambda: sh.sharded_scan_search(s1, test, k=K, exact=True, mesh=one))
    e4 = timed(lambda: sh.sharded_scan_search(s4, test, k=K, exact=True, mesh=four))
    same_e = same_search(e4.out, e1.out, "sharded exact scan")
    log(f"[cards] sharded_scan_search(exact=True) on cuda:0-{n_cards - 1}: {e4.line()} (one card "
        f"{e1.seconds:.3f} s); ids equal to the one-card mesh up to ties ({same_e:.5f} "
        f"identical), recall@10 {_recall(gt_d, gt_i, e4.out[0], e4.out[1])[0]:.4f}")
    k1 = sum(a4.k1.values())
    del s1, s4, a1, a4, b4, e1, e4
    sh._SHARD_BASE_CACHE.clear()

    sync_all()
    reset_peaks()
    g1, spans1 = timed_spans(lambda: sh.build_sharded(train, idx.config, mesh=one))
    (g4o, spans4o), (g4, spans4) = in_order_and_at_once(
        lambda: sh.build_sharded(train, idx.config, mesh=four), spans=True)
    shards_on_cards(g4.out, devs, "build_sharded")
    still_on_card_0("build_sharded")
    same_index(g4o.out, g4.out, "build_sharded in order against at once")
    g4o.out = None
    bad = sharded_real_slot_mismatches(g1.out, g4.out)
    log(f"[cards] build_sharded (sharded GMM, per-shard hashing, sorts, global tables) with "
        f"the main path's config on cuda:0-{n_cards - 1}: {_pair(g4o, g4)}, equal shard for "
        f"shard (stages in order: {_spans(spans4o)}; at once: {_spans(spans4)}); one card "
        f"{g1.seconds:.3f} s: {_spans(spans1)}; real slots equal to the one-card build: "
        f"{not bad}; peak memory per card {peaks_gb()} GB")
    check(not bad, f"build_sharded on the cards differs from the one-card build in {bad[:8]}")
    return k1


def glove_lsh(lsh, train, test, gt_d, gt_i, label: str, n_cards: int = 4,
              queries: int = GLOVE_LSH_QUERIES, delta: float = GLOVE_DELTA,
              mesh_2d_queries: int = 256, join_k: int = 100, join_delta: float = 0.9,
              profile: bool = False):
    """The lsh index over n_cards cards: the global engine per card (the
    window filter), the 2 x 2 mesh, the table-sharded join; then
    build_sharded with the lsh configuration and its two searches, which
    the NCCL run is held to. With `profile`, profile_overlap of the
    four-card global engine. Returns ((window filter, score-and-merge)
    launches of the four-card global search, the reference results
    {"global": ..., "scan": ...})."""
    from clann_tpu_torch.parallel import sharded as sh
    from clann_tpu_torch.parallel.join import sharded_closest_pairs
    from clann_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from clann_tpu_torch.testing import sharded_real_slot_mismatches

    devs, four, one = cards(n_cards), cards_mesh(n_cards), one_card_mesh(n_cards)
    q, gd, gi = test[:queries], gt_d[:queries], gt_i[:queries]
    sync_all()
    reset_peaks()
    s1 = sh.shard_index(lsh.index, n_cards, mesh=one)
    s4 = sh.shard_index(lsh.index, n_cards, mesh=four)
    shards_on_cards(s4, devs, "shard_index (lsh)")
    r1 = timed(lambda: sh.sharded_global_search(s1, q, delta=delta, mesh=one))
    r4o, r4 = in_order_and_at_once(lambda: sh.sharded_global_search(s4, q, delta=delta,
                                                                    mesh=four))
    still_on_card_0("the sharded global engine")
    same_bits(r4o, r4, "the four-card global engine in order against at once")
    same = same_search(r4.out, r1.out, "sharded global engine")
    same_bits(r4, r1, "the four-card global engine against the one-card mesh", by_card=False)
    rec, idr = _recall(gd, gi, r4.out[0], r4.out[1])
    _every_card(r4.wf, n_cards, "the four-card global engine")
    _only_card_0(r1.wf, "the one-card global engine", total=sum(r4.wf.values()))
    check(rec >= LSH_GATE * delta, f"four-card global engine recall@10 {rec:.4f}")
    single = timed(lambda: lsh.search_batch(q, mode="lsh"))
    log(f"[cards] sharded_global_search delta={delta}, {queries} queries in one batch on "
        f"cuda:0-{n_cards - 1}: recall@10 {rec:.4f} (gate {LSH_GATE * delta:.2f}), id-recall "
        f"{idr:.4f}; ids equal to the one-card mesh up to ties ({same:.5f} identical), dc "
        f"equal ({float(np.mean(r4.out[2].distance_computations)):.1f}/query); window filter "
        f"launches {_launch_line(r4.wf)} (one card {_launch_line(r1.wf)}); "
        f"{_pair(r4o, r4, queries)}, "
        f"bit-identical; one-card mesh {queries / r1.seconds:.1f} QPS ({r1.line()}), "
        f"bit-identical; "
        f"single device (facade, batches of 256) {queries / single.seconds:.1f} QPS; peak "
        f"memory per card {peaks_gb()} GB on {label}")
    launches = sum(r4.wf.values()), sum(r4.sm.values())
    check(r4.sm == r4.wf, f"the four-card global engine launched the window filter {r4.wf} "
                          f"and the score-and-merge {r4.sm} by card")
    if profile:
        profile_overlap(lambda: sh.sharded_global_search(s4, q, delta=delta, mesh=four),
                        f"sharded_global_search, {queries} queries on cuda:0-{n_cards - 1}")
    del s1, r1, r4, r4o

    # the 2 x 2 (query, cluster) mesh: cluster shards on cuda:0-1, the
    # second query block on cuda:2-3
    q2 = q[:mesh_2d_queries]
    half1 = sh.shard_index(lsh.index, 2, mesh=make_mesh(2, devices=[devs[0]] * 2))
    half4 = sh.shard_index(lsh.index, 2, mesh=make_mesh(2, devices=devs[:2]))
    m1 = timed(lambda: sh.sharded_global_search(
        half1, q2, delta=delta, mesh=make_mesh_2d(2, 2, devices=[devs[0]] * 4)))
    m4 = timed(lambda: sh.sharded_global_search(
        half4, q2, delta=delta, mesh=make_mesh_2d(2, 2, devices=devs[:4])))
    same2 = same_search(m4.out, m1.out, "2 x 2 mesh")
    _every_card(m4.wf, 4, "the four-card 2 x 2 mesh")
    log(f"[cards] 2 x 2 make_mesh_2d over cuda:0-3, {mesh_2d_queries} queries: ids equal to "
        f"the one-card 2 x 2 mesh up to ties ({same2:.5f} identical), dc equal; window filter "
        f"launches {_launch_line(m4.wf)}; {m4.line()} (one card {m1.seconds:.3f} s)")
    del half1, half4, m1, m4

    j1 = timed(lambda: sharded_closest_pairs(lsh.index, join_k, delta=join_delta, mesh=one))
    j4 = timed(lambda: sharded_closest_pairs(lsh.index, join_k, delta=join_delta, mesh=four))
    same_j = all(np.array_equal(x, y) for x, y in zip(j4.out, j1.out))
    log(f"[cards] sharded_closest_pairs(k={join_k}, delta={join_delta}) on cuda:0-"
        f"{n_cards - 1}: {j4.line()} (one card {j1.seconds:.3f} s); pairs and sims equal to "
        f"the one-card mesh: {same_j}")
    check(same_j, "the four-card join differs from the one-card join")

    # build_sharded with the lsh configuration: the reference of the NCCL run
    sync_all()
    reset_peaks()
    built, ref = controller_run(train, test, lsh.index.config, four, queries, delta)
    shards_on_cards(built, devs, "build_sharded (lsh)")
    bad = sharded_real_slot_mismatches(s4, built)
    log(f"[cards] build_sharded with the lsh configuration on cuda:0-{n_cards - 1}: "
        f"{ref['build_s']:.3f} s; real slots equal to shard_index of the single-device build: "
        f"{not bad}; peak memory per card {peaks_gb()} GB")
    check(not bad, f"build_sharded (lsh) differs from shard_index(build_index) in {bad[:8]}")
    del s4, built
    rec_g = _recall(gd, gi, ref["global"][0], ref["global"][1])[0]
    rec_s, idr_s = _recall(gt_d, gt_i, ref["scan"][0], ref["scan"][1])
    log(f"[cards] on that build: sharded_global_search {queries} queries recall@10 "
        f"{rec_g:.4f}, {queries / ref['global_s']:.1f} QPS; "
        f"sharded_scan_search(use_pallas=True) {len(test)} queries recall@10 {rec_s:.4f}, "
        f"id-recall {idr_s:.4f}, {len(test) / ref['scan_s']:.0f} QPS (second call)")
    check(rec_g >= LSH_GATE * delta and rec_s >= RECALL_GATE and idr_s >= ID_RECALL_GATE,
          "the four-card lsh build's searches are below their gates")
    return launches, ref


def controller_run(train, test, cfg, mesh, lsh_queries: int = GLOVE_LSH_QUERIES,
                   delta: float = GLOVE_DELTA):
    """What a rank of nccl_ranks runs, from one controller over `mesh`:
    build_sharded, the global engine on the first lsh_queries at delta,
    the fused scan on every query (its second call timed). Returns (the
    sharded index, {"global", "scan": (dists, ids, stats), their seconds,
    the build's and the launches by card})."""
    from clann_tpu_torch.parallel import sharded as sh

    b = timed(lambda: sh.build_sharded(train, cfg, mesh=mesh))
    built, q = b.out, test[:lsh_queries]
    g = timed(lambda: sh.sharded_global_search(built, q, delta=delta, mesh=mesh))
    sh._SHARD_BASE_CACHE.clear()
    timed(lambda: sh.sharded_scan_search(built, test, k=K, use_pallas=True, mesh=mesh))
    s = timed(lambda: sh.sharded_scan_search(built, test, k=K, use_pallas=True, mesh=mesh))
    sh._SHARD_BASE_CACHE.clear()
    return built, {"global": g.out, "scan": s.out, "global_s": g.seconds, "scan_s": s.seconds,
                   "build_s": b.seconds, "wf_global": g.wf, "k1_scan": s.k1}


def glove_walk(walk, test, gt_d, gt_i, single_batch_s: float, label: str,
               n_cards: int = 4, queries: int = 256, delta: float = 0.9) -> int:
    """One walk batch (slot records, K7) with the shards on the cards
    against the one-card mesh. Returns its K7 launches."""
    from clann_tpu_torch.parallel import sharded as sh

    devs, four, one = cards(n_cards), cards_mesh(n_cards), one_card_mesh(n_cards)
    q, gd, gi = test[:queries], gt_d[:queries], gt_i[:queries]
    sync_all()
    reset_peaks()
    s1 = sh.shard_index(walk.index, n_cards, mesh=one)
    s4 = sh.shard_index(walk.index, n_cards, mesh=four)
    shards_on_cards(s4, devs, "shard_index (walk)")
    check(s4.slot_records is not None, "the walk index's shards have no slot records")
    r1 = timed(lambda: sh.sharded_search(s1, q, delta=delta, mesh=one))
    r4o, r4 = in_order_and_at_once(lambda: sh.sharded_search(s4, q, delta=delta, mesh=four))
    still_on_card_0("the sharded walk")
    same_bits(r4o, r4, "the four-card walk in order against at once")
    same = same_search(r4.out, r1.out, "sharded walk")
    same_bits(r4, r1, "the four-card walk against the one-card mesh", by_card=False)
    rec, idr = _recall(gd, gi, r4.out[0], r4.out[1])
    _every_card(r4.k7, n_cards, "the four-card walk")
    _only_card_0(r1.k7, "the one-card walk", total=sum(r4.k7.values()))
    check(rec >= LSH_GATE * delta, f"four-card walk recall@10 {rec:.4f}")
    log(f"[cards] sharded_search (the walk) delta={delta}, one batch of {queries} on cuda:0-"
        f"{n_cards - 1}: recall@10 {rec:.4f} (gate {LSH_GATE * delta:.2f}), id-recall "
        f"{idr:.4f}; ids equal to the one-card mesh up to ties ({same:.5f} identical), dc "
        f"equal; K7 launches {_launch_line(r4.k7)}; {_pair(r4o, r4, queries)}, bit-identical; "
        f"one-card mesh {r1.seconds:.3f} s, bit-identical; single device {single_batch_s:.3f} "
        f"s per batch of 256; peak "
        f"memory per card {peaks_gb()} GB on {label}")
    return sum(r4.k7.values())


def glove_jaccard(data, queries, gt_s, cfg, threshold_recall, label: str,
                  n_cards: int = 4, batch: int = 128, delta: float = 0.9) -> int:
    """The Jaccard corpus built sharded over the cards against the one-card
    mesh (shard for shard), then the sharded search (K7) in batches, beside
    the flat single-device index. `threshold_recall(ids)` reads the
    threshold recall@10. Returns the four-card search's K7 launches."""
    from clann_tpu_torch.core import jaccard as tj
    from clann_tpu_torch.parallel import jaccard as pj

    devs, four, one = cards(n_cards), cards_mesh(n_cards), one_card_mesh(n_cards)
    nq = len(queries)
    sync_all()
    reset_peaks()
    b1 = timed(lambda: pj.build_jaccard_sharded(data, data.universe, cfg, mesh=one))
    b4o, b4 = in_order_and_at_once(
        lambda: pj.build_jaccard_sharded(data, data.universe, cfg, mesh=four))
    same_index(b4o.out, b4.out, "build_jaccard_sharded in order against at once")
    b4o.out = None
    j1, j4 = b1.out, b4.out
    shards_on_cards(j4, devs, "build_jaccard_sharded")
    bad = [f"{f}[{s}]" for f in pj.SHARD_FIELDS for s in range(n_cards)
           if not torch.equal(getattr(j1, f)[s], getattr(j4, f)[s].to(getattr(j1, f)[s].device))]
    check(not bad, f"build_jaccard_sharded on the cards differs from the one-card build in {bad}")

    def search(j, m):
        def run():
            res = [pj.sharded_jaccard_search(j, queries[s: s + batch], mesh=m)
                   for s in range(0, nq, batch)]
            return (np.concatenate([r[0] for r in res]), np.concatenate([r[1] for r in res]),
                    type(res[0][2])(*(np.concatenate([getattr(r[2], f) for r in res])
                                      for f in res[0][2]._fields)))
        return run

    r1 = timed(search(j1, one))
    r4o, r4 = in_order_and_at_once(search(j4, four))
    still_on_card_0("the sharded Jaccard search")
    same_bits(r4o, r4, "the four-card Jaccard search in order against at once")
    same = same_search(r4.out, r1.out, "sharded Jaccard search", atol=0.0)
    same_bits(r4, r1, "the four-card Jaccard search against the one-card mesh",
              by_card=False)
    rec = threshold_recall(r4.out[1])
    _every_card(r4.k7, n_cards, "the four-card Jaccard search")
    check(rec >= LSH_GATE * delta, f"four-card Jaccard threshold recall@10 {rec:.4f}")
    del j1
    flat = tj.build_jaccard_index(data, cfg, device=devs[0])
    single = timed(lambda: [tj.jaccard_search(flat, queries[s: s + batch])
                            for s in range(0, nq, batch)])
    log(f"[cards] build_jaccard_sharded on cuda:0-{n_cards - 1}: {_pair(b4o, b4)} "
        f"(one card {b1.seconds:.3f} s), equal shard for shard; sharded_jaccard_search, {nq} "
        f"queries in batches of {batch}: threshold recall@10 {rec:.4f} (gate "
        f"{LSH_GATE * delta:.2f}); ids equal to the one-card mesh up to ties ({same:.5f} "
        f"identical), dc equal; K7 launches {_launch_line(r4.k7)}; {_pair(r4o, r4, nq)}, "
        f"bit-identical; one-card mesh {nq / r1.seconds:.2f} QPS, bit-identical; single "
        f"device (flat) "
        f"{nq / single.seconds:.2f} QPS; peak memory per card {peaks_gb()} GB on {label}")
    return sum(r4.k7.values())


def dryruns(n_cards: int = 4) -> None:
    """The JAX package's multichip checks, the port's dryrun and
    dryrun_large, over cuda:0..n_cards-1."""
    from clann_tpu_torch.parallel import sharded as sh

    devs = cards(n_cards)
    for fn in (sh.dryrun, sh.dryrun_large):
        t0 = time.perf_counter()
        fn(n_cards, devices=devs)
        sync_all()
        still_on_card_0(fn.__name__)
        log(f"[cards] parallel.sharded.{fn.__name__}({n_cards}) over cuda:0-{n_cards - 1}: "
            f"passed in {time.perf_counter() - t0:.3f} s")


# --- one process per card ------------------------------------------------------

def nccl_ranks(cfg, reference, label: str, work_dir: str, world: int = 4,
               timeout_s: float = 900.0, *, n: int = GLOVE_N, queries: int = GLOVE_QUERIES,
               lsh_queries: int = GLOVE_LSH_QUERIES, delta: float = GLOVE_DELTA,
               device_type: str = "cuda") -> None:
    """`world` processes, one per card, each running this module's rank
    body over an NCCL group (file:// rendezvous in work_dir) on the glove
    shape cut to n points; rank 0's results must equal the
    single-controller run's (`reference`, from glove_lsh). A failed or
    hung rank fails the phase; every rank is stopped before it returns.
    device_type "cpu" runs the same layout over gloo, one CPU shard per
    process."""
    from clann_tpu_torch.parallel.sharded import _SHARD_BASE_CACHE

    on_cards = device_type == "cuda"
    if on_cards:
        cards(world)
        torch.cuda.empty_cache()
    _SHARD_BASE_CACHE.clear()
    os.makedirs(work_dir, exist_ok=True)
    for f in os.listdir(work_dir):
        os.remove(os.path.join(work_dir, f))
    with open(os.path.join(work_dir, "job.pkl"), "wb") as f:
        pickle.dump({"config": cfg, "n": n, "queries": queries, "lsh_queries": lsh_queries,
                     "delta": delta, "device_type": device_type}, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = root
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap over loopback
    init = f"file://{os.path.abspath(work_dir)}/rendezvous"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            out = open(os.path.join(work_dir, f"rank{r}.log"), "w")
            logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "clann_tpu_torch.probes.multicard", "--rank", str(r),
                 "--world", str(world), "--init", init, "--work", work_dir],
                cwd=root, env=dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world)),
                stdout=out, stderr=subprocess.STDOUT))
        deadline = t0 + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in logs:
            out.close()
    wall = time.perf_counter() - t0
    tails = {}
    for r in range(world):
        with open(os.path.join(work_dir, f"rank{r}.log")) as f:
            text = f.read()
        tails[r] = text[-3000:]
        for line in text.splitlines():
            if line.startswith("[cards]"):
                log(line)
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs),
          f"NCCL run: rank exit codes {rcs} after {wall:.1f} s (limit {timeout_s:.0f} s); "
          f"tails {json.dumps(tails)}")
    got = np.load(os.path.join(work_dir, "rank0.npz"))
    st_type = type(reference["global"][2])
    for key in ("global", "scan"):
        want = reference[key]
        mine = (got[f"{key}_d"], got[f"{key}_i"],
                st_type(*(got[f"{key}_{f}"] for f in st_type._fields)))
        same = same_search(mine, want, f"NCCL {key} against the single controller", atol=0.0)
        exact = (np.array_equal(mine[1], want[1]) and np.array_equal(mine[0], want[0]))
        log(f"[cards] {'NCCL' if on_cards else 'gloo'} rank 0's {key} results against the "
            f"single-controller run: ids equal up to ties ({same:.5f} identical), dc equal; "
            f"bit-identical {exact}")
    ranks = []
    for r in range(world):
        with open(os.path.join(work_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    nq_g, nq_s = len(reference["global"][1]), len(reference["scan"][1])
    log(f"[cards] one process per card, {world} ranks over {'NCCL' if on_cards else 'gloo'}: "
        f"{wall:.1f} s in all "
        f"(processes started, data made, built, searched); build_sharded "
        f"{max(r['build_s'] for r in ranks):.3f} s (single controller "
        f"{reference['build_s']:.3f} s); sharded_global_search {nq_g / ranks[0]['global_s']:.1f} "
        f"QPS (single controller {nq_g / reference['global_s']:.1f}); sharded_scan_search "
        f"(use_pallas) {nq_s / ranks[0]['scan_s']:.0f} QPS (single controller "
        f"{nq_s / reference['scan_s']:.0f}); K1 launches per rank "
        f"{[r['k1'] for r in ranks]}, window filter {[r['wf'] for r in ranks]}; peak memory "
        f"per card {[r['peak_gb'] for r in ranks]} GB on {label}")
    check(not on_cards or all(r["k1"] == 1 and r["wf"] > 0 for r in ranks),
          "a rank did not launch K1 once and the window filter on its own card")


def rank_main(rank: int, world: int, init: str, work: str) -> None:
    """One rank of nccl_ranks: the glove data from its seeds (cut to the
    job's n), build_sharded over the global mesh (this card only), the
    global engine on the first lsh_queries at delta and the fused scan on
    every query. Rank 0 writes the results; every rank writes its
    readings."""
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors
    from clann_tpu_torch.parallel.distributed import global_mesh, initialize_distributed

    global LOCAL_CARDS
    with open(os.path.join(work, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    cfg, on_cards = job["config"], job["device_type"] == "cuda"
    if on_cards:
        LOCAL_CARDS = [rank]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        me = torch.device("cuda", rank)
    else:
        LOCAL_CARDS = []
        me = torch.device("cpu")
    check(initialize_distributed(init, world, rank, backend=None if on_cards else "gloo"),
          "no process group opened")
    mesh = global_mesh(local_devices=None if on_cards else [me])
    check(mesh.multiprocess and mesh.cluster_devices()[0] == me
          and (not on_cards or torch.cuda.current_device() == rank),
          f"rank {rank}: mesh {mesh.cluster_devices()}")
    train = clustered_unit_vectors(job["n"], GLOVE_D, n_modes=GLOVE_MODES,
                                   spread=GLOVE_SPREAD, seed=0)
    test = clustered_unit_vectors(job["queries"], GLOVE_D, n_modes=GLOVE_MODES,
                                  spread=GLOVE_SPREAD, seed=1)
    reset_peaks()
    built, run = controller_run(train, test, cfg, mesh, job["lsh_queries"], job["delta"])
    shards_on_cards(built, [me] * world, f"rank {rank}'s build_sharded")
    k1, wf = run["k1_scan"], run["wf_global"]
    check(not on_cards or (set(wf) == {rank} and k1 == {rank: 1}),
          f"rank {rank} launched the window filter on {wf} and K1 on {k1}")
    if rank == 0:
        arrays = {}
        for key in ("global", "scan"):
            d, i, st = run[key]
            arrays.update({f"{key}_d": d, f"{key}_i": i},
                          **{f"{key}_{f}": getattr(st, f) for f in st._fields})
        np.savez(os.path.join(work, "rank0.npz"), **arrays)
    readings = {"build_s": run["build_s"], "global_s": run["global_s"],
                "scan_s": run["scan_s"], "k1": k1.get(rank, 0),
                "wf": wf.get(rank, 0), "peak_gb": peaks_gb()}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(readings, f)
    log(f"[cards] rank {rank} on {me}: build_sharded {run['build_s']:.3f} s, global "
        f"{run['global_s']:.3f} s, scan {run['scan_s']:.4f} s; shard {rank}'s "
        f"{built.shard_points[rank]} points")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# --- past one card -------------------------------------------------------------

def index_bytes_by_card(sharded) -> Dict[int, int]:
    """Bytes of a sharded index's per-shard tensors on each card."""
    out: Dict[int, int] = collections.defaultdict(int)
    for f in dataclasses.fields(sharded):
        parts = getattr(sharded, f.name)
        if isinstance(parts, list):
            for t in parts:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    out[t.device.index] += t.numel() * t.element_size()
    return dict(out)


def past_one_card(cfg, label: str, n: int = PAST_N, n_cards: int = 4,
                  queries: int = GLOVE_QUERIES, lsh_queries: int = GLOVE_LSH_QUERIES,
                  delta: float = GLOVE_DELTA) -> Dict[str, int]:
    """An index larger than one card: clustered_unit_vectors(n, 100, 1024
    modes, spread 0.7, seed 0), queries seed 1, the lsh configuration
    `cfg`; plan_capacity must read that it does not fit one card. Ground
    truth by brute_force_topk on cuda:0 (independent of the sharded code);
    build_sharded over cuda:0..n_cards-1 with its stage seconds; the global
    engine on lsh_queries at delta and the fused scan on all queries,
    gated. Returns the K1 / window filter / score-and-merge launches of the two
    searches."""
    from clann_tpu_torch.data.synthetic import clustered_unit_vectors
    from clann_tpu_torch.ops.distances import brute_force_topk
    from clann_tpu_torch.parallel import mesh as pm
    from clann_tpu_torch.parallel import sharded as sh
    from clann_tpu_torch.parallel.capacity import plan_capacity

    devs, four = cards(n_cards), cards_mesh(n_cards)
    t0 = time.perf_counter()
    train = clustered_unit_vectors(n, GLOVE_D, n_modes=GLOVE_MODES, spread=GLOVE_SPREAD, seed=0)
    test = clustered_unit_vectors(queries, GLOVE_D, n_modes=GLOVE_MODES, spread=GLOVE_SPREAD,
                                  seed=1)
    data_s = time.perf_counter() - t0
    plan = plan_capacity(n, GLOVE_D, cfg)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    share = plan.shardable_bytes / n_cards + plan.replicated_bytes
    log(f"[cards] past one card: {n} x {GLOVE_D} (data made on the host in {data_s:.1f} s); "
        f"plan_capacity: {(plan.shardable_bytes + plan.replicated_bytes) / 1e9:.1f} GB, "
        f"fits_single_chip {plan.fits_single_chip}, {plan.min_devices} cards needed, "
        f"{plan.recommended_devices} recommended; per-card share over {n_cards} "
        f"{share / 1e9:.2f} GB; a card holds {card_bytes / 1e9:.2f} GB")
    check(not plan.fits_single_chip, f"plan_capacity says {n} points fit one card")

    sync_all()
    t0 = time.perf_counter()
    gt_d, gt_i = brute_force_topk(train, test, k=K, device=devs[0], block_q=PAST_GT_BLOCK)
    gt_d, gt_i = gt_d.cpu().numpy(), gt_i.cpu().numpy()
    gt_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"[cards] ground truth: brute_force_topk of {queries} queries over the {n} f32 rows on "
        f"cuda:0 in {gt_s:.1f} s")

    # the build read twice: its shard bodies in order, then at once (the
    # in-order index stays on the cards for the comparison)
    sync_all()
    reset_peaks()
    with pm._shards_in_order():
        bo, spans_o = timed_spans(lambda: sh.build_sharded(train, cfg, mesh=four))
    peak_build = peaks_gb()
    reset_peaks()
    b, spans = timed_spans(lambda: sh.build_sharded(train, cfg, mesh=four))
    built = b.out
    shards_on_cards(built, devs, "build_sharded past one card")
    still_on_card_0("build_sharded past one card")
    same_index(bo.out, built, "build_sharded past one card in order against at once")
    bo.out = None
    torch.cuda.empty_cache()
    held = index_bytes_by_card(built)
    log(f"[cards] build_sharded over cuda:0-{n_cards - 1}: {_pair(bo, b)}, equal shard for "
        f"shard (stages, synchronized, in order: {_spans(spans_o)}; at once: {_spans(spans)}); "
        f"{sum(built.shard_clusters)} clusters, points per card {list(built.shard_points)}; "
        f"index bytes per card {[round(held.get(i, 0) / 1e9, 3) for i in range(n_cards)]} GB "
        f"({sum(held.values()) / 1e9:.2f} GB in all); peak memory per card {peak_build} GB in "
        f"order ({peaks_gb()} GB at once, the in-order index still held) beside plan_capacity's "
        f"share {share / 1e9:.2f} GB on {label}")
    check(sorted(held) == list(range(n_cards)), f"the index lies on cards {sorted(held)}")

    q = test[:lsh_queries]
    reset_peaks()
    g = timed(lambda: sh.sharded_global_search(built, q, delta=delta, mesh=four))
    rec_g, idr_g = _recall(gt_d[:lsh_queries], gt_i[:lsh_queries], g.out[0], g.out[1])
    _every_card(g.wf, n_cards, "the global engine past one card")
    log(f"[cards] past one card: sharded_global_search delta={delta}, {lsh_queries} queries: "
        f"recall@10 {rec_g:.4f} (gate {LSH_GATE * delta:.2f}), id-recall {idr_g:.4f}; dc/query "
        f"{float(np.mean(g.out[2].distance_computations)):.1f}; window filter launches "
        f"{_launch_line(g.wf)}; {lsh_queries / g.seconds:.1f} QPS, {g.line()}; peak memory "
        f"per card {peaks_gb()} GB")
    check(rec_g >= LSH_GATE * delta, f"past one card: global recall@10 {rec_g:.4f}")

    reset_peaks()
    s0 = timed(lambda: sh.sharded_scan_search(built, test, k=K, use_pallas=True, mesh=four))
    _every_card(s0.k1, n_cards, "the fused scan past one card", per_card=1)
    rec_s, idr_s = _recall(gt_d, gt_i, s0.out[0], s0.out[1])
    rate, times = median_qps(
        lambda: sh.sharded_scan_search(built, test, k=K, use_pallas=True, mesh=four), queries)
    s1 = timed(lambda: sh.sharded_scan_search(built, test, k=K, use_pallas=True, mesh=four))
    log(f"[cards] past one card: sharded_scan_search(use_pallas=True), {queries} queries: "
        f"recall@10 {rec_s:.4f} (gate {RECALL_GATE}), id-recall {idr_s:.4f} (gate "
        f"{ID_RECALL_GATE}); dc/query {float(np.mean(s0.out[2].distance_computations)):.0f}; "
        f"K1 launches {_launch_line(s0.k1)}; first call {s0.seconds:.3f} s (bases built); "
        f"{rate:.0f} QPS (median of 3: {_fmt_times(times)}); one call {s1.line()}; peak "
        f"memory per card {peaks_gb()} GB")
    check(rec_s >= RECALL_GATE and idr_s >= ID_RECALL_GATE,
          f"past one card: scan recall@10 {rec_s:.4f} / id-recall {idr_s:.4f}")
    # what serving both modes keeps on the cards: the index and the fused
    # scan's bases (bf16 rows, permuted f32 rows and ids per shard)
    bases = [t for hit in sh._SHARD_BASE_CACHE.values() for part in hit[1:] for t in part
             if t is not None]
    served = sum(held.values()) + sum(t.numel() * t.element_size() for t in bases)
    log(f"[cards] past one card: the index and the fused scan's bases hold {served / 1e9:.2f} "
        f"GB across the cards; one card holds {card_bytes / 1e9:.2f} GB")
    check(served > card_bytes, f"{served} bytes would fit one card of {card_bytes}")
    del built
    sh._SHARD_BASE_CACHE.clear()
    torch.cuda.empty_cache()
    return {"k1": sum(s0.k1.values()), "wf": sum(g.wf.values()), "sm": sum(g.sm.values())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of the NCCL run of nccl_ranks")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="the rendezvous URL (file:// or tcp://)")
    ap.add_argument("--work", required=True, help="the run's directory (config in, results out)")
    args = ap.parse_args(argv)
    rank_main(args.rank, args.world, args.init, args.work)


if __name__ == "__main__":
    main()

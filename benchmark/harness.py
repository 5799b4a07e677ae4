"""One run of one cell: set-up, a closed-loop window, the check, one line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the first statement of run.py): the
collection and the query pool (both fixed by the configuration) made on
the card, the pool ordered from the seed (``Ring``), the index built, the
cell's own batch shape warmed up, the peak-memory counters reset. The
window: one caller sends a batch of the pool, waits for the numpy results,
sends the next, until ``--seconds`` have passed; each batch is timed on the
host clock from the call to its results. With ``--trace 1`` a steady
stretch of the window is profiled. After the window the program is freed
and the reference judges every answer the window returned.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from benchmark import spec
from benchmark.trace import TraceSummary

FORBIDDEN = ("jax", "jaxlib", "flax", "clann_tpu")
ROOT = Path(__file__).resolve().parent.parent
WARMUP_BATCHES = 3
TRACE_AT = 1 / 3  # the traced stretch starts this far into the window
TRACE_SPAN_S = 2.0
NAME_CHARS = 120  # a profiler name is cut to its head (C++ kernels carry their templates)


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    cell: spec.Cell
    setup_s: float = 0.0
    build_s: float = 0.0
    batch_s: List[float] = field(default_factory=list)
    batch_rows: List[int] = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0  # window peak of the fullest card
    dc: Optional[np.ndarray] = None  # distance computations per window query
    numbers: dict = field(default_factory=dict)  # the check's readings
    trace: Optional[TraceSummary] = None

    @property
    def queries(self) -> int:
        return int(sum(self.batch_rows))


class Ring:
    """The window's batches. The pool, in an order drawn from the seed, is
    laid out twice, so that every batch is a contiguous view and the window
    copies nothing. Each replay of the pool starts at an offset of its own
    below the batch size, drawn from the seed without repeats, so no batch
    of one replay holds the queries of a batch of another, as long as there
    are fewer replays than queries in a batch: an answer cannot be reused."""

    def __init__(self, pool_q: np.ndarray, batch: int, seed: int):
        from benchmark.data.mixture import sub_seed

        rng = np.random.default_rng(sub_seed(seed, "order"))
        n = pool_q.shape[0]
        order = rng.permutation(n)
        self.rows = np.concatenate([order, order])
        self.queries = pool_q[self.rows]
        self.offsets = rng.permutation(batch)
        self.batch, self.per_replay = batch, n // batch

    def __call__(self, i: int):
        """(pool rows, queries) of the window's i-th batch."""
        replay, j = divmod(i, self.per_replay)
        s = int(self.offsets[replay % len(self.offsets)]) + j * self.batch
        return self.rows[s:s + self.batch], self.queries[s:s + self.batch]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float,
             devices, wrap: Optional[Callable] = None, program: bool = True,
             min_batches: int = 0, log=print):
    """Run `cell` once on `devices`. `wrap(search, train, pool) -> search`
    puts something in the timed path's place (the control, or a planted
    fault); with program=False the program is not built and `wrap` gets
    None. The window ends once `seconds` have passed and `min_batches`
    batches have come back. Returns (run, result line dict)."""
    import torch

    from benchmark.data.mixture import make_dataset
    from benchmark.port import System, sync
    from benchmark.reference.check import compare, judge

    traffic, config = cell.traffic, cell.config
    batch, pool = int(traffic["batch"]), int(traffic["pool"])
    run = Run(cell=cell)

    train, pool_q = make_dataset(config, pool, devices[0])
    ring = Ring(pool_q, batch, seed)
    system = System(config, traffic, devices) if program else None
    if system is not None:
        run.build_s = system.build(train)
    search = system.search if wrap is None else wrap(system and system.search, train, pool_q)
    for i in range(min(WARMUP_BATCHES, pool // batch)):  # batches the window never sends
        search(pool_q[i * batch:(i + 1) * batch])
    sync(devices)
    cuda = [d for d in devices if d.type == "cuda"]
    setup_peak = max([torch.cuda.max_memory_allocated(d) for d in cuda], default=0)
    for d in cuda:
        torch.cuda.reset_peak_memory_stats(d)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s (build {run.build_s:.3f} s); window {seconds} s",
        file=sys.stderr)

    answers, dcs = [], []  # (pool rows, distances, ids) of every batch
    prof = trace_t0 = trace_s = None
    traced_rows = traced_batches = 0
    span = min(TRACE_SPAN_S, seconds * TRACE_AT)
    i = 0
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    while True:
        rows, q = ring(i)
        t0 = time.perf_counter()
        if trace and prof is None and t0 - t_w0 >= seconds * TRACE_AT:
            prof = _profiler(devices)
            prof.start()
            trace_t0 = t0 = time.perf_counter()
        dists, ids, stats = search(q)
        t1 = time.perf_counter()
        run.batch_s.append(t1 - t0)
        run.batch_rows.append(len(q))
        answers.append((rows, dists, ids))
        dcs.append(System.distance_computations(stats))
        i += 1
        if trace_t0 is not None:
            traced_rows += len(q)
            traced_batches += 1
            if t1 - trace_t0 >= span and traced_batches >= 2:
                prof.stop()
                trace_s, trace_t0 = t1 - trace_t0, None
        # a traced run runs on until its stretch is over
        if t1 >= deadline and i >= min_batches and (not trace or trace_s is not None):
            break
    run.window_s = time.perf_counter() - t_w0
    if trace:
        run.trace = _summary(prof, trace_s, devices)
        run.trace.batches, run.trace.queries = traced_batches, traced_rows
    run.peak_bytes = max([torch.cuda.max_memory_allocated(d) for d in cuda], default=0)
    if dcs and all(x is not None for x in dcs):
        run.dc = np.concatenate(dcs)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the port may not use: {found}")

    if system is not None:
        system.close()
    del search
    ref_dev = devices[0]
    t_check = time.perf_counter()
    numbers = compare(torch.as_tensor(train, device=ref_dev),
                      torch.as_tensor(pool_q, device=ref_dev), answers, int(config["k"]))
    t_check = time.perf_counter() - t_check
    run.numbers = numbers
    correct, shown = judge(numbers, cell.limits)

    times_ms = np.asarray(run.batch_s) * 1e3
    log(f"window {run.window_s:.3f} s: {len(times_ms)} batches, {run.queries} queries; "
        f"batch ms median {_percentile(times_ms, 50):.3f}, p95 {_percentile(times_ms, 95):.3f} "
        f"over {len(times_ms)} samples; {numbers['queries']} answers compared in "
        f"{t_check:.3f} s ({run.queries / pool:.2f} replays of the pool)",
        file=sys.stderr)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {
        "correct": bool(correct),
        "attempted": run.queries,
        "failed": int(numbers["bad_rows"]),
        "metrics": metrics,
        "device": _device(devices, max(setup_peak, run.peak_bytes)),
    }
    if trace:
        line["device"]["busy_s"] = run.trace.busy_mean_s()
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {k: [[name[:NAME_CHARS], sec] for name, sec in v] for k, v in (
            ("device_ops", run.trace.device_ops), ("idle_gaps", run.trace.idle_gaps))}
    line["checks"] = shown
    return run, line


def _profiler(devices):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _summary(prof, window_s: float, devices) -> TraceSummary:
    from benchmark.trace import summarize

    cards = sorted({d.index or 0 for d in devices if d.type == "cuda"})
    return summarize(prof.profiler.kineto_results.events(), window_s, cards)


def _device(devices, peak: int) -> dict:
    import torch

    cuda = [d for d in devices if d.type == "cuda"]
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": len(devices),
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cuda[0]),
            "count": len(cuda), "memory_peak_bytes": int(peak)}


def _cache_dirs() -> None:
    """Every cache of the program inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["CLANN_CACHE_DIR"] = str(build / "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    _cache_dirs()
    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {n} visible", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    _, line = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start, devices)
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():  # the last lines: each number beside its limit
        bound = (f"at least {c['at_least']}" if "at_least" in c else f"at most {c['at_most']}")
        print(f"check {name}: {c['value']!r} ({bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

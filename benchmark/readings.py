"""Readings that limits are set from: the program on a dozen seeds or more,
the control (control.py) on three or more and, with ``--n-probe``, the
program probing fewer IVF segments than it does by default (the step a
later change could be tempted by), one process, each over one pass of the
cell's query pool at the cell's own batch size.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 [--n-probe 1 --fault-seeds 201 202 203] \\
        --out readings.json

Writes one JSON object per run (seed, who, the check's numbers) and, last,
the lower reading of each number (the worst sound run) and the upper ones
(the control's and the cut program's nearest to passing). The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __name__ == "__main__":  # run as a script: the checkout's root heads the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import spec  # noqa: E402
from benchmark.harness import ROOT, _cache_dirs, run_cell  # noqa: E402


def fewer_probes(n_probe):
    """A `wrap` for harness.run_cell: the program's own search at `n_probe`."""

    def wrap(search, *_):
        handle = search.__self__.handle
        return lambda q: handle.search_batch(q, mode=search.__self__.mode, n_probe=n_probe)

    return wrap


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--n-probe", type=int, default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    _cache_dirs()
    import torch

    from benchmark.control import tf32_search

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    n_batches = int(cell.traffic["pool"]) // int(cell.traffic["batch"])
    rows = []
    fault = f"n_probe={args.n_probe}"
    wraps = {"program": None, "control": tf32_search(devices[0], int(cell.config["k"])),
             fault: fewer_probes(args.n_probe)}
    runs = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, fault) for s in (args.fault_seeds if args.n_probe else [])])
    for seed, who in runs:
        t0 = time.perf_counter()
        run, line = run_cell(cell, seed, 0.0, False, t0, devices, wrap=wraps[who],
                             program=who != "control", min_batches=n_batches)
        row = {"seed": seed, "who": who, "correct": line["correct"], **run.numbers,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run, line
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": cell.name, "kind": torch.cuda.get_device_name(0)}
    for name, lim in cell.limits.items():
        worst, nearest = (min, max) if "at_least" in lim else (max, min)
        summary[name] = {"limit": lim}
        for who in ("program", "control", fault):
            got = [r[name] for r in rows if r["who"] == who]
            if got:
                summary[name][who] = (worst if who == "program" else nearest)(got)
    print(json.dumps(summary), flush=True)
    with open(args.out, "w") as f:
        for r in rows + [summary]:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""A cell of BENCHMARK.json at a size the CPU runs in seconds."""

from __future__ import annotations

import time

import torch

from benchmark import harness, spec


def tiny_cell(name: str, rows: int = 3000, batch: int = 16, pool: int = 64) -> spec.Cell:
    cell = spec.load_cell(name, harness.ROOT)
    # as many points a mode as the configuration holds, so the collection
    # clusters as it does at full size
    modes = max(8, rows * int(cell.config["modes"]) // int(cell.config["rows"]))
    cell.config = {**cell.config, "rows": rows, "modes": modes}
    cell.traffic = {**cell.traffic, "batch": batch, "pool": pool}
    return cell


def run_tiny(cell: spec.Cell, seed: int = 2**31 + 7, wrap=None, trace=False, devices=None,
             program: bool = True):
    devices = devices or [torch.device("cpu")] * cell.chips
    return harness.run_cell(cell, seed, 0.3, trace, time.perf_counter(), devices, wrap=wrap,
                            program=program, min_batches=int(cell.traffic["pool"])
                            // int(cell.traffic["batch"]), log=lambda *a, **k: None)

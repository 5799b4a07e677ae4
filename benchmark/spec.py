"""Find a cell and everything it names, by name, from BENCHMARK.json and the
files beside it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. Adding a cell, a
configuration, a traffic mix or a metric is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _applies(m, name)]
    return cell_from_files(name, w["config"], w["traffic"], int(w["chips"]), e2e, per_layer,
                           here)


def cell_from_files(name: str, config: str, traffic: str, chips: int,
                    end_to_end: List[dict], per_layer: List[dict], here: Path = HERE) -> Cell:
    """A cell from its files alone (also one that BENCHMARK.json does not
    list yet)."""
    return Cell(
        name=name, chips=chips, config_name=config, traffic_name=traffic,
        config=_json(here / "configs" / f"{config}.json"),
        traffic=_json(here / "traffic" / f"{traffic}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        end_to_end=end_to_end, per_layer=per_layer,
    )


def reader(metric: str, here: Path = HERE) -> Callable:
    """`read(run)` of metrics/<metric>.py: the metric's value, or None where
    the run holds nothing to read."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


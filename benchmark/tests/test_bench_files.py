"""Everything is found by name: a new cell, configuration, traffic mix or
metric is new files and entries, with no edit to the harness."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness, spec

HERE = Path(spec.__file__).resolve().parent


def test_every_cell_and_metric_of_the_benchmark_is_found():
    bench = spec.load_benchmark(harness.ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], harness.ROOT)
        assert cell.chips == w["chips"] and cell.limits
        assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
        assert cell.per_layer, w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()


@pytest.fixture
def copy_of_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_cell_configuration_traffic_and_metric_added_as_files(copy_of_benchmark):
    root = copy_of_benchmark
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "glove100-lsh.json").read_text())
    (here / "configs" / "glove25-lsh.json").write_text(json.dumps({**cfg, "dims": 25}))
    (here / "traffic" / "global-b64.json").write_text(json.dumps(
        {"mode": "lsh", "delta": 0.9, "batch": 64, "pool": 1024}))
    (here / "limits" / "glove25-lsh.global-b64.json").write_text(json.dumps(
        {"recall": {"at_least": 0.72}}))
    (here / "metrics" / "batch_p50_ms.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "glove25-lsh", "source": "x",
                             "file": "benchmark/configs/glove25-lsh.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "glove25-lsh.global-b64", "config": "glove25-lsh",
                               "traffic": "global-b64", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "batch_p50_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "facade", "moves": "qps",
                               "workloads": ["glove25-lsh.global-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("glove25-lsh.global-b64", root, here=here)
    assert cell.config["dims"] == 25 and cell.traffic["batch"] == 64
    assert cell.limits == {"recall": {"at_least": 0.72}}
    names = [m["name"] for m in cell.per_layer]
    assert "batch_p50_ms" in names and "dc_per_query" not in names
    assert spec.reader("batch_p50_ms", here=here)(None) == 42.0
    # the older cells do not report the new metric
    old = spec.load_cell("glove100-lsh.global-b256", root, here=here)
    assert "batch_p50_ms" not in [m["name"] for m in old.per_layer]


def test_metric_without_workloads_goes_to_every_cell_reporting_what_it_moves():
    bench = spec.load_benchmark(harness.ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], harness.ROOT)
        names = {m["name"] for m in cell.per_layer}
        assert {"build_s", "device_idle"} <= names

"""The shape of a run's last line, and the runs that must print none."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import run_tiny, tiny_cell


def _shape(line, metric_names):
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) <= set(metric_names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert "value" in c and ({"at_least", "at_most"} & set(c))
    json.dumps(line)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(trace):
    cell = tiny_cell("glove100-lsh.global-b256")
    run, line = run_tiny(cell, trace=trace)
    wanted = cell.per_layer if trace else cell.end_to_end
    _shape(line, [m["name"] for m in wanted])
    if not trace:
        assert set(line["metrics"]) == {"qps", "batch_p95_ms", "recall_at_10", "setup_s"}
        assert line["metrics"]["recall_at_10"]["value"] == run.numbers["recall"]
    else:
        assert {"build_s", "dc_per_query"} <= set(line["metrics"])
        # no card: no device reading is given a value
        assert "device_idle" not in line["metrics"]


def _run_py(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "glove100-lsh.global-b256", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = _run_py(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""

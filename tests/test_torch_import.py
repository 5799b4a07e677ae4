"""The PyTorch port imports no JAX, and its smoke script refuses to run
without a card or outside the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "clann_tpu_torch",
    "clann_tpu_torch.__main__",
    "clann_tpu_torch.api",
    "clann_tpu_torch.bench",
    "clann_tpu_torch.bench.ann_adapter",
    "clann_tpu_torch.bench.harness",
    "clann_tpu_torch.config",
    "clann_tpu_torch.errors",
    "clann_tpu_torch.testing",
    "clann_tpu_torch.core.index",
    "clann_tpu_torch.core.jaccard",
    "clann_tpu_torch.data.hdf5",
    "clann_tpu_torch.data.metricdata",
    "clann_tpu_torch.data.setdata",
    "clann_tpu_torch.data.synthetic",
    "clann_tpu_torch.io",
    "clann_tpu_torch.io.h5",
    "clann_tpu_torch.io.interop",
    "clann_tpu_torch.io.refcodec",
    "clann_tpu_torch.metrics.csv",
    "clann_tpu_torch.metrics.recall",
    "clann_tpu_torch.metrics.run",
    "clann_tpu_torch.metrics.schema",
    "clann_tpu_torch.metrics.trace",
    "clann_tpu_torch.ops._build",
    "clann_tpu_torch.ops.block_scan",
    "clann_tpu_torch.ops.collision",
    "clann_tpu_torch.ops.distances",
    "clann_tpu_torch.ops.gather",
    "clann_tpu_torch.ops.global_query",
    "clann_tpu_torch.ops.gmm",
    "clann_tpu_torch.ops.hashing",
    "clann_tpu_torch.ops.ivf",
    "clann_tpu_torch.ops.join",
    "clann_tpu_torch.ops.minhash",
    "clann_tpu_torch.ops.prefixmap",
    "clann_tpu_torch.ops.query",
    "clann_tpu_torch.ops.scan_topk",
    "clann_tpu_torch.ops.sketches",
    "clann_tpu_torch.ops.sources",
    "clann_tpu_torch.parallel",
    "clann_tpu_torch.parallel.capacity",
    "clann_tpu_torch.parallel.distributed",
    "clann_tpu_torch.parallel.gmm",
    "clann_tpu_torch.parallel.jaccard",
    "clann_tpu_torch.parallel.join",
    "clann_tpu_torch.parallel.mesh",
    "clann_tpu_torch.parallel.sharded",
    "clann_tpu_torch.probes",
    "clann_tpu_torch.probes.gather_rate",
    "clann_tpu_torch.puffinn",
]

_PROBE = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "h5py", "clann_tpu", "triton"))
assert not bad, bad
from clann_tpu_torch.ops import _build
assert _build._LIB is None, "kernel library loaded at import time"
print("clean")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mods=SLICE_MODULES)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean" in proc.stdout


def test_every_jax_module_has_a_counterpart():
    """The port does all the JAX package does: each module of clann_tpu has
    a module of the same path in clann_tpu_torch (the Pallas kernels'
    modules, ops/pallas/X, map to ops/X, beside their CUDA kernels)."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files if f.endswith(".py")}

    want = {m.replace("ops/pallas/", "ops/") for m in modules("clann_tpu")}
    missing = sorted(want - modules("clann_tpu_torch"))
    assert not missing, missing


def test_exports_match_the_jax_package():
    """The port exports the JAX package's facade names (init_from_file and
    serialize with the native h5 format), and the same errors."""
    import clann_tpu
    import clann_tpu_torch

    later = set()
    assert set(clann_tpu.__all__) - set(clann_tpu_torch.__all__) == later
    assert set(clann_tpu_torch.__all__) == set(clann_tpu.__all__)
    for name in ("insert", "rebuild", "save_metrics", "plan_capacity", "CapacityPlan",
                 "init_from_file", "serialize"):
        assert callable(getattr(clann_tpu_torch, name)), name
    from clann_tpu_torch.core.index import build_lsh_index, insert, rebuild  # noqa: F401
    from clann_tpu_torch.ops.join import closest_pairs  # noqa: F401
    for method in ("closest_pairs", "insert", "rebuild", "reset_metrics", "save_metrics",
                   "serialize", "from_file"):
        assert callable(getattr(clann_tpu_torch.Clann, method)), method


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's own imports stay off the JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for banned in ("import jax", "from jax", "clann_tpu.", "import clann_tpu\n",
                   "h5py"):
        assert banned not in src, banned


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    """No CUDA (or no package beside it): non-zero exit, no ok line."""
    import torch

    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the no-card refusal "
                        "cannot be observed here")
        cwd = REPO
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

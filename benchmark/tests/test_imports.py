"""Nothing the benchmark runs loads jax, jaxlib, flax or clann_tpu (top-level
names compared whole: clann_tpu_torch is the port), and the reference loads
nothing of clann_tpu_torch."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

HERE = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "clann_tpu"}


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_names_a_forbidden_package():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        assert not set(_imported_tops(path)) & FORBIDDEN, path
    for path in (HERE / "reference").rglob("*.py"):
        assert "clann_tpu_torch" not in set(_imported_tops(path)), path


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("clann_tpu_torch_lookalike", sys)
    assert "clann_tpu_torch" not in harness.FORBIDDEN
    assert set(harness.forbidden_modules()) <= FORBIDDEN


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        "from benchmark.tests.tiny import run_tiny, tiny_cell\n"
        "from benchmark import spec\n"
        "for m in spec.load_benchmark(spec.HERE.parent)['end_to_end'] "
        "+ spec.load_benchmark(spec.HERE.parent)['per_layer']: spec.reader(m['name'])\n"
        "run_tiny(tiny_cell('glove100-lsh.global-b256'), trace=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert "clann_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import benchmark.reference.check, benchmark.reference.knn, benchmark.control\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert not tops & (FORBIDDEN | {"clann_tpu_torch"})

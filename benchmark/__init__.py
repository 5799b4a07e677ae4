"""The benchmark of clann_tpu_torch on the H100: one cell of BENCHMARK.json
per run (``python benchmark/run.py --workload <cell> ...``).

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and one reader per
metric in ``metrics/<metric>.py``. Nothing here imports jax or clann_tpu;
``reference/`` imports nothing of clann_tpu_torch either.
"""

"""Run one cell of BENCHMARK.json once and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

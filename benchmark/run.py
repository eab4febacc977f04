#!/usr/bin/env python3
"""Run one cell of the benchmark once (see BENCHMARK.json):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the cell's metrics, the checks that decide ``correct`` and the
device as one JSON line, the last line of standard output; the numbers
compared, each beside its limit, are the last lines of standard error.
Needs as many CUDA devices as the cell asks for, and runs nothing on the
CPU without them.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder: the port and the benchmark are
# packages there
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))

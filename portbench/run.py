"""Run one cell of the port's benchmark:

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json. Prints the
result as one JSON object on the last line of standard output; see
portbench/core.py.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, heads the import path
sys.path[0] = ROOT

from portbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], ROOT, T_START))

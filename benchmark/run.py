"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the route ``Auto`` took, the card and the set-up's parts on
earlier lines, the compared numbers beside their limits as the last
lines of standard error, and one JSON object as the last line of
standard output. Needs a CUDA card; exits non-zero without one.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

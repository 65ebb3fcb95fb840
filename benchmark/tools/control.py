"""Run a cell's control on the card: the reference put in the program's
place, in TF32 (``benchmark/reference/control.py``), through the cell's
own loop, sampling and comparison, at the cell's own size:

    python3 benchmark/tools/control.py --workload <cell> --seeds 11 12 13 [--seconds 2]

Prints one JSON line per seed with the compared numbers. The readings
set the upper end of each limit (``PERF.md``); the benchmark's own runs
never run this.
"""

import importlib
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmark.core.cells import load_cell  # noqa: E402
from benchmark.core.harness import run_cell  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    control = importlib.import_module(
        f"benchmark.reference.{cell.traffic['loop']}").control
    for seed in args.seeds:
        res = run_cell(cell, seed, args.seconds, False,
                       torch.device("cuda", 0), wrap=control,
                       log=lambda *a: print(*a, file=sys.stderr))
        print(json.dumps({"control": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

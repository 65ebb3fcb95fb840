"""Run one cell several times, each run its own process as the check runs
it, and summarise: for each metric the median and the spread (the
distance between the first and third quartile of
``statistics.quantiles(values, n=4)`` over the median).

    python3 benchmark/tools/runs.py --workload <cell> --seeds 1 2 3 \
        --out runs.jsonl [--seconds 30] [--trace 0]

Each run's result line, with its seed, exit code and the end of its
standard error, is appended to ``--out``; the summary is printed last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds),
             "--trace", str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": p.returncode, "wall_s": wall, "result": res,
               "stdout_head": lines[:-1][-12:], "stderr_tail": p.stderr[-3000:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (res or {}).get("checks", {}).items()}
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(wall, 1),
                          "correct": (res or {}).get("correct"),
                          "metrics": short, "checks": checks,
                          "route": [l for l in lines if l.startswith(("route", "setup", "card", "trace"))]}),
              flush=True)
        if res is None:
            print(p.stderr[-2000:], flush=True)
        results.append(res)
    ok = [r for r in results if r]
    names = sorted({k for r in ok for k in r.get("metrics", {})})
    summary = {}
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
        summary[name] = {"median": statistics.median(vals), "spread": spread(vals),
                         "values": vals}
    print(json.dumps({"summary": args.workload, "runs": len(results),
                      "correct": sum(bool(r and r["correct"]) for r in results),
                      "metrics": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

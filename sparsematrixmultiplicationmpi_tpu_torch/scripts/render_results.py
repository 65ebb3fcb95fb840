"""Render ``REPORT.md`` and the figures from a sweep checkpoint CSV
(port of the JAX package's ``scripts/render_results.py``).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.render_results \
        [CSV] [--out-dir DIR]

The sweep renders on completion; this covers an interrupted run, whose
checkpoint CSV holds every row finished so far. Either package's CSV
renders: the schema is shared (``bench/harness.py::CSV_COLUMNS``). The
figures need matplotlib and are skipped, with a message, without it.
Touches no device. ``CSV`` defaults to ``results/h100/h100_sweep.csv``,
``--out-dir`` to the CSV's directory.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..bench.harness import read_csv
from ..bench.report import render_report
from . import _common

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="render_results", description=__doc__.split("\n\n")[0])
    ap.add_argument("csv", nargs="?",
                    default=os.path.join(_common.RESULTS_DIR,
                                         "h100_sweep.csv"))
    ap.add_argument("--out-dir", default=None,
                    help="where REPORT.md and figures/ go (default: the "
                         "CSV's directory)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.csv):
        return _common.refuse("render_results", f"no such CSV {args.csv}")
    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.csv))
    os.makedirs(out_dir, exist_ok=True)
    records = read_csv(args.csv)
    kinds = sorted({r.device_kind for r in records}) or ["no records"]
    title = f"{', '.join(kinds)} results — matrix x k x strategy sweep"
    if _common.has_matplotlib():
        from ..bench.plots import render_all

        paths = render_all(records, os.path.join(out_dir, "figures"))
    else:
        paths = []
        print("figures skipped: matplotlib is not installed")
    render_report(records, os.path.join(out_dir, "REPORT.md"), title=title)
    print(f"{len(records)} records -> {len(paths)} figures + REPORT.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())

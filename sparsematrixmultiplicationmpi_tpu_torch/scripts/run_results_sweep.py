"""The results sweep on one device (port of the JAX package's
``scripts/run_results_sweep.py``).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.run_results_sweep \
        [--device cuda|cpu] [--out-dir DIR] [--matrices NAME ...] \
        [--ks K ...] [--strategies NAME ...] [--scale S]

The JAX script's grid, through ``bench/harness.py::sweep`` (amortized
timing, per-job watchdog, CSV checkpoint and resume, and the dead-backend
guard whose health probe is a small matmul on the device):

* the main tier: six matrices x k in {1, 6, 12, 32} x the row, column,
  nnz, windowed_row, auto and library strategies;
* k in {3, 9} (the reference's other ``batch_test.sh`` widths) x column,
  windowed_row and auto;
* the bf16 tier: cop20k, fem_banded and powerlaw at k = 32 through auto;
* the matrix-impact tier: roadnet and dc1 at k = 6 x windowed_row, auto.

Then every row that cannot be right (``suspicious_records``: above 95 %
of the byte roofline, or non-monotonic in k) is measured again as the
median of three runs (``remeasure_record``), and the JSON, ``REPORT.md``
and, where matplotlib is installed, the figures are rendered from the
whole checkpoint. ``--matrices``, ``--ks`` and ``--strategies`` cut every
tier to the names and widths given; ``--scale`` shrinks every matrix but
cage4 (a quick run). A run stopped part way resumes from its checkpoint
(``<tag>_sweep.csv``, ``tag`` = ``h100`` on the card, ``cpu`` on the
CPU); failed rows are retried. Exits 3 when the dead-backend guard
aborted the sweep, 1 without CUDA for a card run.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..bench.harness import (
    _run_with_timeout, read_csv, remeasure_record, suspicious_records,
    sweep, write_csv, write_json,
)
from ..bench.report import render_report
from ..io.generate import (
    amazon0302_like, banded_csr, cage4_like, cop20k_like, dc1_like,
    powerlaw_csr, random_csr, roadnet_like,
)
from . import _common

__all__ = ["main", "build_matrices", "TIERS", "BF16_NAMES"]


def _n(x: int, scale: float) -> int:
    return max(int(x * scale), 16)


#: name -> builder(scale), f32, the JAX script's matrices and seeds.
BUILDERS = {
    "cage4_like": lambda s: cage4_like(),
    "fem_banded_100k": lambda s: banded_csr(_n(100_000, s), 150, 18,
                                            seed=11),
    "powerlaw_100k": lambda s: powerlaw_csr(_n(100_000, s), _n(100_000, s),
                                            _n(1_500_000, s), seed=12),
    "uniform_random_100k": lambda s: random_csr(
        _n(100_000, s), _n(100_000, s), _n(1_200_000, s), seed=13),
    "amazon0302_like": lambda s: amazon0302_like(scale=s),
    "cop20k_like": lambda s: cop20k_like(scale=s),
    "roadnet_like": lambda s: roadnet_like(scale=s),
    "dc1_like": lambda s: dc1_like(scale=s),
}
MAIN = ("cage4_like", "fem_banded_100k", "powerlaw_100k",
        "uniform_random_100k", "amazon0302_like", "cop20k_like")
IMPACT = ("roadnet_like", "dc1_like")
BF16_NAMES = ("cop20k_like", "fem_banded_100k", "powerlaw_100k")
#: (matrices, ks, strategies, bf16) per tier, in run order; the f32
#: tiers also estimate the compute / communication split.
TIERS = (
    (MAIN, (1, 6, 12, 32),
     ("row", "column", "nnz", "windowed_row", "auto", "library"), False),
    (MAIN, (3, 9), ("column", "windowed_row", "auto"), False),
    (BF16_NAMES, (32,), ("auto",), True),
    (IMPACT, (6,), ("windowed_row", "auto"), False),
)


def build_matrices(names, scale: float = 1.0) -> dict:
    return {name: BUILDERS[name](scale).astype(np.float32) for name in names}


def _progress(r) -> None:
    print(f"{r.matrix} k={r.k} {r.strategy} ({r.dtype}): "
          + (f"FAILED {r.error}" if r.error else
             f"{r.execution_time * 1e3:.3f} ms "
             f"{r.gnnz_per_s:.3f} Gnnz/s "
             f"{'ok' if r.correct else 'MISMATCH'}"), flush=True)


def _backend_ok(device: torch.device):
    """Health probe of the dead-backend guard: a small matmul on the
    device whose value is read back, under a watchdog (a dead device
    may hang rather than raise)."""

    def ok() -> bool:
        def probe():
            x = torch.ones((128, 128), device=device)
            return float((x @ x).sum())

        try:
            return _run_with_timeout(probe, 180.0) > 0
        except Exception:
            return False

    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="run_results_sweep", description=__doc__.split("\n\n")[0])
    _common.add_device_args(ap)
    ap.add_argument("--matrices", nargs="+", choices=sorted(BUILDERS),
                    default=None, help="cut the grid to these matrices")
    ap.add_argument("--ks", type=int, nargs="+", default=None,
                    help="cut the grid to these widths")
    ap.add_argument("--strategies", nargs="+", default=None,
                    help="cut the grid to these strategies")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the matrices (default: full size)")
    args = ap.parse_args(argv)
    err = _common.device_error(args.device)
    if err:
        return _common.refuse("run_results_sweep", err)
    device = torch.device(args.device)

    def cut(values, chosen):
        return [x for x in values if chosen is None or x in chosen]

    tiers = []
    for names, ks, strategies, bf16 in TIERS:
        names, ks = cut(names, args.matrices), cut(ks, args.ks)
        strategies = cut(strategies, args.strategies)
        if names and ks and strategies:
            tiers.append((names, ks, strategies, bf16))
    needed = sorted({n for names, *_ in tiers for n in names})
    matrices = build_matrices(needed, args.scale)

    os.makedirs(args.out_dir, exist_ok=True)
    tag = _common.tag(args.device)
    hardware = _common.hardware(args.device)
    checkpoint = os.path.join(args.out_dir, f"{tag}_sweep.csv")
    backend_ok = _backend_ok(device)
    common = dict(
        device_counts=[1], device=args.device, warmup=1, iters=2,
        amortized=True, checkpoint_csv=checkpoint, resume_from=checkpoint,
        progress=_progress, job_timeout=600.0,
        max_consecutive_failures=8, backend_ok=backend_ok)

    aborted = None
    records = []
    try:
        for names, ks, strategies, bf16 in tiers:
            if bf16:
                records += sweep(
                    {f"{n}_bf16": matrices[n] for n in names}, ks=ks,
                    strategy_names=strategies, dtype=torch.bfloat16,
                    **common)
            else:
                records += sweep(
                    {n: matrices[n] for n in names}, ks=ks,
                    strategy_names=strategies, comm_split=True, **common)
    except RuntimeError as e:
        aborted = str(e)
        print(f"SWEEP ABORTED: {aborted}", flush=True)

    # The JSON, the report and the figures come from the whole
    # checkpoint: a resumed run holds only the jobs it ran itself.
    all_records = read_csv(checkpoint) if os.path.exists(checkpoint) else []

    if not aborted:
        by_name = dict(matrices)
        for n in BF16_NAMES:
            if n in matrices:
                by_name[f"{n}_bf16"] = matrices[n].astype(torch.bfloat16)
        sus = suspicious_records(all_records)
        for rec, reason in sus:
            csr = by_name.get(rec.matrix)
            if csr is None or not backend_ok():
                print(f"SUSPECT (not re-measured): {rec.matrix} k={rec.k} "
                      f"{rec.strategy}: {reason}", flush=True)
                continue
            print(f"re-measuring {rec.matrix} k={rec.k} {rec.strategy} "
                  f"({reason})", flush=True)
            new = remeasure_record(csr, rec, mesh=device)
            key = (rec.matrix, rec.k, rec.strategy, rec.devices, rec.dtype)
            all_records = [
                new if (r.matrix, r.k, r.strategy, r.devices, r.dtype) == key
                else r for r in all_records]
            _progress(new)
        if sus:
            write_csv(checkpoint, all_records)

    write_json(os.path.join(args.out_dir, f"{tag}_sweep.json"), all_records,
               hardware=hardware, note="amortized steady-state timing")
    if _common.has_matplotlib():
        from ..bench.plots import render_all

        paths = render_all(all_records, os.path.join(args.out_dir,
                                                     "figures"))
    else:
        paths = []
        print("figures skipped: matplotlib is not installed", flush=True)
    render_report(all_records, os.path.join(args.out_dir, "REPORT.md"),
                  title=f"{hardware} results — matrix x k x strategy sweep")
    print(f"{len(all_records)} records ({len(records)} new), "
          f"{len(paths)} figures + REPORT.md", flush=True)
    return 3 if aborted else 0


if __name__ == "__main__":
    sys.exit(main())

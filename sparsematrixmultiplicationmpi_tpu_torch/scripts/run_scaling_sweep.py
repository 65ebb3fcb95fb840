"""Every strategy at several ranks, with each strategy's collectives
counted (port of the JAX package's ``scripts/run_scaling_sweep.py``).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.run_scaling_sweep \
        [--device cuda|cpu] [--out-dir DIR] [--ps P ...] [--ks K ...] \
        [--scale S]

The JAX script ran its strategies on an 8-device CPU mesh and parsed the
compiled HLO for collectives. Here each rank count ``p`` is one group of
``p`` spawned ranks (``parallel/launch.py::run_ranks``): NCCL ranks, one
card each, by default, and gloo ranks on the host CPU with ``--device
cpu``. Every rank runs every job:

* the row, column, nnz, banded_row, windowed_row and auto strategies on
  the JAX script's three fixtures (a 3-D FEM mesh, a band, a power law)
  at k = 6 and 32: ``run_benchmark`` (amortized, with the
  ``comm_comp_split`` estimate), correct against ``spmm_host_f64``;
* for ``p > 1``, one multiply of every strategy at k = 6, its result
  gathered and left sharded, with ``utils/collectives.py``'s counter
  giving each collective's kind, count and bytes on rank 0 (the count
  the HLO parse gave).

``p`` runs over 1, 2, 4 and 8: on the card those up to the card count
(a ``--ps`` above it is refused), on the CPU those below 8, and 8 where
the host has 8 cores, each rank taking its share of the host's threads.
Writes ``<tag>_mesh_scaling.csv`` / ``.json`` (``tag`` = ``h100`` on the
card, ``cpu`` on the CPU; the JSON keys of the JAX package's
``results/cpu_mesh_scaling.json``), ``collective_bytes.json`` and, with
matplotlib, the scaling figures. On the CPU the times are host timings
of gloo ranks: they show the collectives' structure and the results'
correctness, not the card's speed. Exits 1 when a job failed or
disagreed with the oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..bench.harness import _failed_record, run_benchmark, write_csv, \
    write_json
from ..io.generate import (
    banded_csr, fem3d_csr, generate_fat_vector, powerlaw_csr,
)
from ..parallel import get_strategy, run_ranks
from ..utils import collectives as coll
from . import _common

__all__ = ["main", "fixtures", "STRATEGIES", "KS", "COMM_K"]

STRATEGIES = ("row", "column", "nnz", "banded_row", "windowed_row", "auto")
KS = (6, 32)
#: The width of the counted multiplies.
COMM_K = 6


def fixtures(scale: float = 1.0) -> dict:
    """The JAX script's three matrices (f32), shrunk by ``scale``."""
    def n(x):
        return max(int(x * scale), 16)

    return {
        "fem3d_50k": fem3d_csr(n(50_000), n(1_080_000), seed=0,
                               dtype=np.float32),
        "banded_60k": banded_csr(n(60_000), 120, 18, seed=1,
                                 dtype=np.float32),
        "powerlaw_60k": powerlaw_csr(n(60_000), n(60_000), n(600_000),
                                     seed=2, dtype=np.float32),
    }


def _progress(r) -> None:
    print(f"{r.matrix} k={r.k} p={r.devices} {r.strategy}: "
          + (f"FAILED {r.error}" if r.error else
             f"{r.execution_time} s {'ok' if r.correct else 'MISMATCH'}"),
          flush=True)


def _rank_jobs(mesh, matrices, ks, threads):
    """Every job on this rank of the group: ``(records, collective
    records)``; every rank runs the same jobs, so their collectives pair
    up."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(threads)
    records, comm = [], []
    for mat, csr in matrices.items():
        for k in ks:
            for sname in STRATEGIES:
                try:
                    rec = run_benchmark(
                        csr, k, get_strategy(sname), mesh, matrix_name=mat,
                        warmup=1, iters=2, amortized=True, comm_split=True)
                except Exception as e:  # recorded, and the sweep goes on
                    rec = _failed_record(
                        csr, k, sname, mesh.size, mat, None, mesh.device,
                        error=f"{type(e).__name__}: {e}"[:500])
                records.append(rec)
                if mesh.rank == 0:
                    _progress(rec)
        if mesh.size == 1:
            continue
        v = torch.from_numpy(generate_fat_vector(
            csr.shape[1], COMM_K, seed=3).astype(np.float32)).to(
            mesh.device)
        for sname in STRATEGIES:
            strat = get_strategy(sname)
            try:
                op = strat.prepare(csr, mesh)
                for gather in (False, True):
                    coll.reset_collective_stats()
                    strat.spmm(op, v, gather_result=gather)
                    stats = coll.collective_stats()
                    comm.append({
                        "matrix": mat, "strategy": strat.name,
                        "devices": mesh.size, "gathered": gather,
                        "nnz": csr.nnz,
                        "collectives": {
                            kind: {"count": c, "bytes": b}
                            for kind, (c, b) in sorted(stats.items())},
                        "total_bytes": sum(b for _, b in stats.values())})
            except Exception as e:
                comm.append({"matrix": mat, "strategy": sname,
                             "devices": mesh.size, "error": repr(e)})
    return records, comm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="run_scaling_sweep", description=__doc__.split("\n\n")[0])
    _common.add_device_args(ap)
    ap.add_argument("--ps", type=int, nargs="+",
                    help="rank counts (default: 1, 2, 4, 8 as the cards "
                         "or the host's cores allow)")
    ap.add_argument("--ks", type=int, nargs="+", default=list(KS))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the fixtures (default: full size)")
    args = ap.parse_args(argv)
    err = _common.device_error(args.device)
    if err:
        return _common.refuse("run_scaling_sweep", err)
    cores = os.cpu_count() or 1
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        ps = args.ps or [p for p in (1, 2, 4, 8) if p <= cards]
        if max(ps) > cards:
            return _common.refuse(
                "run_scaling_sweep", f"--ps {max(ps)} needs {max(ps)} CUDA "
                f"devices, and this host has {cards}")
    else:
        ps = args.ps or [1, 2, 4] + ([8] if cores >= 8 else [])
    print(f"rank counts on {_common.hardware(args.device)}: {ps}",
          flush=True)
    matrices = fixtures(args.scale)
    os.makedirs(args.out_dir, exist_ok=True)
    tag = _common.tag(args.device)

    records, comm = [], []
    for p in ps:
        threads = max(1, cores // p)
        recs, coms = run_ranks(_rank_jobs, p, matrices, args.ks,
                               threads, device=args.device,
                               timeout=3600.0)[0]
        for c in coms:
            print(f"comm {c['matrix']} p={p} {c['strategy']} "
                  f"gather={c.get('gathered')}: "
                  f"{c.get('collectives', c.get('error'))}", flush=True)
        records += recs
        comm += coms

    where = ("gloo ranks on the host CPU" if args.device == "cpu"
             else f"NCCL ranks on {_common.hardware(args.device)}")
    write_csv(os.path.join(args.out_dir, f"{tag}_mesh_scaling.csv"),
              records)
    write_json(
        os.path.join(args.out_dir, f"{tag}_mesh_scaling.json"), records,
        note=(f"{where} at p = {ps}: validates correctness and the "
              "collectives' structure. Timings are host timings of these "
              "ranks, not the card's speed."))
    with open(os.path.join(args.out_dir, "collective_bytes.json"), "w") as f:
        json.dump({
            "note": ("Per-collective call counts and bytes on rank 0, "
                     "counted around each collective by "
                     "utils/collectives.py; program-derived, "
                     "device-independent."),
            "records": comm}, f, indent=2)

    if _common.has_matplotlib():
        from ..bench.plots import plot_speedup, plot_time_vs_devices

        fig_dir = os.path.join(args.out_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        ok = [r for r in records if r.execution_time == r.execution_time]
        k_fig = max(args.ks)
        for mat in matrices:
            sub = [r for r in ok if r.matrix == mat and r.k == k_fig]
            if sub:
                plot_time_vs_devices(sub, os.path.join(
                    fig_dir, f"{tag}mesh_time_{mat}.png"))
                base = [r.execution_time for r in sub if r.devices == 1]
                if base:
                    plot_speedup(sub, os.path.join(
                        fig_dir, f"{tag}mesh_speedup_{mat}.png"),
                        baseline_time=min(base), matrix=mat, k=k_fig)
    bad = [r for r in records if r.correct is not True]
    print(f"done: {len(records)} jobs, {len(bad)} failed/mismatched",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Model-level benchmarks on one device: GCN training, a CG solve and
PageRank (port of the JAX package's ``scripts/run_models_bench.py``).

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.run_models_bench \
        [--device cuda|cpu] [--out-dir DIR]

* GCN: two-layer GCN (f 64 -> h 128 -> c 16) on the 100,000-node
  synthetic task, ``auto_format(k_nominal=128)``, Adam 1e-2, 20 steps
  timed after one;
* CG: the 121,192-row SPD banded system (``bench/systems.py``), 8
  right-hand sides, ``auto_format(k_nominal=8)``, ``tol=1e-5``, best of
  3 solves after one;
* PageRank: ``cop20k_like(seed=4)`` with ``|values|``, column-normalised,
  ``auto_format(k_nominal=1)``, ``tol=1e-7``, best of 3 runs after one,
  and the steady per-iteration time as the slope between fixed 10- and
  60-iteration runs.

Each operand is priced for the run's device and for a caller that
multiplies one-shot, as the three models do through ``spmm_any``
(``auto_format(device=, one_shot=True)``: on the card the H100 cost
table picks the route, and its kernels).

Times are CUDA events on the card (the host clock on the CPU). Writes
``models_h100.json`` (``models_cpu.json`` for ``--device cpu``) under
``--out-dir`` with the JAX script's keys, ``"hardware"`` being the
card's name and power limit from ``nvidia-smi``. Prints one JSON line of
checks (each model's route among them: its format and the kernels it
launches on the card, ``ops/auto.py::route_kernels``) and launch
counts; exits 1 when a check fails: a non-finite or non-falling GCN
loss, a CG solution whose true residual exceeds 1e-4 or that took more
than ``max_iter`` iterations, PageRank ranks off a host float64 power
iteration of the same length by more than the f32 tier (1e-4 of each
rank) or not summing to 1, and on the card kernel launches other than
one multiply's of the route's kernels (each counted on one call, every
one of them launched) a CG iteration, plus one, a PageRank iteration,
or a GCN SpMM. A route with no hand-written kernel (COO, which the H100
table picks for PageRank's graph at small ``--scale``) must launch none:
its multiply is a gather and an ``index_add_``, as the JAX package's is
XLA's segment sum, with no Pallas kernel either. The route is named in
the checks all the same (``pagerank_route``). ``--scale`` shrinks the
three problems for a quick run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..bench.systems import spd_banded_system
from ..io.generate import cop20k_like
from ..models import (
    conjugate_gradient, init_gcn, make_train_step, normalize_adjacency,
    normalize_columns, pagerank, synthetic_node_classification,
)
from ..ops import cuda_banded, cuda_gather, cuda_windowed
from ..ops.auto import auto_format, route_kernels, spmm_any
from ..ops.autodiff import make_symmetric_spmm
from ..ops.oracle import spmm_host_f64
from ..utils.timing import time_fn, time_region
from . import _common

__all__ = ["main", "gcn_bench", "cg_bench", "pagerank_bench",
           "pagerank_host_f64", "hi_only"]

#: PageRank's f32 tier against the host f64 iteration, per rank: above
#: the split product's error and below that of the same iteration on the
#: ``hi_only`` matrix, which the chip smoke test holds it between.
PAGERANK_RTOL = 1e-4
#: CG's true-residual gate, relative to ``||b||``, in f64.
CG_RESIDUAL_TOL = 1e-4
#: The SpMMs of one two-layer GCN training step: one a layer forward,
#: one a layer backward (``A^T = A``).
GCN_SPMMS_PER_STEP = 4


def _reset_counts() -> None:
    for mod in (cuda_windowed, cuda_banded, cuda_gather):
        mod.reset_launch_counts()


def _counts() -> dict:
    return {**cuda_windowed.launch_counts(), **cuda_banded.launch_counts(),
            **cuda_gather.launch_counts()}


def _one_multiply(multiply, n: int, k: int, dev) -> dict:
    """The kernels one multiply launches on its route."""
    v = torch.zeros((n, k), dtype=torch.float32, device=dev)
    _reset_counts()
    multiply(v)
    return _counts()


def _route(operand, kernels: tuple) -> dict:
    return {"format": type(operand).__name__, "kernels": list(kernels)}


def _launched_per_multiply(launches: dict, per: dict, calls: int,
                           route: tuple) -> bool:
    """Whether one multiply launched each kernel of the route, and
    ``launches`` is ``calls`` multiplies' kernels; a route without
    hand-written kernels (COO's) launched none."""
    if not route:
        return not any(per.values()) and not any(launches.values())
    return (all(per.get(name, 0) > 0 for name in route)
            and all(launches[name] == per[name] * calls for name in per))


def gcn_bench(dev: torch.device, n: int = 100_000):
    """GCN training: ``(result, checks, launches)``."""
    f, h, c, steps = 64, 128, 16, 20
    adj, x, labels, mask = synthetic_node_classification(
        n, f, c, avg_degree=16, seed=1)
    host = auto_format(normalize_adjacency(adj), device=dev, one_shot=True,
                       k_nominal=128)
    operand = host.astype(torch.float32).to(dev)
    print(f"gcn operand: {type(operand).__name__}", flush=True)
    per = _one_multiply(lambda v: spmm_any(operand, v), n, h, dev)
    spmm = make_symmetric_spmm(operand)
    params = init_gcn(f, h, c, generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, device=dev)
    step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
    x, labels, mask = (torch.from_numpy(a).to(dev) for a in (x, labels, mask))
    _reset_counts()
    first = float(step(params, x, labels, mask))
    launches = _counts()
    losses = []
    dt = time_region(lambda: losses.append(step(params, x, labels, mask)),
                     dev, n=steps) / steps
    last = float(losses[-1])
    result = {"step_ms": dt * 1e3, "steps_per_s": 1 / dt, "nodes": n,
              "edges": adj.nnz, "hidden": h,
              "loss_finite": bool(np.isfinite(last))}
    checks = {"gcn_loss_finite": result["loss_finite"],
              "gcn_loss_falls": bool(last < first)}
    route = route_kernels(operand, h)
    checks["gcn_route"] = _route(operand, route)
    if dev.type == "cuda":
        # A training step's SpMMs (two layers, forward and backward)
        # through the route's kernels.
        checks["gcn_step_multiplies_launch_the_route"] = \
            _launched_per_multiply(launches, per, GCN_SPMMS_PER_STEP, route)
    print(result, flush=True)
    return result, checks, launches


def cg_bench(dev: torch.device, m: int = 121_192):
    """CG on the SPD banded system: ``(result, checks, launches)``."""
    spd = spd_banded_system(m)
    operand = auto_format(spd, device=dev, one_shot=True,
                          k_nominal=8).to(dev)
    print(f"cg operand: {type(operand).__name__}", flush=True)
    b_host = np.random.default_rng(3).normal(size=(m, 8)).astype(np.float32)
    b = torch.from_numpy(b_host).to(dev)
    max_iter = 200

    def solve():
        return conjugate_gradient(lambda v: spmm_any(operand, v), b,
                                  tol=1e-5, max_iter=max_iter)

    solve()  # warm-up
    per = _one_multiply(lambda v: spmm_any(operand, v), m, 8, dev)
    _reset_counts()
    res = solve()
    launches = _counts()
    dt = min(time_region(solve, dev) for _ in range(3))
    iters = res.iterations
    x = res.x.detach().cpu().double().numpy()
    true_res = (np.linalg.norm(b_host - spmm_host_f64(spd, x))
                / np.linalg.norm(b_host))
    route = route_kernels(operand, 8)
    result = {"solve_ms": dt * 1e3, "iterations": iters,
              "ms_per_iteration": dt * 1e3 / max(iters, 1),
              "residual": float(res.residual_norm), "rhs_columns": 8}
    checks = {"cg_true_residual": float(true_res),
              "cg_converged": bool(iters < max_iter
                                   and true_res <= CG_RESIDUAL_TOL),
              "cg_route": _route(operand, route)}
    if dev.type == "cuda":
        # One multiply an iteration and one for the initial residual,
        # through the route's kernels.
        checks["cg_one_multiply_per_iteration"] = _launched_per_multiply(
            launches, per, iters + 1, route)
    print(result, flush=True)
    return result, checks, launches


def hi_only(csr):
    """``csr`` with every value rounded to bf16: the matrix that a split
    product which lost its ``lo`` plane multiplies by."""
    vals = torch.from_numpy(np.asarray(csr.values, np.float32))
    return dataclasses.replace(
        csr, values=vals.to(torch.bfloat16).to(torch.float32).numpy())


def pagerank_host_f64(csr, iterations: int, damping: float = 0.85):
    """``iterations`` PageRank updates of ``models/pagerank.py`` in float64
    on the host (scipy), from the uniform vector."""
    import scipy.sparse as sp

    n = csr.shape[0]
    a = sp.csr_matrix((np.asarray(csr.values, np.float64),
                       np.asarray(csr.col_indices),
                       np.asarray(csr.row_ptr)), shape=csr.shape)
    r = np.full(n, 1.0 / n)
    for _ in range(iterations):
        r = damping * (a @ r) + (1.0 - damping) / n
        r = r / r.sum()
    return r


def pagerank_bench(dev: torch.device, scale: float = 1.0):
    """PageRank on the cop20k stand-in: ``(result, checks, launches)``."""
    g = cop20k_like(scale=scale, seed=4)
    g = dataclasses.replace(g, values=np.abs(np.asarray(g.values)))
    norm = normalize_columns(g).astype(np.float32)
    operand = auto_format(norm, device=dev, one_shot=True,
                          k_nominal=1).to(dev)
    n = norm.shape[0]
    print(f"pagerank operand: {type(operand).__name__}", flush=True)

    def run(tol, max_iter):
        return pagerank(lambda v: spmm_any(operand, v), n, tol=tol,
                        max_iter=max_iter, dtype=torch.float32, device=dev)

    run(1e-7, 100)  # warm-up
    per = _one_multiply(lambda v: spmm_any(operand, v), n, 1, dev)
    _reset_counts()
    r, it = run(1e-7, 100)
    launches = _counts()
    dt = min(time_region(lambda: run(1e-7, 100), dev) for _ in range(3))
    s = float(r.sum())

    # Steady per-iteration time: the slope between two fixed lengths
    # cancels the per-run cost.
    def timed_fixed(n_it):
        return time_fn(lambda: run(0.0, n_it), dev, warmup=1, iters=3)[0]

    t10, t60 = timed_fixed(10), timed_fixed(60)
    per_iter_ms = (t60 - t10) / 50 * 1e3
    ref = pagerank_host_f64(norm, it)
    got = r.detach().cpu().double().numpy()
    rel = float(np.max(np.abs(got - ref) / ref))
    route = route_kernels(operand, 1)
    result = {"total_ms": dt * 1e3, "iterations": it,
              "ms_per_iteration_steady": per_iter_ms,
              "dispatch_overhead_ms": t10 * 1e3 - 10 * per_iter_ms,
              "rank_sum": s}
    checks = {"pagerank_max_rel_err": rel,
              "pagerank_matches_f64": bool(rel <= PAGERANK_RTOL),
              "pagerank_sums_to_one": bool(abs(s - 1.0) <= 1e-4),
              "pagerank_route": _route(operand, route)}
    if dev.type == "cuda":
        checks["pagerank_one_multiply_per_iteration"] = (
            _launched_per_multiply(launches, per, it, route))
    print(result, flush=True)
    return result, checks, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="run_models_bench", description=__doc__.split("\n\n")[0])
    _common.add_device_args(ap)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the problems (default: full size)")
    args = ap.parse_args(argv)
    err = _common.device_error(args.device)
    if err:
        return _common.refuse("run_models_bench", err)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    results, checks, launches = {}, {}, {}
    results["gcn_train_100k_nodes"], c, launches["gcn_step"] = gcn_bench(
        dev, int(100_000 * args.scale))
    checks.update(c)
    results["cg_solve_121k"], c, launches["cg_solve"] = cg_bench(
        dev, int(121_192 * args.scale))
    checks.update(c)
    results["pagerank_121k"], c, launches["pagerank"] = pagerank_bench(
        dev, args.scale)
    checks.update(c)

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"models_{_common.tag(args.device)}"
                        ".json")
    with open(path, "w") as fo:
        json.dump({"hardware": _common.hardware(args.device),
                   "dtype": "float32", **results}, fo, indent=2)
    print(f"wrote {path}", flush=True)
    print(json.dumps({"checks": checks, "launches": launches}), flush=True)
    failed = [name for name, ok in checks.items()
              if isinstance(ok, bool) and not ok]
    if failed:
        print(f"run_models_bench: failed checks {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Judge PageRank solves against a float64 power iteration.

The iteration is the program's own rule: ``r <- d A r + (1 - d) / n``,
then ``r <- r / sum(r)``, from the uniform vector, until the largest
change of a rank is at most ``tol`` or ``max_iter`` iterations ran.

* ``rank_err``: a solve's ranks against the float64 ranks after as many
  iterations as the solve took, relative to each rank (every rank is at
  least ``(1 - d) / n``): the arithmetic's error, apart from where the
  loop stopped.
* ``stop_err``: how far the solve's stopping point lies from float64's.
  Each iteration shrinks the change by about ``d``; 0 where the solve
  stopped where float64 does, ``log(change / tol) / log(1 / d)`` past it
  (iterations short of convergence), and as much the other way
  (iterations run after float64 had converged).
"""

from __future__ import annotations

import math

import numpy as np

from .operators import as_scipy, operator

__all__ = ["judge", "power_iteration"]


def power_iteration(a, damping: float, tol: float, max_iter: int,
                    keep=()):
    """``(ranks after each iteration in keep, changes per iteration,
    iterations float64 takes)``; runs ``max(keep)`` or until it stops,
    whichever is later."""
    n = a.shape[0]
    r = np.full(n, 1.0 / n)
    kept, deltas, stop = {}, [], None
    last = max([*keep, 0])
    i = 0
    while i < max_iter and (stop is None or i < last):
        r_new = damping * (a @ r) + (1.0 - damping) / n
        r_new = r_new / r_new.sum()
        deltas.append(float(np.max(np.abs(r_new - r))))
        r = r_new
        i += 1
        if i in keep:
            kept[i] = r.copy()
        if stop is None and deltas[-1] <= tol:
            stop = i
    return kept, deltas, (stop if stop is not None else i)


def judge(config: dict, traffic: dict, seed: int, samples: dict) -> dict:
    """``samples["solves"]``: ``(index, ranks, iterations)`` of the sampled
    solves. Returns one ``{name: reading}`` per sampled solve."""
    a = as_scipy(operator(config, seed))
    d, tol = traffic["damping"], traffic["tol"]
    its = sorted({int(it) for _, _, it in samples["solves"]})
    kept, deltas, stop = power_iteration(a, d, tol, traffic["max_iter"],
                                         keep=its)
    out = []
    for _, r, it in samples["solves"]:
        ref = kept.get(int(it))
        err = (math.inf if ref is None else
               float(np.max(np.abs(np.asarray(r, np.float64) - ref) / ref)))
        out.append({"rank_err": err,
                    "stop_err": _stop_err(int(it), stop, deltas, d, tol)})
    return out


def _stop_err(it: int, stop: int, deltas, d: float, tol: float) -> float:
    if it < 1:
        return math.inf
    tiny = 1e-300
    if it < stop:     # stopped early: the change float64 still saw
        return math.log(max(deltas[it - 1], tiny) / tol) / math.log(1.0 / d)
    if it > stop:     # ran on: how far below tol float64 already was
        return math.log(tol / max(deltas[it - 2], tiny)) / math.log(1.0 / d)
    return 0.0


def control(inputs, device):
    """The loop's ``wrap`` that puts the TF32 control in place of the
    program's multiply."""
    from .control import tf32_multiply

    multiply = tf32_multiply(inputs.matrix, device)
    return lambda program_multiply: multiply

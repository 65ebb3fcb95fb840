"""A closed loop of PageRank solves: each solve is one request,
``models/pagerank.py::pagerank`` over ``spmm_any`` on the operand
``Auto`` prepared (``format`` of the traffic file goes to it), from the
uniform vector, until the largest change is at most ``tol`` or
``max_iter`` iterations ran. A solve is timed from the call to its
ranks ready on the device.

Solve 0, ``samples`` more drawn from the seed in ``sample_range`` and
the window's last solve keep their ranks and iteration counts.

Traffic keys: ``k`` (1), ``format``, ``damping``, ``tol``, ``max_iter``,
``warmup_solves``, ``samples``, ``sample_range``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .chain import describe

__all__ = ["Loop"]


class Loop:
    unit = "solves"
    MULTIPLY_SPAN = "bench.spmm"

    def __init__(self, config, traffic, inputs, device, wrap=None):
        self.traffic, self.inputs = traffic, inputs
        self.device = torch.device(device)
        # Tests and the control: the multiply -> what runs in its place.
        self._wrap = wrap
        rng = np.random.default_rng([inputs.seed, 2])
        lo, hi = traffic["sample_range"]
        drawn = rng.choice(np.arange(lo, hi), size=traffic["samples"],
                           replace=False)
        self.sample_at = {0} | {int(i) for i in drawn}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, clock) -> None:
        from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
        from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
            route_kernels, spmm_any)
        from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import Auto
        from sparsematrixmultiplicationmpi_tpu_torch.models.pagerank import pagerank

        a = self.inputs.matrix
        csr = CSR.from_arrays(a.values, a.col_indices, a.row_ptr, a.shape)
        with clock("format_build_s"):
            self.op = Auto(**self.traffic["format"]).prepare(csr, self.device)
            self._sync()
        self.route = describe(self.op, route_kernels(self.op,
                                                     self.traffic["k"]))
        op = self.op
        self.multiply = lambda v: spmm_any(op, v)
        if self._wrap is not None:
            self.multiply = self._wrap(self.multiply)
        self.pagerank = pagerank
        with clock("warmup_s"):
            for _ in range(int(self.traffic["warmup_solves"])):
                self._solve(self.multiply)
            self._sync()

    def _solve(self, multiply):
        t = self.traffic
        return self.pagerank(multiply, self.inputs.matrix.shape[0],
                             damping=t["damping"], tol=t["tol"],
                             max_iter=t["max_iter"], dtype=torch.float32,
                             device=self.device)

    def window(self, seconds: float, span) -> dict:
        multiply = self.multiply

        def traced(v):
            with span(self.MULTIPLY_SPAN):
                return multiply(v)

        keep, kept, times, iters = self.sample_at, {}, [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with span("bench.window"):
            while True:
                ts = time.perf_counter()
                with span("bench.solve"):
                    r, it = self._solve(traced)
                    self._sync()
                te = time.perf_counter()
                times.append(te - ts)
                iters.append(it)
                n = len(times) - 1
                if n in keep:
                    kept[n] = (r, it)
                if te >= deadline:
                    break
        t1 = time.perf_counter()
        kept[n] = (r, it)
        self._kept = kept
        ms = sorted(t * 1e3 for t in times)
        return {"attempted": len(times), "seconds": t1 - t0,
                "solve_s": times, "iterations": iters,
                "summary": {"solve_ms_min": round(ms[0], 4),
                            "solve_ms_median": round(statistics.median(ms), 4),
                            "solve_ms_max": round(ms[-1], 4),
                            "iterations_min": min(iters),
                            "iterations_max": max(iters)}}

    def samples(self) -> dict:
        kept, self._kept = self._kept, None
        return {"solves": [(i, r.double().cpu().numpy(), int(it))
                           for i, (r, it) in sorted(kept.items())]}

    def close(self) -> None:
        self.op = self.multiply = None


def end_to_end(counters: dict, nnz: int) -> dict:
    """Solves completed over the window's seconds, and the 95th
    percentile of every solve's time in it. A result carries those of
    them that ``BENCHMARK.json`` lists for the cell."""
    times = counters["solve_s"]
    p95 = (statistics.quantiles(times, n=100)[94] if len(times) > 1
           else times[0])
    return {"solves_per_s": counters["attempted"] / counters["seconds"],
            "solve_ms_p95": p95 * 1e3}

"""Profiler integration (port of
``sparsematrixmultiplicationmpi_tpu/utils/profiling.py``).

The reference split communication from computation by uncommenting
timer blocks inside every kernel and rebuilding (``RowWise.cpp:21-23,
52-60,89-98``). Here:

* ``trace(log_dir)`` records a ``torch.profiler`` trace of a region (CPU
  ops, and the card's kernels where there is one) and writes it to
  ``log_dir/trace.json`` (Chrome trace format, Perfetto-viewable);
* ``annotate(name)`` marks an application phase inside a trace
  (``record_function``);
* ``comm_comp_split`` estimates the collective-vs-compute split by
  differential timing: the strategy with its result gathered and left
  sharded, each as an amortized slope (``utils/timing.py``: CUDA events
  on the card).
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["trace", "annotate", "comm_comp_split"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace.json``; yields the profiler (its ``key_averages()``
    has the per-op times)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named phase in profiler traces."""
    return torch.profiler.record_function(name)


def comm_comp_split(strategy, operand, v, mesh=None, *, inner: int = 10,
                    warmup: int = 1, iters: int = 3):
    """``(total, compute, communication)`` seconds per SpMM: the
    strategy timed with the result gathered (total) and left sharded
    (compute and the collectives inside the multiply); the difference
    estimates the result's gather, the reference's "communication time"
    (``RowWise.cpp:89-98``). A slope below the timer's resolution falls
    back to the chain's upper bound, for both alike, so the difference
    stays meaningful."""
    from .timing import measure_amortized

    def per_iter(gather):
        timing, _ = measure_amortized(
            lambda vv, op: strategy.spmm(op, vv, gather_result=gather),
            v, operand, inner=inner, warmup=warmup, iters=iters)
        return (timing.seconds_per_iter if timing.resolved
                else timing.upper_bound)

    t_total = per_iter(True)
    t_comp = per_iter(False)
    return t_total, t_comp, max(t_total - t_comp, 0.0)

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
* ``span(name)`` marks a region of the per-multiply or per-iteration
  path: while a profiler records, a ``record_function`` region in its
  trace (on the kernels' clock) and a host duration in the registry;
  otherwise one shared no-op context, so the hot path pays one flag
  read;
* ``count(name, n)`` adds ``n`` to a named counter of the same path
  (bytes staged, say): its count and total, and only while a profiler
  records, as ``span`` does;
* ``phase(name, sync=None)`` marks set-up work done once per matrix:
  its host seconds always go to the registry (count and total), and it
  is a ``record_function`` region too while a profiler records;
* ``snapshot()`` reads the registry (spans, phases and counters),
  ``reset_spans()`` clears it;
* ``comm_comp_split`` estimates the collective-vs-compute split by
  differential timing: the strategy with its result gathered and left
  sharded, each as an amortized slope (``utils/timing.py``: CUDA events
  on the card).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from .timing import _synchronize

__all__ = ["trace", "annotate", "span", "phase", "count", "snapshot",
           "reset_spans", "comm_comp_split"]

#: name -> {"count", "total_s", "durations_s"}: what spans and phases
#: recorded in this process (``durations_s`` holds spans' only); a
#: counter's entry is {"count", "total"}.
_REGISTRY: dict = {}
_NOOP = contextlib.nullcontext()


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


def _recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``)
    session is recording in this process: one module-global read."""
    return _autograd_profiler._is_profiler_enabled


def _add(name: str, seconds: float, keep: bool) -> None:
    entry = _REGISTRY.get(name)
    if entry is None:
        entry = _REGISTRY[name] = {"count": 0, "total_s": 0.0,
                                   "durations_s": []}
    entry["count"] += 1
    entry["total_s"] += seconds
    if keep:
        entry["durations_s"].append(seconds)


class _Span:
    """A ``record_function`` region whose host duration is registered."""

    __slots__ = ("name", "_region", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._region = torch.profiler.record_function(self.name)
        self._region.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._region.__exit__(*exc)
        _add(self.name, seconds, keep=True)
        return False


def span(name: str):
    """A region of the hot path, ``with span("pagerank.update"): ...``.
    With no profiler recording it is one shared no-op context: no
    allocation, no clock read, no record. While one records it is a
    ``record_function`` region in the profiler's trace and its host
    duration is appended to the registry."""
    if not _recording():
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Set-up work done once per matrix, ``with phase("format.place",
    sync=device): ...``: its host seconds are always added to the
    registry (count and total); while a profiler records it is also a
    ``record_function`` region. With ``sync`` (a device, a tensor, or a
    collection of them) a CUDA device is synchronised before the clock
    stops, so the work the phase queued on it is counted."""
    region = (torch.profiler.record_function(name) if _recording()
              else _NOOP)
    with region:
        t0 = time.perf_counter()
        try:
            yield
            if sync is not None:
                _synchronize(sync)
        finally:
            _add(name, time.perf_counter() - t0, keep=False)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` (one to its count, ``n`` to its
    total), ``count("coo.staged_bytes", nbytes)``. Like ``span`` it
    records only while a profiler records; otherwise it is one flag
    read."""
    if not _recording():
        return
    entry = _REGISTRY.get(name)
    if entry is None:
        entry = _REGISTRY[name] = {"count": 0, "total": 0}
    entry["count"] += 1
    entry["total"] += n


def snapshot() -> dict:
    """A copy of the registry: ``{name: {"count", "total_s",
    "durations_s"}}`` for spans and phases, ``durations_s`` the spans'
    host durations (empty for a phase), and ``{name: {"count",
    "total"}}`` for counters."""
    return {name: {k: list(v) if isinstance(v, list) else v
                   for k, v in e.items()}
            for name, e in _REGISTRY.items()}


def reset_spans() -> None:
    """Forget everything spans, phases and counters recorded."""
    _REGISTRY.clear()


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

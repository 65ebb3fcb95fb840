"""Timing for the port (counterpart of
``sparsematrixmultiplicationmpi_tpu/utils/timing.py``).

On a CUDA tensor every measurement is taken with CUDA events on the
current stream after warm-up and ends in a synchronize, so it covers the
device's work and not only its enqueue; on a CPU tensor the host clock
is the only clock there is. The result says nothing about the device it
did not run on. ``PhaseTimer`` records named phases on the host clock,
each ended by a synchronize of the CUDA device its work ran on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch

__all__ = ["AmortizedTiming", "PhaseTimer", "Timing", "measure_amortized",
           "time_fn", "time_fn_amortized", "time_region"]


@dataclasses.dataclass
class Timing:
    """One timed measurement (seconds)."""

    name: str
    seconds: float

    def to_dict(self):
        return {"name": self.name, "seconds": self.seconds}


def _synchronize(target) -> None:
    """Wait for the device work behind ``target``: a tensor, a device (or
    its name), or a list, tuple or dict of them. CPU work is done when
    the call returns."""
    if isinstance(target, dict):
        target = list(target.values())
    if isinstance(target, (list, tuple)):
        for t in target:
            _synchronize(t)
        return
    device = (target.device if isinstance(target, torch.Tensor)
              else torch.device(target))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates named phase timings (the reference's debug timers,
    ``results_debug.csv``)."""

    def __init__(self):
        self.records: List[Timing] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase on the host clock. ``sync`` (or ``"sync"`` set in
        the yielded dict) is a tensor, a device or a collection of them
        whose CUDA device is synchronized before the clock stops: PyTorch
        returns before the card has finished."""
        start = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            target = result.get("sync", sync)
            if target is not None:
                _synchronize(target)
            self.records.append(Timing(name, time.perf_counter() - start))

    def total(self, prefix: str = "") -> float:
        return sum(r.seconds for r in self.records
                   if r.name.startswith(prefix))

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out


def time_region(fn, device: torch.device, n: int = 1) -> float:
    """Seconds for ``n`` back-to-back calls of ``fn()`` on ``device``:
    CUDA events around the calls for a CUDA device, the host clock
    otherwise."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return time.perf_counter() - t0


def time_fn(fn, device: torch.device, *, warmup: int = 1, iters: int = 5):
    """(best seconds of one ``fn()`` call, last result) after warm-up."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn()
    best = min(time_region(fn, device) for _ in range(max(iters, 1)))
    return best, result


@dataclasses.dataclass
class AmortizedTiming:
    """A two-point amortized measurement. ``seconds_per_iter`` is NaN
    when the slope is below the endpoints' own run-to-run spread;
    ``upper_bound`` (chain time / chain length) is always a valid
    bound."""

    seconds_per_iter: float   # NaN when below resolution
    upper_bound: float        # t_hi / inner
    resolved: bool
    t_lo: float               # best time of the 1-call chain
    t_hi: float               # best time of the `inner`-call chain
    noise: float              # endpoint spread (median - best), summed


def measure_amortized(fn, v, *args, inner: int = 20, warmup: int = 1,
                      iters: int = 3):
    """Steady-state per-call time of ``fn(v, *args)``.

    Times a chain of ``inner`` back-to-back calls and a chain of one; the
    slope between the two cancels the fixed per-chain cost. Every call
    re-runs ``fn`` on the same input
    (the reference feeds back ``v + 1e-30 * sum(out)``, which leaves
    ``v`` as it is; feeding the output itself back would overflow to inf
    within a hundred iterates). Calls run in stream order, so each one's
    full work is inside the chain's timing. Returns ``(AmortizedTiming,
    fn(v, *args))``.
    """
    device = v.device

    def call():
        fn(v, *args)

    def stats(n):
        for _ in range(max(warmup, 1)):
            time_region(call, device, n)
        times = sorted(time_region(call, device, n)
                       for _ in range(max(iters, 1)))
        return times[0], times[len(times) // 2] - times[0]

    t_hi, noise_hi = stats(inner)
    t_lo, noise_lo = stats(1)
    slope = (t_hi - t_lo) / (inner - 1)
    resolution = max((noise_hi + noise_lo) / (inner - 1), 1e-7)
    resolved = slope > resolution
    timing = AmortizedTiming(
        seconds_per_iter=slope if resolved else float("nan"),
        upper_bound=t_hi / inner, resolved=resolved, t_lo=t_lo, t_hi=t_hi,
        noise=noise_hi + noise_lo)
    return timing, fn(v, *args)


def time_fn_amortized(fn, v, *args, inner: int = 20, warmup: int = 1,
                      iters: int = 3):
    """``measure_amortized`` as ``(seconds per call, fn(v, *args))``;
    NaN when below resolution."""
    timing, result = measure_amortized(fn, v, *args, inner=inner,
                                       warmup=warmup, iters=iters)
    return timing.seconds_per_iter, result

"""The traced window: ``torch.profiler`` around the loop, read back from
its Chrome trace.

The loops mark their calls into the program with spans of their own
(``record_function`` regions named ``bench.*``); a device operation
belongs to a span when the host call that launched it (matched by the
trace's correlation id) lies inside one. The device is busy wherever at
least one kernel, copy or fill runs: the union of their intervals, so
overlapping operations are not counted twice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import tempfile
from bisect import bisect_left, bisect_right

__all__ = ["NoTrace", "Tracer", "SpanStats", "TraceSummary", "summarize",
           "WINDOW_SPAN", "PENDING_FREE"]

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
#: A span is issued with the device out of the way when fewer device
#: operations than this had been launched before it began and had not
#: yet ended. CUDA's launch queue holds about a thousand, so such a span's
#: host time holds no wait for a slot in it, however slow the device.
PENDING_FREE = 64


class NoTrace(contextlib.nullcontext):
    """The untraced run: spans cost nothing."""

    summary = None

    def span(self, name: str):
        return contextlib.nullcontext()


class Tracer:
    """Profiles the enclosed window; ``summary`` is read after it closes."""

    summary = None

    def __init__(self):
        self._prof = None

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(name)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            if isinstance(events, dict):
                events = events.get("traceEvents", [])
            self.summary = summarize(events)
        self._prof = None
        return False


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0      # the spans' own host durations, summed
    device_s: float = 0.0    # device operations launched inside them
    device_ops: int = 0
    free_host_s: list = dataclasses.field(default_factory=list)
    # ^ host durations of the spans begun with fewer than PENDING_FREE
    #   operations pending on the device


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    spans: dict              # name -> SpanStats
    device_ops: list         # [[name, seconds]], most time first
    idle_gaps: list          # [[what the host was doing, seconds]]
    n_device_ops: int
    n_attributed: int


def _union(intervals):
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(intervals, points):
    """For each point (sorted), the name of the shortest interval of
    ``intervals`` (``(start, end, name)``, sorted by start) holding it,
    or None."""
    heap, out, j = [], [], 0
    for p in points:
        while j < len(intervals) and intervals[j][0] <= p:
            s, e, name = intervals[j]
            heapq.heappush(heap, (e - s, e, name))
            j += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(events) -> TraceSummary:
    """Reduce a Chrome trace's events (``ts``/``dur`` in microseconds) to
    the window's busy time, each ``bench.*`` span's host and device time,
    the device operations that took most time and the idle gaps by what
    the host was doing."""
    us = 1e-6
    spans, host, dev, launch = {}, [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"]) * us
        t = s + float(e.get("dur", 0.0)) * us
        if cat == "user_annotation" and name.startswith("bench."):
            spans.setdefault(name, []).append((s, t))
        elif cat in DEVICE_CATS:
            dev.append((s, t, name, (e.get("args") or {}).get("correlation")))
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = s
        if cat in HOST_CATS:
            host.append((s, t, name))
    if WINDOW_SPAN not in spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = spans.pop(WINDOW_SPAN)[0]
    dev_all = dev
    dev = [(max(s, w0), min(t, w1), n, c) for s, t, n, c in dev
           if t > w0 and s < w1]
    busy = _union([(s, t) for s, t, _, _ in dev])
    busy_s = sum(t - s for s, t in busy)

    # Operations launched and not yet ended at a time: launches before it
    # less ends before it (an operation ends after its launch).
    matched = [(launch[c], t) for _, t, _, c in dev_all if c in launch]
    launched = sorted(s for s, _ in matched)
    ended = sorted(t for _, t in matched)

    def pending(p):
        return bisect_left(launched, p) - bisect_left(ended, p)

    stats = {}
    starts = {}
    for name, ivs in spans.items():
        ivs.sort()
        stats[name] = SpanStats(
            count=len(ivs), host_s=sum(t - s for s, t in ivs),
            free_host_s=[t - s for s, t in ivs if pending(s) < PENDING_FREE])
        starts[name] = ([s for s, _ in ivs], [t for _, t in ivs])
    by_name, attributed = {}, 0
    for s, t, name, corr in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        at = launch.get(corr)
        if at is None:
            continue
        attributed += 1
        for span, (ss, ts) in starts.items():
            i = bisect_right(ss, at) - 1
            if i >= 0 and at <= ts[i]:
                stats[span].device_s += t - s
                stats[span].device_ops += 1

    gaps = []
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    where = {}
    if gaps:
        pts = [g0 for g0, _ in gaps]
        bench = sorted((s, t, n) for n, (ss, ts) in starts.items()
                       for s, t in zip(ss, ts))
        span_at = _innermost(bench, pts)
        op_at = _innermost(sorted(host), pts)
        for (g0, g1), sp, op in zip(gaps, span_at, op_at):
            key = f"{sp or 'loop'}/{op or 'python'}"
            where[key] = where.get(key, 0.0) + (g1 - g0)
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return TraceSummary(window_s=w1 - w0, busy_s=busy_s, spans=stats,
                        device_ops=top(by_name), idle_gaps=top(where),
                        n_device_ops=len(dev), n_attributed=attributed)

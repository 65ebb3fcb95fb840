"""Arithmetic the per-layer readers in ``benchmark/metrics`` share. Each
returns None where the traced run gave it nothing to read."""

from __future__ import annotations

import statistics

__all__ = ["issue_ms", "roofline_pct", "idle_pct"]


def _span(run, name):
    if run.trace is None:
        return None
    s = run.trace.spans.get(name)
    return s if s is not None and s.count else None


def issue_ms(run, name):
    """Host milliseconds to issue one ``name`` span, the median over the
    spans begun with the device out of the way (``trace.PENDING_FREE``):
    in a device-bound loop the launch queue fills, and a later span's
    host time is then the wait for a slot, which the device paces."""
    s = _span(run, name)
    if s is None or not s.free_host_s:
        return None
    return statistics.median(s.free_host_s) * 1e3


def roofline_pct(run, name):
    """The byte floor of one multiply over the device time of the
    operations one ``name`` span launched, in percent."""
    s = _span(run, name)
    if s is None or run.floor_s is None or s.device_s <= 0:
        return None
    return 100.0 * run.floor_s * s.count / s.device_s


def idle_pct(run):
    """Share of the traced window with nothing running on the device."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

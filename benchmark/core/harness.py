"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

``run.py`` calls ``main``; the CPU tests call ``run_cell`` with
``device="cpu"``, which skips only the look for a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from .cells import Cell, load_cell, load_reader
from .floors import floor_seconds

__all__ = ["Inputs", "RunContext", "make_inputs", "run_cell", "main",
           "FORBIDDEN", "forbidden_modules", "TRACE_SECONDS"]

#: Top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the port was made from (compared whole, since the
#: port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsematrixmultiplicationmpi_tpu")
#: Length of the traced window (``--trace 1``), at most ``--seconds``:
#: long enough for thousands of multiplies or tens of solves, short
#: enough that the profiler's trace stays small.
TRACE_SECONDS = 1.0


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class Inputs:
    seed: int
    matrix: object        # reference.generate.Csr, float32 values
    v0: np.ndarray        # (n, k) float32 start vector


def make_inputs(cell: Cell, seed: int) -> Inputs:
    """What both sides are given: the configuration's operator for
    ``seed`` in the configuration's precision, and ``v0`` (integers
    1..100, the MPI reference's fat vector)."""
    from benchmark.reference.generate import generate_fat_vector
    from benchmark.reference.operators import operator

    dtype = np.dtype(cell.config["dtype"])
    a = operator(cell.config, seed)
    matrix = a._replace(values=a.values.astype(dtype))
    v0 = generate_fat_vector(a.shape[1], cell.traffic["k"], seed).astype(dtype)
    return Inputs(seed=seed, matrix=matrix, v0=v0)


@dataclasses.dataclass
class RunContext:
    """What a per-layer metric's reader reads (``benchmark/metrics``)."""
    cell: Cell
    setup: dict           # set-up parts, seconds
    counters: dict        # the loop's window: attempted, seconds, ...
    trace: object         # core.trace.TraceSummary, or None untraced
    floor_s: float | None  # one multiply's byte floor on this card
    multiply_span: str    # the span the loop marks one multiply with


class _Clock:
    def __init__(self):
        self.parts = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + (
                time.perf_counter() - t0)


def pin_to_quietest_cpu(log=print):
    """Pin the calling thread to the CPU on which a fixed bit of Python
    runs fastest (best of 3 on each CPU it may use). The loops are
    issued by this one thread; the card's host shares its cores with
    other work, and a thread left to move between them, or placed on a
    busy one, changed a host-bound cell's rate by 10-25 % from run to
    run."""
    cpus = sorted(os.sched_getaffinity(0))
    best = {}
    for cpu in cpus:
        os.sched_setaffinity(0, {cpu})
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sum(range(100_000))
            times.append(time.perf_counter() - t0)
        best[cpu] = min(times)
    cpu = min(best, key=best.get)
    os.sched_setaffinity(0, {cpu})
    log("cpu: " + " ".join(f"{c}:{best[c] * 1e3:.3f}" for c in cpus)
        + f" pinned {cpu}")


def card_info(device) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch

    info = {"platform": "cpu", "kind": "cpu", "count": 0, "power_limit": None}
    if device.type != "cuda":
        return info
    info.update(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def _e2e(cell: Cell, values: dict) -> dict:
    """The cell's end-to-end metrics, as ``BENCHMARK.json`` lists them. A
    metric's value is the loop's value of its name or, failing that, of
    the part of its name before the first dot: ``gnnz_per_s.k1`` is the
    chain loop's ``gnnz_per_s``, held to a bound of its own."""
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        key = name if name in values else name.split(".")[0]
        if key in values:
            out[name] = {"value": values[key], "unit": m["unit"]}
    return out


def _checks(cell: Cell, seed: int, samples: dict) -> tuple:
    """``({name: {"value", "limit"}}, failed samples)``: the reference's
    readings (``benchmark/reference/<loop>.py::judge``), each the worst
    over the samples, beside the traffic file's limits."""
    judge = importlib.import_module(
        f"benchmark.reference.{cell.traffic['loop']}").judge
    readings = judge(cell.config, cell.traffic, seed, samples)
    limits = cell.traffic["limits"]
    checks = {name: {"value": max((r[name] for r in readings if name in r),
                                  default=math.inf), "limit": limit}
              for name, limit in limits.items()}
    failed = sum(any(not v <= limits[n] for n, v in r.items())
                 for r in readings)
    return checks, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, wrap=None, log=print) -> dict:
    """One run; returns the result object (``correct`` ... ``checks``).
    ``wrap(inputs, device)``, for the control and the tests, gives what
    the loop puts in place of the program's calls (its ``wrap``)."""
    import torch

    from .trace import NoTrace, Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    clock = _Clock()
    clock.parts["imports_s"] = time.perf_counter() - t_start
    device = torch.device(device)
    with clock("card_s"):
        card = card_info(device)
    log(f"card: {card['kind']} power_limit: {card['power_limit']}")
    with clock("data_s"):
        inputs = make_inputs(cell, seed)
    a = inputs.matrix
    loop = cell.loop_module().Loop(
        cell.config, cell.traffic, inputs, device,
        wrap=None if wrap is None else wrap(inputs, device))
    loop.setup(clock)
    # What set-up left behind is never collected in the window.
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        pin_to_quietest_cpu(log)
    log(f"route: {loop.route}")
    setup_s = time.perf_counter() - t_start
    clock.parts["setup_s"] = setup_s
    log("setup: " + " ".join(f"{k}={v:.4f}" for k, v in clock.parts.items()))

    length = min(seconds, TRACE_SECONDS) if trace else seconds
    tracer = Tracer() if trace else NoTrace()
    with tracer:
        counters = loop.window(length, tracer.span)
    log(f"window: {counters['attempted']} {loop.unit} in "
        f"{counters['seconds']:.4f} s" + "".join(
            f" {k}={v}" for k, v in counters.get("summary", {}).items()))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that may not load in a run: {found}")
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    samples = loop.samples()
    loop.close()
    del loop
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = _checks(cell, seed, samples)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    floor_s = floor_seconds(a.shape[0], a.shape[1], a.nnz, cell.traffic["k"],
                            card["kind"])
    device_out = {"platform": card["platform"], "kind": card["kind"],
                  "count": card["count"], "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": counters["attempted"],
              "failed": failed}
    if trace:
        ctx = RunContext(cell=cell, setup=clock.parts, counters=counters,
                         trace=tracer.summary, floor_s=floor_s,
                         multiply_span=cell.loop_module().Loop.MULTIPLY_SPAN)
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        s = tracer.summary
        device_out.update(busy_s=s.busy_s, window_s=s.window_s)
        result["metrics"] = metrics
        result["device"] = device_out
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
        log(f"trace: {s.n_device_ops} device ops, {s.n_attributed} matched "
            f"to their launch; spans (count/device ops/issued free) " + " ".join(
                f"{k}:{v.count}/{v.device_ops}/{len(v.free_host_s)}"
                for k, v in s.spans.items()))
    else:
        values = cell.loop_module().end_to_end(counters, a.nnz)
        result["metrics"] = _e2e(cell, {"setup_s": setup_s, **values})
        result["device"] = device_out
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=t_start)
    # Again once the judge and the readers have run: they load modules too.
    found = forbidden_modules()
    if found:
        print(f"modules that may not load in a run: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0

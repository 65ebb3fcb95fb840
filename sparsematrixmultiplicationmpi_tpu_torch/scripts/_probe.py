"""What the cost-model probes share: their command line, the matrices
they measure, a timer, the oracle check every timed result passes first,
and the JSON they write.

Each probe runs on the card (``--device cuda``, the default) and writes
``<out-dir>/<name>.json`` (``results/h100/`` by default) with the card's
name and power limit; ``--device cpu`` runs it on the CPU at
``--scale`` of its sizes and writes ``<name>_cpu.json``, which no table
reads.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..formats.matrix import CSR, as_float64
from ..ops.oracle import spmm_host_f64
from ..utils.compare import are_matrices_equal, default_tolerance
from . import _common
from .run_results_sweep import BUILDERS, IMPACT, MAIN

#: The results sweep's matrices (its builders: the same sizes and seeds).
FAMILIES = MAIN + IMPACT


def matrix(name: str, scale: float = 1.0) -> CSR:
    """One of ``FAMILIES`` in f32, at ``scale`` of its size."""
    return BUILDERS[name](scale).astype(np.float32)


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    _common.add_device_args(ap)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of each matrix's size (default 1)")
    return ap


def device_of(prog: str, args):
    """The run's device, or the exit code of a refused card run."""
    err = _common.device_error(args.device)
    if err:
        return _common.refuse(prog, err)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", 0)
    return torch.device("cpu")


def _once(fn, device: torch.device, n: int) -> float:
    """Seconds per call over ``n`` back-to-back calls: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def seconds(fn, device: torch.device, n: int = 20, warmup: int = 3,
            rounds: int = 3) -> float:
    """Seconds per call of ``fn()`` over ``n`` back-to-back calls, the best
    of ``rounds``."""
    return seconds_each([fn], device, n, warmup, rounds)[0]


def seconds_each(fns, device: torch.device, n: int = 20, warmup: int = 3,
                 rounds: int = 5) -> list:
    """``seconds`` of each of ``fns``, timed in turns (a round times each
    once, in order), so that none is measured alone while the card's
    clocks ramp up after idling."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], _once(fn, device, n))
    return best


class Checked:
    """The oracle of one matrix and fat vector (bf16 ``uint16`` bits
    decoded): ``ok(out)`` holds a result against ``spmm_host_f64`` in the
    tier of ``utils/compare.py`` (f32 unless ``dtype`` says otherwise,
    numpy or torch)."""

    def __init__(self, csr: CSR, v_host: np.ndarray):
        self.oracle = spmm_host_f64(csr, v_host)
        abs_csr = CSR(values=np.abs(as_float64(csr.values)),
                      col_indices=csr.col_indices, row_ptr=csr.row_ptr,
                      shape=csr.shape)
        self.cond = spmm_host_f64(abs_csr, np.abs(as_float64(v_host)))

    def ok(self, out: torch.Tensor, dtype=np.float32) -> bool:
        got = out.detach().to("cpu", torch.float64).numpy()
        return got.shape == self.oracle.shape and are_matrices_equal(
            got, self.oracle, tolerance=default_tolerance(dtype),
            relative=True, condition_scale=self.cond)


def timed_checked(label: str, fn, check: Checked, device, **kw) -> float:
    """``fn()`` checked against the oracle, then timed (seconds per
    call). A wrong result raises: no time is recorded for it."""
    if not check.ok(fn()):
        raise RuntimeError(f"{label}: result disagrees with spmm_host_f64")
    return seconds(fn, device, **kw)


def chain_body(label: str, op, v, check: Checked):
    """One body of ``Auto``'s chain over the operand ``op`` (on ``v``'s
    device), as a function of no argument: what an iterative caller pays
    a multiply, and what the cost model estimates. The chain (encode, a
    body, decode) is checked against the oracle first."""
    from ..parallel.strategies import Auto

    enc, body, dec = Auto().chain_parts(op)
    x = enc(v, op)
    if not check.ok(dec(body(x, op), op)):
        raise RuntimeError(f"{label}: result disagrees with spmm_host_f64")
    return lambda: body(x, op)


def chain_body_seconds(label: str, op, v, check: Checked, device) -> float:
    """Seconds of one ``chain_body``."""
    return seconds(chain_body(label, op, v, check), device)


def fat_vector(n: int, k: int, device, seed: int = 0):
    from ..io.generate import generate_fat_vector

    v_host = generate_fat_vector(n, k, seed=seed).astype(np.float32)
    return v_host, torch.from_numpy(v_host).to(device)


def write(args, name: str, payload: dict) -> str:
    """``<out-dir>/<name>.json`` (``<name>_cpu.json`` on the CPU) with the
    hardware beside the payload; returns the path."""
    os.makedirs(args.out_dir, exist_ok=True)
    suffix = "" if args.device == "cuda" else "_cpu"
    path = os.path.join(args.out_dir, f"{name}{suffix}.json")
    out = {"hardware": _common.hardware(args.device), "device": args.device,
           "scale": args.scale, **payload}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return path

"""Benchmark harness (port of
``sparsematrixmultiplicationmpi_tpu/bench/harness.py``, one job).

``run_benchmark`` prepares one strategy's operand on a mesh (or one
device), times its SpMM — amortized over a chain of iterates, or one
call at a time — checks the result against the host float64 oracle and
returns a ``BenchRecord`` with the derived rates. On a mesh every rank
runs it and gets the same record. Every record names the device it ran
on (``device_kind``): a CPU run is a CPU number. The sweep runner, the
re-measure protocol and the CSV/JSON writers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..formats.matrix import CSR, array_dtype, as_float64, cast, to_tensor
from ..io.generate import generate_fat_vector
from ..parallel.mesh import as_mesh
from ..parallel.strategies import Strategy
from ..utils.compare import (
    are_matrices_equal, default_tolerance, max_abs_error,
)
from ..utils.timing import measure_amortized, time_fn

__all__ = ["BenchRecord", "run_benchmark", "roofline_bytes",
           "roofline_seconds", "HBM_BANDWIDTH", "device_kind"]

#: Device-memory bandwidth (bytes/s) by the name the device reports
#: (``device_kind``): NVIDIA's data-sheet figure for the H100 SXM, and a
#: nominal host figure for the CPU.
HBM_BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "cpu": 50e9,
}


def device_kind(device: torch.device) -> str:
    """The name the device reports: ``torch.cuda.get_device_name`` for a
    CUDA device, ``"cpu"`` otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _hbm_bandwidth(kind: str) -> float:
    try:
        return HBM_BANDWIDTH[kind]
    except KeyError:
        raise ValueError(
            f"no memory bandwidth on record for device {kind!r}; add its "
            "data-sheet figure to HBM_BANDWIDTH") from None


def roofline_bytes(nnz: int, m: int, n: int, k: int, dtype=np.float32,
                   index_dtype=np.int32) -> int:
    """Minimum device-memory traffic of one SpMM in the gather model:
    values + indices + one fat-vector row per nonzero (no reuse) + the
    output."""
    vb = np.dtype(dtype).itemsize
    ib = np.dtype(index_dtype).itemsize
    return nnz * (vb + ib) + nnz * k * vb + m * k * vb


def roofline_seconds(nnz, m, n, k, dtype=np.float32, kind="cpu") -> float:
    return roofline_bytes(nnz, m, n, k, dtype) / _hbm_bandwidth(kind)


@dataclasses.dataclass
class BenchRecord:
    """One (matrix, k, strategy, device) measurement."""

    matrix: str
    m: int
    n: int
    nnz: int
    k: int
    strategy: str
    devices: int
    execution_time: float          # seconds per SpMM; NaN below resolution
    prepare_time: float            # format build + move to the device
    correct: Optional[bool]        # vs the host f64 oracle
    max_error: Optional[float]
    gflops: float                  # 2*nnz*k / t
    gnnz_per_s: float              # nnz / t
    roofline_fraction: Optional[float]
    dtype: str
    device_kind: str
    gathered: bool = True          # result gathered on every rank
    comp_time: Optional[float] = None  # comm_comp_split: sharded result
    comm_time: Optional[float] = None  # and the gather's estimate
    time_upper_bound: Optional[float] = None  # chain time / chain length

    def to_dict(self):
        return dataclasses.asdict(self)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_benchmark(csr: CSR, k: int, strategy: Strategy, mesh, *,
                  matrix_name: str = "matrix", seed: int = 0,
                  warmup: int = 2, iters: int = 5,
                  oracle: Optional[np.ndarray] = None,
                  check: bool = True, gather_result: bool = True,
                  dtype=None, amortized: bool = False,
                  inner: int = 10, comm_split: bool = False) -> BenchRecord:
    """Benchmark one strategy on one matrix on ``mesh`` (a ``Mesh``, or a
    device for one device).

    ``amortized=True`` times the strategy's chain body (``chain_parts``)
    as a two-point slope over ``inner`` back-to-back iterates — the
    marginal cost of one more multiply that an iterative consumer pays,
    with the one-time encode/decode outside — escalating the chain length
    (``inner``, 4x, 16x) until the slope resolves. Otherwise it times one
    ``spmm`` call at a time. ``gather_result=False`` times the multiply
    with its result left sharded (it is gathered outside the timing for
    the check); ``comm_split`` adds ``comm_comp_split``'s estimate.
    """
    mesh = as_mesh(mesh)
    device = mesh.device
    if dtype is not None:
        csr = csr.astype(dtype)
    m, n = csr.shape
    nnz = csr.nnz
    kind = device_kind(device)
    sol = roofline_seconds(nnz, m, n, k, csr.values.dtype, kind)
    # ``cast``, not ``astype``: a bf16 matrix's values are uint16 bits.
    v_host = cast(generate_fat_vector(n, k, seed=seed), csr.values.dtype)
    v = to_tensor(v_host, device)

    t0 = time.perf_counter()
    operand = strategy.prepare(csr, mesh)
    _sync(device)
    prepare_time = time.perf_counter() - t0

    upper_bound = None
    if amortized:
        enc, body, dec = strategy.chain_parts(
            operand, mesh, gather_result=gather_result)
        v_enc = enc(v, operand)
        timing = out_enc = None
        for inner_try in (inner, inner * 4, inner * 16):
            timing, out_enc = measure_amortized(
                body, v_enc, operand, inner=inner_try, warmup=warmup,
                iters=iters)
            if timing.resolved:
                break
        best = timing.seconds_per_iter
        upper_bound = timing.upper_bound
        out = dec(out_enc, operand)
    else:
        best, out = time_fn(
            lambda: strategy.spmm(operand, v, gather_result=gather_result),
            device, warmup=warmup, iters=iters)
        if not gather_result:
            out = strategy.gather(operand, out, k)
    out = out.detach().cpu().double().numpy()

    correct = err = None
    if check:
        from ..ops.oracle import spmm_host_f64

        if oracle is None:
            oracle = spmm_host_f64(csr, v_host)
        relative = csr.values.dtype != np.float64
        cond = None
        if relative:
            # Forward-error conditioning of each output element,
            # sum |a_ij * v_jk| (utils/compare.py::are_matrices_equal).
            abs_csr = dataclasses.replace(
                csr, values=np.abs(as_float64(csr.values)))
            cond = spmm_host_f64(abs_csr, np.abs(as_float64(v_host)))
        err = max_abs_error(out, oracle)
        correct = are_matrices_equal(
            out, oracle, tolerance=default_tolerance(array_dtype(csr.values)),
            relative=relative, condition_scale=cond)

    comp_time = comm_time = None
    if comm_split:
        from ..utils.profiling import comm_comp_split

        _, comp_time, comm_time = comm_comp_split(
            strategy, operand, v, mesh, inner=inner, warmup=warmup,
            iters=iters)

    resolved = best == best and best > 0
    return BenchRecord(
        matrix=matrix_name, m=m, n=n, nnz=nnz, k=k,
        strategy=strategy.name, devices=mesh.size,
        execution_time=best, prepare_time=prepare_time,
        correct=correct, max_error=err,
        gflops=2.0 * nnz * k / best / 1e9 if resolved else float("nan"),
        gnnz_per_s=nnz / best / 1e9 if resolved else float("nan"),
        roofline_fraction=sol / best if resolved else None,
        dtype=str(array_dtype(csr.values)).removeprefix("torch."),
        device_kind=kind, gathered=gather_result,
        comp_time=comp_time, comm_time=comm_time,
        time_upper_bound=upper_bound,
    )

"""Benchmark harness (port of
``sparsematrixmultiplicationmpi_tpu/bench/harness.py``).

``run_benchmark`` prepares one strategy's operand on a mesh (or one
device), times its SpMM — amortized over a chain of iterates, or one
call at a time — checks the result against the host float64 oracle and
returns a ``BenchRecord`` with the derived rates. On a mesh every rank
runs it and gets the same record. Every record names the device it ran
on (``device_kind``): a CPU run is a CPU number.

``sweep`` runs the cartesian product matrix x k x devices x strategy
(the reference's ``batch_test.sh``), recording a job that raises as a
failed row, with a per-job watchdog and a CSV checkpoint to resume from.
``suspicious_records`` and ``remeasure_record`` are the re-measure
protocol for rows that cannot be right; ``read_csv``, ``write_csv`` and
``write_json`` carry records in the JAX package's CSV schema.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..formats.matrix import CSR, array_dtype, as_float64, cast, to_tensor
from ..io.generate import generate_fat_vector
from ..parallel.mesh import as_mesh
from ..parallel.strategies import Strategy, get_strategy
from ..utils.compare import (
    are_matrices_equal, default_tolerance, max_abs_error,
)
from ..utils.timing import measure_amortized, time_fn

__all__ = ["BenchRecord", "run_benchmark", "sweep", "CSV_COLUMNS",
           "suspicious_records", "remeasure_record", "read_csv",
           "write_csv", "write_json", "roofline_bytes", "roofline_seconds",
           "HBM_BANDWIDTH", "device_kind"]

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
    error: Optional[str] = None    # the exception of a failed job
    remeasured: int = 0            # >0: a suspicious row replaced by the
                                   # median of this many amortized runs
    spread_rel: Optional[float] = None  # (max - min) / median of those

    def to_dict(self):
        return dataclasses.asdict(self)


def _dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``...: the name of a torch or numpy
    dtype (numpy ``uint16`` is bfloat16 bits)."""
    if not isinstance(dtype, torch.dtype):
        dtype = array_dtype(np.zeros(0, dtype))
    return str(dtype).removeprefix("torch.")


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
    (``inner``, 4x, 16x) until the slope resolves on every rank. Otherwise
    it times one ``spmm`` call at a time. ``gather_result=False`` times
    the multiply with its result left sharded (it is gathered outside the
    timing for the check); ``comm_split`` adds ``comm_comp_split``'s
    estimate.
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
            if _all_ranks(timing.resolved, mesh):
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
        dtype=_dtype_name(csr.values.dtype), device_kind=kind,
        gathered=gather_result,
        comp_time=comp_time, comm_time=comm_time,
        time_upper_bound=upper_bound,
    )


def _all_ranks(flag: bool, mesh) -> bool:
    """``flag`` held on every rank of ``mesh``'s group: each rank reads its
    own clock, so a rank-local decision to lengthen a chain would leave
    the ranks issuing different collectives. Not a counted collective."""
    if mesh.group is None or mesh.size == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(t.item())


def _run_with_timeout(fn, timeout: Optional[float]):
    """Per-job watchdog (the reference's 240 s ``qdel``,
    ``batch_test.sh:88-92``): ``fn`` runs in a daemon thread, and past
    ``timeout`` seconds ``TimeoutError`` is raised so the sweep records
    the job as failed and goes on. A Python thread cannot be killed: a
    job that hangs leaks its thread, and on a CUDA device that thread
    keeps the device's context and whatever it allocated; ranks that
    ``run_ranks`` spawned for it run on to their own time limit. Run a
    sweep in a subprocess for harder isolation."""
    if timeout is None:
        return fn()
    import threading

    box: Dict[str, object] = {}

    def target():
        try:
            box["rec"] = fn()
        except BaseException as e:  # re-raised in the caller's thread
            box["exc"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise TimeoutError(f"job exceeded {timeout} s watchdog")
    if "exc" in box:
        raise box["exc"]  # type: ignore[misc]
    return box["rec"]


def _benchmark_on_rank(mesh, csr, k, strategy, kwargs):
    """One rank of a job on ``p`` spawned ranks (``run_ranks``)."""
    return run_benchmark(csr, k, strategy, mesh, **kwargs)


def _run_job(csr, k, strategy, p: int, device, kwargs) -> BenchRecord:
    """One job on ``p`` devices: in this process on the one-device mesh
    for ``p = 1``, else on ``p`` spawned ranks (NCCL on cards, gloo on
    the CPU), whose rank 0's record is returned. More ranks than cards
    raises."""
    if p == 1:
        return run_benchmark(csr, k, strategy, as_mesh(device), **kwargs)
    from ..parallel.launch import run_ranks

    if torch.device(device).type == "cuda" and \
            p > torch.cuda.device_count():
        raise ValueError(f"{p} ranks need {p} CUDA devices, have "
                         f"{torch.cuda.device_count()}")
    return run_ranks(_benchmark_on_rank, p, csr, k, strategy, kwargs,
                     device=device)[0]


def sweep(matrices: Dict[str, CSR], ks: Sequence[int],
          strategy_names: Sequence[str], device_counts: Sequence[int], *,
          device="cuda", warmup: int = 2, iters: int = 5,
          check: bool = True, gather_result: bool = True, dtype=None,
          amortized: bool = False, comm_split: bool = False, progress=None,
          resume_from: Optional[str] = None,
          checkpoint_csv: Optional[str] = None,
          on_error: str = "record",
          job_timeout: Optional[float] = None,
          max_consecutive_failures: Optional[int] = None,
          backend_ok=None,
          ) -> List[BenchRecord]:
    """Cartesian sweep (matrix x k x devices x strategy), the
    ``batch_test.sh:9-50`` analog, on ``device`` (``"cuda"`` or
    ``"cpu"``): ``p = 1`` in this process, ``p > 1`` on ``p`` spawned
    ranks (``_run_job``).

    A job that raises, its strategy's construction included, is recorded
    as a failed row (``on_error="record"``) or re-raised (``"raise"``),
    and the sweep goes on; ``job_timeout`` adds the watchdog
    (``_run_with_timeout``). ``checkpoint_csv`` appends each record as it
    completes; ``resume_from`` skips (matrix, k, strategy, devices) jobs
    already in a CSV without an error, so a killed sweep resumes where it
    stopped. Rows are keyed by the strategy's canonical name
    (``row_wise``, not the alias ``row``) when it could be built.

    ``max_consecutive_failures`` aborts once that many jobs fail back to
    back (a dead device makes every remaining job burn its watchdog);
    with ``backend_ok``, a zero-argument health probe, the sweep only
    aborts when the probe fails too, and a streak on a healthy device
    (one matrix that always fails) is recorded and passed.
    """
    done = set()
    if resume_from:
        import csv as _csv
        import os

        if os.path.exists(resume_from):
            with open(resume_from) as f:
                for row in _csv.DictReader(f):
                    if row.get("error") not in ("", "None", None):
                        continue  # failed jobs are retried on resume
                    done.add((row["matrix"], int(row["k"]),
                              row["strategy"], int(row["devices"])))

    ckpt = None
    if checkpoint_csv:
        import csv as _csv
        import os

        # Keyed on the file's existence, not on ``done``: a checkpoint of
        # failed rows only has an empty done-set and must still be
        # rewritten and appended to, not truncated.
        new_file = not (resume_from == checkpoint_csv
                        and os.path.exists(checkpoint_csv))
        if not new_file:
            # This sweep's job keys under both the caller's alias and the
            # canonical name (a failed construction records the alias).
            job_names = {}
            for sname in strategy_names:
                names = {sname}
                try:
                    names.add(get_strategy(sname).name)
                except Exception:
                    pass  # the alias alone: the job will record it so
                job_names[sname] = names
            retry_keys = {
                (mat_name, int(k), nm, int(p))
                for mat_name in matrices for k in ks
                for p in device_counts
                for sname in strategy_names for nm in job_names[sname]
            }
            # Rewrite before appending: an older header would misalign
            # the appended rows, and the failed rows this sweep retries
            # would duplicate their keys. Failed rows of other jobs stay
            # (a sibling sweep sharing the checkpoint keeps its record).
            old = read_csv(checkpoint_csv)
            write_csv(checkpoint_csv, [
                r for r in old
                if not r.error
                or (r.matrix, r.k, r.strategy, r.devices) not in retry_keys
            ])
        ckpt_f = open(checkpoint_csv, "w" if new_file else "a", newline="")
        ckpt = _csv.DictWriter(ckpt_f, fieldnames=CSV_COLUMNS)
        if new_file:
            ckpt.writeheader()

    records: List[BenchRecord] = []
    consecutive_failures = 0
    try:
        for mat_name, csr in matrices.items():
            for k in ks:
                oracle = None
                if check:
                    from ..ops.oracle import spmm_host_f64

                    oracle = spmm_host_f64(
                        csr, generate_fat_vector(csr.shape[1], k, seed=0))
                for p in device_counts:
                    for sname in strategy_names:
                        # Everything job-specific, the strategy's
                        # construction too, lies inside the try.
                        sname_canon = sname
                        try:
                            # Auto's cost model is k-aware: give it the
                            # job's fat-vector width.
                            strategy = (get_strategy(sname, k_nominal=k)
                                        if sname == "auto"
                                        else get_strategy(sname))
                            sname_canon = strategy.name
                            if (mat_name, k, strategy.name, p) in done:
                                continue
                            rec = _run_with_timeout(
                                lambda: _run_job(csr, k, strategy, p,
                                                 device, dict(
                                    matrix_name=mat_name, warmup=warmup,
                                    iters=iters, oracle=oracle,
                                    check=check,
                                    gather_result=gather_result,
                                    dtype=dtype, amortized=amortized,
                                    comm_split=comm_split)),
                                job_timeout)
                        except Exception as e:
                            if on_error == "raise":
                                raise
                            rec = _failed_record(
                                csr, k, sname_canon, p, mat_name, dtype,
                                device,
                                error=f"{type(e).__name__}: {e}"[:500])
                        records.append(rec)
                        if ckpt:
                            ckpt.writerow(rec.to_dict())
                            ckpt_f.flush()
                        if progress:
                            progress(rec)
                        consecutive_failures = (
                            consecutive_failures + 1 if rec.error else 0)
                        if (max_consecutive_failures is not None
                                and consecutive_failures
                                >= max_consecutive_failures):
                            if backend_ok is not None and backend_ok():
                                # The device answers: a job class that
                                # keeps failing, not an outage.
                                consecutive_failures = 0
                                continue
                            raise RuntimeError(
                                f"{consecutive_failures} consecutive job "
                                "failures — backend presumed dead; "
                                "checkpointed rows are safe, resume "
                                f"retries the rest (last: {rec.error})")
    finally:
        if ckpt:
            ckpt_f.close()
    return records


def _failed_record(csr, k, strategy_name, devices, matrix_name, dtype,
                   device="cuda", error: Optional[str] = None
                   ) -> BenchRecord:
    m, n = csr.shape
    device = torch.device(device)
    kind = (device_kind(device)
            if device.type != "cuda" or torch.cuda.is_available()
            else "no CUDA device")
    return BenchRecord(
        matrix=matrix_name, m=m, n=n, nnz=csr.nnz, k=k,
        strategy=strategy_name, devices=devices,
        execution_time=float("nan"), prepare_time=float("nan"),
        correct=False, max_error=None, gflops=0.0, gnnz_per_s=0.0,
        roofline_fraction=None,
        dtype=_dtype_name(dtype if dtype is not None else csr.values.dtype),
        device_kind=kind, gathered=True, error=error,
    )


#: The sweep CSV's columns, in the JAX package's order.
CSV_COLUMNS = [
    "matrix", "m", "n", "nnz", "k", "strategy", "devices",
    "execution_time", "prepare_time", "correct", "max_error",
    "gflops", "gnnz_per_s", "roofline_fraction", "dtype", "device_kind",
    "gathered", "comp_time", "comm_time", "time_upper_bound", "error",
    "remeasured", "spread_rel",
]


def suspicious_records(records: Sequence[BenchRecord]):
    """Rows whose timing cannot be right and must be measured again
    before they are published: ``[(record, reason), ...]`` for resolved,
    non-failed rows above 95 % of the byte roofline, or slower by more
    than 1.5x than a larger-k sibling in their (matrix, strategy,
    devices, dtype) group (SpMM work grows with k, so one of the pair is
    noise; both are flagged)."""
    out = []
    seen = set()

    def flag(r, reason):
        key = (r.matrix, r.k, r.strategy, r.devices, r.dtype)
        if key not in seen:
            seen.add(key)
            out.append((r, reason))

    resolved = [r for r in records
                if not r.error and r.execution_time == r.execution_time]
    for r in resolved:
        if r.roofline_fraction and r.roofline_fraction > 0.95:
            flag(r, f"{r.roofline_fraction * 100:.1f}% of roofline")
    groups = {}
    for r in resolved:
        if r.roofline_fraction and r.roofline_fraction > 0.95:
            continue  # flagged already; it must not drag its neighbours in
        groups.setdefault(
            (r.matrix, r.strategy, r.devices, r.dtype), []).append(r)
    for grp in groups.values():
        grp = sorted(grp, key=lambda r: r.k)
        for lo, hi in zip(grp, grp[1:]):
            if lo.execution_time > 1.5 * hi.execution_time:
                reason = (f"non-monotonic in k: k={lo.k} "
                          f"{lo.execution_time * 1e3:.3f} ms > 1.5x "
                          f"k={hi.k} {hi.execution_time * 1e3:.3f} ms")
                flag(lo, reason)
                flag(hi, reason)
    return out


def remeasure_record(csr: CSR, rec: BenchRecord, *, runs: int = 3,
                     mesh="cuda", warmup: int = 1, iters: int = 5,
                     inner: int = 20) -> BenchRecord:
    """A suspicious row replaced by the median of ``runs`` fresh
    amortized measurements on ``mesh`` (a ``Mesh`` or a device): the run
    whose time is the median, stamped ``remeasured=runs`` and
    ``spread_rel`` = (max - min) / median over the runs. The strategy is
    rebuilt from the row's canonical name."""
    import math

    strat = get_strategy(rec.strategy)
    recs = [run_benchmark(csr, rec.k, strat, mesh, matrix_name=rec.matrix,
                          check=True, amortized=True, warmup=warmup,
                          iters=iters, inner=inner)
            for _ in range(runs)]
    resolved = [r for r in recs
                if not r.error and r.execution_time == r.execution_time]
    if not resolved:
        return recs[-1]
    times = sorted(r.execution_time for r in resolved)
    med = times[len(times) // 2]
    spread = ((times[-1] - times[0]) / med
              if med and not math.isnan(med) else None)
    base = next(r for r in resolved if r.execution_time == med)
    return dataclasses.replace(base, remeasured=runs, spread_rel=spread)


def read_csv(path: str) -> List[BenchRecord]:
    """Records back from a sweep CSV (to render reports and figures from
    a checkpoint: a resumed sweep holds only the jobs it ran)."""
    import csv

    def _f(x):
        return float(x) if x not in ("", "None") else float("nan")

    def _opt_f(x):
        return None if x in ("", "None") else float(x)

    records = []
    with open(path) as f:
        for row in csv.DictReader(f):
            records.append(BenchRecord(
                matrix=row["matrix"], m=int(row["m"]), n=int(row["n"]),
                nnz=int(row["nnz"]), k=int(row["k"]),
                strategy=row["strategy"], devices=int(row["devices"]),
                execution_time=_f(row["execution_time"]),
                prepare_time=_f(row["prepare_time"]),
                correct={"True": True, "False": False}.get(
                    row["correct"], None),
                max_error=_opt_f(row["max_error"]),
                gflops=_f(row["gflops"]),
                gnnz_per_s=_f(row["gnnz_per_s"]),
                roofline_fraction=_opt_f(row["roofline_fraction"]),
                dtype=row["dtype"], device_kind=row["device_kind"],
                gathered=row["gathered"] == "True",
                comp_time=_opt_f(row.get("comp_time", "")),
                comm_time=_opt_f(row.get("comm_time", "")),
                time_upper_bound=_opt_f(row.get("time_upper_bound", "")),
                error=(row.get("error") or None)
                if row.get("error") not in ("", "None") else None,
                remeasured=int(row.get("remeasured") or 0),
                spread_rel=_opt_f(row.get("spread_rel", "")),
            ))
    return records


def write_csv(path: str, records: Iterable[BenchRecord]):
    """One row per job in ``CSV_COLUMNS`` (the measured quantities of
    the reference's ``get_csv_all.sh`` schema)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        for r in records:
            w.writerow(r.to_dict())


def write_json(path: str, records: Iterable[BenchRecord], **extra):
    payload = {"records": [r.to_dict() for r in records], **extra}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)

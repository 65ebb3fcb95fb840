"""Command-line driver, the ``main.cpp`` analog (port of
``sparsematrixmultiplicationmpi_tpu/cli.py``).

``spmm-torch run <matrix.mtx> --k 12`` does what the reference binary
does (``Source Code/main.cpp:7-409``): load the matrix, generate the
seeded fat vector, run the sequential baseline and then each strategy,
check each against the baseline and report the times, in the
reference's phrases ("<Algo> Execution time:", "Results are the
same!/different!", ``main.cpp:80,168,186,191``), with ``--json`` and
``--csv`` for structured output. ``sweep`` is the ``batch_test.sh``
analog, ``convert`` writes a prepared format (``.npz``, the JAX
package's layout) and ``run`` takes one back, ``reorder`` writes an
RCM-reordered ``.mtx`` and ``info`` lists the devices.

Every command that multiplies runs on the card (``--device cuda``, the
default) unless it is given ``--device cpu``; without CUDA a card run
stops with an error and never carries on on the CPU. ``--devices p``
with ``p > 1`` runs on ``p`` ranks: spawned here (``run_ranks``, rank 0
alone prints and writes files), or under ``torchrun`` the group that is
already initialized.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]

STRATEGY_LABELS = {
    "row_wise": "Row-wise",
    "column_wise": "Column-wise",
    "nnz": "Non-zero Elements",
    "library": "Library",
    "auto": "Auto",
    "banded_row_wise": "Banded Row-wise",
}


def _build_parser():
    p = argparse.ArgumentParser(
        prog="spmm-torch",
        description="sparse matrix x fat vector benchmark on PyTorch + CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def device_arg(parser):
        parser.add_argument("--device", default="cuda",
                            choices=["cuda", "cpu"],
                            help="where to multiply (default: the card)")

    run = sub.add_parser("run", help="run strategies on one matrix "
                                     "(the ./main <k> <matrix.mtx> analog)")
    run.add_argument("matrix", help=".mtx or .npz path, or synthetic spec "
                                    "like 'synthetic:cop20k'")
    run.add_argument("--k", type=int, default=12,
                     help="fat-vector column count (reference argv[1])")
    run.add_argument("--strategy", default="all",
                     help="row|column|nnz|library|auto|sequential|all")
    run.add_argument("--devices", type=int, default=None,
                     help="ranks (default: the initialized group, else 1)")
    device_arg(run)
    run.add_argument("--dtype", default="float32",
                     choices=["float64", "float32", "bfloat16"])
    run.add_argument("--no-check", action="store_true",
                     help="skip the comparison with the baseline")
    run.add_argument("--no-gather", action="store_true",
                     help="leave results sharded (the PETSc lesson)")
    run.add_argument("--iters", type=int, default=5)
    run.add_argument("--warmup", type=int, default=2)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--amortized", action="store_true",
                     help="steady-state per-iteration timing")
    run.add_argument("--json", dest="json_path", default=None,
                     help="write records to JSON file ('-' for stdout)")
    run.add_argument("--csv", dest="csv_path", default=None)

    swp = sub.add_parser("sweep", help="matrix x k x devices sweep "
                                       "(the batch_test.sh analog)")
    swp.add_argument("matrices", nargs="+")
    swp.add_argument("--k", type=int, nargs="+", default=[1, 3, 6, 9, 12],
                     help="k values (reference sweep: 1 3 6 9 12)")
    swp.add_argument("--devices", type=int, nargs="+", default=None,
                     help="rank counts (default: every card, or 1 CPU)")
    device_arg(swp)
    swp.add_argument("--strategy", nargs="+",
                     default=["row", "column", "nnz", "library"])
    swp.add_argument("--dtype", default="float32")
    swp.add_argument("--iters", type=int, default=5)
    swp.add_argument("--csv", dest="csv_path", default="results.csv")
    swp.add_argument("--json", dest="json_path", default=None)
    swp.add_argument("--plots", dest="plots_dir", default=None,
                     help="render figure set to this directory "
                          "(needs matplotlib)")
    swp.add_argument("--amortized", action="store_true",
                     help="steady-state per-iteration timing")
    swp.add_argument("--comm-split", action="store_true",
                     help="also measure compute vs gather-collective split")
    swp.add_argument("--job-timeout", type=float, default=240.0,
                     help="per-job watchdog seconds; jobs exceeding it are "
                          "recorded as failed (the reference's 240 s qdel, "
                          "batch_test.sh:88-92). 0 disables.")
    swp.add_argument("--resume", action="store_true",
                     help="skip jobs already present in the --csv file")

    sub.add_parser("info", help="print device and process-group "
                                "information")

    conv = sub.add_parser(
        "convert",
        help="convert .mtx to a compute-ready saved format (.npz)",
    )
    conv.add_argument("input", help=".mtx path or synthetic spec")
    conv.add_argument("output", help="output .npz path")
    conv.add_argument("--format", default="auto",
                      choices=["auto", "csr", "coo", "bucketed", "banded"])
    conv.add_argument("--block-rows", type=int, default=None)
    conv.add_argument("--dtype", default="float32")
    conv.add_argument("--rcm", action="store_true",
                      help="apply RCM bandwidth-reducing reordering first")

    ro = sub.add_parser(
        "reorder", help="RCM-reorder a matrix and write it back as .mtx"
    )
    ro.add_argument("input")
    ro.add_argument("output")
    return p


def _torch_dtype(name: str):
    import torch

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _load_matrix(spec: str, dtype: str):
    """The CSR (or, from a ``.npz``, the prepared ``BandedBlocks`` /
    ``BucketedELL``) that ``spec`` names, in ``dtype``, on the host."""
    from .io import generate as gen
    from .io.mtx import read_matrix_market

    if spec.startswith("synthetic:"):
        name = spec.split(":", 1)[1]
        factories = {
            "cop20k": lambda: gen.cop20k_like(),
            "cop20k_small": lambda: gen.cop20k_like(scale=0.1),
            "cage4": lambda: gen.cage4_like(),
            "random": lambda: gen.random_csr(100_000, 100_000, 2_000_000),
            "powerlaw": lambda: gen.powerlaw_csr(100_000, 100_000, 2_000_000),
            "banded": lambda: gen.banded_csr(100_000, 100, 20),
            "roadnet": lambda: gen.roadnet_like(),
            "roadnet_small": lambda: gen.roadnet_like(scale=0.1),
            "dc1": lambda: gen.dc1_like(),
            "dc1_small": lambda: gen.dc1_like(scale=0.1),
        }
        if name not in factories:
            raise ValueError(f"unknown synthetic matrix {name!r}; "
                             f"options: {sorted(factories)}")
        csr = factories[name]()
    elif spec.endswith(".npz"):
        from .formats.banded import BandedBlocks
        from .formats.matrix import CSR, BucketedELL
        from .formats.serialize import load_format

        obj = load_format(spec)
        if isinstance(obj, (BandedBlocks, BucketedELL)):
            # Prepared compute formats run through spmm_any directly.
            return obj.astype(_torch_dtype(dtype))
        if not isinstance(obj, CSR):
            raise ValueError(
                f"{spec} holds a {type(obj).__name__}; supported for run: "
                "CSR, BucketedELL, BandedBlocks")
        csr = obj
    else:
        csr = read_matrix_market(spec)
    return csr.astype(_torch_dtype(dtype))


def _strategies(arg: str):
    if arg == "all":
        # The reference's four (row, column, nnz + PETSc) and this
        # framework's structure-adaptive path.
        return ["row", "column", "nnz", "library", "auto"]
    return [s.strip() for s in arg.split(",")]


def _check_device(device: str) -> None:
    """A card run needs CUDA: without it the command stops here."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError("--device cuda needs a CUDA device, and "
                         "torch.cuda.is_available() is False; pass "
                         "--device cpu to run on the CPU")


def _mesh(args):
    """The initialized process group's mesh (``--devices`` ranks of it),
    or the one-device mesh of ``--device``."""
    import torch.distributed as dist

    from .parallel.mesh import as_mesh, make_mesh

    if dist.is_initialized():
        return make_mesh(args.devices, device=args.device)
    return as_mesh(args.device)


def cmd_run(args) -> int:
    import torch.distributed as dist

    from .parallel import get_strategy

    _check_device(args.device)
    for name in _strategies(args.strategy):  # a bad name fails here
        if name != "sequential":
            get_strategy(name)
    p = args.devices
    if p is not None and p < 1:
        raise ValueError(f"--devices {p}: need at least one")
    if p is not None and p > 1 and not dist.is_initialized():
        from .parallel.launch import run_ranks

        return max(run_ranks(_run_on_mesh, p, args, device=args.device))
    return _run_on_mesh(_mesh(args), args)


def _run_on_mesh(mesh, args) -> int:
    """``run`` on ``mesh`` (every rank of it runs this; rank 0 prints and
    writes the files)."""
    from .bench.harness import run_benchmark, write_csv
    from .formats.banded import BandedBlocks
    from .formats.matrix import BucketedELL, array_dtype, cast, to_tensor
    from .io.generate import generate_fat_vector
    from .parallel import Sequential, get_strategy
    from .utils.compare import default_tolerance
    from .utils.timing import PhaseTimer, time_fn

    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    timer = PhaseTimer()
    with timer.phase("load"):
        csr = _load_matrix(args.matrix, args.dtype)
    load_time = timer.total("load")
    if isinstance(csr, (BandedBlocks, BucketedELL)):
        return _run_prepared(args, csr, mesh, load_time, say)
    m, n = csr.shape

    # Header block: reference main.cpp:55-64 phrase contracts.
    say(f"World size: {mesh.size}")
    say(f"Sparse matrix: {args.matrix}")
    say(f"Matrix size: {m}x{n}")
    say(f"Vector size: {n}x{args.k}")
    say(f"Non-zero elements: {csr.nnz}")
    say(f"Load time: {load_time:.6f} s")

    dtype = array_dtype(csr.values)
    v = to_tensor(cast(generate_fat_vector(n, args.k, seed=args.seed),
                       dtype), mesh.device)

    # Sequential baseline (main.cpp:74-93).
    seq = Sequential()
    seq_op = seq.prepare(csr, mesh)
    seq_time, seq_out = time_fn(lambda: seq.spmm(seq_op, v), mesh.device,
                                warmup=args.warmup, iters=args.iters)
    oracle = seq_out.detach().cpu().double().numpy()
    say(f"Serial Algo Execution time: {seq_time:.6f} s")

    records = []
    failures = 0
    for name in _strategies(args.strategy):
        if name == "sequential":
            continue
        strategy = get_strategy(name)
        rec = run_benchmark(
            csr, args.k, strategy, mesh, matrix_name=args.matrix,
            seed=args.seed, warmup=args.warmup, iters=args.iters,
            oracle=None if args.no_check else oracle,
            check=not args.no_check, gather_result=not args.no_gather,
            amortized=args.amortized)
        records.append(rec)
        label = STRATEGY_LABELS.get(strategy.name, strategy.name)
        # Reference phrase contracts: main.cpp:168,186,191 etc.
        if rec.execution_time == rec.execution_time:
            say(f"{label} Execution time: {rec.execution_time:.6f} s "
                f"({rec.gnnz_per_s:.3f} Gnnz/s, {rec.gflops:.3f} GFLOP/s, "
                f"{(rec.roofline_fraction or 0) * 100:.1f}% of roofline)")
        else:
            # Below timing resolution: the bound, never a rate.
            bound = rec.time_upper_bound
            say(f"{label} Execution time: < {bound:.6f} s "
                "(below timing resolution; no throughput claimed)"
                if bound else
                f"{label} Execution time: measurement failed")
        if rec.correct is not None:
            if rec.correct:
                say(f"{label}: Results are the same!")
            else:
                say(f"{label}: Results are different! "
                    f"(max error {rec.max_error:.3e}, tolerance "
                    f"{default_tolerance(dtype):.1e})")
                failures += 1

    if lead and args.json_path:
        payload = {
            "matrix": args.matrix, "m": m, "n": n, "nnz": csr.nnz,
            "k": args.k, "devices": mesh.size, "serial_time": seq_time,
            "records": [r.to_dict() for r in records],
        }
        if args.json_path == "-":
            print(json.dumps(payload))
        else:
            with open(args.json_path, "w") as f:
                json.dump(payload, f, indent=2)
    if lead and args.csv_path:
        write_csv(args.csv_path, records)
    return 1 if failures else 0


def _run_prepared(args, operand, mesh, load_time, say) -> int:
    """Time a prepared compute format (from ``convert``) through
    ``spmm_any`` on the mesh's device; with no CSR there is no oracle."""
    from .formats.banded import BandedBlocks
    from .formats.matrix import array_dtype, cast, to_tensor
    from .io.generate import generate_fat_vector
    from .ops.auto import spmm_any
    from .utils.timing import measure_amortized, time_fn

    m, n = operand.shape
    say(f"World size: {mesh.size}")
    say(f"Sparse matrix: {args.matrix} [{type(operand).__name__}]")
    say(f"Matrix size: {m}x{n}")
    say(f"Vector size: {n}x{args.k}")
    say(f"Load time: {load_time:.6f} s")

    dtype = array_dtype(operand.band if isinstance(operand, BandedBlocks)
                        else operand.buckets[0].vals)
    device = mesh.device
    v = to_tensor(cast(generate_fat_vector(n, args.k, seed=args.seed),
                       dtype), device)
    operand = operand.to(device)
    if args.amortized:
        timing, _ = measure_amortized(
            lambda vv, op: spmm_any(op, vv), v, operand,
            warmup=args.warmup, iters=args.iters)
        best = timing.seconds_per_iter
        if best != best:  # below resolution
            say(f"Auto Execution time: < {timing.upper_bound:.6f} s "
                "(below timing resolution)")
            return 0
    else:
        best, _ = time_fn(lambda: spmm_any(operand, v), device,
                          warmup=args.warmup, iters=args.iters)
    say(f"Auto Execution time: {best:.6f} s")
    say("(oracle comparison unavailable for prepared formats; "
        "run on the .mtx to validate)")
    return 0


def _print_progress(r) -> None:
    verdict = {True: "ok", False: "MISMATCH", None: ""}[r.correct]
    print(f"{r.matrix} k={r.k} p={r.devices} {r.strategy}: "
          f"{r.execution_time:.6f}s {verdict}")


def cmd_sweep(args) -> int:
    import torch

    from .bench.harness import sweep, write_json

    _check_device(args.device)
    if args.plots_dir:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ValueError(f"--plots needs matplotlib: {e}") from None
    matrices = {
        spec: _load_matrix(spec, args.dtype) for spec in args.matrices
    }
    device_counts = args.devices or [
        torch.cuda.device_count() if args.device == "cuda" else 1]
    records = sweep(
        matrices, args.k, args.strategy, device_counts,
        device=args.device, iters=args.iters, amortized=args.amortized,
        comm_split=args.comm_split,
        job_timeout=args.job_timeout or None,
        resume_from=args.csv_path if args.resume else None,
        checkpoint_csv=args.csv_path,
        progress=_print_progress,
    )
    if args.csv_path:
        print(f"wrote {args.csv_path}")
    if args.json_path:
        write_json(args.json_path, records)
        print(f"wrote {args.json_path}")
    if args.plots_dir:
        from .bench.plots import render_all

        paths = render_all(records, args.plots_dir)
        print(f"wrote {len(paths)} figures to {args.plots_dir}")
    return 0


def cmd_convert(args) -> int:
    from .formats.serialize import save_format
    from .utils.timing import PhaseTimer

    csr = _load_matrix(args.input, args.dtype)
    if args.rcm:
        from .formats.reorder import (
            apply_symmetric_permutation, bandwidth, rcm_ordering,
        )

        bw0 = bandwidth(csr)
        csr = apply_symmetric_permutation(csr, rcm_ordering(csr))
        print(f"RCM: bandwidth {bw0} -> {bandwidth(csr)}")
    timer = PhaseTimer()
    with timer.phase("build"):
        obj = _build_format(args.format, csr, args.block_rows)
    save_format(args.output, obj)
    print(f"{args.input} -> {args.output} "
          f"[{type(obj).__name__}, built in {timer.total('build'):.2f} s]")
    return 0


def _build_format(fmt: str, csr, block_rows):
    """The prepared compute format ``convert`` saves."""
    if fmt == "csr":
        obj = csr
    elif fmt == "coo":
        obj = csr.to_coo()
    elif fmt == "bucketed":
        from .formats.matrix import BucketedELL

        obj = BucketedELL.from_csr(csr)
    elif fmt == "banded":
        from .formats.banded import BandedBlocks

        obj = BandedBlocks.from_csr(csr, block_rows=block_rows)
        if obj is None:
            raise ValueError(
                "matrix has no profitable band structure; use "
                "--format bucketed (or --rcm to reorder first)")
    else:
        from .formats.windowed import WindowedPairs
        from .ops.auto import auto_format

        obj = auto_format(csr)
        if isinstance(obj, WindowedPairs):
            raise ValueError(
                "auto picked WindowedPairs, which has no saved format; use "
                "--format banded, bucketed, csr or coo")
    return obj


def cmd_reorder(args) -> int:
    from .formats.reorder import (
        apply_symmetric_permutation, bandwidth, rcm_ordering,
    )
    from .io.mtx import write_matrix_market

    csr = _load_matrix(args.input, "float64")
    bw0 = bandwidth(csr)
    csr = apply_symmetric_permutation(csr, rcm_ordering(csr))
    write_matrix_market(args.output, csr, comment="RCM-reordered")
    print(f"bandwidth {bw0} -> {bandwidth(csr)}; wrote {args.output}")
    return 0


def cmd_info(args) -> int:
    import torch
    import torch.distributed as dist

    n = torch.cuda.device_count()
    print(f"devices: {n}")
    for i in range(n):
        print(f"  [cuda:{i}] {torch.cuda.get_device_name(i)}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if dist.is_initialized():
        print(f"process group: {dist.get_backend()}, rank "
              f"{dist.get_rank()} of {dist.get_world_size()}")
    else:
        print("process group: none")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.command == "run":
            return cmd_run(args)
        if args.command == "sweep":
            return cmd_sweep(args)
        if args.command == "info":
            return cmd_info(args)
        if args.command == "convert":
            return cmd_convert(args)
        if args.command == "reorder":
            return cmd_reorder(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"spmm: error: {e}", file=sys.stderr)
        return 1
    return 2


if __name__ == "__main__":
    sys.exit(main())

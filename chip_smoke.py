#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the headline benchmark of the JAX package (``bench.py``)
run through the port: the cop20k_A stand-in (121,192^2, ~2.62 M nnz,
f32), a fat vector of k = 32, ``Auto().prepare`` (format search ->
``WindowedPairs`` with transposed bf16 hi|lo planes), and the
transposed-state chain (enc: permute, pad, kernel B2; body: kernel B1
with the fused next-state epilogue; dec). Phases:

1. build the kernels from ``csrc/`` with ``nvcc`` (``-Xptxas -v`` report);
2. build the operand and print its route;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (B2 bitwise; B1 fused and unfused
   within ``1e-5 * cond + 1e-6``, ``cond`` = plain B1 on the planes'
   absolute values, the fused state bitwise equal to the split of the
   unfused sum; plus B1 on a block-spanning small operand), and
   their times over many launches after warm-up;
4. main path: launch counts zeroed, a one-shot ``spmm_any`` and the
   amortized ``run_benchmark(inner=20)``, both checked against the host
   float64 oracle; the counts must show B2 and one B1 per body call.

Prints the card's name and power limit, one JSON line with the main
path's result, one with the kernels, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line,
when any phase fails or no CUDA device is present. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SRC = "sparsematrixmultiplicationmpi_tpu_torch/csrc/windowed_kernels.cu"
REPLACES = {
    "B1": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:206",
    "B2": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:122",
}
K = 32
B1_RTOL, B1_ATOL = 1e-5, 1e-6


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back launches,
    CUDA events on the current stream, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def b1_error(got, want, cond) -> float:
    """Largest excess of |got - want| over the B1 tolerance (<= 0 is
    inside), and the max abs error, both in f32."""
    diff = (got - want).abs()
    return float((diff - (B1_RTOL * cond + B1_ATOL)).max()), \
        float(diff.max())


def hi_plus_lo(state):
    import torch

    w = state.shape[-1] // 2
    return state[..., :w].to(torch.float32) + state[..., w:].to(torch.float32)


def kernel_phase(wp, v):
    """B2 and B1 against their plain versions at the operand's shapes."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw

    out = {}
    C, nb, U = wp.chunk_cols, wp.n_blocks, wp.pairs_per_step
    v_p = wp.encode(v).contiguous()

    slabs = cw.chunk_slabs(v_p, C=C, split=True)
    slabs_p = cw.chunk_slabs_plain(v_p, C=C, split=True)
    torch.cuda.synchronize()
    check(slabs.shape == slabs_p.shape, "B2 shape differs from plain")
    same = torch.equal(slabs.view(torch.int16), slabs_p.view(torch.int16))
    err = float((slabs.float() - slabs_p.float()).abs().max())
    print(f"B2 chunk_slabs {tuple(v_p.shape)} -> {tuple(slabs.shape)} "
          f"bitwise_equal={same} max_abs_err={err}")
    check(same, "B2 is not bitwise equal to its plain version")
    out["B2"] = {"max_abs_err": err,
                 "ms": cuda_ms(lambda: cw.chunk_slabs(v_p, C=C, split=True),
                               200),
                 "plain_ms": cuda_ms(lambda: cw.chunk_slabs_plain(
                     v_p, C=C, split=True), 50)}

    args = (wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs)
    kw = dict(nb=nb, pairs_per_step=U, split=True)
    plain_args = (wp.pair_block, wp.pair_chunk, wp.tiles_t, slabs)
    plain_kw = dict(nb=nb, split=True)
    got = cw.windowed_matmul_tmulti(*args, **kw)
    want = cw.windowed_matmul_tmulti_plain(*plain_args, **plain_kw)
    cond = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t.abs(), slabs.abs(),
        **plain_kw)
    excess, err_unfused = b1_error(got, want, cond)
    print(f"B1 unfused {tuple(got.shape)} max_abs_err={err_unfused} "
          f"tolerance_excess={excess}")
    check(excess <= 0, "B1 (unfused) outside tolerance of its plain version")
    fused = cw.windowed_matmul_tmulti(*args, fuse_resplit=True, **kw)
    same = torch.equal(fused.view(torch.int16),
                       cw.resplit_slabs(got).view(torch.int16))
    print(f"B1 fused {tuple(fused.shape)} bitwise equal to the resplit of "
          f"its unfused sum: {same}")
    check(same, "B1 fused epilogue differs from resplit(unfused)")
    fused_p = cw.windowed_matmul_tmulti_plain(*plain_args, fuse_resplit=True,
                                              **plain_kw)
    # Each side's hi + lo is its f32 sum to within 2**-17 relative, so two
    # sums a hair apart may round to states 2**-16 relative apart.
    excess, err_fused = b1_error(hi_plus_lo(fused), hi_plus_lo(fused_p),
                                 cond + want.abs() * (2.0 ** -16 / B1_RTOL))
    print(f"B1 fused (hi + lo) vs plain max_abs_err={err_fused} "
          f"tolerance_excess={excess}")
    check(excess <= 0, "B1 (fused) outside tolerance of its plain version")
    del want, cond, fused_p
    out["B1"] = {
        "max_abs_err": max(err_unfused, err_fused),
        "ms": cuda_ms(lambda: cw.windowed_matmul_tmulti(
            *args, fuse_resplit=True, **kw), 50),
        "plain_ms": cuda_ms(lambda: cw.windowed_matmul_tmulti_plain(
            *plain_args, fuse_resplit=True, **plain_kw), 5, warmup=1),
        "unfused_ms": cuda_ms(lambda: cw.windowed_matmul_tmulti(*args, **kw),
                              50),
    }
    return out


def spans_blocks_case(dev):
    """B1 on the block-spanning operand of tests/test_tmulti.py
    (R = 8, U = 8, odd pair runs), against its plain version and the
    host oracle."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        fem3d_csr, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_windowed as cw
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_host_f64,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import _finish

    csr = fem3d_csr(512, 8192, seed=2).astype(np.float32)
    wp = WindowedPairs.from_csr(csr, block_rows=8, chunk_cols=128,
                                reorder=None, pairs_per_step=8,
                                beat_gather_margin=1e9, max_inflation=1e9)
    check(bool((np.diff(wp.block_ptr) % 8 != 0).any()),
          "spans-blocks operand has no block run that spans a step")
    wp = wp.to(dev)
    v_host = generate_fat_vector(csr.shape[1], 16, seed=3).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v_host).to(dev)).contiguous()
    slabs = cw.chunk_slabs(v_p, C=128, split=True)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=wp.n_blocks, pairs_per_step=8, split=True)
    want = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t, slabs, nb=wp.n_blocks)
    cond = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, wp.tiles_t.abs(), slabs.abs(),
        nb=wp.n_blocks)
    excess, err = b1_error(got, want, cond)
    computed = got.transpose(1, 2).reshape(wp.n_blocks * 8, 16)
    rows = wp.decode(_finish(wp, computed, v_p))
    ref = spmm_host_f64(csr, v_host)
    rel = float(np.abs(rows.cpu().double().numpy() - ref).max()
                / np.abs(ref).max())
    print(f"B1 spans-blocks R=8 U=8 pairs={wp.n_pairs} max_abs_err={err} "
          f"tolerance_excess={excess} rel_err_vs_f64_oracle={rel}")
    check(excess <= 0, "B1 spans-blocks outside tolerance of plain")
    check(rel < 5e-3, "B1 spans-blocks disagrees with the f64 oracle")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
            run_benchmark,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
            WindowedPairs,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
            cop20k_like, generate_fat_vector,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.ops import (
            _kernel_lib, cuda_windowed as cw,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any
        from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
            spmm_host_f64,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto
        from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
            are_matrices_equal, default_tolerance, max_abs_error,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise PhaseFailed("the port imported jax")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    power = smi.stdout.strip()
    print(power)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    _kernel_lib.load_library()
    info = _kernel_lib.build_info
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    print(info["ptxas"])

    # 2. operand
    t0 = time.perf_counter()
    csr = cop20k_like(dtype=np.float32)
    t1 = time.perf_counter()
    wp = Auto().prepare(csr, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(isinstance(wp, WindowedPairs),
          f"route is {type(wp).__name__}, not WindowedPairs")
    route = dict(type=type(wp).__name__, R=wp.block_rows, C=wp.chunk_cols,
                 U=wp.pairs_per_step, P=wp.n_pairs, nb=wp.n_blocks,
                 pad_rows=wp.pad_rows, spill=wp.spill is not None,
                 supports_transposed_chain=wp.supports_transposed_chain)
    print(f"matrix: m={csr.shape[0]} nnz={csr.nnz} generated in "
          f"{t1 - t0:.2f} s; prepare {t2 - t1:.2f} s; route {route}")
    check(wp.block_rows == wp.chunk_cols == 128 and wp.pairs_per_step == 16
          and wp.spill is None and wp.supports_transposed_chain,
          f"unexpected route {route}")
    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    v = torch.from_numpy(v_host).to(dev)

    # 3. kernels against their plain versions
    timings = kernel_phase(wp, v)
    spans_blocks_case(dev)

    # 4. main path, counted
    oracle = spmm_host_f64(csr, v_host)
    abs_csr = type(csr)(values=np.abs(csr.values),
                        col_indices=csr.col_indices, row_ptr=csr.row_ptr,
                        shape=csr.shape)
    cond = spmm_host_f64(abs_csr, np.abs(v_host))
    tol = default_tolerance(np.dtype(np.float32))
    body_calls = [0]

    class CountedAuto(Auto):
        def chain_parts(self, operand):
            enc, body, dec = super().chain_parts(operand)

            def counted_body(x, op):
                body_calls[0] += 1
                return body(x, op)

            return enc, counted_body, dec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    one_shot = spmm_any(wp, v).cpu().double().numpy()
    one_shot_ok = are_matrices_equal(one_shot, oracle, tolerance=tol,
                                     relative=True, condition_scale=cond)
    del wp
    rec = run_benchmark(csr, K, CountedAuto(), dev,
                        matrix_name="cop20k_like", warmup=2, iters=5,
                        oracle=oracle, check=True, dtype=np.float32,
                        amortized=True, inner=20)
    torch.cuda.synchronize()
    counts = cw.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"one-shot spmm_any: correct={one_shot_ok} "
          f"max_abs_err={max_abs_error(one_shot, oracle)}")
    print(f"launch counts {counts}; chain body calls {body_calls[0]}")
    result = {
        "metric": "spmm_gnnz_per_s_cop20k_k32",
        "value": rec.gnnz_per_s, "unit": "Gnnz/s",
        "execution_time_s": rec.execution_time,
        "time_upper_bound_s": rec.time_upper_bound,
        "gflops": rec.gflops, "roofline_fraction": rec.roofline_fraction,
        "correct": rec.correct, "one_shot_correct": one_shot_ok,
        "max_error": rec.max_error, "prepare_time_s": rec.prepare_time,
        "device_kind": rec.device_kind, "power": power,
        "nnz": rec.nnz, "k": rec.k, "dtype": rec.dtype,
        "launches": counts, "max_memory_allocated": peak,
    }
    print(json.dumps(result))
    check(one_shot_ok, "one-shot spmm_any disagrees with the f64 oracle")
    check(rec.correct is True, "amortized main path disagrees with oracle")
    check(rec.execution_time == rec.execution_time,
          "chained iterate time did not resolve")
    check(counts["B1"] == 1 + body_calls[0] and body_calls[0] > 0,
          f"B1 launches {counts['B1']} != 1 one-shot + {body_calls[0]} "
          "chain bodies")
    check(counts["B2"] == 2, f"B2 launches {counts['B2']} != 2 "
          "(one-shot relayout + chain encode)")

    kernels = [
        {"name": f"{name} {label}", "route": "cuda", "source": SRC,
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": timings[name]["max_abs_err"],
         "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"]}
        for name, label in (("B1", "windowed_matmul_tmulti"),
                            ("B2", "chunk_slabs"))]
    print(f"B1 unfused ms {timings['B1']['unfused_ms']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

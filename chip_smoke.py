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
   float64 oracle; the counts must show B2 and one B1 per body call;
5. solver path: the JAX package's model-benchmark CG system
   (``spd_banded_system(121,192)``, f32, 8 right-hand sides) through
   ``Auto(k_nominal=8)`` -> ``BandedBlocks`` (r = 128, no spill, 947
   blocks) -> kernel B5. B5 against its plain version at k = 1, 8, 32
   and on a spill operand (``1e-5 * cond + 1e-6``), a one-shot
   ``spmm_any`` against the f64 oracle, then ``conjugate_gradient(tol=
   1e-5)`` with the counts zeroed: B5 launches = iterations + 1, true
   residual <= 1e-4, ``x`` within 5e-3 of a host f64 ``spsolve``, the
   iteration count within 1 of CG through the plain route; the
   per-iteration time from fixed-length solves and the amortized
   ``run_benchmark`` rate.

Prints the card's name and power limit, one JSON line with the main
path's result, one with the solver path's, one with the kernels, and as
the last line
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
B5_SRC = "sparsematrixmultiplicationmpi_tpu_torch/csrc/banded_kernels.cu"
B5_REPLACES = "sparsematrixmultiplicationmpi_tpu/ops/pallas_banded.py:31"
M_SPD, K_CG = 121_192, 8
#: Fixed-length CG solves for the per-iteration slope. Past ~20
#: iterations the recursive residual of this well-conditioned system
#: underflows to zero in f32 and a tol = 0 solve stops, so both lengths
#: stay below that.
CG_SHORT, CG_LONG = 4, 16


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


def band_spill_case(dev):
    """B5 on the spill operand of tests/test_pallas.py (block_rows = 8):
    the band part against its plain version, the whole SpMM (B5 + spill)
    against the host oracle. Returns the max abs error."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
        BandedBlocks,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import COO
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        banded_csr, generate_fat_vector, random_csr,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_banded as cb
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_host_f64,
    )

    dense = (banded_csr(200, 4, 3, seed=133).to_dense()
             + random_csr(200, 200, 250, seed=134).to_dense())
    rows, cols = np.nonzero(dense)
    csr = COO.from_arrays(dense[rows, cols], rows, cols,
                          dense.shape).to_csr().astype(np.float32)
    bb = BandedBlocks.from_csr(csr, block_rows=8)
    check(bb.spill is not None, "spill case has no spill")
    bb = bb.to(dev)
    v_host = generate_fat_vector(200, 5, seed=135).astype(np.float32)
    v = torch.from_numpy(v_host).to(dev)
    got = cb.band_matmul(bb.band, v, m=200)
    want = cb.band_matmul_plain(bb.band, v, m=200)
    cond = cb.band_matmul_plain(bb.band.abs(), v.abs(), m=200)
    excess, err = b1_error(got, want, cond)
    ref = spmm_host_f64(csr, v_host)
    out = cb.spmm_banded_cuda(bb, v).cpu().double().numpy()
    rel = float(np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1)))
    print(f"B5 spill case r=8 k=5 max_abs_err={err} tolerance_excess="
          f"{excess} rel_err_vs_f64_oracle={rel}")
    check(excess <= 0, "B5 spill case outside tolerance of plain")
    check(rel < 1e-4, "B5 + spill disagrees with the f64 oracle")
    return err


def spsolve_f64(csr, b):
    """Host float64 direct solve of ``csr x = b`` (duplicates summed)."""
    import scipy.sparse
    import scipy.sparse.linalg

    a = scipy.sparse.csr_matrix(
        (csr.values.astype(np.float64), csr.col_indices, csr.row_ptr),
        shape=csr.shape).tocsc()
    a.sum_duplicates()
    return scipy.sparse.linalg.spsolve(a, b, permc_spec="NATURAL")


def solver_phase(dev, power):
    """Phase 5: the CG solve of the JAX package's model benchmark on the
    port's band route. Returns the B5 entry of the kernels line."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        run_benchmark,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        spd_banded_system,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
        BandedBlocks,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        conjugate_gradient,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import cuda_banded as cb
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any
    from sparsematrixmultiplicationmpi_tpu_torch.ops.banded import (
        spmm_banded,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_host_f64,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto
    from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
        are_matrices_equal, default_tolerance, max_abs_error,
    )

    # 5.1 build and route
    t0 = time.perf_counter()
    spd = spd_banded_system(M_SPD, seed=2)
    t1 = time.perf_counter()
    op = Auto(k_nominal=K_CG).prepare(spd, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    route = dict(type=type(op).__name__,
                 block_rows=getattr(op, "block_rows", None),
                 spill=getattr(op, "spill", None) is not None,
                 band=tuple(getattr(op, "band", torch.empty(0)).shape))
    print(f"spd system: m={spd.shape[0]} nnz={spd.nnz} generated in "
          f"{t1 - t0:.2f} s; prepare {t2 - t1:.2f} s; route {route}")
    check(isinstance(op, BandedBlocks) and op.block_rows == 128
          and op.spill is None and route["band"] == (947, 128, 384),
          f"unexpected solver route {route}")
    m = spd.shape[0]

    # 5.2 B5 against its plain version
    errs, ms = [], {}
    for k in (1, K_CG, 32):
        v = torch.from_numpy(generate_fat_vector(m, k, seed=k).astype(
            np.float32)).to(dev)
        got = cb.band_matmul(op.band, v, m=m)
        want = cb.band_matmul_plain(op.band, v, m=m)
        cond = cb.band_matmul_plain(op.band.abs(), v.abs(), m=m)
        excess, err = b1_error(got, want, cond)
        print(f"B5 band_matmul band {tuple(op.band.shape)} k={k} "
              f"max_abs_err={err} tolerance_excess={excess}")
        check(excess <= 0, f"B5 outside tolerance of its plain version, "
              f"k={k}")
        errs.append(err)
        if k == K_CG:
            ms = {"ms": cuda_ms(lambda: cb.band_matmul(op.band, v, m=m), 200),
                  "plain_ms": cuda_ms(lambda: cb.band_matmul_plain(
                      op.band, v, m=m), 50)}
        del got, want, cond
    errs.append(band_spill_case(dev))
    band_bytes = op.band.numel() * op.band.element_size()
    print(f"B5 k={K_CG}: {ms['ms']} ms ({band_bytes / ms['ms'] / 1e9:.3f} "
          f"TB/s of band), plain {ms['plain_ms']} ms")

    # 5.3 one-shot spmm_any against the f64 oracle
    v_host = generate_fat_vector(m, K_CG, seed=0).astype(np.float32)
    one = spmm_any(op, torch.from_numpy(v_host).to(dev)).cpu().double()
    oracle = spmm_host_f64(spd, v_host)
    abs_spd = type(spd)(values=np.abs(spd.values),
                        col_indices=spd.col_indices, row_ptr=spd.row_ptr,
                        shape=spd.shape)
    one_ok = are_matrices_equal(
        one.numpy(), oracle,
        tolerance=default_tolerance(np.dtype(np.float32)),
        relative=True, condition_scale=spmm_host_f64(abs_spd,
                                                     np.abs(v_host)))
    print(f"solver one-shot spmm_any: correct={one_ok} "
          f"max_abs_err={max_abs_error(one.numpy(), oracle)}")
    check(one_ok, "solver one-shot spmm_any disagrees with the f64 oracle")

    # 5.4 CG as the JAX package's model benchmark runs it, counted
    b_host = np.random.default_rng(3).normal(size=(m, K_CG)).astype(
        np.float32)
    b = torch.from_numpy(b_host).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res = conjugate_gradient(lambda x: spmm_any(op, x), b, tol=1e-5,
                             max_iter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = cb.launch_counts()["B5"]
    peak = torch.cuda.max_memory_allocated()
    x = res.x.cpu().double().numpy()
    resid = b_host - spmm_host_f64(spd, x)
    true_rel = float((np.linalg.norm(resid, axis=0)
                      / np.linalg.norm(b_host, axis=0)).max())
    x_ref = spsolve_f64(spd, b_host.astype(np.float64))
    x_err = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
    plain = conjugate_gradient(lambda x: spmm_banded(op, x), b, tol=1e-5,
                               max_iter=200)
    print(f"CG: {res.iterations} iterations in {solve_s * 1e3:.3f} ms, "
          f"B5 launches {launches}, true relative residual {true_rel}, "
          f"x vs f64 spsolve {x_err}; plain route {plain.iterations} "
          "iterations")
    correct = (launches == res.iterations + 1 and true_rel <= 1e-4
               and x_err <= 5e-3 and abs(plain.iterations - res.iterations)
               <= 1 and bool(torch.isfinite(res.x).all()))

    # 5.5 per-iteration time: two-point slope of fixed-length solves
    def timed_solve(n_iter):
        best = float("inf")
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = conjugate_gradient(lambda x: spmm_any(op, x), b, tol=0.0,
                                   max_iter=n_iter)
            end.record()
            end.synchronize()
            check(r.iterations == n_iter, f"fixed-length CG stopped at "
                  f"{r.iterations} of {n_iter} iterations")
            best = min(best, start.elapsed_time(end))
        return best

    t_short, t_long = timed_solve(CG_SHORT), timed_solve(CG_LONG)
    ms_per_iter = (t_long - t_short) / (CG_LONG - CG_SHORT)
    flag = torch.zeros(K_CG, device=dev)
    sync_ms = cuda_ms(lambda: bool((flag > 0).any()), 200)
    print(f"CG fixed-length solves: {CG_SHORT} its {t_short} ms, "
          f"{CG_LONG} its {t_long} ms -> {ms_per_iter} ms per iteration; "
          f"B5 {ms['ms']} ms = {ms['ms'] / ms_per_iter:.3f} of it; one "
          f"convergence test (.item() round trip, empty queue) {sync_ms} ms")
    del op
    rec = run_benchmark(spd, K_CG, Auto(k_nominal=K_CG), dev,
                        matrix_name="spd_banded_121k", warmup=2, iters=5,
                        oracle=oracle, check=True, dtype=np.float32,
                        amortized=True, inner=20)
    print(f"run_benchmark amortized band SpMM: {rec.gnnz_per_s} Gnnz/s, "
          f"{rec.execution_time * 1e3} ms per multiply, correct="
          f"{rec.correct}")
    print(json.dumps({
        "path": "cg_spd121k_k8", "iterations": res.iterations,
        "true_rel_residual": true_rel, "x_rel_err_vs_spsolve": x_err,
        "plain_route_iterations": plain.iterations,
        "ms_per_cg_iteration": ms_per_iter, "b5_ms": ms["ms"],
        "sync_ms": sync_ms, "gnnz_per_s": rec.gnnz_per_s,
        "spmm_correct": rec.correct, "correct": correct,
        "b5_launches": launches, "max_memory_allocated": peak,
        "power": power}))
    check(correct, "CG on the band route failed its checks")
    check(rec.correct is True, "amortized band SpMM disagrees with oracle")
    check(ms_per_iter > 0, "CG per-iteration slope did not resolve")
    return {"name": "B5 band_matmul", "route": "cuda", "source": B5_SRC,
            "replaces": B5_REPLACES, "launches": launches,
            "max_abs_err": max(errs), "ms": ms["ms"],
            "plain_ms": ms["plain_ms"]}


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

    # 5. solver path
    kernels.append(solver_phase(dev, power))
    if "jax" in sys.modules:
        raise PhaseFailed("the port imported jax")
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

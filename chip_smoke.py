#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the headline benchmark of the JAX package (``bench.py``)
run through the port: the cop20k_A stand-in (121,192^2, ~2.62 M nnz,
f32), a fat vector of k = 32, ``Auto().prepare`` (format search ->
``WindowedPairs`` with transposed bf16 hi|lo planes, kept on the card as
their compact nonzero plane ``CompactTiles``), and the transposed-state
chain (enc: permute, pad, kernel B2; body: kernel B1 with the fused
next-state epilogue; dec). Phases:

1. build the kernels from ``csrc/`` with ``nvcc`` (``-Xptxas -v`` report);
2. build the operand (``auto_format`` on the host, then ``to(cuda)``,
   which builds the compact plane; that build is also timed alone) and
   print its route and the plane's bytes;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (B2 bitwise; B1 fused and unfused
   within ``1e-5 * cond + 1e-6``, ``cond`` = plain B1 on the planes'
   absolute values, the plain version on the dense planes rebuilt from
   the compact one, the fused state bitwise equal to the split of the
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
   ``run_benchmark`` rate;
6. two-pair path: ``Auto(pairs_per_step=2)`` on the cop20k stand-in
   (route R = C = 256, U = 2, 2,270 pairs, 474 blocks, a spill), its
   card copy checked to hold the natural compact plane of
   ``tiles_split``, equal bit for bit to the host's dense plane, and no
   dense natural plane (the plane's entries and bytes and the
   ``to(cuda)`` that builds it timed). B3 (split3, on that plane) and B4
   (f32, one dense plane; on the build's tiles and on full-mantissa
   ones) against their plain versions at k = 32 (on the host's dense
   planes), B7 (one launch over every spill
   bucket, and each bucket alone) against the take route, all within
   ``1e-5 * cond + 1e-6``; then, with the counts zeroed, a one-shot
   ``spmm_any`` with the spill through the take route, one with the
   spill through B7 (``SPILL_DMA_GATHER``, one B7 launch), and the
   amortized ``run_benchmark`` (encode, iterate = B2 + B3 + spill,
   decode), each against the f64 oracle, and the path's peak device
   memory. The same in bf16 (route R = C = 512, 1,098 pairs, a spill;
   the card copy holds the natural compact plane of ``tiles``): B4
   (bf16, on that plane) against its plain version, one-shot and
   amortized ``run_benchmark(dtype=bfloat16)`` in the bf16 tier. Last,
   the dense natural kernel that B3 and B4 bf16 run for chunks wider
   than the compact kernel stages: the U=2 build with ``chunk_cols``
   pinned to 1024, f32 and bf16, whose card copies keep their dense
   planes; B3 and B4 bf16 on them against their plain versions within
   ``1e-5 * cond + 1e-6``;
7. phased chain: ``Auto(phase_layout=True)`` (three phases, 448 chunks
   per phase). B6 resident and streamed (B1 per phase) against the plain
   version and each other; with the counts zeroed, a one-shot
   ``spmm_any`` and the amortized ``run_benchmark`` (body = B6 +
   ``resplit_slabs``), against the f64 oracle; one B6 launch per call.

Beside each kernel the phases time its library yardstick (``library_ms``:
``torch.sparse.mm`` on a CSR of the entries the kernel multiplies, built
on the card outside the timing; none for B2's split mode) and compute
its bound (``bound_ms``: the larger of its bytes over the H100 SXM's
3.35 TB/s and its operations over the peak for their type). B1, B3, B4
bf16 and B6 read a compact plane, so their bound counts its bytes and
the f32 FMAs per entry and column of k that they run (two with split
planes, one without); ``dense_bound_ms`` beside it is the bound of the
dense tiles the kernels read before.

Prints the card's name and power limit, one JSON line with the main
path's result, one with the solver path's, one for each of phases 6 and
7, one with the kernels, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line,
when any phase fails or no CUDA device is present. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SRC = "sparsematrixmultiplicationmpi_tpu_torch/csrc/windowed_kernels.cu"
REPLACES = {
    "B1": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:206",
    "B2": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:124",
    "B3": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:95",
    "B4": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:81",
    "B6": "sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py:421",
}
B7_SRC = "sparsematrixmultiplicationmpi_tpu_torch/csrc/gather_kernels.cu"
B7_REPLACES = "sparsematrixmultiplicationmpi_tpu/ops/pallas_gather.py:42"
#: The routes the JAX package's format search picks on the cop20k stand-in.
U2_F32_ROUTE = dict(R=256, C=256, U=2, P=2270, nb=474, spill=True)
U2_BF16_ROUTE = dict(R=512, C=512, U=2, P=1098)
PHASES = ((0, 5456, 0, 0, 947), (5456, 4832, 448, 409, 495),
          (10288, 480, 896, 887, 60))
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
#: The H100 SXM's published dense peaks (NVIDIA's data sheet): HBM bytes
#: per second, and FLOP/s by operand type (bf16 and TF32 on the tensor
#: cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float, kind: str) -> dict:
    """The least time the card could take for a kernel's work, in ms: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its operations over the peak for ``kind``, and
    which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sparse_csr(rows, cols, vals, shape):
    """A CSR tensor on the card (duplicates summed), the operand of the
    library call ``torch.sparse.mm`` that stands beside a kernel."""
    import torch

    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, shape)
    return coo.coalesce().to_sparse_csr()


def windowed_csr(wp, dtype=None):
    """The entries a windowed kernel multiplies, as a CSR in the
    operand's padded-permuted space: tile ``p``'s ``(r, c)`` at row
    ``block * R + r``, column ``chunk * C + c`` (hi + lo for split
    planes; a phase layout's pairs with their global ids), in the tiles'
    dtype or ``dtype``."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
        _plain_pairs,
    )

    tiles, pair_block, pair_chunk = _plain_pairs(wp)
    _, R, C = tiles.shape
    p, r, c = torch.nonzero(tiles, as_tuple=True)
    return sparse_csr(pair_block.long()[p] * R + r,
                      pair_chunk.long()[p] * C + c,
                      tiles[p, r, c].to(dtype or tiles.dtype),
                      (wp.n_blocks * R, wp.pad_rows))


def library_ms(label, a_csr, x, n=50) -> float:
    """Milliseconds of one ``torch.sparse.mm(a_csr, x)`` (cuSPARSE), the
    yardstick beside a kernel; the port never calls it."""
    import torch

    ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), n)
    print(f"{label} library call torch.sparse.mm (CSR {tuple(a_csr.shape)} "
          f"nnz={a_csr._nnz()} {a_csr.dtype}, x {tuple(x.shape)}): {ms} ms")
    return ms


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
    n_chunks, k = slabs.shape[0], v_p.shape[1]
    mode1_ms = cuda_ms(lambda: cw.chunk_slabs(v_p, C=C, split=False), 200)
    mode1_library_ms = cuda_ms(lambda: v_p.view(n_chunks, C, k).transpose(
        1, 2).contiguous(), 200)
    print(f"B2 split mode: no one-call library counterpart (a transpose "
          f"and a two-plane bf16 split); mode 1 (f32 relayout) {mode1_ms} ms"
          f", its library call view/transpose/contiguous {mode1_library_ms}"
          " ms")
    out["B2"] = {"max_abs_err": err,
                 "ms": cuda_ms(lambda: cw.chunk_slabs(v_p, C=C, split=True),
                               200),
                 "plain_ms": cuda_ms(lambda: cw.chunk_slabs_plain(
                     v_p, C=C, split=True), 50),
                 **bound(nbytes(v_p, slabs), 0, "f32"), "library_ms": None,
                 "mode1_ms": mode1_ms, "mode1_library_ms": mode1_library_ms}

    ct = wp.tiles_t  # the compact plane, all the kernel reads of the tiles
    dense = ct.to_dense()
    args = (wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs)
    kw = dict(nb=nb, pairs_per_step=U, split=True)
    plain_args = (wp.pair_block, wp.pair_chunk, dense, slabs)
    plain_kw = dict(nb=nb, split=True)
    got = cw.windowed_matmul_tmulti(*args, **kw)
    want = cw.windowed_matmul_tmulti_plain(*plain_args, **plain_kw)
    cond = cw.windowed_matmul_tmulti_plain(
        wp.pair_block, wp.pair_chunk, dense.abs(), slabs.abs(), **plain_kw)
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
    P, _, R = ct.shape
    k8 = slabs.shape[1]
    # slabs, the work list and the fused bf16 [hi | lo] state (nb, k8, 2R)
    rest = nbytes(slabs, wp.pair_chunk, wp.block_ptr) + nb * k8 * 2 * R * 2
    a_csr = windowed_csr(wp)
    out["B1"] = {
        "max_abs_err": max(err_unfused, err_fused),
        "ms": cuda_ms(lambda: cw.windowed_matmul_tmulti(
            *args, fuse_resplit=True, **kw), 200),
        "plain_ms": cuda_ms(lambda: cw.windowed_matmul_tmulti_plain(
            *plain_args, fuse_resplit=True, **plain_kw), 5, warmup=1),
        # the compact plane and the rest; two f32 FMAs per entry and k
        **bound(ct.nbytes + rest, 2 * 2 * ct.nnz * k8, "f32"),
        # the dense tiles and the rest; three bf16 products per tile
        "dense_bound_ms": bound(nbytes(dense) + rest,
                                3 * 2 * P * C * R * k8, "bf16")["bound_ms"],
        "library_ms": library_ms("B1", a_csr, v_p),
        "unfused_ms": cuda_ms(lambda: cw.windowed_matmul_tmulti(*args, **kw),
                              200),
    }
    print(f"B1 fused {out['B1']['ms']} ms, unfused {out['B1']['unfused_ms']}"
          f" ms, bound {out['B1']['bound_ms']} ms (compact plane "
          f"{ct.nbytes} B), dense-tile bound {out['B1']['dense_bound_ms']} "
          f"ms, library {out['B1']['library_ms']} ms")
    return out


def spans_blocks_case(dev):
    """B1 on the block-spanning operand of tests/test_tmulti.py
    (R = 8, U = 8, odd pair runs), against its plain version and the
    host oracle."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        CompactTiles, WindowedPairs,
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
    host = WindowedPairs.from_csr(csr, block_rows=8, chunk_cols=128,
                                  reorder=None, pairs_per_step=8,
                                  beat_gather_margin=1e9, max_inflation=1e9)
    check(bool((np.diff(host.block_ptr) % 8 != 0).any()),
          "spans-blocks operand has no block run that spans a step")
    # R = 8 routes to the plain path, so the card copy keeps dense tiles;
    # the kernel gets the compact plane built here.
    wp = host.to(dev)
    ct = CompactTiles.from_dense(host.tiles_t, True).to(dev)
    v_host = generate_fat_vector(csr.shape[1], 16, seed=3).astype(np.float32)
    v_p = wp.encode(torch.from_numpy(v_host).to(dev)).contiguous()
    slabs = cw.chunk_slabs(v_p, C=128, split=True)
    got = cw.windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs,
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
            # The band's nonzeros: band[b, i, w] is A[b*r + i, (b-1)*r + w].
            nbk, r, _ = op.band.shape
            bi, i, w = torch.nonzero(op.band, as_tuple=True)
            rows, cols = bi * r + i, (bi - 1) * r + w
            keep = (rows < m) & (cols >= 0) & (cols < m)
            a_csr = sparse_csr(rows[keep], cols[keep],
                               op.band[bi, i, w][keep], (m, m))
            ms = {"ms": cuda_ms(lambda: cb.band_matmul(op.band, v, m=m), 200),
                  "plain_ms": cuda_ms(lambda: cb.band_matmul_plain(
                      op.band, v, m=m), 50),
                  # band, v and the output; the band's FMAs on the CUDA
                  # cores.
                  **bound(nbytes(op.band, v) + m * k * 4,
                          2 * op.band.numel() * k, "f32"),
                  "library_ms": library_ms("B5", a_csr, v, 200)}
            del a_csr
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
    return entry("B5", "band_matmul", B5_SRC, B5_REPLACES, launches,
                 {"max_abs_err": max(errs), **ms})


def counted_auto(**format_kwargs):
    """An ``Auto(**format_kwargs)`` whose chain bodies are counted in its
    ``body_calls``."""
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto

    class CountedAuto(Auto):
        body_calls = 0

        def chain_parts(self, operand):
            enc, body, dec = super().chain_parts(operand)

            def counted_body(x, op):
                self.body_calls += 1
                return body(x, op)

            return enc, counted_body, dec

    return CountedAuto(**format_kwargs)


def oracle_parts(csr, v_host):
    """The host f64 oracle of ``csr @ v_host`` and its conditioning
    ``sum |a_ij v_jk|`` (bf16 bits decoded)."""
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        as_float64,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_host_f64,
    )

    abs_csr = type(csr)(values=np.abs(as_float64(csr.values)),
                        col_indices=csr.col_indices, row_ptr=csr.row_ptr,
                        shape=csr.shape)
    return (spmm_host_f64(csr, v_host),
            spmm_host_f64(abs_csr, np.abs(as_float64(v_host))))


def matches_oracle(out, oracle, cond, dtype) -> bool:
    """``out`` against the f64 oracle in ``dtype``'s tier, as
    ``run_benchmark`` checks."""
    from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
        are_matrices_equal, default_tolerance,
    )

    return are_matrices_equal(out.cpu().double().numpy(), oracle,
                              tolerance=default_tolerance(dtype),
                              relative=True, condition_scale=cond)


def kernel_vs_plain(label, kernel, plain, tiles, slabs, n=50):
    """``kernel()`` against ``plain(tiles, slabs)`` at the path's shapes,
    within ``1e-5 * cond + 1e-6`` (``cond`` = the plain version on
    ``|tiles|``, ``|slabs|``), and both timed. Returns the kernels-line
    numbers of one kernel."""
    err = check_vs_plain(label, kernel(), plain, tiles, slabs)
    return {"max_abs_err": err, "ms": cuda_ms(kernel, n),
            "plain_ms": cuda_ms(lambda: plain(tiles, slabs), 5, warmup=1)}


def check_vs_plain(label, got, plain, tiles, slabs) -> float:
    """``got`` against ``plain(tiles, slabs)`` within ``1e-5 * cond +
    1e-6``; returns the max abs error."""
    want = plain(tiles, slabs)
    cond = plain(tiles.abs(), slabs.abs())
    excess, err = b1_error(got, want, cond)
    print(f"{label} {tuple(got.shape)} max_abs_err={err} "
          f"tolerance_excess={excess}")
    check(excess <= 0, f"{label} outside tolerance of its plain version")
    return err


def spill_gather_phase(spill, v_p) -> dict:
    """B7 on the U=2 spill: one ``ell_gather_bucketed`` launch and each
    bucket through ``ell_gather_rows`` against the take route, within
    ``1e-5 * cond + 1e-6``; the times of the one launch, its plain
    version, the per-plane launches, the take route and the library
    call; the bound. Returns the B7 numbers of the kernels line."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_gather as cg, ell as ell_ops,
    )

    buckets = spill.buckets
    vals32 = [b.vals.float().contiguous() for b in buckets]
    abs_spill = dataclasses.replace(spill, buckets=tuple(
        dataclasses.replace(b, vals=vals.abs())
        for b, vals in zip(buckets, vals32)))
    stacked = cg.ell_gather_bucketed(spill, v_p)
    cond = cg.ell_gather_bucketed_plain(abs_spill, v_p.abs())
    errs, first = [], 0
    for b, vals in zip(buckets, vals32):
        rows = b.cols.shape[0]
        take = ell_ops.spmm_ell(b, v_p, unpad=False, dma_gather=False)
        for how, got in (("ell_gather_bucketed",
                          stacked[first:first + rows]),
                         ("ell_gather_rows",
                          cg.ell_gather_rows(b.cols, vals, v_p))):
            excess, err = b1_error(got, take, cond[first:first + rows])
            print(f"B7 {how} bucket {tuple(b.cols.shape)} vs the take "
                  f"route: max_abs_err={err} tolerance_excess={excess}")
            check(excess <= 0, f"B7 ({how}) outside tolerance of the take "
                  "route")
            errs.append(err)
        first += rows
    check(stacked.shape[0] == first + 1 and not bool(stacked[-1].any()),
          "ell_gather_bucketed's last row is not the zero row")

    def per_plane():
        return [cg.ell_gather_rows(b.cols, vals, v_p)
                for b, vals in zip(buckets, vals32)]

    def take_route():
        return [ell_ops.spmm_ell(b, v_p, unpad=False, dma_gather=False)
                for b in buckets]

    k = v_p.shape[1]
    cols = torch.cat([b.cols.reshape(-1) for b in buckets])
    slots = cols.numel()
    b_idx, w = zip(*(torch.nonzero(vals, as_tuple=True) for vals in vals32))
    offsets = np.cumsum([0] + [b.cols.shape[0] for b in buckets])[:-1]
    a_csr = sparse_csr(
        torch.cat([r + int(o) for r, o in zip(b_idx, offsets)]),
        torch.cat([b.cols[r, c] for b, r, c in zip(buckets, b_idx, w)]),
        torch.cat([vals[r, c] for vals, r, c in zip(vals32, b_idx, w)]),
        (first, v_p.shape[0]))
    b7 = {"max_abs_err": max(errs),
          "ms": cuda_ms(lambda: cg.ell_gather_bucketed(spill, v_p), 200),
          "plain_ms": cuda_ms(lambda: cg.ell_gather_bucketed_plain(
              spill, v_p), 50),
          # cols and vals (int32, f32), each distinct row of v once, the
          # stacked output and its zero row; one FMA per slot and column.
          **bound(nbytes(cols, *vals32)
                  + int(torch.unique(cols).numel()) * k * 4
                  + (first + 1) * k * 4, 2 * slots * k, "f32"),
          "library_ms": library_ms("B7", a_csr, v_p, 200),
          "per_plane_ms": cuda_ms(per_plane, 200),
          "take_route_ms": cuda_ms(take_route, 50)}
    print(f"B7 all {len(buckets)} buckets: one launch {b7['ms']} ms, plain "
          f"{b7['plain_ms']} ms, per-plane launches {b7['per_plane_ms']} ms,"
          f" take route {b7['take_route_ms']} ms, bound {b7['bound_ms']} ms")
    return b7


def windowed_route(wp) -> dict:
    return dict(R=wp.block_rows, C=wp.chunk_cols, U=wp.pairs_per_step,
                P=wp.n_pairs, nb=wp.n_blocks, spill=wp.spill is not None)


ENTRY_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def entry(name, label, src, replaces, launches, numbers, **extra):
    """One kernel of the kernels line: ``numbers`` holds its measured
    ``ENTRY_KEYS`` (``library_ms`` None where no one call computes the
    same function), ``extra`` whatever else the phase measured."""
    return {"name": f"{name} {label}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            **{key: numbers[key] for key in ENTRY_KEYS}, **extra}


def two_pair_operand(csr, dev, label):
    """``Auto(pairs_per_step=2).prepare(csr, dev)`` in its two steps, the
    host build and ``to(cuda)`` (which builds the compact plane on the
    host, timed with it), with the card copy's plane checked: a natural
    ``CompactTiles`` whose ``to_dense`` equals the host's own dense
    natural plane bit for bit, and no dense natural plane. Returns the
    card copy, the host's dense plane on the card (the plain versions'
    tiles) and the plane's numbers."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        to_tensor,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        CompactTiles,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import auto_format

    t0 = time.perf_counter()
    host = auto_format(csr, pairs_per_step=2)
    t1 = time.perf_counter()
    wp = host.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    field = "tiles_split" if host.split else "tiles"
    dense = to_tensor(host.natural_plane, dev)
    ct = wp.natural_plane
    check(isinstance(ct, CompactTiles) and ct.natural
          and not any(isinstance(getattr(wp, f), torch.Tensor)
                      for f in ("tiles", "tiles_split")),
          f"the two-pair {label} card copy does not hold the compact plane "
          f"in place of its dense {field}")
    check(torch.equal(ct.to_dense().view(torch.int16),
                      dense.view(torch.int16)),
          f"the two-pair {label} card copy's compact plane is not the "
          f"host's {field} bit for bit")
    numbers = {"entries": ct.nnz, "bytes": ct.nbytes,
               "dense_bytes": nbytes(dense), "to_cuda_s": t2 - t1}
    print(f"two-pair {label}: auto_format {t1 - t0:.2f} s; route "
          f"{windowed_route(wp)}; to(cuda) {t2 - t1} s, the compact natural "
          f"plane built in it: {ct.nnz} entries, {ct.nbytes} B on the card "
          f"in place of the dense {field} {nbytes(dense)} B "
          f"{tuple(dense.shape)}, equal to it bit for bit")
    return wp, dense, numbers


def wide_chunk_phase(dev, csr) -> None:
    """The dense natural kernel, which B3 and B4 bf16 run only for chunks
    wider than ``COMPACT_MAX_C`` (no default route builds one): the
    cop20k stand-in's U=2 build with ``chunk_cols`` pinned to 1024, f32
    and bf16. Its card copy must keep the dense natural plane; B3 (mode
    0) and B4 bf16 (mode 1) on it against their plain versions within
    ``1e-5 * cond + 1e-6``, both timed."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        COMPACT_MAX_C, WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_windowed as cw,
    )

    C = 1024
    v = torch.from_numpy(generate_fat_vector(
        csr.shape[1], K, seed=0).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    host = WindowedPairs.from_csr(csr, chunk_cols=C, pairs_per_step=2,
                                  beat_gather_margin=1e9)
    print(f"two-pair build at C = {C}: {time.perf_counter() - t0:.2f} s")
    for label, h in (("f32", host), ("bf16", host.astype(torch.bfloat16))):
        wp = h.to(dev)
        tiles = wp.natural_plane
        route = windowed_route(wp)
        print(f"two-pair {label} at C = {C}: route {route}; natural plane "
              f"{type(tiles).__name__} {tuple(tiles.shape)} "
              f"{nbytes(tiles) if isinstance(tiles, torch.Tensor) else 0} B")
        check(C > COMPACT_MAX_C and route["C"] == C and route["U"] == 2
              and isinstance(tiles, torch.Tensor),
              f"the C = {C} two-pair {label} card copy does not keep its "
              f"dense natural plane")
        pb, pc, bp, nb = (wp.pair_block, wp.pair_chunk, wp.block_ptr,
                          wp.n_blocks)
        v_p = wp.encode(v.to(torch.float32 if label == "f32"
                             else tiles.dtype)).contiguous()
        slabs = cw.chunk_slabs(v_p, C=C, split=label == "f32")
        if label == "f32":
            kernel, plain = cw.windowed_matmul_split3, \
                cw.windowed_matmul_split3_plain
        else:
            kernel, plain = cw.windowed_matmul_single, \
                cw.windowed_matmul_single_plain
        got = kernel_vs_plain(
            f"{'B3' if label == 'f32' else 'B4 bf16'} dense natural kernel "
            f"C = {C}", lambda: kernel(pb, pc, bp, tiles, slabs, nb=nb),
            lambda t, s: plain(pb, pc, t, s, nb=nb), tiles, slabs, n=20)
        print(f"dense natural kernel ({label}, C = {C}) {got['ms']} ms, "
              f"plain {got['plain_ms']} ms")
        del wp, tiles, slabs, v_p
    del host


def two_pair_phase(dev, csr, power):
    """Phase 6: the U=2 windowed path on the cop20k stand-in, f32 (B2 +
    B3, spill by take or by B7) and bf16 (B2 + B4). Returns the B3, B4
    and B7 entries of the kernels line."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        run_benchmark,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import cast
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_gather as cg, cuda_windowed as cw, ell as ell_ops,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any

    # 6.1 route and the compact natural plane
    wp, dense, plane_f32 = two_pair_operand(csr, dev, "f32")
    route = windowed_route(wp)
    check(route == U2_F32_ROUTE, f"unexpected two-pair route {route}")
    print(f"spill buckets {[tuple(b.cols.shape) for b in wp.spill.buckets]}")
    C, nb = wp.chunk_cols, wp.n_blocks
    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    v = torch.from_numpy(v_host).to(dev)
    v_p = wp.encode(v).contiguous()
    pb, pc, bp = wp.pair_block, wp.pair_chunk, wp.block_ptr

    # 6.2 B3, B4 (f32) and B7 against their plain versions; B3 on the
    # compact plane, the plain version on the host's dense plane
    ct = wp.tiles_split
    P, R = wp.n_pairs, wp.block_rows
    flops = 2 * P * R * C * K  # one product of every tile
    out_bytes = nb * R * K * 4
    a_csr = windowed_csr(wp)  # hi + lo of every tile: B3's and B4's entries
    slabs = cw.chunk_slabs(v_p, C=C, split=True)
    b3 = kernel_vs_plain(
        "B3 windowed_matmul_split3",
        lambda: cw.windowed_matmul_split3(pb, pc, bp, ct, slabs, nb=nb),
        lambda t, s: cw.windowed_matmul_split3_plain(pb, pc, t, s, nb=nb),
        dense, slabs, n=200)
    rest = nbytes(slabs, pc, bp) + out_bytes
    # the compact plane and the rest; two f32 FMAs per entry and k (dense:
    # the tiles, three bf16 products per tile)
    b3.update(bound(ct.nbytes + rest, 2 * 2 * ct.nnz * K, "f32"),
              dense_bound_ms=bound(nbytes(dense) + rest, 3 * flops,
                                   "bf16")["bound_ms"],
              library_ms=library_ms("B3", a_csr, v_p))
    print(f"B3 {b3['ms']} ms, bound {b3['bound_ms']} ms (compact plane "
          f"{ct.nbytes} B), dense-tile bound {b3['dense_bound_ms']} ms, "
          f"library {b3['library_ms']} ms")
    tiles32 = dense[..., :C].float() + dense[..., C:].float()
    del dense
    slabs32 = cw.chunk_slabs(v_p, C=C, split=False)
    b4_f32 = kernel_vs_plain(
        "B4 windowed_matmul_single f32",
        lambda: cw.windowed_matmul_single(pb, pc, bp, tiles32, slabs32,
                                          nb=nb),
        lambda t, s: cw.windowed_matmul_single_plain(pb, pc, t, s, nb=nb),
        tiles32, slabs32)
    b4_f32.update(bound(nbytes(tiles32, slabs32, pc, bp) + out_bytes, flops,
                        "f32"),
                  library_ms=library_ms("B4 f32", a_csr, v_p))
    # hi + lo tiles hold ~17 bits and v integers, which two TF32 terms
    # represent exactly: full-mantissa operands exercise the 3xTF32 split.
    gen = torch.Generator(device=dev).manual_seed(5)
    tiles32 *= 1 + 2.0 ** -12 * (2 * torch.rand(
        tiles32.shape, generator=gen, device=dev) - 1)
    slabs32 *= 1 + 2.0 ** -12 * (2 * torch.rand(
        slabs32.shape, generator=gen, device=dev) - 1)
    b4_full = check_vs_plain(
        "B4 windowed_matmul_single f32 full-mantissa",
        cw.windowed_matmul_single(pb, pc, bp, tiles32, slabs32, nb=nb),
        lambda t, s: cw.windowed_matmul_single_plain(pb, pc, t, s, nb=nb),
        tiles32, slabs32)
    del slabs, tiles32, slabs32, a_csr
    b7 = spill_gather_phase(wp.spill, v_p)

    # 6.3 main path, counted: one-shot (take, then B7), amortized chain
    oracle, cond = oracle_parts(csr, v_host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    cg.reset_launch_counts()
    one_take = matches_oracle(spmm_any(wp, v), oracle, cond, torch.float32)
    ell_ops.SPILL_DMA_GATHER = True
    try:
        one_dma = matches_oracle(spmm_any(wp, v), oracle, cond,
                                 torch.float32)
    finally:
        ell_ops.SPILL_DMA_GATHER = False
    del wp, v_p
    strat = counted_auto(pairs_per_step=2)
    rec = run_benchmark(csr, K, strat, dev, matrix_name="cop20k_like",
                        warmup=2, iters=5, oracle=oracle, check=True,
                        dtype=np.float32, amortized=True, inner=20)
    torch.cuda.synchronize()
    counts = {**cw.launch_counts(), **cg.launch_counts()}
    plane_f32["peak_device_memory"] = torch.cuda.max_memory_allocated()
    print(f"two-pair f32 one-shot spmm_any: take route correct={one_take}, "
          f"B7 route correct={one_dma}; amortized {rec.execution_time * 1e3}"
          f" ms per multiply, {rec.gnnz_per_s} Gnnz/s, correct={rec.correct}"
          f"; launch counts {counts}; chain body calls {strat.body_calls}")
    check(one_take and one_dma, "two-pair one-shot disagrees with the oracle")
    check(rec.correct is True, "two-pair amortized path disagrees with oracle")
    check(rec.execution_time == rec.execution_time,
          "two-pair chained iterate time did not resolve")
    calls = 2 + strat.body_calls
    # One B7 launch for the whole spill of the one B7-routed call.
    check(strat.body_calls > 0 and counts["B3"] == calls
          and counts["B2"] == calls and counts["B7"] == 1
          and counts["B1"] == counts["B4"] == counts["B6"] == 0,
          f"two-pair launch counts {counts} != {calls} B2/B3 (2 one-shot + "
          f"{strat.body_calls} bodies) and 1 B7")
    f32 = {"gnnz_per_s": rec.gnnz_per_s, "execution_time_s":
           rec.execution_time, "correct": rec.correct,
           "one_shot_take_correct": one_take, "one_shot_b7_correct": one_dma,
           "max_error": rec.max_error, "launches": counts}
    b3_launches, b7_launches = counts["B3"], counts["B7"]

    # 6.4 bf16: route, B4 against its plain version, main path counted
    csr_bf = csr.astype(torch.bfloat16)
    wpb, dense_b, plane_bf16 = two_pair_operand(csr_bf, dev, "bf16")
    route_bf = windowed_route(wpb)
    check({k: route_bf[k] for k in U2_BF16_ROUTE} == U2_BF16_ROUTE,
          f"unexpected bf16 two-pair route {route_bf}")
    vb = v.to(torch.bfloat16)  # integers 1..100: exact in bf16
    slabs_b = cw.chunk_slabs(wpb.encode(vb).contiguous(), C=wpb.chunk_cols,
                             split=False)
    pb, pc, bp, nb = (wpb.pair_block, wpb.pair_chunk, wpb.block_ptr,
                      wpb.n_blocks)
    ctb = wpb.tiles
    b4 = kernel_vs_plain(
        "B4 windowed_matmul_single bf16",
        lambda: cw.windowed_matmul_single(pb, pc, bp, ctb, slabs_b, nb=nb),
        lambda t, s: cw.windowed_matmul_single_plain(pb, pc, t, s, nb=nb),
        dense_b, slabs_b, n=200)
    P, R, C = ctb.shape
    rest = nbytes(slabs_b, pc, bp) + nb * R * K * 4
    # the compact plane and the rest, one f32 FMA per entry and k (dense:
    # the tiles, one bf16 product per tile)
    b4.update(bound(ctb.nbytes + rest, 2 * ctb.nnz * K, "f32"),
              dense_bound_ms=bound(nbytes(dense_b) + rest,
                                   2 * P * R * C * K, "bf16")["bound_ms"])
    del dense_b
    v_pb = wpb.encode(vb).contiguous()
    try:
        b4["library_ms"] = library_ms("B4 bf16", windowed_csr(wpb), v_pb)
    except RuntimeError as e:  # a cuSPARSE without a bf16 CSR product
        print(f"B4 bf16: torch.sparse.mm refused bf16 operands ({e}); the "
              "library call is timed on the same entries in f32")
        b4["library_ms"] = library_ms(
            "B4 bf16 (f32 operands)", windowed_csr(wpb, torch.float32),
            v_pb.float())
    del slabs_b, v_pb
    print(f"B4 bf16 {b4['ms']} ms, bound {b4['bound_ms']} ms (compact "
          f"plane {ctb.nbytes} B), dense-tile bound {b4['dense_bound_ms']} "
          f"ms, library {b4['library_ms']} ms")
    oracle_bf, cond_bf = oracle_parts(csr_bf, cast(v_host, torch.bfloat16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    one_bf = matches_oracle(spmm_any(wpb, vb), oracle_bf, cond_bf,
                            torch.bfloat16)
    del wpb
    strat = counted_auto(pairs_per_step=2)
    rec_bf = run_benchmark(csr, K, strat, dev, matrix_name="cop20k_like",
                           warmup=2, iters=5, oracle=oracle_bf, check=True,
                           dtype=torch.bfloat16, amortized=True, inner=20)
    torch.cuda.synchronize()
    counts_bf = cw.launch_counts()
    plane_bf16["peak_device_memory"] = torch.cuda.max_memory_allocated()
    print(f"two-pair bf16 one-shot spmm_any correct={one_bf}; amortized "
          f"{rec_bf.execution_time * 1e3} ms per multiply, "
          f"{rec_bf.gnnz_per_s} Gnnz/s, correct={rec_bf.correct}, dtype "
          f"{rec_bf.dtype}; launch counts {counts_bf}; chain body calls "
          f"{strat.body_calls}")
    check(one_bf, "bf16 two-pair one-shot disagrees with the oracle")
    check(rec_bf.correct is True and rec_bf.dtype == "bfloat16",
          "bf16 two-pair amortized path disagrees with the oracle")
    check(rec_bf.execution_time == rec_bf.execution_time,
          "bf16 two-pair chained iterate time did not resolve")
    calls = 1 + strat.body_calls
    check(strat.body_calls > 0 and counts_bf["B4"] == calls
          and counts_bf["B2"] == calls and counts_bf["B3"] == 0,
          f"bf16 two-pair launch counts {counts_bf} != {calls} B2/B4")
    print(json.dumps({
        "path": "cop20k_u2_k32", "route_f32": route, "route_bf16": route_bf,
        "f32": f32, "bf16": {
            "gnnz_per_s": rec_bf.gnnz_per_s,
            "execution_time_s": rec_bf.execution_time,
            "correct": rec_bf.correct, "one_shot_correct": one_bf,
            "max_error": rec_bf.max_error, "launches": counts_bf},
        "b7_all_buckets_ms": b7["ms"], "take_route_ms": b7["take_route_ms"],
        "plane_f32": plane_f32, "plane_bf16": plane_bf16, "power": power}))
    # 6.5 the dense natural kernel, for chunks past the compact width
    wide_chunk_phase(dev, csr)
    # B4 f32 runs on no routed path (an f32 build carries split planes, so
    # B3 runs): its numbers ride on the B4 entry.
    f32_extra = {f"f32_{key}": b4_f32[key] for key in ENTRY_KEYS}
    return [
        entry("B3", "windowed_matmul_split3", SRC, REPLACES["B3"],
              b3_launches, b3, dense_bound_ms=b3["dense_bound_ms"],
              compact_plane_bytes=plane_f32["bytes"]),
        entry("B4", "windowed_matmul_single (bf16)", SRC, REPLACES["B4"],
              counts_bf["B4"], b4, dense_bound_ms=b4["dense_bound_ms"],
              compact_plane_bytes=plane_bf16["bytes"], **f32_extra,
              f32_full_mantissa_max_abs_err=b4_full),
        entry("B7", "ell_gather_bucketed (all spill buckets, one launch)",
              B7_SRC, B7_REPLACES, b7_launches, b7,
              per_plane_ms=b7["per_plane_ms"],
              take_route_ms=b7["take_route_ms"]),
    ]


def phased_phase(dev, csr, power):
    """Phase 7: the phased resident layout on the cop20k stand-in, chain
    body B6 + ``resplit_slabs``. Returns the B6 entry of the kernels
    line."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        run_benchmark,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        CompactTiles,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_windowed as cw,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import spmm_any
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto

    t0 = time.perf_counter()
    wp = Auto(phase_layout=True).prepare(csr, dev)
    torch.cuda.synchronize()
    route = windowed_route(wp)
    ct = wp.tiles_t
    print(f"phased: prepare {time.perf_counter() - t0:.2f} s; route {route};"
          f" phases {wp.phases}; chunks_per_phase {wp.chunks_per_phase}; "
          f"tiles_t {tuple(ct.shape)} {ct.dtype} as {type(ct).__name__}, "
          f"{ct.nnz} entries, {ct.nbytes} B")
    check(wp.phases == PHASES and wp.chunks_per_phase == 448
          and isinstance(ct, CompactTiles)
          and tuple(ct.shape) == (10768, 256, 128)
          and ct.dtype == torch.bfloat16 and route["U"] == 16
          and wp.supports_transposed_chain,
          f"unexpected phased route {route} {wp.phases}")
    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    v = torch.from_numpy(v_host).to(dev)
    slabs = cw.chunk_slabs(wp.encode(v).contiguous(), C=wp.chunk_cols,
                           split=True)
    args = (wp.pair_block_ph, wp.pair_chunk_ph, wp.block_ptr_ph, ct, slabs)
    kw = dict(nb=wp.n_blocks, phases=wp.phases,
              chunks_per_phase=wp.chunks_per_phase, pairs_per_step=16)
    dense = ct.to_dense()  # the plain version's tiles

    def plain(t, s):
        return cw.windowed_matmul_tmulti_phased_plain(
            wp.pair_block_ph, wp.pair_chunk_ph, t, s, nb=wp.n_blocks,
            phases=wp.phases)

    b6 = kernel_vs_plain(
        "B6 windowed_matmul_tmulti_phased resident",
        lambda: cw.windowed_matmul_tmulti_phased(*args, **kw), plain,
        dense, slabs, n=200)
    streamed = kernel_vs_plain(
        "B6 windowed_matmul_tmulti_phased streamed (B1 per phase)",
        lambda: cw.windowed_matmul_tmulti_phased(*args, force_streamed=True,
                                                 **kw), plain,
        dense, slabs, n=200)
    same = torch.equal(cw.windowed_matmul_tmulti_phased(*args, **kw),
                       cw.windowed_matmul_tmulti_phased(
                           *args, force_streamed=True, **kw))
    print(f"B6 resident bitwise equal to the streamed route: {same}; "
          f"resident {b6['ms']} ms, streamed {streamed['ms']} ms, plain "
          f"{b6['plain_ms']} ms")
    check(same, "B6 resident and streamed routes differ")
    P, C2, R = ct.shape
    # slabs, the work list and the f32 output; the plane, two f32 FMAs
    # per entry and k (dense: the tiles, three bf16 products per tile)
    rest = (nbytes(slabs, wp.pair_chunk_ph, wp.block_ptr_ph)
            + wp.n_blocks * K * R * 4)
    b6.update(bound(ct.nbytes + rest, 2 * 2 * ct.nnz * K, "f32"),
              dense_bound_ms=bound(nbytes(dense) + rest,
                                   3 * 2 * P * (C2 // 2) * R * K,
                                   "bf16")["bound_ms"],
              library_ms=library_ms("B6", windowed_csr(wp),
                                    wp.encode(v).contiguous()))
    del slabs, args, dense

    phases = wp.phases
    oracle, cond = oracle_parts(csr, v_host)
    torch.cuda.synchronize()
    cw.reset_launch_counts()
    one = matches_oracle(spmm_any(wp, v), oracle, cond, torch.float32)
    del wp
    strat = counted_auto(phase_layout=True)
    rec = run_benchmark(csr, K, strat, dev, matrix_name="cop20k_like",
                        warmup=2, iters=5, oracle=oracle, check=True,
                        dtype=np.float32, amortized=True, inner=20)
    torch.cuda.synchronize()
    counts = cw.launch_counts()
    print(f"phased one-shot spmm_any correct={one}; amortized "
          f"{rec.execution_time * 1e3} ms per multiply, {rec.gnnz_per_s} "
          f"Gnnz/s, correct={rec.correct}; launch counts {counts}; chain "
          f"body calls {strat.body_calls}")
    check(one, "phased one-shot disagrees with the oracle")
    check(rec.correct is True, "phased amortized path disagrees with oracle")
    check(rec.execution_time == rec.execution_time,
          "phased chained iterate time did not resolve")
    check(strat.body_calls > 0 and counts["B6"] == 1 + strat.body_calls
          and counts["B2"] == 2 and counts["B1"] == 0,
          f"phased launch counts {counts} != {1 + strat.body_calls} B6 "
          "(1 one-shot + the chain bodies) and 2 B2")
    print(json.dumps({
        "path": "cop20k_phased_k32", "route": route,
        "phases": [list(ph) for ph in phases],
        "gnnz_per_s": rec.gnnz_per_s, "execution_time_s": rec.execution_time,
        "correct": rec.correct, "one_shot_correct": one,
        "max_error": rec.max_error, "launches": counts,
        "b6_resident_ms": b6["ms"], "b6_streamed_ms": streamed["ms"],
        "power": power}))
    return entry("B6", "windowed_matmul_tmulti_phased", SRC, REPLACES["B6"],
                 counts["B6"], b6, dense_bound_ms=b6["dense_bound_ms"],
                 streamed_ms=streamed["ms"],
                 streamed_max_abs_err=streamed["max_abs_err"])


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
            CompactTiles, WindowedPairs,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
            cop20k_like, generate_fat_vector,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.ops import (
            _kernel_lib, cuda_windowed as cw,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
            auto_format, spmm_any,
        )
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
    host = auto_format(csr)  # Auto().prepare is this, then .to(device)
    t_host = time.perf_counter()
    check(isinstance(host, WindowedPairs),
          f"route is {type(host).__name__}, not WindowedPairs")
    wp = host.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t3 = time.perf_counter()
    plane = CompactTiles.from_dense(host.tiles_t, host.split)
    build_s = time.perf_counter() - t3
    check(isinstance(wp.tiles_t, CompactTiles) and wp.tiles is None
          and wp.tiles_split is None and wp.tiles_t.nnz == plane.nnz
          and wp.tiles_t.shape == host.tiles_t.shape,
          "the card copy does not hold the compact plane in place of "
          "tiles_t")
    print(f"compact plane: {plane.nnz} entries, {wp.tiles_t.nbytes} B on the"
          f" card in place of the dense tiles_t {host.tiles_t.nbytes} B "
          f"{tuple(host.tiles_t.shape)}; built on the host in {build_s} s; "
          f"auto_format {t_host - t1:.2f} s, to(cuda) {t2 - t_host:.2f} s")
    plane_bytes = wp.tiles_t.nbytes
    del host, plane
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
    strat = counted_auto()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    one_shot = spmm_any(wp, v).cpu().double().numpy()
    one_shot_ok = are_matrices_equal(one_shot, oracle, tolerance=tol,
                                     relative=True, condition_scale=cond)
    del wp
    rec = run_benchmark(csr, K, strat, dev,
                        matrix_name="cop20k_like", warmup=2, iters=5,
                        oracle=oracle, check=True, dtype=np.float32,
                        amortized=True, inner=20)
    torch.cuda.synchronize()
    counts = cw.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"one-shot spmm_any: correct={one_shot_ok} "
          f"max_abs_err={max_abs_error(one_shot, oracle)}")
    print(f"main path peak device memory (one-shot and run_benchmark): "
          f"{peak} B")
    print(f"launch counts {counts}; chain body calls {strat.body_calls}")
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
        "compact_plane_bytes": plane_bytes,
        "compact_plane_build_s": build_s,
    }
    print(json.dumps(result))
    check(one_shot_ok, "one-shot spmm_any disagrees with the f64 oracle")
    check(rec.correct is True, "amortized main path disagrees with oracle")
    check(rec.execution_time == rec.execution_time,
          "chained iterate time did not resolve")
    check(counts["B1"] == 1 + strat.body_calls and strat.body_calls > 0,
          f"B1 launches {counts['B1']} != 1 one-shot + {strat.body_calls} "
          "chain bodies")
    check(counts["B2"] == 2, f"B2 launches {counts['B2']} != 2 "
          "(one-shot relayout + chain encode)")

    b1 = timings["B1"]
    kernels = [
        entry("B1", "windowed_matmul_tmulti", SRC, REPLACES["B1"],
              counts["B1"], b1, dense_bound_ms=b1["dense_bound_ms"],
              unfused_ms=b1["unfused_ms"]),
        entry("B2", "chunk_slabs", SRC, REPLACES["B2"], counts["B2"],
              timings["B2"])]

    # 5. solver path
    kernels.append(solver_phase(dev, power))

    # 6. two-pair path (B3, B4, B7), 7. phased chain (B6)
    kernels.extend(two_pair_phase(dev, csr, power))
    kernels.append(phased_phase(dev, csr, power))
    kernels.sort(key=lambda e: e["name"])
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

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
   ``resplit_slabs``), against the f64 oracle; one B6 launch per call;
8. GCN training on the model benchmark's graph (``gcn_task()``: 100,000
   nodes, 598,723 nnz, f = 64, h = 128, c = 16, f32; ``auto_format(
   k_nominal=128)`` -> ``BucketedELL``, take-route gathers) through the
   custom-gradient SpMM (``make_symmetric_spmm``): the first step's loss
   and four gradients against the same port code in float64 on the CPU
   (SpMM through a CPU COO operand; loss within 1e-4 relative, each
   gradient within 1e-3 of its largest magnitude), 20 Adam steps with a
   falling loss, ``step_ms`` (CUDA events over 20 steps after 3 warm-up,
   best and worst of 3 rounds) beside ``step_ms_library`` (the same
   training through ``torch.sparse.mm``) and the peak memory; then one
   4-head ``multi_head_gat`` (64 -> 4 x 32) forward and backward, checked
   against CPU float64 the same way and timed;
9. GCN training on the cop20k mesh graph (``mesh_gcn_task()``: 121,192
   nodes, 2,745,522 nnz; route ``WindowedPairs`` R = 256, C = 128,
   U = 16, a spill): the card's compact plane against the host's dense
   plane bit for bit; B2 at k = 128 and 16 against its plain version bit
   for bit, and B1 at this R and k8 = 128 and 16 against its plain
   version on B2's plain slabs and the host's dense plane (``1e-5 * cond
   + 1e-6``); then the checks and times of
   phase 8, with exactly 4 B1 and 4 B2 launches a training step (the
   forward and backward SpMMs at k = 128 and 16) and no other kernel;
10. the hub route: ``auto_format(dc1_like(), allow_hub=True)`` at k = 32,
   f32, must give ``HubExtracted`` with the JAX package's pick on that
   matrix (4 hubs over a ``BucketedELL`` remainder, take-route gathers:
   no hand-written kernel); a one-shot ``spmm_any`` on the card
   against the f64 oracle in the f32 tier, timed beside
   ``torch.sparse.mm`` on the whole matrix;
11. the strategies on a one-rank NCCL group (``initialize_distributed``
   on a free local port, ``make_mesh``, ``make_mesh_2d(1, 1)``): what a
   counted collective costs there; ``Auto`` (the one-device path),
   ``RowWise``, ``ColumnWise``, ``NonZeroElement`` (psum, scatter),
   ``Library``, ``Grid2D`` and ``WindowedRowWise`` (U = 16, U = 2 f32
   and bf16) on the cop20k stand-in at k = 32, ``BandedRowWise`` on the
   CG system at k = 8, each with its result gathered and left sharded:
   against the f64 oracle, its ms per multiply beside the one-device
   ``Auto``'s, its collectives and its launches (1 B2 + 1 B1 a
   ``WindowedRowWise`` multiply at U = 16, 1 B2 + 1 B3 or B4 at U = 2);
   ``comm_comp_split`` of ``RowWise`` and ``WindowedRowWise``; the
   strategy ``Auto`` picks for several ranks; then
   ``dryrun_multichip(1)`` in a spawned rank;
12. the kernels of a p = 4 mesh's ranks, one after another in this
   process: ``WindowedRowWise().partition(cop20k, 4)`` (U = 16) and the
   U = 2 f32 partition, each route against the JAX package's; for every
   rank its card copy's compact plane bit for bit its host plane, its
   halo window cut on the host, B2 on it bit for bit, B1 or B3 against
   the plain version on the host's dense plane (``1e-5 * cond + 1e-6``)
   and timed beside its bound, and its rows; the four row blocks,
   decoded, against the f64 oracle.

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
path's result, one with the solver path's, one for each of phases 6 to
12, each phase's wall seconds, one with the kernels (B1 and B2 also
with their launches per mesh GCN step, B1 with its R = 256, k8 = 128
check; B1 to B4 with their launches a distributed multiply, B1 and B3
with their per-rank numbers at p = 4), and as the last line
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

        def chain_parts(self, operand, mesh=None, **kwargs):
            enc, body, dec = super().chain_parts(operand, mesh, **kwargs)

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


GCN_F, GCN_H, GCN_C = 64, 128, 16
GCN_STEPS, GCN_WARMUP, GCN_ROUNDS = 20, 3, 3
#: The card's f32 step against the same port code in f64 on the CPU: the
#: loss within 1e-4 relative, each gradient within 1e-3 of its largest
#: magnitude (bf16 hi + lo slabs and f32 sums on the card).
GCN_LOSS_RTOL, GCN_GRAD_TOL = 1e-4, 1e-3
GAT_HEADS, GAT_WIDTH = 4, 32
#: The GCN route the JAX package's format search picks on the cop20k
#: mesh graph at k_nominal = 128.
MESH_ROUTE = dict(R=256, C=128, U=16, spill=True)
#: The JAX package's hub pick on dc1_like at k_nominal = 32 (its
#: auto_format on the host): hub count and remainder format.
HUB_DC1 = (4, "BucketedELL")


def reset_counts() -> None:
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_banded, cuda_gather, cuda_windowed,
    )

    for mod in (cuda_windowed, cuda_banded, cuda_gather):
        mod.reset_launch_counts()


def all_counts() -> dict:
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_banded, cuda_gather, cuda_windowed,
    )

    return {**cuda_windowed.launch_counts(), **cuda_banded.launch_counts(),
            **cuda_gather.launch_counts()}


def step_times(fn, n=GCN_STEPS, warmup=GCN_WARMUP, rounds=GCN_ROUNDS):
    """Milliseconds per ``fn()`` by CUDA events over ``n`` calls after
    ``warmup``: (best, worst) of ``rounds`` rounds."""
    times = [cuda_ms(fn, n, warmup if i == 0 else 0) for i in range(rounds)]
    return min(times), max(times)


def to_cpu_f64(tensors):
    """Leaf copies of ``tensors`` in float64 on the CPU that require grad."""
    import torch

    return [t.detach().to("cpu", torch.float64).requires_grad_()
            for t in tensors]


def grads_agree(label, loss, ref_loss, grads, ref_grads) -> dict:
    """The card's loss and gradients against the CPU float64 run:
    ``GCN_LOSS_RTOL`` relative and ``GCN_GRAD_TOL`` of each gradient's
    largest magnitude."""
    import torch

    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    grad_rel = [float((g.detach().cpu().double() - r).abs().max()
                      / r.abs().max()) for g, r in zip(grads, ref_grads)]
    print(f"{label}: loss {loss} (CPU f64 {ref_loss}, rel {loss_rel}); "
          f"gradients' max error over their largest magnitude {grad_rel}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{label}: a gradient is not finite")
    check(loss_rel <= GCN_LOSS_RTOL,
          f"{label}: loss {loss} differs from CPU f64 {ref_loss}")
    check(max(grad_rel) <= GCN_GRAD_TOL,
          f"{label}: gradients differ from CPU f64 ({grad_rel})")
    return {"loss_rel_err": loss_rel, "grad_rel_err": max(grad_rel)}


def gcn_train_phase(label, dev, a_hat, operand, task,
                    counted_kernels=()) -> dict:
    """One GCN training run on the card through ``operand``: the first
    step's loss and gradients against the same port code in float64 on
    the CPU (SpMM through the CPU COO operand of ``a_hat``), 20 Adam
    steps with the launches counted (``counted_kernels`` must each launch
    4 times a step: forward and backward at the two widths), a falling
    loss, and the step time against the same training through the
    library call (``torch.sparse.mm``)."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        GCNParams, gcn_loss, init_gcn, make_train_step,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff import (
        make_symmetric_spmm,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.library import (
        to_torch_sparse,
    )

    x_host, labels_host, mask_host = task
    x, labels, mask = (torch.from_numpy(a).to(dev)
                       for a in (x_host, labels_host, mask_host))
    spmm = make_symmetric_spmm(operand)

    def fresh_params():
        return init_gcn(GCN_F, GCN_H, GCN_C,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.float32, device=dev)

    # the first step against CPU float64
    params = fresh_params()
    reset_counts()
    loss = gcn_loss(params, spmm, x, labels, mask)
    loss.backward()
    torch.cuda.synchronize()
    first_counts = all_counts()
    ref_params = GCNParams(*to_cpu_f64(params))
    ref_spmm = make_symmetric_spmm(a_hat.to_coo().astype(np.float64).to(
        "cpu"))
    t0 = time.perf_counter()
    ref_loss = gcn_loss(ref_params, ref_spmm, torch.from_numpy(
        x_host.astype(np.float64)), torch.from_numpy(labels_host),
        torch.from_numpy(mask_host))
    ref_loss.backward()
    ref_s = time.perf_counter() - t0
    out = grads_agree(f"{label} GCN first step", loss.item(),
                      ref_loss.item(), [p.grad for p in params],
                      [p.grad for p in ref_params])
    print(f"{label}: CPU f64 reference step {ref_s:.2f} s; launches of the "
          f"first forward + backward {first_counts}")

    # 20 Adam steps, counted
    step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
    reset_counts()
    losses = [float(step(params, x, labels, mask))
              for _ in range(GCN_STEPS)]
    torch.cuda.synchronize()
    counts = all_counts()
    with torch.no_grad():
        final = float(gcn_loss(params, spmm, x, labels, mask))
    print(f"{label}: losses over {GCN_STEPS} Adam steps {losses}, after "
          f"them {final}; launches {counts}")
    check(np.isfinite(losses).all() and np.isfinite(final)
          and final < losses[0],
          f"{label}: the loss did not fall ({losses[0]} -> {final})")
    for name in counted_kernels:
        check(counts[name] == 4 * GCN_STEPS and first_counts[name] == 4,
              f"{label}: {name} launched {counts[name]} times in "
              f"{GCN_STEPS} steps ({first_counts[name]} in one forward + "
              "backward), not 4 a step")
    for name, n in counts.items():
        check(name in counted_kernels or n == 0,
              f"{label}: {name} launched {n} times on this path")

    # step times: the kernels' route, then the library call
    torch.cuda.reset_peak_memory_stats()
    step_ms = step_times(lambda: step(params, x, labels, mask))
    peak = torch.cuda.max_memory_allocated()
    lib_params = fresh_params()
    lib_spmm = make_symmetric_spmm(to_torch_sparse(a_hat.astype(
        np.float32), device=dev))
    lib_loss = gcn_loss(lib_params, lib_spmm, x, labels, mask).item()
    check(abs(lib_loss - losses[0]) <= GCN_LOSS_RTOL * abs(losses[0]),
          f"{label}: the library route's first loss {lib_loss} differs "
          f"from the kernels' {losses[0]}")
    lib_step = make_train_step(lib_spmm, torch.optim.Adam(lib_params,
                                                          lr=1e-2))
    step_ms_library = step_times(lambda: lib_step(lib_params, x, labels,
                                                  mask))
    print(f"{label}: step {step_ms} ms (best, worst of {GCN_ROUNDS} rounds "
          f"of {GCN_STEPS}), library route {step_ms_library} ms; peak "
          f"device memory {peak} B")
    out.update(first_loss=losses[0], final_loss=final,
               step_ms=step_ms[0], step_ms_range=list(step_ms),
               step_ms_library=step_ms_library[0],
               step_ms_library_range=list(step_ms_library),
               max_memory_allocated=peak, launches_per_step={
                   name: counts[name] / GCN_STEPS
                   for name in counted_kernels})
    return out


def gat_phase(dev, a_hat, x_host) -> dict:
    """One 4-head ``multi_head_gat`` (64 -> 4 x 32) forward and backward on
    the card against the same code in float64 on the CPU (mean square of
    the output as the loss, checked as the GCN's), and timed."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        GATParams, init_gat, multi_head_gat,
    )

    gen = torch.Generator().manual_seed(1)
    heads = [init_gat(GCN_F, GAT_WIDTH, generator=gen, device=dev)
             for _ in range(GAT_HEADS)]
    coo = a_hat.to_coo().astype(np.float32)
    adj, x = coo.to(dev), torch.from_numpy(x_host).to(dev)

    def loss_of(hs, a, xx):
        return multi_head_gat(hs, a, xx).square().mean()

    loss = loss_of(heads, adj, x)
    loss.backward()
    ref_heads = [GATParams(*to_cpu_f64(h)) for h in heads]
    ref_loss = loss_of(ref_heads, coo.astype(np.float64).to("cpu"),
                       torch.from_numpy(x_host.astype(np.float64)))
    ref_loss.backward()
    out = grads_agree("GAT 4 heads", loss.item(), ref_loss.item(),
                      [p.grad for h in heads for p in h],
                      [p.grad for h in ref_heads for p in h])
    out = {f"gat_{key}": val for key, val in out.items()}

    def fwd_bwd():
        loss_of(heads, adj, x).backward()

    ms = step_times(fwd_bwd)
    print(f"GAT {GAT_HEADS} heads {GCN_F} -> {GAT_HEADS}x{GAT_WIDTH} on "
          f"{coo.nnz} edges: forward + backward {ms} ms")
    out.update(gat_fwd_bwd_ms=ms[0], gat_fwd_bwd_ms_range=list(ms))
    return out


def gcn_100k_phase(dev, power, n=100_000) -> None:
    """Phase 8: GCN training on the model benchmark's graph (100,000
    nodes, ``k_nominal = 128`` -> ``BucketedELL``: take-route gathers, no
    hand-written kernel), and one 4-head GAT on it."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        gcn_task,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        BucketedELL,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import auto_format

    t0 = time.perf_counter()
    a_hat, x, labels, mask = gcn_task(n=n)
    t1 = time.perf_counter()
    host = auto_format(a_hat, k_nominal=128)
    t2 = time.perf_counter()
    check(isinstance(host, BucketedELL),
          f"the 100k GCN graph routes to {type(host).__name__}, not "
          "BucketedELL")
    buckets = [tuple(b.vals.shape) for b in host.buckets]
    op = host.astype(torch.float32).to(dev)
    print(f"GCN 100k: graph {a_hat.shape[0]} nodes, {a_hat.nnz} nnz built "
          f"in {t1 - t0:.2f} s; auto_format {t2 - t1:.2f} s -> BucketedELL "
          f"buckets {buckets}")
    res = gcn_train_phase("GCN 100k", dev, a_hat, op, (x, labels, mask))
    res.update(gat_phase(dev, a_hat, x))
    print(json.dumps({"path": "gcn_train_100k_nodes", "nodes": a_hat.shape[0],
                      "nnz": a_hat.nnz, "route": "BucketedELL",
                      "buckets": buckets, **res, "power": power}))


def b1_wide_check(wp, dense, k) -> dict:
    """B2 and B1 at the mesh operand's R = 256 and ``k8 = k``, each against
    its plain version on the same inputs: B2 bit for bit, B1 (on B2's
    plain slabs and the host's dense plane ``dense``) within ``1e-5 *
    cond + 1e-6``, as phase 3 holds them at R = 128; B1 timed, with its
    bound."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_windowed as cw,
    )

    v = torch.from_numpy(generate_fat_vector(wp.shape[1], k, seed=k).astype(
        np.float32)).to(wp.device)
    v_p = wp.encode(v).contiguous()
    slabs = cw.chunk_slabs(v_p, C=wp.chunk_cols, split=True)
    slabs_p = cw.chunk_slabs_plain(v_p, C=wp.chunk_cols, split=True)
    same = (slabs.shape == slabs_p.shape and torch.equal(
        slabs.view(torch.int16), slabs_p.view(torch.int16)))
    print(f"B2 chunk_slabs {tuple(v_p.shape)} -> {tuple(slabs.shape)} "
          f"bitwise_equal={same}")
    check(same, f"B2 at k={k} is not bitwise equal to its plain version")
    ct = wp.tiles_t
    args = (wp.pair_block, wp.pair_chunk, wp.block_ptr, ct, slabs)
    kw = dict(nb=wp.n_blocks, pairs_per_step=wp.pairs_per_step, split=True)

    def plain(t, s):
        return cw.windowed_matmul_tmulti_plain(
            wp.pair_block, wp.pair_chunk, t, s, nb=wp.n_blocks, split=True)

    res = kernel_vs_plain(
        f"B1 windowed_matmul_tmulti R={wp.block_rows} k8={k}",
        lambda: cw.windowed_matmul_tmulti(*args, **kw), plain, dense,
        slabs_p, n=100)
    rest = (nbytes(slabs, wp.pair_chunk, wp.block_ptr)
            + wp.n_blocks * k * wp.block_rows * 4)
    res.update(bound(ct.nbytes + rest, 2 * 2 * ct.nnz * k, "f32"))
    print(f"B1 R={wp.block_rows} k8={k}: {res['ms']} ms, plain "
          f"{res['plain_ms']} ms, bound {res['bound_ms']} ms")
    return res


def gcn_mesh_phase(dev, power, scale=1.0) -> dict:
    """Phase 9: GCN training on the cop20k mesh graph (``k_nominal =
    128`` -> ``WindowedPairs`` R = 256, C = 128, U = 16 with a spill):
    every SpMM, forward and backward at k = 128 and k = 16, is B2 then
    B1. B1 at this operand's R = 256 and k8 = 128, 16 against its plain
    version. Returns B1's numbers at k8 = 128 and the launches per
    training step."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        mesh_gcn_task,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        CompactTiles, WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        to_tensor,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import auto_format

    t0 = time.perf_counter()
    a_hat, x, labels, mask = mesh_gcn_task(f=GCN_F, c=GCN_C, scale=scale)
    t1 = time.perf_counter()
    host = auto_format(a_hat, k_nominal=128)
    t2 = time.perf_counter()
    check(isinstance(host, WindowedPairs),
          f"the mesh GCN graph routes to {type(host).__name__}")
    wp = host.to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    route = windowed_route(wp)
    print(f"GCN mesh: graph {a_hat.shape[0]} nodes, {a_hat.nnz} nnz built "
          f"in {t1 - t0:.2f} s; auto_format {t2 - t1:.2f} s, to(cuda) "
          f"{t3 - t2:.2f} s; route {route}; compact plane "
          f"{wp.tiles_t.nnz} entries, {wp.tiles_t.nbytes} B")
    check(all(route[key] == val for key, val in MESH_ROUTE.items())
          and isinstance(wp.tiles_t, CompactTiles),
          f"unexpected mesh GCN route {route}")
    # the host's dense plane, for B1's plain version: the card's compact
    # plane must be that plane, bit for bit
    dense = to_tensor(host.tiles_t, dev)
    check(torch.equal(wp.tiles_t.to_dense().view(torch.int16),
                      dense.view(torch.int16)),
          "the mesh operand's compact plane is not its host's dense plane")
    del host
    b1 = {k: b1_wide_check(wp, dense, k) for k in (128, 16)}
    del dense
    res = gcn_train_phase("GCN mesh", dev, a_hat, wp, (x, labels, mask),
                          counted_kernels=("B1", "B2"))
    print(json.dumps({"path": "gcn_train_cop20k_mesh",
                      "nodes": a_hat.shape[0], "nnz": a_hat.nnz,
                      "route": route, **res,
                      "b1_r256": {k: {key: b1[k][key] for key in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms")}
                          for k in b1}, "power": power}))
    return b1[128], res["launches_per_step"]


def hub_phase(dev, power, scale=1.0) -> None:
    """Phase 10: the hub route. ``auto_format(dc1_like(), allow_hub=True)``
    at k = 32, f32, must give ``HubExtracted`` with ``HUB_DC1`` (the JAX
    package's pick on the same matrix: 4 hubs over a ``BucketedELL``
    remainder, whose SpMM is the take route, no hand-written kernel); a
    one-shot ``spmm_any`` on the card against the f64 oracle in the f32
    tier, timed beside the library call on the whole matrix."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.hub import (
        HubExtracted,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        dc1_like, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, spmm_any,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.library import (
        spmm_library, to_torch_sparse,
    )

    csr = dc1_like(dtype=np.float32, scale=scale)
    t0 = time.perf_counter()
    host = auto_format(csr, allow_hub=True)
    t1 = time.perf_counter()
    check(isinstance(host, HubExtracted),
          f"dc1 with allow_hub routes to {type(host).__name__}")
    rem_route = {"type": type(host.remainder).__name__}
    check((host.n_hubs, rem_route["type"]) == HUB_DC1,
          f"dc1's hub pick is {host.n_hubs} hubs over {rem_route}, not "
          f"{HUB_DC1}")
    op = host.to(dev)
    print(f"hub: dc1 {csr.shape[0]} rows, {csr.nnz} nnz; auto_format "
          f"(allow_hub) {t1 - t0:.2f} s -> HubExtracted with {op.n_hubs} "
          f"hubs, remainder {rem_route}")
    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    v = torch.from_numpy(v_host).to(dev)
    oracle, cond = oracle_parts(csr, v_host)
    torch.cuda.synchronize()
    reset_counts()
    one = matches_oracle(spmm_any(op, v), oracle, cond, torch.float32)
    torch.cuda.synchronize()
    counts = all_counts()
    ms = cuda_ms(lambda: spmm_any(op, v), 50)
    lib = to_torch_sparse(csr, device=dev)
    lib_ms = cuda_ms(lambda: spmm_library(lib, v), 50)
    print(f"hub one-shot spmm_any correct={one}, {ms} ms; library call on "
          f"the whole matrix {lib_ms} ms; launches {counts}")
    print(json.dumps({"path": "hub_dc1_k32", "n_hubs": op.n_hubs,
                      "remainder": rem_route, "correct": one,
                      "spmm_ms": ms, "library_ms": lib_ms,
                      "launches": counts, "power": power}))
    check(one, "the hub route disagrees with the f64 oracle")


#: The JAX package's routes of ``WindowedRowWise`` on the cop20k stand-in
#: at p = 4 (its CPU run on 4 virtual devices): tile shape, input mode,
#: halo chunks left and right, padded rows per rank.
P4_ROUTES = {16: dict(R=128, C=128, mode="halo", halo=(49, 47),
                      s_loc=30336),
             2: dict(R=256, C=256, mode="halo", halo=(25, 24),
                     s_loc=30464)}
#: The kernel each windowed generation runs after B2 on a rank.
RANK_KERNEL = {(16, "float32"): "B1", (2, "float32"): "B3",
               (2, "bfloat16"): "B4"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strategy_case(label, strat, where, csr, v, oracle, cond, dtype,
                  gathers=(True, False)):
    """One strategy on the mesh ``where``: its prepare (host clock), then
    for each ``gather_result`` one multiply with the launch counts and
    collectives counted, its whole result against the f64 oracle in
    ``dtype``'s tier, and its ms per multiply (CUDA events, after
    warm-up). Returns the operand and the numbers."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.utils import (
        collectives as coll,
    )

    t0 = time.perf_counter()
    op = strat.prepare(csr, where)
    torch.cuda.synchronize()
    out = {"prepare_s": time.perf_counter() - t0}
    for gather in gathers:
        reset_counts()
        coll.reset_collective_stats()
        res = strat.spmm(op, v, gather_result=gather)
        torch.cuda.synchronize()
        launches = {k: n for k, n in all_counts().items() if n}
        stats = coll.collective_stats()
        full = res if gather else strat.gather(op, res, v.shape[1])
        ok = matches_oracle(full, oracle, cond, dtype)
        ms = cuda_ms(lambda: strat.spmm(op, v, gather_result=gather), 20)
        out["gathered" if gather else "sharded"] = {
            "correct": ok, "ms": ms, "launches": launches,
            "collectives": {k: list(c) for k, c in stats.items()}}
        print(f"{label} gather_result={gather}: correct={ok}, {ms} ms per "
              f"multiply; launches {launches}; collectives {stats}")
        check(ok, f"{label} (gather_result={gather}) disagrees with the f64 "
              "oracle")
    return op, out


def collective_costs(mesh, dev) -> dict:
    """What one counted collective costs on the one-rank group, on a
    (121,216, 32) f32 tensor (the cop20k result): its time by CUDA events
    over 50 calls, the host's time to issue one, and the host's time to
    issue one behind ~10 ms of queued device work (``torch.cuda._sleep``:
    near 10 ms if the call waits for the device); beside a device copy
    of the same bytes."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.utils import (
        collectives as coll,
    )

    x = torch.randn((121216, K), device=dev)
    out = {"copy_ms": cuda_ms(lambda: x.clone(), 50)}
    for kind, fn in (("all-gather", lambda: coll.all_gather(x, mesh)),
                     ("all-reduce", lambda: coll.psum(x, mesh)),
                     ("reduce-scatter", lambda: coll.psum_scatter(x, mesh))):
        ms = cuda_ms(fn, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        issue_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        fn()
        behind_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out[kind] = {"ms": ms, "host_issue_ms": issue_ms,
                     "host_ms_behind_10ms_of_work": behind_ms}
    print(f"collectives on the one-rank NCCL group, {x.numel() * 4} B: "
          f"{out}")
    return out


def strategies_phase(dev, power, csr) -> dict:
    """Phase 11: every strategy through a one-rank NCCL group on the card
    at full size (cop20k f32, k = 32; the band strategy on the CG
    system at k = 8), result gathered and not, against the f64 oracle,
    with its ms per multiply beside the one-device ``Auto``'s and its
    collectives; the windowed strategy's launches (1 B2 + 1 B1 at U = 16,
    1 B2 + 1 B3 or B4 at U = 2) a multiply; ``comm_comp_split`` of
    ``RowWise`` and ``WindowedRowWise``; ``dryrun_multichip(1)``. Returns
    each windowed kernel's launches a distributed multiply."""
    import torch
    import torch.distributed as dist

    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        spd_banded_system,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.entry import (
        dryrun_multichip,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import cast
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
        Auto, BandedRowWise, ColumnWise, Grid2D, Library, NonZeroElement,
        RowWise, WindowedRowWise, initialize_distributed, make_mesh,
        make_mesh_2d,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
        comm_comp_split,
    )

    initialize_distributed(rank=0, world_size=1, device="cuda",
                           init_method=f"tcp://127.0.0.1:{free_port()}")
    res, per_multiply = {}, {}
    try:
        mesh, mesh2 = make_mesh(), make_mesh_2d(1, 1)
        check(mesh.size == 1 and mesh.device == dev and
              dist.get_backend() == "nccl", f"unexpected mesh {mesh}")
        res["collective_costs"] = collective_costs(mesh, dev)
        v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(
            np.float32)
        v = torch.from_numpy(v_host).to(dev)
        oracle, cond = oracle_parts(csr, v_host)
        for label, strat, where in (
                ("Auto (one device)", Auto(), mesh),
                ("RowWise", RowWise(), mesh),
                ("ColumnWise", ColumnWise(), mesh),
                ("NonZeroElement psum", NonZeroElement(), mesh),
                ("NonZeroElement scatter", NonZeroElement("scatter"), mesh),
                ("Library", Library(), mesh),
                ("Grid2D 1x1", Grid2D(), mesh2)):
            op, res[label] = strategy_case(label, strat, where, csr, v,
                                           oracle, cond, torch.float32)
            if label == "RowWise":
                res[label]["comm_comp_split_s"] = comm_comp_split(
                    strat, op, v, inner=10)
            del op
        csr_bf = csr.astype(torch.bfloat16)
        oracle_bf, cond_bf = oracle_parts(csr_bf, cast(v_host,
                                                       torch.bfloat16))
        for U, dt in ((16, "float32"), (2, "float32"), (2, "bfloat16")):
            label = f"WindowedRowWise U={U} {dt}"
            bf = dt == "bfloat16"
            strat = WindowedRowWise(pairs_per_step=U)
            op, r = strategy_case(
                label, strat, mesh, csr_bf if bf else csr,
                v.to(torch.bfloat16) if bf else v,
                oracle_bf if bf else oracle, cond_bf if bf else cond,
                torch.bfloat16 if bf else torch.float32)
            r["route"] = dict(R=op.block_rows, C=op.chunk_cols, U=U,
                              mode=op.input_mode, P=op.pairs.n_pairs,
                              nb=op.pairs.n_blocks,
                              spill=op.spill_cols is not None,
                              tail=0 if op.tail_values is None
                              else int(op.tail_values.shape[0]))
            kernel = RANK_KERNEL[(U, dt)]
            for key in ("gathered", "sharded"):
                check(r[key]["launches"] == {"B2": 1, kernel: 1},
                      f"{label}: launches {r[key]['launches']} a multiply, "
                      f"not one B2 and one {kernel}")
            per_multiply.setdefault("B2", 1)
            per_multiply[kernel] = 1
            if U == 16:
                r["comm_comp_split_s"] = comm_comp_split(strat, op, v,
                                                         inner=10)
            print(f"{label}: route {r['route']}")
            res[label] = r
            del op
        t0 = time.perf_counter()
        pick = type(Auto()._mesh_route(csr)).__name__
        res["auto_mesh_route"] = {"pick": pick,
                                  "seconds": time.perf_counter() - t0}
        print(f"Auto's pick on a mesh of several ranks: {pick}")
        spd = spd_banded_system(M_SPD, seed=2)
        vb_host = generate_fat_vector(M_SPD, K_CG, seed=K_CG).astype(
            np.float32)
        o_spd, c_spd = oracle_parts(spd, vb_host)
        op, r = strategy_case("BandedRowWise", BandedRowWise(
            k_nominal=K_CG), mesh, spd, torch.from_numpy(vb_host).to(dev),
            o_spd, c_spd, torch.float32)
        r["route"] = dict(r=op.block_rows, band=list(op.band.shape),
                          spill=op.spill_cols is not None)
        check(r["route"]["band"] == [947, 128, 384]
              and not r["route"]["spill"],
              f"unexpected band route {r['route']}")
        res["BandedRowWise"] = r
        del op
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    reports = dryrun_multichip(1)
    res["dryrun_multichip_1"] = {"seconds": time.perf_counter() - t0,
                                 **reports[0]}
    print(f"dryrun_multichip(1) on the card: {reports[0]}")
    one = res["Auto (one device)"]["gathered"]["ms"]
    for label, r in res.items():
        if "gathered" in r:
            print(f"{label}: {r['gathered']['ms']} ms gathered, "
                  f"{r['sharded']['ms']} ms sharded per multiply; the "
                  f"one-device Auto {one} ms")
    print(json.dumps({"path": "strategies_world_size_1", "k": K,
                      "strategies": res, "power": power}))
    return per_multiply


def rank_kernels_phase(dev, power, csr, p=4) -> dict:
    """Phase 12: the per-rank kernels at the shapes of a p = 4 mesh, one
    rank after another in this process. ``WindowedRowWise().partition(
    csr, 4)`` (U = 16) and the U = 2 f32 partition, each checked against
    the JAX package's route; for every rank: its card copy's compact
    plane bit for bit its host plane, its halo window cut on the host,
    B2 on it bit for bit its plain version, B1 (U = 16) or B3 (U = 2)
    within ``1e-5 * cond + 1e-6`` of the plain version on the host's
    dense plane and timed beside its bound, and its rows (spill and
    row-owned tail included); the four row blocks, decoded, against the
    f64 oracle. Returns each kernel's per-rank numbers."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        to_tensor,
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
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
        WindowedRowWise,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel.windowed_strategy \
        import rank_rows, rank_window

    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    oracle, cond_all = oracle_parts(csr, v_host)
    out = {}
    for U in (16, 2):
        kernel = RANK_KERNEL[(U, "float32")]
        t0 = time.perf_counter()
        shards = WindowedRowWise(pairs_per_step=U).partition(csr, p)
        part_s = time.perf_counter() - t0
        h = shards[0]
        route = dict(R=h.block_rows, C=h.chunk_cols, mode=h.input_mode,
                     halo=(h.halo_left, h.halo_right), s_loc=h.s_loc)
        print(f"p={p} U={U} partition {part_s:.2f} s: route {route}, "
              f"{h.pairs.n_pairs} pairs and {h.pairs.n_blocks} blocks a "
              f"rank, spill {h.spill_cols is not None}, tail "
              f"{0 if h.tail_values is None else len(h.tail_values)} a rank")
        check(route == P4_ROUTES[U], f"U={U}: route {route}, not the JAX "
              f"package's {P4_ROUTES[U]}")
        v_pad = torch.zeros((p * h.s_loc, K), dtype=torch.float32,
                            device=dev)
        perm = torch.from_numpy(h.perm).long().to(dev)
        v_pad[: csr.shape[0]] = torch.from_numpy(v_host).to(dev)[perm]
        rows, ranks = [], []
        for d, host in enumerate(shards):
            op = host.to(dev)
            hp, cp = host.pairs, op.pairs
            plane = cp.tiles_t if U > 2 else cp.tiles_split
            dense = to_tensor(hp.tiles_t if U > 2 else hp.tiles_split, dev)
            check(isinstance(plane, CompactTiles) and torch.equal(
                plane.to_dense().view(torch.int16), dense.view(torch.int16)),
                f"rank {d} U={U}: the card's compact plane is not its host "
                "plane")
            window = rank_window(host, v_pad, d)
            slabs = cw.chunk_slabs(window, C=host.chunk_cols, split=True)
            slabs_p = cw.chunk_slabs_plain(window, C=host.chunk_cols,
                                           split=True)
            check(torch.equal(slabs.view(torch.int16),
                              slabs_p.view(torch.int16)),
                  f"rank {d} U={U}: B2 differs from its plain version")
            nb = cp.n_blocks
            if U > 2:
                def run():
                    return cw.windowed_matmul_tmulti(
                        cp.pair_block, cp.pair_chunk, cp.block_ptr, plane,
                        slabs, nb=nb, pairs_per_step=U, split=True)

                def plain(t, s):
                    return cw.windowed_matmul_tmulti_plain(
                        cp.pair_block, cp.pair_chunk, t, s, nb=nb,
                        split=True)
            else:
                def run():
                    return cw.windowed_matmul_split3(
                        cp.pair_block, cp.pair_chunk, cp.block_ptr, plane,
                        slabs, nb=nb)

                def plain(t, s):
                    return cw.windowed_matmul_split3_plain(
                        cp.pair_block, cp.pair_chunk, t, s, nb=nb)
            r = kernel_vs_plain(f"rank {d} {kernel} U={U}", run, plain,
                                dense, slabs_p, n=100)
            out_bytes = nb * host.block_rows * K * 4
            r.update(bound(plane.nbytes + nbytes(slabs, cp.pair_chunk,
                                                 cp.block_ptr) + out_bytes,
                           2 * 2 * plane.nnz * K, "f32"))
            runs = np.diff(hp.block_ptr)
            r.update(rank=d, pairs=cp.n_pairs, entries=plane.nnz,
                     plane_bytes=plane.nbytes, window_rows=window.shape[0],
                     empty_pairs=int((np.diff(
                         plane.pair_nz_ptr.cpu().numpy()) == 0).sum()),
                     last_block_pairs=int(runs[-1]),
                     max_other_block_pairs=int(runs[:-1].max(initial=0)))
            print(f"rank {d} {kernel}: {r['ms']} ms, plain {r['plain_ms']} "
                  f"ms, bound {r['bound_ms']} ms ({plane.nnz} entries, "
                  f"{plane.nbytes} B of plane; {r['empty_pairs']} of its "
                  f"{cp.n_pairs} pairs empty, {r['last_block_pairs']} on "
                  f"its last block, at most {r['max_other_block_pairs']} on "
                  "another)")
            ranks.append(r)
            rows.append(rank_rows(op, window))
            del op, dense, slabs, slabs_p
        got = shards[0].to(dev).decode(torch.cat(rows))
        ok = matches_oracle(got, oracle, cond_all, torch.float32)
        print(f"p={p} U={U}: the {p} row blocks assembled and decoded "
              f"correct={ok}")
        check(ok, f"p={p} U={U}: the assembled rows disagree with the f64 "
              "oracle")
        out[kernel] = {"route": route, "partition_s": part_s,
                       "correct": ok, "ranks": ranks}
        del shards
    print(json.dumps({"path": "rank_kernels_p4_cop20k_k32", **{
        k: {**v, "ranks": [{key: r[key] for key in (
            "rank", "ms", "plain_ms", "bound_ms", "max_abs_err", "pairs",
            "entries", "empty_pairs", "last_block_pairs",
            "max_other_block_pairs")} for r in v["ranks"]]}
            for k, v in out.items()},
        "power": power}))
    return out


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
    phase_s, t_phase = {}, time.perf_counter()
    _kernel_lib.load_library()
    info = _kernel_lib.build_info
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    print(info["ptxas"])

    phase_s["1"] = time.perf_counter() - t_phase

    # 2. operand
    t_phase = t0 = time.perf_counter()
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

    phase_s["2"] = time.perf_counter() - t_phase

    # 3. kernels against their plain versions
    t_phase = time.perf_counter()
    timings = kernel_phase(wp, v)
    spans_blocks_case(dev)

    phase_s["3"] = time.perf_counter() - t_phase

    # 4. main path, counted
    t_phase = time.perf_counter()
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

    phase_s["4"] = time.perf_counter() - t_phase

    # 5. solver path
    t_phase = time.perf_counter()
    kernels.append(solver_phase(dev, power))
    phase_s["5"] = time.perf_counter() - t_phase

    # 6. two-pair path (B3, B4, B7), 7. phased chain (B6)
    t_phase = time.perf_counter()
    kernels.extend(two_pair_phase(dev, csr, power))
    phase_s["6"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    kernels.append(phased_phase(dev, csr, power))
    phase_s["7"] = time.perf_counter() - t_phase
    del csr

    # 8. GCN training on the model benchmark's graph, and a GAT;
    # 9. on the cop20k mesh graph (B2 + B1 under autograd); 10. hub route
    t_phase = time.perf_counter()
    gcn_100k_phase(dev, power)
    b1_r256, per_step = gcn_mesh_phase(dev, power)
    hub_phase(dev, power)
    phase_s["8-10"] = time.perf_counter() - t_phase

    # 11. the strategies on one NCCL rank; 12. the kernels of a p = 4
    # mesh's ranks, one after another
    t_phase = time.perf_counter()
    csr = cop20k_like(dtype=np.float32)
    per_multiply = strategies_phase(dev, power, csr)
    phase_s["11"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    p4 = rank_kernels_phase(dev, power, csr)
    phase_s["12"] = time.perf_counter() - t_phase
    del csr
    for e in kernels:
        name = e["name"].split()[0]
        if name in per_multiply:
            e["distributed"] = {"launches_per_multiply": per_multiply[name]}
        if name in p4:
            e.setdefault("distributed", {})["p4_ranks"] = [
                {key: r[key] for key in (
                    "rank", "ms", "plain_ms", "bound_ms", "max_abs_err")}
                for r in p4[name]["ranks"]]
    print(f"phase wall seconds {json.dumps(phase_s)}")
    for e in kernels:
        if e["name"].split()[0] in per_step:
            e["gcn_mesh_launches_per_step"] = per_step[e["name"].split()[0]]
        if e["name"].split()[0] == "B1":
            e["r256_k128"] = {key: b1_r256[key] for key in ENTRY_KEYS[:5]}
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

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
   amortized ``run_benchmark(inner=20)`` through ``Auto()``, which
   prices the card's route with the H100 cost table (its route is
   printed), both checked against the host float64 oracle; the counts
   must show B2 and one B1 per body call;
Phases 2-3 build the operand on the host with the reference's cost
table, and phases 5-12 pass it to their builds (``cost_table=V5E``):
they drive each kernel at the shape ``PERF.md`` records. Every multiply
on the card routes by the card's dispatch gates
(``formats/cost.py::dispatch_table``), whatever table built its operand;

5. solver path: the JAX package's model-benchmark CG system
   (``spd_banded_system(121,192)``, f32, 8 right-hand sides) through
   ``Auto(k_nominal=8)`` -> ``BandedBlocks`` (r = 128, no spill, 947
   blocks) -> kernel B5. ``band_kernel``'s ``-Xptxas -v`` lines; B5
   against its plain version (``1e-5 * cond + 1e-6``, plus one bf16 ulp
   for a bf16 band) at k = 1, 8, 32 and 128 in f32 and k = 32 in bf16,
   each timed beside its bound (bytes, or its 3xTF32 / bf16 products on
   the tensor cores), its plain version, ``spmm_banded`` (the batched
   matmuls) and ``torch.sparse.mm`` on the band's nonzeros (B5 must beat
   the last two at k = 32 and take at most 0.100 ms at k = 8), and on a
   spill operand; a one-shot
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
   ``spmm_any`` (the spill through B7, the card's dispatch, one B7
   launch a call) and the amortized ``run_benchmark`` (encode, iterate =
   B2 + B3 + B7 spill, decode), each against the f64 oracle, and the path's peak device
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
   k_nominal=128)`` -> ``BucketedELL``, one B7 launch an SpMM) through the
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
   phase 8, with exactly 4 B1, 4 B2 and 4 B7 (the spill) launches a
   training step (the forward and backward SpMMs at k = 128 and 16) and
   no other kernel;
10. the hub route: ``auto_format(dc1_like(), allow_hub=True)`` at k = 32,
   f32, must give ``HubExtracted`` with the JAX package's pick on that
   matrix (4 hubs over a ``BucketedELL`` remainder, gathered through
   B7 on the card); a one-shot ``spmm_any`` on the card
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
   decoded, against the f64 oracle;
13. the command line (``cli.py``) on the card: ``info`` in a
   subprocess that must name the card and import no JAX; ``run
   synthetic:cop20k --k 32 --strategy all --json`` in this process with
   the counts zeroed (every phrase line, "Results are the same!" for
   every strategy, five correct records naming the card, one B2 and one
   B1 per ``auto`` and ``column`` multiply, each strategy's ms beside
   phase 11's one-rank figure); ``reorder synthetic:cop20k`` to a
   2.6 M-entry ``.mtx`` read back bit for bit by the native parser (and
   timed beside the numpy parser), and
   ``run`` of it ``--strategy auto --amortized`` (one B1 a chain body,
   one B2); ``convert synthetic:banded --format banded`` (r = 128, no
   spill) and ``run`` of the ``.npz`` (one B5 a multiply of
   ``_run_prepared``; the file, loaded outside the command, through
   ``spmm_any`` on the card against the f64 oracle); ``sweep
   synthetic:cop20k_small --k 8 32`` (auto, library, row) with a CSV
   checkpoint and again with ``--resume`` (no job runs), ``read_csv``
   giving back its records, ``render_report`` naming the card, its
   ``suspicious_records``; and the dense views (``dense_views_check``):
   ``to_dense`` of a card copy of CSR, COO, ELL, BucketedELL,
   BandedBlocks and windowed U = 16 and U = 2 operands of small
   matrices, f32 and bf16, bit for bit the host's (an f32 windowed copy
   holds only its kernels' hi|lo planes: the host's view of those planes
   bit for bit, the host operand's within 2**-16), ``spmm_dense`` of
   each against the f64 oracle;
14. narrow k on the kernels (a k that is not a multiple of 8 is
   zero-padded to 8 on the card; the reference took its dense plain
   route below k = 12): PageRank at k = 1 on the models benchmark's
   cop20k graph (``auto_format(k_nominal=1)`` -> ``WindowedPairs``
   U = 16): B2 bit for bit and B1 against their plain versions at
   k8 = 8, then with the counts zeroed one B2 and one B1 an iteration
   and nothing else, a peak device memory far below one dense plane,
   the ranks within 1e-4 of each rank of a host float64 power iteration
   and summing to 1, while the same iteration on the matrix rounded to
   bf16 (a B1 without its lo plane) misses that limit, ms per iteration (the 10/60 slope) beside one
   multiply by the kernels and by the old plain route; ``spmm_any`` at
   k in {1, 3, 6, 9} on the cop20k stand-in's U = 16, U = 2 f32 and
   U = 2 bf16 operands (and the U = 16 transposed chain) against the
   f64 oracle with one B2 and one B1 / B3 / B4 a call, B3 and B4
   against their plain versions at k8 = 8; ``scripts.run_models_bench``
   (all checks passed), ``scripts.run_results_sweep`` cut to cop20k at
   k = 1 and 32 (auto and the bf16 row: all correct on the card) and
   resumed with no job run again, ``spmm(csr, v)``, and
   the three ``examples/torch_0*`` scripts with ``--device cuda``; each
   model's printed route launching its format's kernels, CG through its
   pick within 1.25x of CG through the band (B5) in the same run,
   ``spmm`` one launch of each kernel of its route (alone with
   ``--phase 14``);
15. routing on the card (``routing_phase``; alone with ``--phase 15``):
   for each matrix of the results sweep's ``MAIN`` family at k = 1 and
   32 (the gather calibration's own matrices), then matrices held out
   of every calibration (the models benchmark's CG system at k = 8, the
   six rungs of ``exp_auto_threshold``'s ladder at k = 32), every class
   the search weighs under the card's cost table
   (``ops/auto.py::route_candidates``: bucketed ELL, COO, the best
   ``WindowedPairs``, ``BandedBlocks`` where one builds), its ``Auto``
   chain checked against the f64 oracle and one chain body timed; each
   class's H100 estimate beside its time, and the pick (the cheapest
   estimate, ``auto_format(csr, device=cuda)``'s) within 1.25x of the
   fastest.

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
15, each phase's wall seconds, one with the kernels (B1 and B2 also
with their launches per mesh GCN step, B1 with its R = 256, k8 = 128
check; B1 to B4 with their launches a distributed multiply, B1 and B3
with their per-rank numbers at p = 4; B1, B2 and B5 with their
launches in phase 13's command-line runs; B1 to B4 with their k8 = 8
numbers and launches of phase 14), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line,
when any phase fails or no CUDA device is present. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
#: (dtype name, k) at which phase 5 checks and times B5 on the CG band.
B5_WIDTHS = (("float32", 1), ("float32", K_CG), ("float32", 32),
             ("float32", 128), ("bfloat16", 32))
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

    tiles, pair_block, pair_chunk = wp.plain_pairs()
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


def band_ptxas() -> str:
    """``-Xptxas -v``'s lines for B5's ``band_kernel`` (registers, stack,
    spills, static shared memory), from this process's build."""
    from sparsematrixmultiplicationmpi_tpu_torch.ops import _kernel_lib

    lines = _kernel_lib.build_info.get("ptxas", "").splitlines()
    out = []
    for j, line in enumerate(lines):
        if "band_kernel" in line and "Compiling entry" in line:
            out.append(line)
            for nxt in lines[j + 1: j + 4]:
                if "Compiling entry" in nxt:
                    break
                out.append(nxt)
    return "B5 ptxas:\n" + ("\n".join(out) or "(no band_kernel lines: "
                             f"{_kernel_lib.build_info.get('ptxas')!r})")


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
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E

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
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        _kernel_lib, cuda_banded as cb,
    )
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
    op = Auto(k_nominal=K_CG, cost_table=V5E).prepare(spd, dev)
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

    # 5.2 B5 against its plain version and timed, at the widths around
    # its column chunk: f32 at k = 1, 8, 32 and 128, bf16 at k = 32
    print(band_ptxas())
    # The band's nonzeros: band[b, i, w] is A[b*r + i, (b-1)*r + w].
    _, r, _ = op.band.shape
    bi, i, w = torch.nonzero(op.band, as_tuple=True)
    rows, cols = bi * r + i, (bi - 1) * r + w
    keep = (rows < m) & (cols >= 0) & (cols < m)
    nz_rows, nz_cols, nz_vals = rows[keep], cols[keep], op.band[bi, i, w][keep]
    del bi, i, w, rows, cols, keep
    errs, widths, ms = [], [], {}
    for name, k in B5_WIDTHS:
        dtype = getattr(torch, name)
        f32 = dtype == torch.float32
        band = op.band.to(dtype)
        op_d = dataclasses.replace(op, band=band)
        v = torch.from_numpy(generate_fat_vector(m, k, seed=k).astype(
            np.float32)).to(dev, dtype)
        got = cb.band_matmul(band, v, m=m)
        want = cb.band_matmul_plain(band, v, m=m)
        cond = cb.band_matmul_plain(band.float().abs(), v.float().abs(), m=m)
        diff = (got.float() - want.float()).abs()
        # Both sum f32 products in another order; a bf16 result is rounded
        # once on each side, one bf16 ulp apart at most.
        tol = B1_RTOL * cond + B1_ATOL
        if not f32:
            tol = tol + 2.0 ** -7 * want.float().abs()
        excess, err = float((diff - tol).max()), float(diff.max())
        del got, want, cond, diff, tol
        a_csr = sparse_csr(nz_rows, nz_cols, nz_vals.to(dtype), (m, m))
        nums = {"dtype": str(dtype).split(".")[-1], "k": k,
                "max_abs_err": err, "tolerance_excess": excess,
                "ms": cuda_ms(lambda: cb.band_matmul(band, v, m=m), 200),
                "plain_ms": cuda_ms(lambda: cb.band_matmul_plain(
                    band, v, m=m), 50),
                "spmm_banded_ms": cuda_ms(lambda: spmm_banded(op_d, v), 50),
                # band, v and the output; f32 products in 3xTF32 (three
                # TF32 products each) on the tensor cores, bf16 in bf16.
                **bound(nbytes(band, v) + m * k * band.element_size(),
                        (3 if f32 else 1) * 2 * band.numel() * k,
                        "tf32" if f32 else "bf16"),
                "library_ms": library_ms(f"B5 {dtype} k={k}", a_csr, v, 200),
                "smem_bytes": _kernel_lib.load_library().band_smem(
                    r, k, cb.BAND_K_CHUNK, 0 if f32 else 1)}
        nums["bound_share"] = nums["bound_ms"] / nums["ms"]
        del a_csr, op_d, band, v
        print(f"B5 band_matmul band {tuple(op.band.shape)} "
              f"{json.dumps(nums)}")
        check(excess <= 0, f"B5 outside tolerance of its plain version, "
              f"{dtype} k={k}")
        if f32:  # the entry's error; a bf16 width's is in its own row
            errs.append(err)
        widths.append(nums)
        if f32 and k == K_CG:
            ms = {key: nums[key] for key in ENTRY_KEYS[1:]}
    del nz_rows, nz_cols, nz_vals
    by = {(x["dtype"], x["k"]): x for x in widths}
    k32 = by["float32", 32]
    check(k32["ms"] < k32["spmm_banded_ms"] and k32["ms"] < k32["library_ms"],
          f"B5 at k = 32 ({k32['ms']} ms) not faster than spmm_banded "
          f"({k32['spmm_banded_ms']}) and torch.sparse.mm "
          f"({k32['library_ms']})")
    check(by["float32", K_CG]["ms"] <= 0.100,
          f"B5 at k = {K_CG} took {by['float32', K_CG]['ms']} ms > 0.100")
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
    rec = run_benchmark(spd, K_CG, Auto(k_nominal=K_CG, cost_table=V5E),
                        dev,
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
                 {"max_abs_err": max(errs), **ms}, widths=widths)


def counted_auto(**format_kwargs):
    """An ``Auto(**format_kwargs)`` whose chain bodies are counted in its
    ``body_calls``, and which keeps the route of its last prepared operand
    in ``route``."""
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto

    class CountedAuto(Auto):
        body_calls = 0
        route = None

        def prepare(self, csr, mesh):
            op = super().prepare(csr, mesh)
            self.route = {"type": type(op).__name__}
            if hasattr(op, "pairs_per_step"):
                self.route.update(R=op.block_rows, C=op.chunk_cols,
                                  U=op.pairs_per_step, P=op.n_pairs,
                                  spill=op.spill is not None)
            return op

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
    B3, spill by B7, the take route held against it) and bf16 (B2 + B4). Returns the B3, B4
    and B7 entries of the kernels line."""
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E

    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        run_benchmark,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import cast
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_gather as cg, cuda_windowed as cw,
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
    # The card's dispatch gathers the spill through B7 (the take route is
    # held against it bucket by bucket in spill_gather_phase).
    one_dma = matches_oracle(spmm_any(wp, v), oracle, cond, torch.float32)
    del wp, v_p
    strat = counted_auto(pairs_per_step=2, cost_table=V5E)
    rec = run_benchmark(csr, K, strat, dev, matrix_name="cop20k_like",
                        warmup=2, iters=5, oracle=oracle, check=True,
                        dtype=np.float32, amortized=True, inner=20)
    torch.cuda.synchronize()
    counts = {**cw.launch_counts(), **cg.launch_counts()}
    plane_f32["peak_device_memory"] = torch.cuda.max_memory_allocated()
    print(f"two-pair f32 one-shot spmm_any (spill by B7): correct={one_dma};"
          f" amortized {rec.execution_time * 1e3}"
          f" ms per multiply, {rec.gnnz_per_s} Gnnz/s, correct={rec.correct}"
          f"; launch counts {counts}; chain body calls {strat.body_calls}")
    check(one_dma, "two-pair one-shot disagrees with the oracle")
    check(rec.correct is True, "two-pair amortized path disagrees with oracle")
    check(rec.execution_time == rec.execution_time,
          "two-pair chained iterate time did not resolve")
    calls = 1 + strat.body_calls
    # One B7 launch for the whole spill of each call.
    check(strat.body_calls > 0 and counts["B3"] == calls
          and counts["B2"] == calls and counts["B7"] == calls
          and counts["B1"] == counts["B4"] == counts["B6"] == 0,
          f"two-pair launch counts {counts} != {calls} B2/B3/B7 (1 one-shot"
          f" + {strat.body_calls} bodies)")
    f32 = {"gnnz_per_s": rec.gnnz_per_s, "execution_time_s":
           rec.execution_time, "correct": rec.correct,
           "one_shot_b7_correct": one_dma,
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
    strat = counted_auto(pairs_per_step=2, cost_table=V5E)
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
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E

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
    wp = Auto(phase_layout=True, cost_table=V5E).prepare(csr, dev)
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
    strat = counted_auto(phase_layout=True, cost_table=V5E)
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
    nodes, ``k_nominal = 128`` -> ``BucketedELL``: one B7 launch an SpMM,
    the card's dispatch), and one 4-head GAT on it."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        gcn_task,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        BucketedELL,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, route_kernels,
    )

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
    res = gcn_train_phase("GCN 100k", dev, a_hat, op, (x, labels, mask),
                          counted_kernels=route_kernels(op, 128))
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
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, route_kernels,
    )

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
                          counted_kernels=route_kernels(wp, 128))
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
    remainder, gathered through B7 on the card); a
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
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E

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
                ("Auto (one device)", Auto(cost_table=V5E), mesh),
                ("RowWise", RowWise(), mesh),
                ("ColumnWise", ColumnWise(cost_table=V5E), mesh),
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
            strat = WindowedRowWise(pairs_per_step=U, cost_table=V5E)
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
        pick = type(Auto(cost_table=V5E)._mesh_route(csr)).__name__
        res["auto_mesh_route"] = {"pick": pick,
                                  "seconds": time.perf_counter() - t0}
        print(f"Auto's pick on a mesh of several ranks: {pick}")
        spd = spd_banded_system(M_SPD, seed=2)
        vb_host = generate_fat_vector(M_SPD, K_CG, seed=K_CG).astype(
            np.float32)
        o_spd, c_spd = oracle_parts(spd, vb_host)
        op, r = strategy_case("BandedRowWise", BandedRowWise(
            k_nominal=K_CG, cost_table=V5E), mesh, spd,
            torch.from_numpy(vb_host).to(dev),
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
    return per_multiply, {label: r["gathered"]["ms"]
                          for label, r in res.items() if "gathered" in r}


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
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E

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
        shards = WindowedRowWise(pairs_per_step=U,
                                 cost_table=V5E).partition(csr, p)
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


#: One strategy's label in ``spmm-torch run``'s output, the one-rank
#: label of phase 11, and its canonical name.
CLI_STRATEGIES = (("Row-wise", "RowWise", "row_wise"),
                  ("Column-wise", "ColumnWise", "column_wise"),
                  ("Non-zero Elements", "NonZeroElement psum", "nnz"),
                  ("Library", "Library", "library"),
                  ("Auto", "Auto (one device)", "auto"))
NUM = r"[0-9.eE+-]+"


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` in this process: (exit code, its stdout), the
    output echoed."""
    import contextlib
    import io

    from sparsematrixmultiplicationmpi_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print(f"$ spmm-torch {' '.join(argv)}  (rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s)")
    print(out, end="")
    return rc, out


def dense_views_check(dev) -> dict:
    """Phase 13's dense views: ``to_dense`` of a card copy of each format,
    f32 and bf16, on small matrices, against the host operand's: bit for
    bit, but where an f32 windowed copy holds only its kernels' bf16
    hi|lo planes (``card_planes``), whose view is the host's view of the
    same planes bit for bit and the host operand's within 2**-16 of each
    value; ``spmm_dense`` of each card copy in ``v``'s dtype on the card,
    within 1e-4 (f32) or 2e-2 (bf16) of the f64 oracle relative to its
    largest output."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats import (
        BandedBlocks, BucketedELL, ELL, CompactTiles, WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        banded_csr, generate_fat_vector, powerlaw_csr,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import (
        spmm_dense, spmm_host_f64,
    )

    t0 = time.perf_counter()
    pl = powerlaw_csr(2000, 2000, 20000, seed=7).astype(np.float32)
    band = banded_csr(400, 6, 4, seed=3).astype(np.float32)
    windowed = {u: WindowedPairs.from_csr(
        pl, block_rows=128, chunk_cols=128, pairs_per_step=u,
        beat_gather_margin=np.inf) for u in (16, 2)}
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        csr, bcsr = pl.astype(dtype), band.astype(dtype)
        ops = {"CSR": (csr, csr), "COO": (csr.to_coo(), csr),
               "ELL": (ELL.from_csr(csr), csr),
               "BucketedELL": (BucketedELL.from_csr(csr), csr),
               "BandedBlocks": (BandedBlocks.from_csr(bcsr, block_rows=8),
                                bcsr),
               **{f"WindowedPairs U={u}": (w.astype(dtype), csr)
                  for u, w in windowed.items()}}
        for name, (host, src) in ops.items():
            card = host.to(dev)
            got, want = card.to_dense(), host.to_dense()
            split_only = isinstance(host, WindowedPairs) and (
                card.split and card.tiles is None)
            if isinstance(host, WindowedPairs):
                check(isinstance(card.tiles_t if host.pairs_per_step > 2
                                 else card.natural_plane, CompactTiles),
                      f"dense views: {name} {dtype} holds no compact plane")
                same = host.card_planes().to("cpu").to_dense()
            else:
                same = want
            bitwise = got.dtype == np.float32 and np.array_equal(got, same)
            close = bool(np.all(np.abs(got - want) <= (
                2.0 ** -16 * np.abs(want) if split_only else 0)))
            v = torch.from_numpy(generate_fat_vector(
                src.shape[1], 4, seed=2).astype(np.float32)).to(dev, dtype)
            out = spmm_dense(card, v)
            ref = spmm_host_f64(src, v.float().cpu().numpy())
            err = float(np.abs(out.float().cpu().numpy() - ref).max()
                        / np.abs(ref).max())
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            label = f"{name} {str(dtype).removeprefix('torch.')}"
            res[label] = {"bitwise": bool(bitwise), "split_only": split_only,
                          "spmm_dense_rel_err": err}
            check(bitwise and close and out.dtype == dtype
                  and out.device == v.device and err < tol,
                  f"dense views: {label}: bitwise={bitwise} close={close} "
                  f"spmm_dense {out.dtype} on {out.device}, rel err {err}")
    print(f"dense views of card copies: {len(res)} operands bit for bit "
          f"({time.perf_counter() - t0:.1f} s): {res}")
    return res


def cli_phase(dev, power, kind, one_rank_ms) -> dict:
    """Phase 13: the port's command line on the card. ``info`` in a
    subprocess that imports no JAX; ``run synthetic:cop20k --k 32
    --strategy all`` in this process, counted (every phrase line, every
    strategy "Results are the same!", five correct records naming the
    card, B1 and B2 once per ``auto`` and ``column`` multiply, each
    strategy's ms beside phase 11's one-rank figure); ``reorder`` to a
    2.6 M-entry ``.mtx`` and ``run`` of it ``--amortized`` (the native
    parser, timed beside the numpy parser, the loaded CSR bit for bit
    the reordered generator's, one B1 a chain body); ``convert
    synthetic:banded --format banded`` and ``run`` of the file (one B5
    a call of ``_run_prepared``; the file loaded outside the command
    against the f64 oracle); a small
    ``sweep`` with a CSV checkpoint, run again with ``--resume`` (no job
    runs), its CSV read back, its report and its suspicious rows.
    Returns B1, B2 and B5's launches in these runs."""
    import re
    import tempfile

    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        read_csv, suspicious_records,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.bench.report import (
        render_report,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        to_tensor,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.reorder import (
        apply_symmetric_permutation, rcm_ordering,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.serialize import (
        load_format,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io import native
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        banded_csr, cop20k_like, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.mtx import (
        read_matrix_market, read_matrix_market_numpy,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import auto as ops_auto
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import strategies

    res, launches = {"dense_views": dense_views_check(dev)}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # info, in a process of its own that must not import JAX
        code = ("import runpy, sys\n"
                "try:\n"
                "    runpy.run_module('sparsematrixmultiplicationmpi_tpu_"
                "torch.cli', run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "print('jax imported:', 'jax' in sys.modules)\n"
                "sys.exit(rc)\n")
        info = subprocess.run([sys.executable, "-c", code, "info"],
                              capture_output=True, text=True, timeout=300)
        print(f"$ python -m sparsematrixmultiplicationmpi_tpu_torch.cli info"
              f"  (rc {info.returncode})\n{info.stdout}{info.stderr}", end="")
        check(info.returncode == 0 and f"] {kind}" in info.stdout
              and "jax imported: False" in info.stdout,
              "cli info did not name the card, failed, or imported jax")

        # run --strategy all at full size, counted
        path = f"{tmp}/run.json"
        reset_counts()
        rc, out = run_cli(["run", "synthetic:cop20k", "--k", str(K),
                           "--strategy", "all", "--json", path])
        counts = all_counts()
        check(rc == 0, f"run --strategy all exited {rc}")
        for pattern in (
                r"World size: 1", r"Sparse matrix: synthetic:cop20k",
                r"Matrix size: 121192x121192", rf"Vector size: 121192x{K}",
                r"Non-zero elements: 2624330", rf"Load time: {NUM} s",
                rf"Serial Algo Execution time: {NUM} s"):
            check(re.search(rf"^{pattern}$", out, re.M) is not None,
                  f"run: no line {pattern!r}")
        per_strategy = {}
        for label, one_rank, _ in CLI_STRATEGIES:
            m = re.search(rf"^{label} Execution time: ({NUM}) s \({NUM} "
                          rf"Gnnz/s, {NUM} GFLOP/s, {NUM}% of roofline\)$",
                          out, re.M)
            check(m is not None, f"run: no timed line for {label}")
            check(f"\n{label}: Results are the same!\n" in out,
                  f"run: {label} is not 'Results are the same!'")
            ms = float(m.group(1)) * 1e3
            per_strategy[label] = {"ms": ms,
                                   "phase11_one_rank_ms":
                                   one_rank_ms[one_rank]}
            print(f"cli {label}: {ms} ms per multiply (best of 5 one-shot "
                  f"calls); phase 11 one rank {one_rank_ms[one_rank]} ms "
                  "(mean of 20)")
        with open(path) as f:
            payload = json.load(f)
        recs = payload["records"]
        check([r["strategy"] for r in recs] ==
              [name for _, _, name in CLI_STRATEGIES]
              and all(r["correct"] is True and r["device_kind"] == kind
                      for r in recs),
              "run --json: records " + str([(r["strategy"], r["correct"],
                                             r["device_kind"]) for r in recs]))
        # time_fn: two warm-up and five timed calls a strategy; auto and
        # column each run B2 then B1 a call.
        calls = 2 * (2 + 5)
        print(f"cli run --strategy all launches {counts}; {calls} multiplies"
              " by auto and column")
        check(counts["B1"] == counts["B2"] == calls,
              f"B1 {counts['B1']}, B2 {counts['B2']} launches, not one "
              f"each for the {calls} auto and column multiplies")
        launches["run_all"] = {"B1": counts["B1"], "B2": counts["B2"],
                               "multiplies": calls}
        res["run_all"] = {"strategies": per_strategy, "load_time_s": float(
            re.search(rf"^Load time: ({NUM}) s$", out, re.M).group(1))}

        # reorder to a 2.6 M-entry .mtx, run it amortized through the
        # native parser
        mtx = f"{tmp}/cop20k.mtx"
        rc, out = run_cli(["reorder", "synthetic:cop20k", mtx])
        check(rc == 0, f"reorder exited {rc}")
        check(native.available(), "the native .mtx parser did not build")
        want = cop20k_like()
        want = apply_symmetric_permutation(want, rcm_ordering(want))
        t0 = time.perf_counter()
        got = read_matrix_market(mtx)
        parse_s = time.perf_counter() - t0
        check(all(np.array_equal(getattr(got, f), getattr(want, f))
                  and getattr(got, f).dtype == getattr(want, f).dtype
                  for f in ("values", "col_indices", "row_ptr"))
              and got.shape == want.shape,
              "the .mtx read back differs from the reordered generator CSR")
        t0 = time.perf_counter()
        got = read_matrix_market_numpy(mtx)
        numpy_parse_s = time.perf_counter() - t0
        check(all(np.array_equal(getattr(got, f), getattr(want, f))
                  for f in ("values", "col_indices", "row_ptr")),
              "the numpy parser reads the .mtx differently")
        print(f"reorder: {want.nnz} entries written, read back bit for bit "
              f"by the native parser in {parse_s} s, by the numpy parser in "
              f"{numpy_parse_s} s")
        del got, want
        bodies, route = [0], {}

        class CountedAuto(strategies.Auto):
            def chain_parts(self, operand, mesh=None, **kwargs):
                route.update(type=type(operand).__name__,
                             U=getattr(operand, "pairs_per_step", None))
                enc, body, dec = super().chain_parts(operand, mesh, **kwargs)

                def counted(x, op):
                    bodies[0] += 1
                    return body(x, op)

                return enc, counted, dec

        reset_counts()
        strategies.STRATEGIES["auto"] = CountedAuto
        try:
            rc, out = run_cli(["run", mtx, "--k", str(K), "--strategy",
                               "auto", "--amortized"])
        finally:
            strategies.STRATEGIES["auto"] = strategies.Auto
        counts = all_counts()
        check(rc == 0 and "Auto: Results are the same!" in out,
              f"run {mtx} --amortized failed (rc {rc})")
        print(f"cli run .mtx --amortized: route {route}, launches "
              f"{counts}; chain bodies {bodies[0]}")
        check(counts["B1"] == bodies[0] > 0 and counts["B2"] == 1,
              f"B1 {counts['B1']} launches for {bodies[0]} chain bodies, "
              f"B2 {counts['B2']} (one encode)")
        launches["mtx_amortized"] = {"B1": counts["B1"], "B2": counts["B2"],
                                     "chain_bodies": bodies[0],
                                     "route": route}
        res["mtx_amortized"] = {
            "parse_s": parse_s, "numpy_parse_s": numpy_parse_s,
            "ms": float(re.search(rf"^Auto Execution time: ({NUM}) s", out,
                                  re.M).group(1)) * 1e3}

        # convert to the band format, run the prepared file
        npz = f"{tmp}/band.npz"
        rc, out = run_cli(["convert", "synthetic:banded", npz, "--format",
                           "banded"])
        check(rc == 0 and "[BandedBlocks," in out, f"convert exited {rc}")
        calls = [0]
        real_spmm_any = ops_auto.spmm_any

        def counted_spmm_any(op, v):
            calls[0] += 1
            return real_spmm_any(op, v)

        reset_counts()
        ops_auto.spmm_any = counted_spmm_any
        try:
            rc, out = run_cli(["run", npz, "--k", "8"])
        finally:
            ops_auto.spmm_any = real_spmm_any
        counts = all_counts()
        check(rc == 0 and "[BandedBlocks]" in out,
              f"run {npz} exited {rc}")
        print(f"cli run band.npz launches {counts}; spmm_any calls "
              f"{calls[0]}")
        check(counts["B5"] == calls[0] > 0,
              f"B5 {counts['B5']} launches for {calls[0]} multiplies")
        launches["prepared_band"] = {"B5": counts["B5"],
                                     "multiplies": calls[0]}
        band = load_format(npz)
        check(band.block_rows == 128 and band.spill is None,
              f"band route r = {band.block_rows}, spill "
              f"{band.spill is not None}")
        csr = banded_csr(100_000, 100, 20).astype(np.float32)
        v_host = generate_fat_vector(csr.shape[1], 8, seed=0).astype(
            np.float32)
        oracle, cond = oracle_parts(csr, v_host)
        out_t = real_spmm_any(band.to(dev), to_tensor(v_host, dev))
        ok = matches_oracle(out_t, oracle, cond, torch.float32)
        print(f"band.npz loaded outside the command: {tuple(band.band.shape)}"
              f" band, spmm_any on the card correct={ok}")
        check(ok, "the loaded band file disagrees with the f64 oracle")
        res["prepared_band"] = {"correct": ok, "ms": float(re.search(
            rf"^Auto Execution time: ({NUM}) s", out, re.M).group(1)) * 1e3}

        # a small sweep, checkpointed, then resumed
        swp = ["sweep", "synthetic:cop20k_small", "--k", "8", str(K),
               "--strategy", "auto", "library", "row",
               "--csv", f"{tmp}/s.csv", "--json", f"{tmp}/s.json"]
        rc, out = run_cli(swp)
        check(rc == 0 and len(re.findall(r" ok$", out, re.M)) == 6,
              f"sweep exited {rc} or not 6 correct jobs")
        with open(f"{tmp}/s.json") as f:
            first = json.load(f)["records"]
        rc, out = run_cli(swp + ["--resume"])
        check(rc == 0 and " k=" not in out, "the resumed sweep ran a job")
        rows = read_csv(f"{tmp}/s.csv")
        check(len(rows) == 6 and [r.to_dict() for r in rows] == first,
              "read_csv does not give back the sweep's records")
        report = render_report(rows)
        check(f"Hardware: {kind}" in report, "the report does not name the "
              "card")
        print(report)
        flagged = suspicious_records(rows)
        print("suspicious rows:",
              [(r.strategy, r.k, why) for r, why in flagged])
        res["sweep"] = {"jobs": len(rows), "suspicious": len(flagged),
                        "ms": {f"{r.strategy} k={r.k}":
                               r.execution_time * 1e3 for r in rows}}
    print(json.dumps({"path": "cli_cop20k_k32", **res,
                      "launches": launches, "power": power}))
    return {"B1": {"run_all": launches["run_all"]["B1"],
                   "mtx_amortized": launches["mtx_amortized"]["B1"]},
            "B2": {"run_all": launches["run_all"]["B2"],
                   "mtx_amortized": launches["mtx_amortized"]["B2"]},
            "B5": {"prepared_band": launches["prepared_band"]["B5"]}}


#: Phase 14: the narrow widths of the reference's ``batch_test.sh`` and
#: the fixed lengths of the PageRank slope.
NARROW_KS = (1, 3, 6, 9)
PR_SHORT, PR_LONG = 10, 60
#: A dense plane of the PageRank operand alone is 674 MB; its compact
#: plane and vectors stay far below this.
PR_PEAK_BYTES = 500_000_000


def run_main(label, main_fn, argv) -> tuple:
    """``main_fn(argv)`` in this process: (exit code, its stdout), the
    output echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue()
    print(f"$ {label} {' '.join(argv)}  (rc {rc}, "
          f"{time.perf_counter() - t0:.1f} s)")
    print(out, end="")
    return rc, out


def padded8(v_p):
    """``v_p`` with zero columns up to k8 = 8, as the route pads it."""
    import torch

    return torch.cat([v_p, v_p.new_zeros((v_p.shape[0], 8 - v_p.shape[1]))],
                     dim=1).contiguous()


def narrow_b1_b2(op, host, v_p) -> dict:
    """B2 (bit for bit) and B1 against their plain versions at k = 1
    zero-padded to k8 = 8 on a U = 16 card copy, B1's plain version on
    the host's dense plane; times, bounds (the kernels' inputs at k8 = 8)
    and the library call at k = 1."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        to_tensor,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_windowed as cw,
    )

    C, nb = op.chunk_cols, op.n_blocks
    v8 = padded8(v_p)
    slabs = cw.chunk_slabs(v8, C=C, split=True)
    slabs_p = cw.chunk_slabs_plain(v8, C=C, split=True)
    torch.cuda.synchronize()
    same = torch.equal(slabs.view(torch.int16), slabs_p.view(torch.int16))
    print(f"B2 at k = 1 padded to 8 {tuple(v8.shape)} -> "
          f"{tuple(slabs.shape)} bitwise_equal={same}")
    check(same, "B2 at k8 = 8 is not bitwise equal to its plain version")
    b2 = {"max_abs_err": 0.0,
          "ms": cuda_ms(lambda: cw.chunk_slabs(v8, C=C, split=True), 200),
          "plain_ms": cuda_ms(lambda: cw.chunk_slabs_plain(
              v8, C=C, split=True), 50),
          **bound(nbytes(v8, slabs), 0, "f32"), "library_ms": None}
    ct = op.tiles_t
    dense = to_tensor(host.tiles_t, v_p.device)
    kw = dict(nb=nb, pairs_per_step=op.pairs_per_step, split=True)
    b1 = kernel_vs_plain(
        "B1 windowed_matmul_tmulti at k = 1 padded to 8",
        lambda: cw.windowed_matmul_tmulti(
            op.pair_block, op.pair_chunk, op.block_ptr, ct, slabs, **kw),
        lambda t, s: cw.windowed_matmul_tmulti_plain(
            op.pair_block, op.pair_chunk, t, s, nb=nb, split=True),
        dense, slabs, n=200)
    rest = nbytes(slabs, op.pair_chunk, op.block_ptr) + nb * 8 * ct.shape[2] * 4
    b1.update(bound(ct.nbytes + rest, 2 * 2 * ct.nnz * 8, "f32"),
              library_ms=library_ms("B1 at k = 1", windowed_csr(op), v_p))
    print(f"B1 at k8 = 8: {b1['ms']} ms, plain {b1['plain_ms']} ms, bound "
          f"{b1['bound_ms']} ms, library (k = 1) {b1['library_ms']} ms; B2 "
          f"{b2['ms']} ms, bound {b2['bound_ms']} ms")
    return {"B1": b1, "B2": b2}


def pagerank_phase(dev, power, scale=1.0):
    """Phase 14a: PageRank at k = 1 on the cop20k stand-in (the models
    benchmark's: seed 4, ``|values|``, column-normalised, f32,
    ``auto_format(k_nominal=1)`` -> ``WindowedPairs`` U = 16). B2 and B1
    against their plain versions at k = 1 padded to 8; PageRank with the
    counts zeroed: one B2 and one B1 an iteration, no other kernel, the
    peak device memory far below one dense plane, the ranks within
    ``PAGERANK_RTOL`` (1e-4) of each rank of a host float64 power
    iteration of the same length and summing to 1; the control: the same
    iteration through the kernels on the matrix rounded to bf16 (what a
    B1 that lost its lo plane multiplies by) must miss that limit; ms per
    iteration (the 10/60 slope) beside one multiply
    by the kernels and by the old plain route (``spmm_windowed_xla``,
    which densifies the compact plane). Returns B1's and B2's numbers,
    the iterations and the counted run's launches."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
        CompactTiles, WindowedPairs,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        cop20k_like, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        normalize_columns, pagerank,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, spmm_any,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
        spmm_windowed_core, spmm_windowed_xla,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts.run_models_bench \
        import PAGERANK_RTOL, hi_only, pagerank_host_f64

    t0 = time.perf_counter()
    g = cop20k_like(seed=4, scale=scale)
    g = dataclasses.replace(g, values=np.abs(g.values))
    norm = normalize_columns(g).astype(np.float32)
    host = auto_format(norm, k_nominal=1)
    t1 = time.perf_counter()
    check(isinstance(host, WindowedPairs) and host.pairs_per_step == 16
          and host.block_rows % 128 == 0,
          f"PageRank's operand routes to {type(host).__name__} "
          f"{windowed_route(host) if isinstance(host, WindowedPairs) else ''}"
          ", not WindowedPairs U = 16 with R % 128 == 0")
    op = host.to(dev)
    check(isinstance(op.tiles_t, CompactTiles), "the PageRank card copy does "
          "not hold the compact plane")
    n = norm.shape[0]
    route = windowed_route(op)
    print(f"PageRank: cop20k_like(seed=4) normalised, {norm.nnz} nnz; "
          f"auto_format(k_nominal=1) {t1 - t0:.2f} s -> route {route}")
    v1 = torch.from_numpy(generate_fat_vector(n, 1, seed=0).astype(
        np.float32)).to(dev)
    v_p = op.encode(v1).contiguous()
    numbers = narrow_b1_b2(op, host, v_p)
    del host

    def run(tol, max_iter):
        return pagerank(lambda v: spmm_any(op, v), n, tol=tol,
                        max_iter=max_iter, dtype=torch.float32, device=dev)

    run(1e-7, 100)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r, it = run(1e-7, 100)
    torch.cuda.synchronize()
    counts, peak = all_counts(), torch.cuda.max_memory_allocated()
    ref = pagerank_host_f64(norm, it)
    got = r.cpu().double().numpy()
    rel = float(np.max(np.abs(got - ref) / ref))
    total = float(r.sum())
    print(f"PageRank: {it} iterations, launches {counts}, peak device memory "
          f"{peak} B; ranks vs host f64 max relative error {rel}, sum "
          f"{total}")
    check(counts["B1"] == counts["B2"] == it and it > 0
          and sum(counts.values()) == 2 * it,
          f"PageRank launches {counts} != one B1 and one B2 in each of "
          f"{it} iterations")
    check(peak < PR_PEAK_BYTES, f"PageRank peak device memory {peak} B: a "
          "dense plane was built")
    check(rel <= PAGERANK_RTOL, f"PageRank ranks off the f64 iteration by "
          f"{rel}")
    check(abs(total - 1.0) <= 1e-4, f"PageRank ranks sum to {total}")
    ctl = WindowedPairs.from_csr(
        hi_only(norm), block_rows=op.block_rows, chunk_cols=op.chunk_cols,
        pairs_per_step=op.pairs_per_step, k_nominal=1).to(dev)
    check(windowed_route(ctl) == route, f"the hi-only control routes to "
          f"{windowed_route(ctl)}, not {route}")
    r_ctl, _ = pagerank(lambda v: spmm_any(ctl, v), n, tol=0.0,
                        max_iter=it, dtype=torch.float32, device=dev)
    rel_ctl = float(np.max(np.abs(r_ctl.cpu().double().numpy() - ref)
                           / ref))
    del ctl
    print(f"PageRank control, the matrix rounded to bf16 (no lo plane): "
          f"ranks vs host f64 max relative error {rel_ctl}; the limit "
          f"{PAGERANK_RTOL} lies between {rel} and it")
    check(rel_ctl > PAGERANK_RTOL, f"the PageRank limit {PAGERANK_RTOL} "
          f"passes the hi-only control ({rel_ctl})")
    t_short = cuda_ms(lambda: run(0.0, PR_SHORT), 3, warmup=1)
    t_long = cuda_ms(lambda: run(0.0, PR_LONG), 3, warmup=1)
    per_iter = (t_long - t_short) / (PR_LONG - PR_SHORT)
    kernel_ms = cuda_ms(lambda: spmm_windowed_core(op, v_p), 50)
    plain_ms = cuda_ms(lambda: spmm_windowed_xla(op, v_p), 5, warmup=1)
    print(f"PageRank ms per iteration {per_iter} (slope of {PR_SHORT} and "
          f"{PR_LONG} iterations: {t_short} / {t_long} ms); one k = 1 "
          f"multiply in permuted space: kernels {kernel_ms} ms, the old "
          f"plain route {plain_ms} ms")
    print(json.dumps({
        "path": "pagerank_cop20k_k1", "route": route, "nnz": norm.nnz,
        "iterations": it, "ms_per_iteration": per_iter,
        "ms_fixed_short": t_short, "ms_fixed_long": t_long,
        "multiply_kernels_ms": kernel_ms, "multiply_plain_route_ms": plain_ms,
        "max_rel_err_vs_f64": rel, "rtol": PAGERANK_RTOL,
        "hi_only_control_max_rel_err": rel_ctl, "rank_sum": total,
        "launches": counts, "max_memory_allocated": peak, "power": power}))
    return numbers, it, counts


def narrow_grid_phase(dev, power, csr) -> dict:
    """Phase 14b: ``spmm_any`` on the cop20k stand-in at k in {1, 3, 6, 9}
    through the U = 16, U = 2 f32 and U = 2 bf16 operands (and, at
    U = 16, the transposed chain), each against the f64 oracle in its
    tier with the counts showing only kernels ran: B2 + B1, B2 + B3,
    B2 + B4, and one B7 for a spill where the card's cost table gathers
    spills through it. B3 and B4 against their plain versions at k = 1 padded to
    8; each route's k = 1 multiply timed beside the old plain route.
    Returns B3's and B4's numbers and each kernel's launches."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import (
        dispatch_table,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
        cast, to_tensor,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops import (
        cuda_windowed as cw,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, spmm_any,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.windowed import (
        spmm_windowed_core, spmm_windowed_xla, windowed_t_chain,
    )

    csr_bf = csr.astype(torch.bfloat16)
    cases = (("U16 f32", csr, {}, torch.float32, "B1"),
             ("U2 f32", csr, {"pairs_per_step": 2}, torch.float32, "B3"),
             ("U2 bf16", csr_bf, {"pairs_per_step": 2}, torch.bfloat16,
              "B4"))
    out, launches, routes = {}, {}, {}
    for label, mat, kw, dtype, kernel in cases:
        t0 = time.perf_counter()
        host = auto_format(mat, **kw)
        op = host.to(dev)
        routes[label] = windowed_route(op)
        print(f"narrow k, {label}: auto_format + to(cuda) "
              f"{time.perf_counter() - t0:.2f} s, route {routes[label]}")
        check(op.pairs_per_step == (16 if label.startswith("U16") else 2),
              f"narrow k, {label}: unexpected route {routes[label]}")
        v1 = torch.from_numpy(generate_fat_vector(
            mat.shape[1], 1, seed=0).astype(np.float32)).to(dev).to(dtype)
        v_p = op.encode(v1).contiguous()
        if kernel != "B1":
            split = dtype == torch.float32
            slabs = cw.chunk_slabs(padded8(v_p), C=op.chunk_cols,
                                   split=split)
            fn, plain = ((cw.windowed_matmul_split3,
                          cw.windowed_matmul_split3_plain) if split else
                         (cw.windowed_matmul_single,
                          cw.windowed_matmul_single_plain))
            args = (op.pair_block, op.pair_chunk)
            nums = kernel_vs_plain(
                f"{kernel} at k = 1 padded to 8 ({label})",
                lambda: fn(*args, op.block_ptr, op.natural_plane, slabs,
                           nb=op.n_blocks),
                lambda t, s: plain(*args, t, s, nb=op.n_blocks),
                to_tensor(host.natural_plane, dev), slabs, n=200)
            ct = op.natural_plane
            P, R, _ = ct.shape
            rest = (nbytes(slabs, op.pair_chunk, op.block_ptr)
                    + op.n_blocks * R * 8 * 4)
            fmas = (2 if split else 1) * 2 * ct.nnz * 8
            nums.update(bound(ct.nbytes + rest, fmas, "f32"))
            try:
                nums["library_ms"] = library_ms(
                    f"{kernel} at k = 1", windowed_csr(op), v_p)
            except RuntimeError as e:  # a cuSPARSE without bf16 CSR
                print(f"{kernel}: torch.sparse.mm refused bf16 ({e}); timed "
                      "on the same entries in f32")
                nums["library_ms"] = library_ms(
                    f"{kernel} at k = 1 (f32 operands)",
                    windowed_csr(op, torch.float32), v_p.float())
            out[kernel] = nums
        del host
        route_ms = cuda_ms(lambda: spmm_windowed_core(op, v_p), 50)
        plain_ms = cuda_ms(lambda: spmm_windowed_xla(op, v_p), 5, warmup=1)
        print(f"narrow k, {label}: one k = 1 multiply (permuted space) "
              f"through the kernels {route_ms} ms, the old plain route "
              f"{plain_ms} ms")
        routes[label].update(k1_kernels_ms=route_ms, k1_plain_route_ms=plain_ms)
        names = ("B2", kernel)
        # A spill gathers through one B7 launch where the card's table
        # routes spills to it.
        if op.spill is not None and dispatch_table(dev).spill_dma_gather:
            names += ("B7",)
        for k in NARROW_KS:
            v_host = generate_fat_vector(mat.shape[1], k, seed=k).astype(
                np.float32)
            if dtype == torch.bfloat16:
                v_host = cast(v_host, torch.bfloat16)
            v = to_tensor(v_host, dev)
            oracle, cond = oracle_parts(mat, v_host)
            reset_counts()
            got = spmm_any(op, v)
            torch.cuda.synchronize()
            counts = all_counts()
            ok = matches_oracle(got, oracle, cond, dtype)
            want = {name: int(name in names) for name in counts}
            print(f"narrow k, {label}, k = {k}: spmm_any correct={ok}, "
                  f"launches {counts}")
            check(ok and tuple(got.shape) == (mat.shape[0], k),
                  f"narrow k, {label}, k = {k}: spmm_any disagrees with the "
                  "f64 oracle")
            check(counts == want, f"narrow k, {label}, k = {k}: launches "
                  f"{counts} != one each of {names}")
            for name in names:
                launches[name] = launches.get(name, 0) + counts[name]
            if kernel == "B1" and op.supports_transposed_chain:
                ch = windowed_t_chain(op, k)
                check(ch is not None, f"no transposed chain at k = {k}")
                enc, body, dec = ch
                reset_counts()
                got = dec(body(enc(v, op), op), op)
                torch.cuda.synchronize()
                counts = all_counts()
                ok = matches_oracle(got, oracle, cond, dtype)
                print(f"narrow k, transposed chain, k = {k}: correct={ok}, "
                      f"launches {counts}")
                check(ok, f"the transposed chain at k = {k} disagrees with "
                      "the f64 oracle")
                check(counts == {**want, "B1": 1, "B2": 1},
                      f"the transposed chain at k = {k} launched {counts}")
                launches["B1"] += counts["B1"]
                launches["B2"] += counts["B2"]
        del op
    print(json.dumps({"path": "narrow_k_cop20k", "ks": list(NARROW_KS),
                      "routes": routes, "launches": launches,
                      "power": power}))
    return out, launches


#: Phase 14: the kernels each format's route must launch on the card
#: (a U = 16 windowed operand's; a format missing here, COO's, launches
#: none and fails the check).
ROUTE_KERNELS = {"BandedBlocks": ("B5",), "BucketedELL": ("B7",),
                 "WindowedPairs": ("B2", "B1")}
#: (launch-count key, route key) of each model of run_models_bench.
MODEL_RUNS = (("gcn_step", "gcn_route"), ("cg_solve", "cg_route"),
              ("pagerank", "pagerank_route"))
#: How far CG's ms an iteration through the models benchmark's pick may
#: be above the same solve's through the band (B5) in the same run (the
#: routing slack: two band operands read 0.895 apart in one run).
CG_SLACK = 1.25


def cg_against_the_band(dev, m=121_192) -> dict:
    """CG on the models benchmark's system (8 right-hand sides) through
    its pick (``auto_format(device=cuda, one_shot=True, k_nominal=8)``)
    and through the band the reference's table picks (B5, the route the
    card took before it had its own table): ms an iteration as the slope of fixed 4- and 16-iteration
    ``tol = 0`` solves, the four timed in turns, best of 7. The pick's
    must be within ``CG_SLACK`` of the band's."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        spd_banded_system,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
        BandedBlocks,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E
    from sparsematrixmultiplicationmpi_tpu_torch.models import (
        conjugate_gradient,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, spmm_any,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts import _probe

    spd = spd_banded_system(m)
    ops = {"pick": auto_format(spd, device=dev, one_shot=True,
                               k_nominal=8).to(dev),
           "band": auto_format(spd, cost_table=V5E).to(dev)}
    check(isinstance(ops["band"], BandedBlocks),
          f"the reference's table picks {type(ops['band']).__name__} for "
          "the CG system, not its band")
    b = torch.from_numpy(np.random.default_rng(3).normal(
        size=(m, 8)).astype(np.float32)).to(dev)

    def solve(op, n):
        return lambda: conjugate_gradient(lambda v: spmm_any(op, v), b,
                                          tol=0.0, max_iter=n)

    fns = [solve(op, n) for op in ops.values() for n in (4, 16)]
    s = _probe.seconds_each(fns, dev, n=5, warmup=1, rounds=7)
    ms = {name: (s[2 * i + 1] - s[2 * i]) / 12 * 1e3
          for i, name in enumerate(ops)}
    out = {"pick": type(ops["pick"]).__name__, "ms_per_iteration": ms,
           "ratio": ms["pick"] / ms["band"]}
    print(f"CG through its pick {out['pick']}: {ms['pick']} ms an iteration;"
          f" through the band (B5): {ms['band']} ms; ratio {out['ratio']:.3f}")
    check(out["ratio"] <= CG_SLACK,
          f"CG through {out['pick']} is {out['ratio']:.3f}x its time through "
          f"the band (slack {CG_SLACK})")
    return out


def scripts_phase(dev, power, scale=1.0) -> dict:
    """Phase 14c-e: ``scripts.run_models_bench.main`` (its checks must all
    pass); ``scripts.run_results_sweep.main`` cut to ``--matrices
    cop20k_like --ks 1 32 --strategies auto windowed_row`` into a
    temporary checkpoint (every row correct), then again, resuming with
    no row run anew; ``spmm(csr, v)`` on the cop20k stand-in (one B2, one
    B1, against the oracle); the three ``examples/torch_0*`` scripts'
    ``main`` with ``--device cuda``, in this process. Each model's
    printed route must launch the kernels its format takes
    (``ROUTE_KERNELS``), CG's ms an iteration through its pick within
    ``CG_SLACK`` of its time through the band (``cg_against_the_band``);
    and
    ``spmm``'s one of each kernel of its route. Returns the launches of
    each. ``scale`` < 1 shrinks every problem (a rehearsal off the
    card)."""
    import tempfile

    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
        read_csv,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.io.generate import (
        cop20k_like, generate_fat_vector,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        auto_format, route_kernels, spmm,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts import (
        run_models_bench, run_results_sweep,
    )

    launches, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        rc, out = run_main("run_models_bench", run_models_bench.main,
                           ["--out-dir", tmp, "--scale", str(scale)])
        check(rc == 0, f"run_models_bench exited {rc}")
        models = json.load(open(os.path.join(tmp, "models_h100.json")))
        # The script counts each model's launches itself (its checks hold
        # them to one multiply's kernels a CG iteration, plus one, and a
        # PageRank step).
        checked = json.loads(out.strip().splitlines()[-1])
        res["models"] = {**models, **checked}
        check(models["hardware"] == power, "models_h100.json names "
              f"{models['hardware']}, not {power}")
        launches["models"] = {
            name: sum(c[name] for c in checked["launches"].values())
            for name in checked["launches"]["cg_solve"]}
        # Each model's route launches the kernels its format takes on the
        # card, every one of them (the script holds their counts to one
        # multiply's a call).
        for model, key in MODEL_RUNS:
            route = checked["checks"][key]
            need = ROUTE_KERNELS.get(route["format"])
            got = checked["launches"][model]
            check(need is not None and set(need) <= set(route["kernels"])
                  and all(got[name] > 0 for name in route["kernels"]),
                  f"{model}: route {route} launched {got}")
        print(f"models: CG route {checked['checks']['cg_route']}, "
              f"{models['cg_solve_121k']['ms_per_iteration']} ms an "
              "iteration")
        res["cg_against_the_band"] = cg_against_the_band(dev)

        argv = ["--matrices", "cop20k_like", "--ks", "1", "32",
                "--strategies", "auto", "--out-dir", tmp,
                "--scale", str(scale)]
        reset_counts()
        rc, out = run_main("run_results_sweep", run_results_sweep.main, argv)
        launches["sweep"] = all_counts()
        check(rc == 0, f"run_results_sweep exited {rc}")
        rows = read_csv(os.path.join(tmp, "h100_sweep.csv"))
        check(len(rows) == 3 and all(r.correct and not r.error
                                     and r.device_kind != "cpu"
                                     for r in rows),
              f"the sweep's rows are not 3 correct card rows: "
              f"{[(r.strategy, r.k, r.dtype, r.correct, r.error) for r in rows]}")
        check(launches["sweep"]["B1"] > 0 and launches["sweep"]["B2"] > 0,
              f"the sweep ran B1 / B2 no time: {launches['sweep']}")
        rc, out = run_main("run_results_sweep (resumed)",
                           run_results_sweep.main, argv)
        check(rc == 0 and "3 records (0 new)" in out,
              "the resumed sweep ran a job again")
        res["sweep"] = {f"{r.strategy} k={r.k} {r.dtype}":
                        r.execution_time * 1e3 for r in rows}

    csr = cop20k_like(dtype=np.float32, scale=scale)
    v_host = generate_fat_vector(csr.shape[1], K, seed=0).astype(np.float32)
    oracle, cond = oracle_parts(csr, v_host)
    pick = auto_format(csr, device=dev, one_shot=True)
    route = route_kernels(pick, K)
    reset_counts()
    got = spmm(csr, torch.from_numpy(v_host).to(dev))
    torch.cuda.synchronize()
    launches["spmm"] = all_counts()
    ok = matches_oracle(got, oracle, cond, torch.float32)
    print(f"spmm(csr, v) on cop20k k = {K}: {type(pick).__name__}, "
          f"correct={ok}, launches {launches['spmm']}")
    check(ok, "spmm(csr, v) disagrees with the f64 oracle")
    check(set(ROUTE_KERNELS[type(pick).__name__]) <= set(route)
          and launches["spmm"] == {name: int(name in route)
                                   for name in launches["spmm"]},
          f"spmm(csr, v) launched {launches['spmm']}, not one of each of "
          f"{route}")
    del csr, pick

    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    for script, expect in (("torch_01_spmm_basics.py", "Results are the same!"),
                           ("torch_02_distributed_strategies.py", "library"),
                           ("torch_03_gcn_training.py", "held-out accuracy")):
        spec = importlib.util.spec_from_file_location(
            script[:-3], os.path.join(root, "examples", script))
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        rc, out = run_main(f"examples/{script}", example.main,
                           ["--device", "cuda"])
        check(rc == 0 and expect in out and "MISMATCH" not in out,
              f"examples/{script} exited {rc}")
    print(json.dumps({"path": "scripts_and_examples", **res,
                      "launches": launches, "power": power}))
    return launches


#: Phase 15: the results sweep's MAIN matrices at these widths, and how
#: far the cost model's pick may be from the fastest class measured.
ROUTING_KS = (1, 32)
ROUTING_SLACK = 1.25


def routing_cases(scale=1.0):
    """``(name, csr, ks, in_sample)`` of phase 15: the results sweep's
    ``MAIN`` matrices, whose gather times are the H100 table's records
    (in sample), then matrices no probe calibrated on (held out): the
    models benchmark's CG system at its k = 8, and the rungs of
    ``exp_auto_threshold``'s band / off-band ladder at its k = 32."""
    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        spd_banded_system,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts import (
        _probe, exp_auto_threshold as thr,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts.run_results_sweep \
        import MAIN

    for name in MAIN:
        yield name, _probe.matrix(name, scale), ROUTING_KS, True
    yield ("cg_spd121k", spd_banded_system(max(int(121_192 * scale), 1000)),
           (8,), False)
    m = max(int(thr.M * scale), 1000)
    for frac in thr.FRACS:
        yield (f"ladder_off_band_{frac}", thr.mixed_csr(
            frac, seed=int(frac * 100), m=m).astype(np.float32), (thr.K,),
            False)


def routing_phase(dev, power, scale=1.0) -> dict:
    """Phase 15: routing on the card. For every matrix of
    ``routing_cases`` and each of its k, each class the
    search weighs (``route_candidates`` priced by the card's table: the
    bucketed ELL and COO gather formats, the best ``WindowedPairs``, the
    ``BandedBlocks`` where one builds), moved to the card, its ``Auto``
    chain (encode, a body, decode) checked against the f64 oracle, and
    one chain body timed with CUDA events over back-to-back calls, the
    classes in turns (``scripts/_probe.py::seconds_each``): what
    an iterative caller pays a multiply, and what ``est_seconds``
    estimates. Its H100 estimate beside its time. The pick (the cheapest
    estimate, ``auto_format(csr, device=cuda)``'s) must measure within
    ``ROUTING_SLACK`` of the fastest class, on the matrices in sample and
    on those held out alike."""
    import torch

    from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import (
        cost_table_for,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
        route_candidates,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.scripts import _probe

    table = cost_table_for(dev)
    print(f"routing: table {table.name} for {power}")
    rows, misses = [], []
    for name, csr, ks, in_sample in routing_cases(scale):
        for k in ks:
            t0 = time.perf_counter()
            cands = [c for c in route_candidates(csr, device=dev,
                                                 k_nominal=k)
                     if c[2] is not None]
            host_s = time.perf_counter() - t0
            pick = min(cands, key=lambda c: c[1])[0]
            v_host, v = _probe.fat_vector(csr.shape[1], k, dev)
            oracle = _probe.Checked(csr, v_host)
            bodies = []
            for cls, est, op in cands:
                try:
                    bodies.append(_probe.chain_body(
                        f"routing {name} k={k} {cls}", op.to(dev), v,
                        oracle))
                except RuntimeError as e:
                    raise PhaseFailed(str(e)) from e
            # In turns: no class is timed alone as the clocks ramp up.
            measured = dict(zip([c[0] for c in cands],
                                _probe.seconds_each(bodies, dev)))
            del bodies
            for cls, est, op in cands:
                row = {"matrix": name, "k": k, "in_sample": in_sample,
                       "class": cls, "format": type(op).__name__,
                       "est_ms": est * 1e3, "ms": measured[cls] * 1e3,
                       "pick": cls == pick}
                if cls == "windowed":
                    row.update(R=op.block_rows, C=op.chunk_cols,
                               U=op.pairs_per_step, pairs=op.n_pairs,
                               spill=op.spill is not None)
                if cls == "banded":
                    row.update(block_rows=op.block_rows)
                rows.append(row)
            fastest = min(measured, key=measured.get)
            ratio = measured[pick] / measured[fastest]
            print(f"routing {name} k={k} "
                  f"({'in sample' if in_sample else 'held out'}): pick {pick} "
                  f"{measured[pick] * 1e3:.4f} ms, fastest {fastest} "
                  f"{measured[fastest] * 1e3:.4f} ms, ratio {ratio:.3f}; "
                  + "; ".join(f"{r['class']} est {r['est_ms']:.4f} ms / "
                              f"measured {r['ms']:.4f} ms" for r in rows
                              if r["matrix"] == name and r["k"] == k)
                  + f"; search {host_s:.1f} s", flush=True)
            if ratio > ROUTING_SLACK:
                misses.append(f"{name} k={k}: {pick} {ratio:.3f}x "
                              f"{fastest}")
            torch.cuda.empty_cache()
    result = {"path": "routing_main_family", "table": table.name,
              "power": power, "slack": ROUTING_SLACK, "rows": rows,
              "misses": misses}
    print(json.dumps(result))
    check(not misses, "the H100 table's pick measures more than "
          f"{ROUTING_SLACK}x the fastest class: {misses}")
    return result


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--phase", type=int, nargs="+", choices=[14, 15],
                    help="build the kernels and run only these phases")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from sparsematrixmultiplicationmpi_tpu_torch.bench.harness import (
            run_benchmark,
        )
        from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import (
            V5E,
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
    if args.phase:
        if 14 in args.phase:
            pagerank_phase(dev, power)
            narrow_grid_phase(dev, power, cop20k_like(dtype=np.float32))
            scripts_phase(dev, power)
        if 15 in args.phase:
            routing_phase(dev, power)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

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
    print(f"launch counts {counts}; chain body calls {strat.body_calls}; "
          f"Auto's route on the card {strat.route}")
    result = {
        "metric": "spmm_gnnz_per_s_cop20k_k32",
        "route": strat.route,
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

    # 5.-13. drive the kernels at the shapes PERF.md §6 records: phases 5
    # to 12 build with the reference's cost table (cost_table=V5E) as
    # before the card had its own; the command line prices for the card.
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
    per_multiply, one_rank_ms = strategies_phase(dev, power, csr)
    phase_s["11"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    p4 = rank_kernels_phase(dev, power, csr)
    phase_s["12"] = time.perf_counter() - t_phase
    del csr

    # 13. the command line on the card
    t_phase = time.perf_counter()
    cli_launches = cli_phase(dev, power, kind, one_rank_ms)
    phase_s["13"] = time.perf_counter() - t_phase

    # 14. narrow k on the kernels: PageRank at k = 1, the k in {1, 3, 6,
    # 9} grid, the models and results scripts, spmm() and the examples
    t_phase = time.perf_counter()
    narrow, pr_iters, pr_counts = pagerank_phase(dev, power)
    csr = cop20k_like(dtype=np.float32)
    b3_b4, narrow_launches = narrow_grid_phase(dev, power, csr)
    narrow.update(b3_b4)
    del csr
    script_launches = scripts_phase(dev, power)
    phase_s["14"] = time.perf_counter() - t_phase

    # 15. routing on the card: each class the H100 table weighs on the
    # results sweep's MAIN matrices, estimated and measured
    t_phase = time.perf_counter()
    routing_phase(dev, power)
    phase_s["15"] = time.perf_counter() - t_phase
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
        if e["name"].split()[0] in cli_launches:
            e["cli_launches"] = cli_launches[e["name"].split()[0]]
        name = e["name"].split()[0]
        if name in narrow:
            e["narrow_k1"] = {key: narrow[name][key] for key in ENTRY_KEYS}
        if name in narrow_launches:
            e["narrow_k_launches"] = narrow_launches[name]
        if name in ("B1", "B2"):
            e["pagerank_launches"] = {
                "iterations": pr_iters,
                "per_iteration": pr_counts[name] / pr_iters}
        script_counts = {run: counts[name]
                         for run, counts in script_launches.items()
                         if counts.get(name)}
        if script_counts:
            e["scripts_launches"] = script_counts
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

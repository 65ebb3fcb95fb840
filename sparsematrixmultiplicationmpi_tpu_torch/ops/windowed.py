"""SpMM over windowed tile pairs (port of
``sparsematrixmultiplicationmpi_tpu/ops/windowed.py``).

The plain path (``spmm_windowed_xla``, the JAX package's XLA path) gathers
each pair's fat-vector slab, runs one batched matmul and segment-sums the
block-sorted products:

    slabs[p] = v[pair_chunk[p]*C : (pair_chunk[p]+1)*C]
    out[pair_block[p]] += tiles[p] @ slabs[p]

Dispatch follows the fat vector's device (``_takes_kernels``): a CPU
tensor takes the plain path, a CUDA tensor the Hopper kernels of
``ops/cuda_windowed.py`` behind the reference's own routing gates (U>2
transposed planes with ``R % 128`` -> B1, or B6 on a phase layout; U=2
-> B3 for split f32 planes, else B4; ``k8 % 16`` for the fused chain
state), with an unaligned ``k`` zero-padded to a multiple of 8 from the
dispatch table's ``kpad_min_k`` up (``formats/cost.py::dispatch_table``).
The reference (its table's 12, which CPU tensors keep) sent a narrower
unaligned ``k`` to XLA's dense route; on the card that route would
rebuild the dense tiles from the compact plane on every call, and the
H100 table pads every ``k`` (a divergence by design).

Core functions live in the operand's padded permuted space
(``WindowedPairs.encode``/``decode``).
"""

from __future__ import annotations

import torch

from ..formats.cost import dispatch_table
from ..formats.windowed import WindowedPairs
from ..utils.profiling import span
from .ell import stack_bucketed

__all__ = ["spmm_windowed", "spmm_windowed_core", "spmm_windowed_xla",
           "windowed_t_chain"]


def _finish(wp: WindowedPairs, out_blocks: torch.Tensor,
            v_p: torch.Tensor) -> torch.Tensor:
    """(nb*R, k) block output -> padded-space result + spill."""
    m, _ = wp.shape
    k = out_blocks.shape[1]
    pad = wp.pad_rows - out_blocks.shape[0]
    if pad > 0:
        out_blocks = torch.cat(
            [out_blocks, out_blocks.new_zeros((pad, k))], dim=0)
    out = out_blocks
    if wp.spill is not None:
        # Restore through the m-row take over the bucket outputs plus one
        # zero row; the take extends over the pad tail (pointing at the
        # zero row) so the result lands directly in padded space.
        bell = wp.spill
        stacked = stack_bucketed(bell, v_p)
        idx = bell.inv_row_perm
        tail = out.shape[0] - m
        if tail > 0:
            idx = torch.cat([idx, idx.new_full((tail,), stacked.shape[0] - 1)])
        out = out + stacked.index_select(0, idx).to(out.dtype)
    return out


def spmm_windowed_xla(wp: WindowedPairs, v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM via slab gather + batched matmul +
    block segment-sum (plain PyTorch on any device). ``v_p`` is
    ``(pad_rows, k)`` from ``wp.encode``."""
    R, C = wp.block_rows, wp.chunk_cols
    nb = wp.n_blocks
    k = v_p.shape[1]
    n_chunks = wp.n_chunks
    tiles, pair_block, pair_chunk = wp.plain_pairs()
    # f32 accumulation even for bf16 operands; operands cast to the tile
    # dtype first, as the reference does.
    out_dtype = torch.promote_types(
        torch.float32, torch.promote_types(tiles.dtype, v_p.dtype))
    if v_p.dtype != tiles.dtype:
        v_p = v_p.to(tiles.dtype)
    slabs = v_p[: n_chunks * C].reshape(n_chunks, C * k).index_select(
        0, pair_chunk).reshape(-1, C, k)
    prods = torch.bmm(tiles.to(out_dtype), slabs.to(out_dtype))
    out_blocks = prods.new_zeros((nb, R, k))
    out_blocks.index_add_(0, pair_block, prods)
    return _finish(wp, out_blocks.reshape(nb * R, k), v_p)


def _takes_kernels(wp: WindowedPairs, k: int, device) -> bool:
    """Whether a width-``k`` product of ``wp`` on ``device`` takes the
    kernels' route (``k`` zero-padded to a multiple of 8) rather than the
    plain gather path: ``k % 8 == 0`` or ``k`` at least the dispatch
    table's ``kpad_min_k`` (the reference's 12 on the CPU, where the
    route runs the kernels' plain versions, the transposed chain; 1 on a
    CUDA device, whose padded kernels win at every k). On the card also
    only a U=2 operand or a U>2 one with transposed planes and
    ``R % 128 == 0``."""
    if not (k % 8 == 0 or k >= dispatch_table(device).kpad_min_k):
        return False
    if torch.device(device).type == "cpu":
        return True
    if wp.pairs_per_step > 2:
        return wp.tiles_t is not None and wp.block_rows % 128 == 0
    return True


def spmm_windowed_core(wp: WindowedPairs, v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM: the plain path for a CPU tensor. For a
    CUDA tensor the kernels wherever ``_takes_kernels`` says so, ``k``
    zero-padded to a multiple of 8: B2 then B1 (B6 on a phase layout) for
    U>2, B2 then B3 (split f32 planes) or B4 (one plane) for U=2. The
    zero-pad is the span ``windowed.pad`` (``utils/profiling.py``)."""
    k = v_p.shape[1]
    k_pad = (-k) % 8
    if v_p.device.type == "cpu" or not _takes_kernels(wp, k, v_p.device):
        return spmm_windowed_xla(wp, v_p)
    from .cuda_windowed import spmm_windowed_cuda

    if k_pad:
        with span("windowed.pad"):
            v_wide = torch.cat([v_p, v_p.new_zeros((v_p.shape[0], k_pad))],
                               dim=1)
        return spmm_windowed_cuda(wp, v_wide)[:, :k]
    return spmm_windowed_cuda(wp, v_p)


def windowed_t_chain(wp: WindowedPairs, k: int):
    """Zero-relayout chained-iterate protocol in transposed state, or
    ``None`` when it does not apply (the caller falls back to the natural
    ``encode``/``iterate``/``decode`` chain).

    The state is the slab array itself — ``(n_chunks, k8, 2C)`` bf16
    ``[hi | lo]`` for f32 operands. ``enc`` permutes, pads and splits once
    (B2), each ``body`` is one B1 launch whose fused epilogue writes the
    next state (``k8 % 16 == 0``; otherwise B1 plus ``resplit_slabs``) or,
    on a phase layout, the phased contraction (B6) plus
    ``resplit_slabs``; ``dec`` adds hi + lo, transposes and undoes the
    permutation. An unaligned ``k`` is zero-padded to ``k8`` in ``enc``
    and sliced in ``dec``. On CPU tensors the same steps run the kernels'
    plain versions, and a narrow unaligned ``k`` gives ``None``, as in the
    reference (``_takes_kernels``). Accuracy: the
    state round-trips through bf16 hi + lo each step (~4e-6 relative),
    inside the f32 tier of ``utils/compare.py``.

    Each returned function takes ``(x, operand)`` like
    ``Strategy.chain_parts`` bodies.
    """
    if not (wp.supports_transposed_chain
            and _takes_kernels(wp, k, wp.device)):
        return None
    k8 = -(-k // 8) * 8
    from .cuda_windowed import (
        chunk_slabs, resplit_slabs, windowed_matmul_tmulti,
        windowed_matmul_tmulti_phased,
    )

    split = wp.split
    slab_dtype = torch.float32 if split else wp.tiles_t.dtype
    C = wp.chunk_cols

    def enc(v, op):
        v_p = op.encode(v).to(slab_dtype)
        if k8 != k:
            v_p = torch.cat(
                [v_p, v_p.new_zeros((v_p.shape[0], k8 - k))], dim=1)
        return chunk_slabs(v_p.contiguous(), C=C, split=split)

    def body(state, op):
        kwargs = dict(nb=op.n_blocks, pairs_per_step=op.pairs_per_step,
                      split=split)
        if op.phases is not None:
            out_t = windowed_matmul_tmulti_phased(
                op.pair_block_ph, op.pair_chunk_ph, op.block_ptr_ph,
                op.tiles_t, state, phases=op.phases,
                chunks_per_phase=op.chunks_per_phase, **kwargs)
            if split:
                return resplit_slabs(out_t)
            return out_t.to(slab_dtype)
        if k8 % 16 == 0:
            return windowed_matmul_tmulti(
                op.pair_block, op.pair_chunk, op.block_ptr, op.tiles_t,
                state, fuse_resplit=True, **kwargs)
        out_t = windowed_matmul_tmulti(
            op.pair_block, op.pair_chunk, op.block_ptr, op.tiles_t, state,
            **kwargs)
        if split:
            return resplit_slabs(out_t)
        return out_t.to(slab_dtype)

    def dec(state, op):
        if split:
            x = (state[:, :, :C].to(torch.float32)
                 + state[:, :, C:].to(torch.float32))
        else:
            x = state.to(torch.float32)
        rows = x.transpose(1, 2).reshape(-1, k8)[:, :k]
        return op.decode(rows)

    return enc, body, dec


def spmm_windowed(wp: WindowedPairs, v: torch.Tensor) -> torch.Tensor:
    """Full SpMM in original coordinates: encode -> iterate -> decode."""
    return wp.decode(spmm_windowed_core(wp, wp.encode(v)))

"""SpMM over windowed tile pairs (port of
``sparsematrixmultiplicationmpi_tpu/ops/windowed.py``).

The plain path (``spmm_windowed_xla``, the JAX package's XLA path) gathers
each pair's fat-vector slab, runs one batched matmul and segment-sums the
block-sorted products:

    slabs[p] = v[pair_chunk[p]*C : (pair_chunk[p]+1)*C]
    out[pair_block[p]] += tiles[p] @ slabs[p]

Dispatch follows the fat vector's device: a CPU tensor takes the plain
path, a CUDA tensor the Hopper kernels of ``ops/cuda_windowed.py`` behind
the reference's own routing gates (``k % 8`` with ``KPAD_MIN_K`` padding,
U>2 transposed planes, ``R % 128``, ``k8 % 16`` for the fused chain
state), so the card takes the route the TPU took.

Core functions live in the operand's padded permuted space
(``WindowedPairs.encode``/``decode``).
"""

from __future__ import annotations

import torch

from ..formats.windowed import KPAD_MIN_K, WindowedPairs
from .ell import spmm_ell

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
        parts = [spmm_ell(b, v_p, unpad=False) for b in bell.buckets]
        parts.append(parts[0].new_zeros((1, k)))
        stacked = torch.cat(parts, dim=0)
        idx = bell.inv_row_perm
        tail = out.shape[0] - m
        if tail > 0:
            idx = torch.cat([idx, idx.new_full((tail,), stacked.shape[0] - 1)])
        out = out + stacked.index_select(0, idx).to(out.dtype)
    return out


def _plain_tiles(wp: WindowedPairs) -> torch.Tensor:
    """The (P, R, C) tiles of the plain path: the operand's own, or, in a
    card copy that holds only the kernels' transposed planes, rebuilt from
    ``tiles_t`` (exact for one plane; hi + lo, within 2**-17 relative of
    the f32 tile, for split planes, the precision the kernels use)."""
    if wp.tiles is not None:
        return wp.tiles
    t = wp.tiles_t
    if wp.split:
        C = wp.chunk_cols
        t = t[:, :C].to(torch.float32) + t[:, C:].to(torch.float32)
    return t.transpose(1, 2)


def spmm_windowed_xla(wp: WindowedPairs, v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM via slab gather + batched matmul +
    block segment-sum (plain PyTorch on any device). ``v_p`` is
    ``(pad_rows, k)`` from ``wp.encode``."""
    R, C = wp.block_rows, wp.chunk_cols
    nb = wp.n_blocks
    k = v_p.shape[1]
    n_chunks = wp.n_chunks
    tiles = _plain_tiles(wp)
    # f32 accumulation even for bf16 operands; operands cast to the tile
    # dtype first, as the reference does.
    out_dtype = torch.promote_types(
        torch.float32, torch.promote_types(tiles.dtype, v_p.dtype))
    if v_p.dtype != tiles.dtype:
        v_p = v_p.to(tiles.dtype)
    slabs = v_p[: n_chunks * C].reshape(n_chunks, C * k).index_select(
        0, wp.pair_chunk).reshape(-1, C, k)
    prods = torch.bmm(tiles.to(out_dtype), slabs.to(out_dtype))
    out_blocks = prods.new_zeros((nb, R, k))
    out_blocks.index_add_(0, wp.pair_block, prods)
    return _finish(wp, out_blocks.reshape(nb * R, k), v_p)


def spmm_windowed_core(wp: WindowedPairs, v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM: the plain path for a CPU tensor. For a
    CUDA tensor, the reference's kernel routing: narrow unaligned ``k``
    (``< KPAD_MIN_K``) and U>2 formats without a 128-multiple ``R`` take
    the plain path, other ``k`` are zero-padded to a multiple of 8 and go
    through the kernels B2 + B1. U=2 formats run kernels B3/B4 there,
    which are not ported yet, so they raise."""
    k = v_p.shape[1]
    k_pad = (-k) % 8
    if v_p.device.type == "cpu" or (k_pad and k < KPAD_MIN_K):
        return spmm_windowed_xla(wp, v_p)
    if wp.pairs_per_step <= 2:
        raise NotImplementedError(
            "pairs_per_step=2 windowed formats run kernels B3/B4 "
            "(pallas_windowed._kernel_split3 / _kernel_plain), not ported "
            "yet; build with the default pairs_per_step")
    if wp.tiles_t is None or wp.block_rows % 128:
        return spmm_windowed_xla(wp, v_p)
    from .cuda_windowed import spmm_windowed_cuda

    if k_pad:
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
    next state (``k8 % 16 == 0``; otherwise B1 plus ``resplit_slabs``),
    ``dec`` adds hi + lo, transposes and undoes the permutation. On CPU
    tensors the same steps run the kernels' plain versions. Accuracy: the
    state round-trips through bf16 hi + lo each step (~4e-6 relative),
    inside the f32 tier of ``utils/compare.py``.

    Each returned function takes ``(x, operand)`` like
    ``Strategy.chain_parts`` bodies.
    """
    if not wp.supports_transposed_chain:
        return None
    k8 = -(-k // 8) * 8
    if k8 != k and k < KPAD_MIN_K:
        return None  # narrow unaligned k: the plain gather path
    if wp.device.type != "cpu" and wp.block_rows % 128:
        return None  # the reference's compiled-kernel gate
    from .cuda_windowed import (
        chunk_slabs, resplit_slabs, windowed_matmul_tmulti,
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

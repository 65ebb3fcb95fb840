"""Gather-based ELL SpMM in plain PyTorch (port of
``sparsematrixmultiplicationmpi_tpu/ops/ell.py``).

``out = sum_w vals[:, w, None] * v[cols[:, w], :]`` — one row gather and a
dense reduction over the width axis (the take route). The explicit-gather
route through kernel B7 (``ops/cuda_gather.py``) is the reference's A/B
switch: off by default (``SPILL_DMA_GATHER``), or forced per call with
``dma_gather=True``. On that route a bucketed operand takes one B7
launch for all its buckets (``stack_bucketed``) where the reference
runs one per bucket and concatenates; the values are the same.
"""

from __future__ import annotations

import torch

from ..formats.matrix import ELL, BucketedELL

__all__ = ["spmm_ell", "spmm_bucketed", "stack_bucketed", "take_rows",
           "SPILL_DMA_GATHER"]

#: Route ELL planes through the explicit-gather kernel B7 instead of the
#: take route. The reference keeps it False after measuring its DMA kernel
#: slower than XLA's take on the v5e (16.0 vs 4.7 ns/row); kept False here
#: for routing parity. Read at each call.
SPILL_DMA_GATHER = False


def take_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx, :]`` (the JAX package's narrow-k widening is a TPU
    gather-speed measure and has no effect on the values)."""
    return v.index_select(0, idx.reshape(-1))


def _spmm_ell_dma(ell: ELL, v: torch.Tensor) -> torch.Tensor:
    """One ELL plane through ``ell_gather_rows`` (B7; ``k <= 128``): f32
    gather-reduce, cast back to ``v``'s dtype as the reference does."""
    from .cuda_gather import ell_gather_rows

    out = ell_gather_rows(ell.cols, ell.vals.to(torch.float32).contiguous(),
                          v.to(torch.float32).contiguous())
    return out.to(v.dtype)


def spmm_ell(ell: ELL, v: torch.Tensor, *, unpad: bool = True,
             dma_gather: bool | None = None) -> torch.Tensor:
    """SpMM over one ELL plane on ``v``'s device: ``(m, k)``, or
    ``(m_padded, k)`` with ``unpad=False``. ``dma_gather=None`` follows
    ``SPILL_DMA_GATHER`` (for ``0 < W`` and ``k <= 128``); True or False
    forces either route."""
    mp, w = ell.cols.shape
    k = v.shape[1]
    if dma_gather is None:
        dma_gather = SPILL_DMA_GATHER and 0 < w and k <= 128
    if dma_gather:
        out = _spmm_ell_dma(ell, v)
    else:
        gathered = take_rows(v, ell.cols).reshape(mp, w, k)
        out = (ell.vals[:, :, None].to(v.dtype) * gathered).sum(dim=1)
    if unpad:
        out = out[: ell.shape[0]]
    return out


def stack_bucketed(bell: BucketedELL, v: torch.Tensor) -> torch.Tensor:
    """Every bucket's padded SpMM output, stacked in bucket order, and one
    zero row for rows absent from every bucket: ``(sum m_padded + 1,
    k)`` in ``v``'s dtype, the table ``inv_row_perm`` indexes. With
    ``SPILL_DMA_GATHER`` (and ``k <= 128``) one B7 launch writes it
    (``ell_gather_bucketed``); otherwise each bucket takes ``spmm_ell``
    and the parts are concatenated, as the reference does."""
    k = v.shape[1]
    if SPILL_DMA_GATHER and k <= 128:
        from .cuda_gather import ell_gather_bucketed

        return ell_gather_bucketed(
            bell, v.to(torch.float32).contiguous()).to(v.dtype)
    parts = [spmm_ell(b, v, unpad=False) for b in bell.buckets]
    parts.append(v.new_zeros((1, k), dtype=parts[0].dtype))
    return torch.cat(parts, dim=0)


def spmm_bucketed(bell: BucketedELL, v: torch.Tensor) -> torch.Tensor:
    """SpMM over bucketed ELL: per-bucket reduce, then one gather back to
    original row order through ``inv_row_perm``."""
    return stack_bucketed(bell, v).index_select(0, bell.inv_row_perm)

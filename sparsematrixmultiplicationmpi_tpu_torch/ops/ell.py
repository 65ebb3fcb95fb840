"""Gather-based ELL SpMM in plain PyTorch (port of
``sparsematrixmultiplicationmpi_tpu/ops/ell.py``).

``out = sum_w vals[:, w, None] * v[cols[:, w], :]`` — one row gather and a
dense reduction over the width axis (the take route). The explicit-gather
route through kernel B7 (``ops/cuda_gather.py``) is taken where the
dispatch table of ``v``'s device says so (``formats/cost.py::
dispatch_table``'s ``spill_dma_gather``: off in the reference's v5e
table, which CPU tensors follow; on in the H100's, which CUDA tensors
follow, as ``scripts/exp_spill_gather.py`` measured), everywhere while
``SPILL_DMA_GATHER`` is set, or per call with ``dma_gather=``. On
that route a bucketed operand takes one B7 launch for all its buckets
(``stack_bucketed``) where the reference runs one per bucket and
concatenates; the values are the same.
"""

from __future__ import annotations

import torch

from ..formats.cost import V5E, dispatch_table
from ..formats.matrix import ELL, BucketedELL

__all__ = ["spmm_ell", "spmm_bucketed", "stack_bucketed", "take_rows",
           "SPILL_DMA_GATHER"]

#: The reference's switch (its v5e table's value: False, after measuring
#: its DMA kernel slower than XLA's take, 16.0 vs 4.7 ns/row). Set True,
#: it sends every ELL plane through B7; False leaves the route to the
#: dispatch table of ``v``'s device. Read at each call.
SPILL_DMA_GATHER = V5E.spill_dma_gather


def _dma_route(v: torch.Tensor, k: int) -> bool:
    """Whether a width-``k`` gather of ``v`` takes B7 by default."""
    return k <= 128 and (SPILL_DMA_GATHER
                         or dispatch_table(v.device).spill_dma_gather)


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
    ``_dma_route`` (for ``0 < W``); True or False forces either route."""
    mp, w = ell.cols.shape
    k = v.shape[1]
    if dma_gather is None:
        dma_gather = 0 < w and _dma_route(v, k)
    if dma_gather:
        out = _spmm_ell_dma(ell, v)
    else:
        gathered = take_rows(v, ell.cols).reshape(mp, w, k)
        out = (ell.vals[:, :, None].to(v.dtype) * gathered).sum(dim=1)
    if unpad:
        out = out[: ell.shape[0]]
    return out


def stack_bucketed(bell: BucketedELL, v: torch.Tensor, *,
                   dma_gather: bool | None = None) -> torch.Tensor:
    """Every bucket's padded SpMM output, stacked in bucket order, and one
    zero row for rows absent from every bucket: ``(sum m_padded + 1,
    k)`` in ``v``'s dtype, the table ``inv_row_perm`` indexes. On the B7
    route (``_dma_route``, or ``dma_gather=True``) one B7 launch writes
    it (``ell_gather_bucketed``); otherwise each bucket takes the take
    route and the parts are concatenated, as the reference does."""
    k = v.shape[1]
    if dma_gather is None:
        dma_gather = _dma_route(v, k)
    if dma_gather:
        from .cuda_gather import ell_gather_bucketed

        return ell_gather_bucketed(
            bell, v.to(torch.float32).contiguous()).to(v.dtype)
    parts = [spmm_ell(b, v, unpad=False, dma_gather=False)
             for b in bell.buckets]
    parts.append(v.new_zeros((1, k), dtype=parts[0].dtype))
    return torch.cat(parts, dim=0)


def spmm_bucketed(bell: BucketedELL, v: torch.Tensor, *,
                  dma_gather: bool | None = None) -> torch.Tensor:
    """SpMM over bucketed ELL: per-bucket reduce (the route as
    ``stack_bucketed`` picks it), then one gather back to original row
    order through ``inv_row_perm``."""
    return stack_bucketed(bell, v, dma_gather=dma_gather).index_select(
        0, bell.inv_row_perm)

"""Gather-based ELL SpMM in plain PyTorch (port of
``sparsematrixmultiplicationmpi_tpu/ops/ell.py``).

``out = sum_w vals[:, w, None] * v[cols[:, w], :]`` — one row gather and a
dense reduction over the width axis. The JAX package's explicit-DMA
gather route (kernel B7, ``_spmm_ell_dma``) is off by default there and
not ported yet.
"""

from __future__ import annotations

import torch

from ..formats.matrix import ELL, BucketedELL

__all__ = ["spmm_ell", "spmm_bucketed", "take_rows"]


def take_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx, :]`` (the JAX package's narrow-k widening is a TPU
    gather-speed measure and has no effect on the values)."""
    return v.index_select(0, idx.reshape(-1))


def spmm_ell(ell: ELL, v: torch.Tensor, *,
             unpad: bool = True) -> torch.Tensor:
    """SpMM over one ELL plane on ``v``'s device: ``(m, k)``, or
    ``(m_padded, k)`` with ``unpad=False``."""
    mp, w = ell.cols.shape
    k = v.shape[1]
    gathered = take_rows(v, ell.cols).reshape(mp, w, k)
    out = (ell.vals[:, :, None].to(v.dtype) * gathered).sum(dim=1)
    if unpad:
        out = out[: ell.shape[0]]
    return out


def spmm_bucketed(bell: BucketedELL, v: torch.Tensor) -> torch.Tensor:
    """SpMM over bucketed ELL: per-bucket reduce, then one gather back to
    original row order through ``inv_row_perm``."""
    parts = [spmm_ell(b, v, unpad=False) for b in bell.buckets]
    # One zero row for rows absent from every bucket.
    parts.append(v.new_zeros((1, v.shape[1]), dtype=parts[0].dtype))
    stacked = torch.cat(parts, dim=0)
    return stacked.index_select(0, bell.inv_row_perm)

"""SDDMM, sampled dense-dense matrix multiplication (port of
``sparsematrixmultiplicationmpi_tpu/ops/sddmm.py``).

``out[i, j] = <a[i, :], b[j, :]>`` evaluated only at a sparse pattern's
nonzero positions: the companion of SpMM in graph attention and in
factorization losses. Two row gathers and a row-wise sum, differentiable
in ``a`` and ``b``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.matrix import COO, CSR

__all__ = ["sddmm", "sddmm_coo"]


def sddmm_coo(pattern: COO, a: torch.Tensor, b: torch.Tensor, *,
              scale_by_values: bool = False) -> COO:
    """SDDMM over a COO pattern. ``a``: (m, d); ``b``: (n, d). Returns a
    COO with the same pattern and values ``<a[row], b[col]>`` (times the
    pattern's values when ``scale_by_values``); host index arrays are
    moved to ``a``'s device."""
    m, n = pattern.shape
    if a.shape[0] != m or b.shape[0] != n or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"shape mismatch: pattern {pattern.shape}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}"
        )
    rows = torch.as_tensor(pattern.row_indices, device=a.device)
    cols = torch.as_tensor(pattern.col_indices, device=a.device)
    values = (a.index_select(0, rows) * b.index_select(0, cols)).sum(dim=1)
    if scale_by_values:
        values = values * torch.as_tensor(
            pattern.values, device=a.device).to(values.dtype)
    return dataclasses.replace(pattern, values=values)


def sddmm(pattern, a: torch.Tensor, b: torch.Tensor, *,
          scale_by_values: bool = False) -> COO:
    """SDDMM over a CSR (converted on the host) or COO pattern."""
    if isinstance(pattern, CSR):
        pattern = pattern.to_coo()
    return sddmm_coo(pattern, a, b, scale_by_values=scale_by_values)

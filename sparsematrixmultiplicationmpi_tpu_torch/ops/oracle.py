"""Sequential-oracle SpMM (PyTorch port of
``sparsematrixmultiplicationmpi_tpu/ops/oracle.py``).

``spmm_host_f64`` is the device-independent float64 ground truth every
result is checked against (the reference's sequential kernel,
``SparseMatrixFatVectorMultiply.cpp:11-31``, also ran in f64 on the host).
``spmm_coo`` is the triple loop as one row gather plus an ``index_add_``
over the COO rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.matrix import COO, CSR, as_float64

__all__ = ["spmm_coo", "spmm_host_f64"]


def spmm_coo(coo: COO, v: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_{j: row[j]==r} values[j] * v[col[j], :]``; ``coo``
    must already be on ``v``'s device (``coo.to(v.device)``)."""
    m, _ = coo.shape
    prods = coo.values[:, None].to(v.dtype) * v.index_select(
        0, coo.col_indices)
    out = torch.zeros((m, v.shape[1]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, coo.row_indices, prods)


def spmm_host_f64(csr: CSR, v) -> np.ndarray:
    """Host-side float64 oracle (numpy, no device involved). Row sums via
    exclusive-cumsum differencing — vectorized and robust to empty rows.
    bfloat16 values or ``v`` (``uint16`` bits) are decoded first."""
    vals = as_float64(csr.values)
    cols = np.asarray(csr.col_indices)
    row_ptr = np.asarray(csr.row_ptr).astype(np.int64)
    v = as_float64(v)
    prods = vals[:, None] * v[cols]
    csum = np.concatenate(
        [np.zeros((1, v.shape[1])), np.cumsum(prods, axis=0)], axis=0)
    return csum[row_ptr[1:]] - csum[row_ptr[:-1]]

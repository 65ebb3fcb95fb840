"""Vendor-library yardstick (port of
``sparsematrixmultiplicationmpi_tpu/ops/library.py``).

The reference benchmarks its hand-written kernels against PETSc
``MatMatMult`` (``Source Code/main.cpp:290-396``) as "what the vendor
library achieves". The JAX package's analog is XLA's BCOO lowering; the
port's is PyTorch's sparse CSR product (cuSPARSE on the card). It is a
yardstick: ``auto_format`` never routes to it, a caller asks for it by
passing the tensor ``to_torch_sparse`` builds to ``spmm_any``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.matrix import COO, CSR, coalesce_coo, to_tensor

__all__ = ["to_torch_sparse", "spmm_library"]


def to_torch_sparse(matrix, device="cuda") -> torch.Tensor:
    """A host CSR or COO as a ``torch.sparse_csr_tensor`` on ``device``
    (int64 indices, duplicate coordinates summed, bf16 bits decoded)."""
    if isinstance(matrix, CSR):
        matrix = matrix.to_coo()
    if not isinstance(matrix, COO):
        raise TypeError(f"expected CSR or COO, got {type(matrix)}")
    m, n = matrix.shape
    i, j, vals = coalesce_coo(np.asarray(matrix.row_indices),
                              np.asarray(matrix.col_indices),
                              np.asarray(matrix.values), n)
    order = np.lexsort((j, i))
    i, j, vals = i[order], j[order], vals[order]
    crow = np.zeros(m + 1, dtype=np.int64)
    np.add.at(crow, i.astype(np.int64) + 1, 1)
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.cumsum(crow)), torch.from_numpy(
            j.astype(np.int64)), to_tensor(vals, "cpu"),
        (m, n), check_invariants=True).to(device)


def spmm_library(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` by the library (the PETSc ``MatMatMult`` analog,
    ``main.cpp:345-348``), in ``a``'s dtype."""
    return a @ v.to(a.dtype)

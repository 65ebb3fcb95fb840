"""Linear systems the benchmarks solve.

``spd_banded_system`` is the SPD matrix of the JAX package's model
benchmark (``scripts/run_models_bench.py``, the CG solve): a banded
FEM-like matrix, made symmetric and diagonally dominant. Host-side numpy,
bit-identical to that script's recipe.
"""

from __future__ import annotations

import numpy as np

from ..formats.matrix import CSR
from ..io.generate import banded_csr
from ..io.mtx import expand_and_build_csr

__all__ = ["spd_banded_system"]


def spd_banded_system(m: int, seed: int = 2, dtype=np.float32) -> CSR:
    """``S + diag(rowsum|S| + 1)`` with ``S = 0.01 * (|B| + |B|^T)`` and
    ``B = banded_csr(m, 60, 12, seed)``: symmetric, strictly diagonally
    dominant with a positive diagonal, hence SPD. Duplicate coordinates
    are kept, as the recipe keeps them (SpMM sums them)."""
    coo = banded_csr(m, 60, 12, seed=seed).to_coo()
    i, j = coo.row_indices, coo.col_indices
    vals = np.abs(coo.values)
    sym = expand_and_build_csr(np.concatenate([i, j]), np.concatenate([j, i]),
                               np.concatenate([vals, vals]) * 0.01, m, m,
                               False)
    rows = sym.to_coo().row_indices
    deg = np.zeros(m)
    np.add.at(deg, rows, np.abs(sym.values))
    diag = np.arange(m)
    return expand_and_build_csr(
        np.concatenate([rows, diag]),
        np.concatenate([sym.col_indices, diag]),
        np.concatenate([sym.values, deg + 1.0]), m, m, False).astype(dtype)

"""PageRank and power iteration over the port's SpMM (port of
``sparsematrixmultiplicationmpi_tpu/models/pagerank.py``).

The reference's ``lax.while_loop`` becomes a Python loop that tests the
same condition before each body, reading one scalar back per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..formats.matrix import CSR

__all__ = ["pagerank", "power_iteration", "normalize_columns"]


def normalize_columns(csr: CSR) -> CSR:
    """Column-stochastic rescale: ``A[:, j] /= colsum[j]`` (dangling
    columns -> 0). Host-side numpy, the same values as the JAX package."""
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values)
    colsum = np.zeros(csr.shape[1])
    np.add.at(colsum, cols, vals)
    scale = np.where(colsum > 0, 1.0 / np.where(colsum == 0, 1, colsum), 0.0)
    return dataclasses.replace(csr, values=vals * scale[cols])


def pagerank(spmm: Callable[[torch.Tensor], torch.Tensor], n: int, *,
             damping: float = 0.85, tol: float = 1e-8, max_iter: int = 200,
             dtype=torch.float64, device="cuda"):
    """PageRank by power iteration on a column-normalized adjacency
    (``spmm`` maps ``(n, k) -> (n, k)`` on ``device``: the card unless
    the caller passes ``"cpu"``).
    Returns ``(ranks (n,), iterations)``."""
    r = torch.full((n, 1), 1.0 / n, dtype=dtype, device=device)
    delta = torch.tensor(float("inf"), dtype=dtype, device=device)
    i = 0
    while i < max_iter and bool(delta > tol):
        r_new = damping * spmm(r) + (1.0 - damping) / n
        r_new = r_new / r_new.sum()
        delta = (r_new - r).abs().max()
        r = r_new
        i += 1
    return r[:, 0], i


def power_iteration(spmm: Callable[[torch.Tensor], torch.Tensor], n: int, *,
                    tol: float = 1e-10, max_iter: int = 500, seed: int = 0,
                    dtype=torch.float64, device="cuda"):
    """Dominant eigenpair of a square sparse matrix by power iteration,
    on ``device`` (the card unless the caller passes ``"cpu"``), from a
    start vector drawn by a ``torch.Generator`` seeded by ``seed``.
    Returns ``(eigenvalue, eigenvector (n,), iterations)``."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn((n, 1), generator=gen, dtype=dtype).to(device)
    v = v / torch.linalg.norm(v)
    lam = torch.tensor(0.0, dtype=dtype, device=device)
    delta = torch.tensor(float("inf"), dtype=dtype, device=device)
    i = 0
    while i < max_iter and bool(delta > tol):
        w = spmm(v)
        lam_new = (v * w).sum()
        v = w / torch.linalg.norm(w)
        delta = (lam_new - lam).abs()
        lam = lam_new
        i += 1
    return lam, v[:, 0], i

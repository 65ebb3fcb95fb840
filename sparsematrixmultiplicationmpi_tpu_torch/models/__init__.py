"""Sparse workloads over the port's SpMM: iterative solvers, Lanczos and
PageRank. GCN and GAT, which need autodiff and SDDMM, are not ported yet."""

from .eigen import LanczosResult, lanczos, topk_eigsh
from .pagerank import normalize_columns, pagerank, power_iteration
from .solvers import SolveResult, cgls, conjugate_gradient, jacobi

__all__ = [
    "LanczosResult", "lanczos", "topk_eigsh",
    "normalize_columns", "pagerank", "power_iteration",
    "SolveResult", "cgls", "conjugate_gradient", "jacobi",
]

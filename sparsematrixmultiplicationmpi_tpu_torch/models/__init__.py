"""Sparse workloads over the port's SpMM: the GCN and graph attention
(trained through the custom-gradient SpMM of ``ops/autodiff.py``),
iterative solvers, Lanczos and PageRank."""

from .eigen import LanczosResult, lanczos, topk_eigsh
from .gat import (
    GATParams, gat_layer, gat_params_from_jax, init_gat, multi_head_gat,
    segment_softmax,
)
from .gcn import (
    GCNParams, gcn_forward, gcn_loss, gcn_params_from_jax, init_gcn,
    make_train_step, normalize_adjacency, synthetic_node_classification,
)
from .pagerank import normalize_columns, pagerank, power_iteration
from .solvers import SolveResult, cgls, conjugate_gradient, jacobi

__all__ = [
    "GCNParams", "gcn_forward", "gcn_loss", "gcn_params_from_jax",
    "init_gcn", "make_train_step", "normalize_adjacency",
    "synthetic_node_classification",
    "GATParams", "gat_layer", "gat_params_from_jax", "init_gat",
    "multi_head_gat", "segment_softmax",
    "LanczosResult", "lanczos", "topk_eigsh",
    "normalize_columns", "pagerank", "power_iteration",
    "SolveResult", "cgls", "conjugate_gradient", "jacobi",
]

"""Systems the benchmarks solve and graphs they train on.

``spd_banded_system`` is the SPD matrix of the JAX package's model
benchmark (``scripts/run_models_bench.py``, the CG solve): a banded
FEM-like matrix, made symmetric and diagonally dominant. ``gcn_task`` is
that benchmark's GCN task (its 100,000-node graph), ``mesh_gcn_task`` the
same widths on the cop20k_A stand-in's FEM mesh. Host-side numpy,
bit-identical to the recipes they follow.
"""

from __future__ import annotations

import numpy as np

from ..formats.matrix import CSR
from ..io.generate import banded_csr, cop20k_like
from ..io.mtx import expand_and_build_csr
from ..models.gcn import (
    draw_class_features, normalize_adjacency, synthetic_node_classification,
)

__all__ = ["spd_banded_system", "gcn_task", "mesh_gcn_task"]


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


def gcn_task(n: int = 100_000, f: int = 64, c: int = 16,
             avg_degree: int = 16, seed: int = 1):
    """The model benchmark's GCN task (``scripts/run_models_bench.py``,
    its graph and features): ``(normalize_adjacency(adj), x (n, f) f32,
    labels (n,) int32, train_mask (n,) bool)``, host arrays."""
    adj, x, labels, mask = synthetic_node_classification(
        n, f, c, avg_degree=avg_degree, seed=seed)
    return normalize_adjacency(adj), x, labels, mask


def mesh_gcn_task(f: int = 64, c: int = 16, seed: int = 0,
                  scale: float = 1.0):
    """A node-classification task on a FEM mesh: the normalized
    adjacency of ``cop20k_like(scale=scale)`` (121,192 nodes at full
    size) in f32, with labels, class-correlated features (class by
    ``draw_class_features``, as ``synthetic_node_classification``
    makes them) and a 70 % train mask drawn from ``seed``. Returns host arrays
    as ``gcn_task`` does."""
    a_hat = normalize_adjacency(cop20k_like(scale=scale).astype(np.float32))
    m = a_hat.shape[0]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, size=m)
    x, mask = draw_class_features(rng, labels, f, c)
    return a_hat, x.astype(np.float32), labels.astype(np.int32), mask

"""Bandwidth-reducing row/column reordering (reverse Cuthill-McKee).

PyTorch-port counterpart of ``sparsematrixmultiplicationmpi_tpu/formats/
reorder.py`` — pure numpy, bit-identical permutations.

The band-dense MXU path (``formats/banded.py``) wins when nonzeros cluster
near the diagonal. Many real matrices (meshes, circuits, graphs) only do so
after a bandwidth-reducing permutation — RCM is the classic one. Pure-numpy
BFS implementation (no scipy dependency in this environment).

``apply_symmetric_permutation`` produces ``P A P^T`` plus the permutation,
so users can reorder once at load time, run every SpMM in the banded
layout, and (optionally) de-permute results:

    perm = rcm_ordering(csr)
    csr_p = apply_symmetric_permutation(csr, perm)   # A' = A[perm][:, perm]
    # y' = A' x'  with x' = x[perm]  =>  y = y'[inv]
"""

from __future__ import annotations

import numpy as np

from .matrix import CSR

__all__ = [
    "rcm_ordering", "apply_symmetric_permutation", "permute_rows",
    "bandwidth",
]


def bandwidth(csr: CSR) -> int:
    """Maximum |i - j| over nonzeros."""
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    return int(np.abs(i - j).max()) if len(i) else 0


def _symmetrized_adjacency(csr: CSR):
    """Undirected adjacency (CSR of A + A^T pattern), degrees included."""
    m, n = csr.shape
    if m != n:
        raise ValueError("RCM needs a square matrix")
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = rows * n + cols
    key = np.unique(key)
    rows, cols = key // n, key % n
    row_ptr = np.cumsum(
        np.bincount(rows + 1, minlength=m + 1)[: m + 1]
    ).astype(np.int64)
    return row_ptr, cols.astype(np.int64)


def rcm_ordering(csr: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: ``perm[k]`` = original index of
    the row placed at position ``k``.

    Level-synchronous Cuthill-McKee: BFS proceeds a whole frontier at a
    time (vectorized numpy per level — O(diameter) Python iterations, not
    O(m)); within each new level nodes are ordered by (parent rank,
    degree), the classic CM tie-break. Matches strict sequential CM's
    bandwidth quality on mesh/banded graphs while scaling to
    multi-million-row matrices.
    """
    m, _ = csr.shape
    row_ptr, adj = _symmetrized_adjacency(csr)
    degree = (row_ptr[1:] - row_ptr[:-1]).astype(np.int64)
    visited = np.zeros(m, dtype=bool)
    order = np.empty(m, dtype=np.int64)
    pos = 0
    start_candidates = np.argsort(degree, kind="stable")
    for s in start_candidates:
        if visited[s]:
            continue
        visited[s] = True
        frontier = np.array([s], dtype=np.int64)
        order[pos] = s
        pos += 1
        while len(frontier):
            counts = degree[frontier]
            parent_rank = np.repeat(
                np.arange(len(frontier), dtype=np.int64), counts
            )
            starts = row_ptr[frontier]
            total = int(counts.sum())
            offs = np.arange(total) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            nbrs = adj[np.repeat(starts, counts) + offs]
            keep = ~visited[nbrs]
            nbrs, parent_rank = nbrs[keep], parent_rank[keep]
            if not len(nbrs):
                break
            # Stable unique keeping first occurrence in (parent, degree)
            # order: sort by the CM key, then dedupe.
            key_order = np.lexsort((degree[nbrs], parent_rank))
            nbrs = nbrs[key_order]
            first = np.zeros(len(nbrs), dtype=bool)
            seen_order = np.unique(nbrs, return_index=True)[1]
            first[seen_order] = True
            level = nbrs[np.sort(np.nonzero(first)[0])]
            visited[level] = True
            order[pos: pos + len(level)] = level
            pos += len(level)
            frontier = level
    return order[::-1].copy()  # the "reverse" in RCM


def permute_rows(csr: CSR, perm: np.ndarray) -> CSR:
    """Row-only permutation ``A[perm, :]`` (host-side)."""
    from .matrix import _csr_take_rows

    return _csr_take_rows(csr, np.asarray(perm))


def apply_symmetric_permutation(csr: CSR, perm: np.ndarray) -> CSR:
    """``A[perm][:, perm]`` — the bandwidth-reducing similarity transform."""
    m, n = csr.shape
    if m != n:
        raise ValueError("symmetric permutation needs a square matrix")
    perm = np.asarray(perm)
    inv = np.empty(m, dtype=np.int64)
    inv[perm] = np.arange(m)
    coo = csr.to_coo()
    i = inv[np.asarray(coo.row_indices)]
    j = inv[np.asarray(coo.col_indices)]
    from ..io.mtx import expand_and_build_csr

    return expand_and_build_csr(
        i, j, np.asarray(coo.values), m, n, symmetric=False
    )

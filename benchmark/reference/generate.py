"""The stand-in generators the configurations name.

``generate_fat_vector``, ``fem3d_csr`` and ``cop20k_like`` are frozen
copies: each gives the same arrays, bit for bit, as the program's own
function of the same name at the version the benchmark was defined
against (``benchmark/tests`` checks it at small scale). ``amazon0302_top5``
is the benchmark's own, since the program's ``amazon0302_like`` keeps
fewer links than the published matrix has. They are not imported from
the program, so that a later change to it cannot move the yardstick. A
matrix comes back as ``Csr`` of plain NumPy arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

__all__ = ["Csr", "GENERATORS", "generate_fat_vector", "fem3d_csr",
           "cop20k_like", "amazon0302_top5"]


class Csr(NamedTuple):
    values: np.ndarray       # float, (nnz,)
    col_indices: np.ndarray  # int32, (nnz,)
    row_ptr: np.ndarray      # int32, (m + 1,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def generate_fat_vector(n: int, k: int, seed: int = 0, dtype=np.float64):
    """Dense ``n x k`` fat vector of integers 1..100, as the MPI
    reference's ``generateLargeFatVector`` (``utils.cpp:193-209``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 101, size=(n, k)).astype(dtype)


def _build(rows, cols, values, m, n) -> Csr:
    """COO triplets (0-based, no duplicates) -> CSR sorted by (row, col)."""
    if len(rows) and (rows.min() < 0 or rows.max() >= m
                      or cols.min() < 0 or cols.max() >= n):
        raise ValueError("matrix entry index out of bounds")
    order = np.argsort(rows * np.int64(n) + cols, kind="stable")
    rows, cols, values = rows[order], cols[order], values[order]
    row_ptr = np.cumsum(
        np.bincount(rows + 1, minlength=m + 1)[: m + 1]).astype(np.int32)
    return Csr(values, cols.astype(np.int32), row_ptr, (int(m), int(n)))


def fem3d_csr(m: int, target_nnz: int, seed: int = 0,
              dtype=np.float64) -> Csr:
    """Symmetric 3-D finite-element mesh: the first ``m`` points of an
    ``s^3`` lattice, each coupled to its 27-point stencil, undirected
    edges decimated at random to ``target_nnz`` stored entries, nodes
    numbered at random; values uniform(-1, 1), symmetric, with the
    diagonal always present."""
    rng = np.random.default_rng(seed)
    s = int(np.ceil(m ** (1.0 / 3.0)))
    ids = np.arange(m, dtype=np.int64)
    x, y, z = ids % s, (ids // s) % s, ids // (s * s)
    canon = [
        (dx, dy, dz)
        for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        if (dz, dy, dx) > (0, 0, 0)
    ]
    ei, ej = [], []
    for dx, dy, dz in canon:
        nx, ny, nz = x + dx, y + dy, z + dz
        ok = (nx >= 0) & (nx < s) & (ny >= 0) & (ny < s) & (nz >= 0) & (nz < s)
        nb = nx + ny * s + nz * s * s
        ok &= nb < m
        ei.append(ids[ok])
        ej.append(nb[ok])
    ei = np.concatenate(ei)
    ej = np.concatenate(ej)
    target_edges = max((int(target_nnz) - m) // 2, 0)
    if target_edges < len(ei):
        keep = rng.permutation(len(ei))[:target_edges]
        ei, ej = ei[keep], ej[keep]
    relabel = rng.permutation(m).astype(np.int64)
    ei, ej = relabel[ei], relabel[ej]
    rows = np.concatenate([ei, ej, np.arange(m, dtype=np.int64)])
    cols = np.concatenate([ej, ei, np.arange(m, dtype=np.int64)])
    ev = rng.uniform(-1.0, 1.0, size=len(ei)).astype(dtype)
    dv = rng.uniform(-1.0, 1.0, size=m).astype(dtype)
    vals = np.concatenate([ev, ev, dv])
    return _build(rows, cols, vals, m, m)


def cop20k_like(seed: int = 0, dtype=np.float64, scale: float = 1.0) -> Csr:
    """Stand-in for SuiteSparse ``Williams/cop20k_A`` (121,192^2, 2,624,331
    entries, symmetric 3-D FEM): ``fem3d_csr`` at its size."""
    m = max(int(121_192 * scale), 16)
    target_nnz = max(int(2_624_331 * scale), m)
    return fem3d_csr(m, target_nnz, seed=seed, dtype=dtype)


def amazon0302_top5(seed: int = 0, dtype=np.float64,
                    scale: float = 1.0) -> Csr:
    """Stand-in for SuiteSparse ``SNAP/amazon0302`` with its published
    counts: 262,111 nodes and 1,234,877 links, none to itself, at most 5
    out of each node (the crawl kept each product's top co-purchases).
    Each node draws 5 distinct targets, 85 % at a cyclic id distance
    drawn from a geometric law of mean 40 and 15 % uniform (an assumed
    crawl-order locality); links dropped at random then leave exactly the
    published count. All values 1 (a pattern file).

    This is the benchmark's own generator, not a copy of the program's
    ``amazon0302_like``, which draws out-degrees from ``Binomial(8,
    4.71/8)`` capped at 5 and keeps about 1,120,454 links after
    duplicates are dropped."""
    rng = np.random.default_rng(seed)
    m = max(int(262_111 * scale), 16)
    target = min(max(int(1_234_877 * scale), m), 5 * m)
    out_deg, draws = 5, 12
    cols = np.full((m, out_deg), -1, dtype=np.int64)
    todo = np.arange(m, dtype=np.int64)
    while todo.size:
        rows = np.repeat(todo, draws).reshape(-1, draws)
        short = rng.uniform(size=rows.shape) < 0.85
        dist = rng.geometric(1.0 / 40.0, size=rows.shape)
        sign = rng.choice((-1, 1), size=rows.shape)
        cand = np.where(short, (rows + sign * dist) % m,
                        rng.integers(0, m, size=rows.shape))
        # A candidate counts once, and never the node itself: mark each
        # repeat (in draw order) and self-link, keep the first 5 left.
        order = np.argsort(cand, axis=1, kind="stable")
        srt = np.take_along_axis(cand, order, axis=1)
        rep = np.zeros_like(srt, dtype=bool)
        rep[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad = np.zeros_like(rep)
        np.put_along_axis(bad, order, rep, axis=1)
        ok = ~bad & (cand != rows)
        rank = np.cumsum(ok, axis=1)
        full = rank[:, -1] >= out_deg
        take = ok & (rank <= out_deg)
        done = todo[full]
        cols[done] = cand[full][take[full]].reshape(-1, out_deg)
        todo = todo[~full]
    rows = np.repeat(np.arange(m, dtype=np.int64), out_deg)
    keep = np.sort(rng.permutation(rows.size)[:target])
    rows, cols = rows[keep], cols.ravel()[keep]
    return _build(rows, cols, np.ones(rows.size, dtype=dtype), m, m)


#: The generators a configuration file may name under ``generator``.
GENERATORS = {"cop20k_like": cop20k_like, "amazon0302_top5": amazon0302_top5}

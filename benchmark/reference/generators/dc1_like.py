"""Stand-in for SuiteSparse ``IBM_EDA/dc1`` (116,835^2, 766,396 entries):
a DC operating-point circuit matrix whose ground and supply rails touch a
large share of all nodes.

A frozen copy of the program's ``io/generate.py::dc1_like`` and of what
it takes from ``io/mtx.py::expand_and_build_csr`` (a general, not a
symmetric, build: the triplets are sorted by (row, col) as they are, and
a pair drawn twice stays two stored entries). It imports nothing of the
program; ``benchmark/tests/test_benchmark_dc1.py`` holds it to the
program's bit for bit at small scale.

Model (the program's): a symmetric random device graph at the matched
mean degree, four rail nets whose degrees are fractions of m (0.35, 0.10,
0.03, 0.01; a documented modelling assumption, since the reference
publishes no per-row statistics of the file), and the full diagonal.
Device values uniform(-1, 1), mirrored; diagonal uniform(0.5, 2).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.generate import Csr, _build

__all__ = ["generate", "RAIL_FRACTIONS"]

RAIL_FRACTIONS = (0.35, 0.10, 0.03, 0.01)


def generate(seed: int = 0, dtype=np.float64, scale: float = 1.0) -> Csr:
    rng = np.random.default_rng(seed)
    m = max(int(116_835 * scale), 64)
    target_nnz = max(int(766_396 * scale), m)
    hub_edges_i, hub_edges_j = [], []
    hubs = rng.choice(m, size=len(RAIL_FRACTIONS), replace=False)
    for h, frac in zip(hubs, RAIL_FRACTIONS):
        # The floor keeps a rail far denser than a device stamp at any size.
        hub_deg = min(m - 1, max(int(m * frac), 64))
        nb = rng.choice(m, size=hub_deg, replace=False)
        nb = nb[nb != h]
        hub_edges_i.append(np.full(nb.size, h, dtype=np.int64))
        hub_edges_j.append(nb.astype(np.int64))
    hi = np.concatenate(hub_edges_i)
    hj = np.concatenate(hub_edges_j)
    # Device stamps: the remaining budget as random symmetric edges.
    budget = max(target_nnz - m - 2 * len(hi), 0) // 2
    di = rng.integers(0, m, size=budget)
    dj = rng.integers(0, m, size=budget)
    ok = di != dj
    di, dj = di[ok], dj[ok]
    ei = np.concatenate([hi, di])
    ej = np.concatenate([hj, dj])
    rows = np.concatenate([ei, ej, np.arange(m, dtype=np.int64)])
    cols = np.concatenate([ej, ei, np.arange(m, dtype=np.int64)])
    ev = rng.uniform(-1.0, 1.0, size=len(ei)).astype(dtype)
    dv = rng.uniform(0.5, 2.0, size=m).astype(dtype)
    vals = np.concatenate([ev, ev, dv])
    return _build(rows, cols, vals, m, m)

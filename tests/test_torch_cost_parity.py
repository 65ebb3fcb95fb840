"""Under the reference's table (``V5E``) the port routes as the JAX
package does: on the results sweep's matrices at scale 0.05, the pick
and ``est_seconds`` of ``auto_format`` and the strategy of
``Auto._mesh_route``, bit for bit, priced for the CPU, for no device and
with the table passed."""

from __future__ import annotations

import numpy as np
import pytest

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.ops.auto as JA
import sparsematrixmultiplicationmpi_tpu.parallel.strategies as JS
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
import sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies as TS
from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import V5E
from sparsematrixmultiplicationmpi_tpu_torch.scripts.run_results_sweep import (
    BUILDERS,
)

SCALE = 0.05


def _n(x):
    return max(int(x * SCALE), 16)


#: The results sweep's builders through the JAX package's generators.
JAX_BUILDERS = {
    "cage4_like": lambda: JG.cage4_like(),
    "fem_banded_100k": lambda: JG.banded_csr(_n(100_000), 150, 18, seed=11),
    "powerlaw_100k": lambda: JG.powerlaw_csr(_n(100_000), _n(100_000),
                                             _n(1_500_000), seed=12),
    "uniform_random_100k": lambda: JG.random_csr(
        _n(100_000), _n(100_000), _n(1_200_000), seed=13),
    "amazon0302_like": lambda: JG.amazon0302_like(scale=SCALE),
    "cop20k_like": lambda: JG.cop20k_like(scale=SCALE),
    "roadnet_like": lambda: JG.roadnet_like(scale=SCALE),
    "dc1_like": lambda: JG.dc1_like(scale=SCALE),
}


def _key(op):
    """What identifies a pick: its type and its defining fields."""
    out = [type(op).__name__]
    for f in ("block_rows", "chunk_cols", "pairs_per_step", "est_seconds",
              "n_pairs"):
        if hasattr(op, f):
            out.append((f, getattr(op, f)))
    if hasattr(op, "pair_block"):
        out.append(np.asarray(op.pair_block).tobytes())
    if hasattr(op, "buckets"):
        out.append(tuple(np.asarray(b.cols).shape for b in op.buckets))
    return out


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_v5e_routes_as_the_jax_package(name, k):
    jc = JAX_BUILDERS[name]().astype(np.float32)
    tc = BUILDERS[name](SCALE).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jc.values), tc.values)
    kw = {"k_nominal": k}
    j_op, j_est = JA._auto_with_est(jc, "auto", kw, allow_hub=False)
    for t_op, t_est in (
            TA._auto_with_est(tc, "auto", kw, False, V5E),
            (TA.auto_format(tc, device="cpu", k_nominal=k), None),
            (TA.auto_format(tc, cost_table=V5E, k_nominal=k), None),
            (TA.auto_format(tc, k_nominal=k), None)):
        assert _key(t_op) == _key(j_op)
        if t_est is not None:
            assert t_est == j_est  # bit for bit
    # The candidates auto_format weighs: its pick is their cheapest.
    cands = [c for c in TA.route_candidates(tc, device="cpu", k_nominal=k)
             if c[2] is not None]
    assert min(cands, key=lambda c: c[1])[1] == j_est
    if jc.shape[0] == jc.shape[1]:
        j_route = type(JS.Auto(k_nominal=k)._mesh_route(jc)).__name__
        assert type(TS.Auto(k_nominal=k)._mesh_route(tc)).__name__ == j_route
        assert type(TS.Auto(k_nominal=k)._mesh_route(tc, "cpu")).__name__ \
            == j_route

"""The JAX package's side of the port's multi-rank tests: each case of
``_torch_dist_ranks`` run by the JAX strategies on ``p`` of
``conftest.py``'s virtual CPU devices, and the comparisons."""

import jax.numpy as jnp
import numpy as np

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.parallel import (
    Grid2D, get_strategy, make_mesh, make_mesh_2d,
)
from sparsematrixmultiplicationmpi_tpu_torch.utils.compare import (
    are_matrices_equal, default_tolerance,
)

import _torch_dist_ranks as R

_JAX_DTYPES = {None: None, "float32": np.float32, "bfloat16": jnp.bfloat16}


def jax_matrix(c):
    return R.build(c["matrix"], JG, JCSR, _JAX_DTYPES[c["dtype"]])


def jax_run(c, p):
    """``(global output, oracle)`` of case ``c`` through the JAX package
    on ``p`` devices; the oracle is the dense float64 product."""
    csr = jax_matrix(c)
    v64 = JG.generate_fat_vector(csr.shape[1], c["k"], seed=c["seed"])
    v = jnp.asarray(v64, _JAX_DTYPES[c["dtype"]] or jnp.float64)
    if c["mesh2d"] is not None:
        mesh, strategy = make_mesh_2d(*c["mesh2d"]), Grid2D(**c["kwargs"])
    else:
        mesh = make_mesh(p)
        strategy = get_strategy(c["strategy"], **c["kwargs"])
    op = strategy.prepare(csr, mesh)
    g = c["gather"]
    if c["mode"] == "spmm":
        out = strategy.spmm(op, v, mesh, gather_result=g)
    elif c["mode"] == "permuted":
        out = strategy.spmm_permuted(op, op.encode(v), mesh,
                                     gather_result=g)
    else:
        enc, body, dec = strategy.chain_parts(op, mesh, gather_result=g)
        x = body(enc(v, op), op)
        if c["mode"] == "chain2":
            x = body(x, op)
        out = dec(x, op)
    dense = np.asarray(csr.to_dense(), np.float64)
    vv = np.asarray(v, np.float64)
    oracle = dense @ vv
    if c["mode"] == "chain2":
        oracle = dense @ oracle
    return np.asarray(out, np.float64), oracle, op


def close(got, want, c, scale_ref=None):
    """Within the case dtype's tier: 1e-10 absolute in float64 (two f64
    sums in another order), ``default_tolerance`` relative in float32, 5e-2
    of the result's scale in bfloat16."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False
    if c["dtype"] is None:
        return float(np.max(np.abs(got - want), initial=0.0)) <= 1e-10 * max(
            1.0, float(np.max(np.abs(want), initial=0.0)))
    if c["dtype"] == "bfloat16":
        # the JAX package's own bf16 gate (tests/test_parallel.py): the
        # largest error over the result's scale
        scale = max(float(np.max(np.abs(want), initial=0.0)), 1.0)
        return float(np.max(np.abs(got - want), initial=0.0)) / scale < 5e-2
    return are_matrices_equal(got, want, relative=True,
                              tolerance=default_tolerance(np.float32))


def check_case(c, p, rank_results):
    """The ranks' result of case ``c`` against the oracle (whole result)
    and against the JAX package's output (same layout)."""
    outs = [r[c["id"]]["out"] for r in rank_results]
    fulls = [r[c["id"]]["full"] for r in rank_results]
    j_out, oracle, _ = jax_run(c, p)
    for full in fulls:
        assert close(full, oracle, c), (c["id"], "oracle")
    got = R.assemble(c, outs, p)
    assert got.shape[0] >= j_out.shape[0] and got.shape[1] >= j_out.shape[1]
    got = got[: j_out.shape[0], : j_out.shape[1]]
    assert close(got, j_out, c), (c["id"], "jax")

"""The port's models (CG, preconditioned CG, CGLS, Jacobi, PageRank, power
iteration, Lanczos) against the JAX package's on the same systems, the
CG system of the model benchmark, and CG over the port's ``Auto`` band
operand against JAX CG over the reference's einsum route.

Tolerances: in float64 both sides run the same iteration over sums taken
in another order, so iteration counts are equal and solutions agree to
1e-10 (ranks to 1e-12); only unpreconditioned CG on an ill-conditioned
system, past 3n iterations, agrees in its count to 1 %. Start vectors of
power iteration and Lanczos come from different generators, so those
compare eigenvalues only, against JAX and ``numpy.linalg.eigh``. The f32
CG compares solutions to 1e-4 of their largest entry: a few f32
roundings per iteration, four iterations.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.models as JM
from sparsematrixmultiplicationmpi_tpu import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu import BucketedELL as JBucketedELL
from sparsematrixmultiplicationmpi_tpu import spmm_bucketed as j_spmm_bucketed
from sparsematrixmultiplicationmpi_tpu.io.mtx import (
    expand_and_build_csr as j_expand_and_build_csr,
)
from sparsematrixmultiplicationmpi_tpu.ops.auto import (
    auto_format as j_auto_format, spmm_any as j_spmm_any,
)
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.models as TM
from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
    spd_banded_system,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    COO, BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    auto_format, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.ell import spmm_bucketed
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.parallel import Auto


def _port_csr(dense):
    rows, cols = np.nonzero(dense)
    return COO.from_arrays(dense[rows, cols], rows, cols,
                           dense.shape).to_csr()


def _closures(dense):
    """(port closure, JAX closure) over bucketed ELL of ``dense``."""
    bell = BucketedELL.from_csr(_port_csr(dense)).to("cpu")
    jbell = JBucketedELL.from_csr(JCSR.from_dense(dense))
    return (lambda v: spmm_bucketed(bell, v),
            lambda v: j_spmm_bucketed(jbell, v))


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _same_solve(got, want, atol=1e-10):
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=atol,
                               rtol=0)


def _cg_systems():
    d = np.asarray(JG.banded_csr(80, 3, 3, seed=43).to_dense())
    spd = d @ d.T + 5 * np.eye(80)
    tri = 4 * np.eye(16) + np.diag(np.ones(15), 1) + np.diag(np.ones(15), -1)
    return {
        "fat-rhs": (spd, np.random.default_rng(44).normal(size=(80, 3)),
                    1e-12),
        "1d-rhs": (tri, np.arange(16.0), 1e-10),
    }


@pytest.mark.parametrize("name", list(_cg_systems()))
def test_conjugate_gradient_matches_jax_f64(name):
    a, b, tol = _cg_systems()[name]
    port, jax_op = _closures(a)
    got = TM.conjugate_gradient(port, _t(b), tol=tol)
    want = JM.conjugate_gradient(jax_op, jnp.asarray(b), tol=tol)
    assert got.x.shape == tuple(b.shape)
    _same_solve(got, want)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(a, b),
                               atol=1e-6)
    assert float(got.residual_norm) == pytest.approx(
        float(want.residual_norm), rel=1e-6, abs=1e-15)


def test_preconditioned_cg_matches_jax_f64():
    rng = np.random.default_rng(217)
    n = 100
    diag = 10.0 ** rng.uniform(0, 4, size=n)
    off = rng.normal(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.05)
    a = (off + off.T) * 0.1 + np.diag(diag)
    b = rng.normal(size=n)
    port, jax_op = _closures(a)
    inv_d, j_inv_d = _t(1.0 / diag), jnp.asarray(1.0 / diag)
    got = TM.conjugate_gradient(port, _t(b), tol=1e-10, max_iter=2000,
                                preconditioner=lambda r: r * inv_d[:, None])
    want = JM.conjugate_gradient(jax_op, jnp.asarray(b), tol=1e-10,
                                 max_iter=2000,
                                 preconditioner=lambda r: r * j_inv_d[:, None])
    _same_solve(got, want)
    # Unpreconditioned, this system (condition ~1e4) takes over 3n
    # iterations: CG has lost orthogonality, and the count depends on the
    # order of each sum, so the two counts agree to 1 %, not exactly.
    plain = TM.conjugate_gradient(port, _t(b), tol=1e-10, max_iter=2000)
    j_plain = JM.conjugate_gradient(jax_op, jnp.asarray(b), tol=1e-10,
                                    max_iter=2000)
    assert plain.iterations == pytest.approx(int(j_plain.iterations),
                                             rel=0.01)
    assert got.iterations < plain.iterations
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(a, b),
                               atol=1e-5)


def test_jacobi_matches_jax_f64():
    rng = np.random.default_rng(45)
    off = rng.uniform(-0.1, 0.1, size=(30, 30)) * (
        rng.uniform(size=(30, 30)) < 0.2)
    np.fill_diagonal(off, 0)
    a = off + np.eye(30) * 3.0
    b = rng.normal(size=30)
    port, jax_op = _closures(a)
    got = TM.jacobi(port, _t(np.diag(a)), _t(b))
    want = JM.jacobi(jax_op, jnp.asarray(np.diag(a)), jnp.asarray(b))
    _same_solve(got, want)
    assert got.x.shape == (30,)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(a, b),
                               atol=1e-7)


@pytest.mark.parametrize("shape,k,seeds", [
    ((80, 30, 500), 2, (213, 214)),
    ((40, 25, 300), None, (215, 216)),
], ids=["overdetermined", "1d-rhs"])
def test_cgls_matches_jax_f64(shape, k, seeds):
    m, n, nnz = shape
    a = np.asarray(JG.random_csr(m, n, nnz, seed=seeds[0]).to_dense())
    port, jax_op = _closures(a)
    port_t, jax_t = _closures(np.ascontiguousarray(a.T))
    rng = np.random.default_rng(seeds[1])
    b = rng.normal(size=m if k is None else (m, k))
    got = TM.cgls(port, port_t, _t(b), tol=1e-14, max_iter=500)
    want = JM.cgls(jax_op, jax_t, jnp.asarray(b), tol=1e-14, max_iter=500)
    _same_solve(got, want)
    np.testing.assert_allclose(got.x.numpy(),
                               np.linalg.lstsq(a, b, rcond=None)[0],
                               atol=1e-6)


def test_pagerank_matches_jax_f64():
    jcsr = JG.random_csr(60, 60, 500, seed=41)
    jcsr = dataclasses.replace(jcsr, values=jnp.abs(jcsr.values))
    tcsr = TG.random_csr(60, 60, 500, seed=41)
    tcsr = dataclasses.replace(tcsr, values=np.abs(tcsr.values))
    jnorm = JM.normalize_columns(jcsr)
    tnorm = TM.normalize_columns(tcsr)
    np.testing.assert_array_equal(tnorm.values, np.asarray(jnorm.values))
    bell = BucketedELL.from_csr(tnorm).to("cpu")
    jbell = JBucketedELL.from_csr(jnorm)
    ranks, iters = TM.pagerank(lambda v: spmm_bucketed(bell, v), 60,
                               tol=1e-12, device="cpu")
    jranks, jiters = JM.pagerank(lambda v: j_spmm_bucketed(jbell, v), 60,
                                 tol=1e-12)
    assert iters == int(jiters) < 200
    np.testing.assert_allclose(ranks.numpy(), np.asarray(jranks), atol=1e-12,
                               rtol=0)
    assert float(ranks.sum()) == pytest.approx(1.0, abs=1e-9)


def _sym(n=60, seed=211, shift=6.0):
    d = np.asarray(JG.banded_csr(n, 4, 3, seed=seed).to_dense())
    return d + d.T + shift * np.eye(n)


def test_topk_eigsh_matches_jax_and_eigh():
    sym = _sym()
    port, jax_op = _closures(sym)
    vals, vecs = TM.topk_eigsh(port, 60, k=3, steps=60, device="cpu")
    jvals, _ = JM.topk_eigsh(jax_op, 60, k=3, steps=60)
    dense = np.linalg.eigvalsh(sym)
    top3 = dense[np.argsort(-np.abs(dense))[:3]]
    np.testing.assert_allclose(np.sort(vals.numpy()), np.sort(top3),
                               rtol=1e-8)
    np.testing.assert_allclose(np.sort(vals.numpy()),
                               np.sort(np.asarray(jvals)), rtol=1e-8)
    for i in range(3):
        v = vecs[:, i].numpy()
        assert np.linalg.norm(sym @ v - float(vals[i]) * v) < 1e-6
    basis = TM.lanczos(port, 60, steps=20, device="cpu").vectors.numpy()
    np.testing.assert_allclose(basis @ basis.T, np.eye(20), atol=1e-8)


def test_power_iteration_matches_jax_and_eigh():
    d = np.asarray(JG.random_csr(40, 40, 300, seed=42).to_dense())
    sym = d + d.T + 10 * np.eye(40)
    port, jax_op = _closures(sym)
    lam, vec, iters = TM.power_iteration(port, 40, tol=1e-12,
                                         device="cpu")
    jlam, _, _ = JM.power_iteration(jax_op, 40, tol=1e-12)
    eigs = np.linalg.eigvalsh(sym)
    target = eigs[np.argmax(np.abs(eigs))]
    assert float(lam) == pytest.approx(target, rel=1e-6)
    assert float(lam) == pytest.approx(float(jlam), rel=1e-6)
    assert vec.shape == (40,) and 0 < iters < 500


def _recipe_with_jax_package(m, seed):
    """``scripts/run_models_bench.py``'s SPD construction, verbatim, on the
    JAX package's own functions."""
    spd_csr = JG.banded_csr(m, 60, 12, seed=seed)
    coo = spd_csr.to_coo()
    i, j = np.asarray(coo.row_indices), np.asarray(coo.col_indices)
    vals = np.abs(np.asarray(coo.values))
    sym = j_expand_and_build_csr(np.concatenate([i, j]),
                                 np.concatenate([j, i]),
                                 np.concatenate([vals, vals]) * 0.01,
                                 m, m, False)
    deg = np.zeros(m)
    np.add.at(deg, np.asarray(sym.to_coo().row_indices),
              np.abs(np.asarray(sym.values)))
    return j_expand_and_build_csr(
        np.concatenate([np.asarray(sym.to_coo().row_indices), np.arange(m)]),
        np.concatenate([np.asarray(sym.to_coo().col_indices), np.arange(m)]),
        np.concatenate([np.asarray(sym.values), deg + 1.0]),
        m, m, False).astype(jnp.float32)


def test_spd_banded_system_is_the_model_benchmark_matrix():
    m = 3000
    want = _recipe_with_jax_package(m, seed=2)
    got = spd_banded_system(m, seed=2)
    for field in ("values", "col_indices", "row_ptr"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))
    assert got.values.dtype == np.float32 and got.shape == (m, m)
    dense = got.to_dense().astype(np.float64)
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0
    for k_nominal in (8, 32):
        op = auto_format(got, k_nominal=k_nominal)
        jop = j_auto_format(want, k_nominal=k_nominal)
        assert type(op).__name__ == type(jop).__name__ == "BandedBlocks"
        assert op.block_rows == jop.block_rows == 128
        assert op.spill is None and jop.spill is None


def test_cg_over_auto_band_operand_matches_jax_f32():
    m = 3000
    spd = spd_banded_system(m, seed=2)
    op = Auto(k_nominal=8).prepare(spd, "cpu")
    assert type(op).__name__ == "BandedBlocks" and op.spill is None
    jop = j_auto_format(_recipe_with_jax_package(m, seed=2), k_nominal=8)
    b = np.random.default_rng(3).normal(size=(m, 8)).astype(np.float32)
    got = TM.conjugate_gradient(lambda x: spmm_any(op, x),
                                torch.from_numpy(b), tol=1e-5, max_iter=200)
    want = JM.conjugate_gradient(
        lambda x: j_spmm_any(jop, x, use_pallas=False), jnp.asarray(b),
        tol=1e-5, max_iter=200)
    assert got.x.dtype == torch.float32
    assert got.iterations == int(want.iterations)
    x, jx = got.x.numpy(), np.asarray(want.x)
    assert np.abs(x - jx).max() <= 1e-4 * np.abs(jx).max()
    res = b - spmm_host_f64(spd, x.astype(np.float64))
    rel = np.linalg.norm(res, axis=0) / np.linalg.norm(b, axis=0)
    assert rel.max() < 1e-4


@pytest.mark.parametrize("fn", ["pagerank", "power_iteration", "lanczos",
                                "topk_eigsh"])
def test_model_entry_points_default_to_the_card(fn):
    # An entry point runs on the card unless the caller asks for the CPU:
    # on a machine without one the default raises, it does not quietly
    # run on the CPU.
    sig = inspect.signature(getattr(TM, fn))
    assert sig.parameters["device"].default == "cuda"

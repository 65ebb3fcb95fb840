"""Models over a mesh of spawned CPU ranks (gloo), against the
one-device port and the JAX package: a GCN trained over ``RowWise``
through the distributed symmetric SpMM, CG, Lanczos and PageRank taking
the distributed SpMM as their operator (``tests/test_distributed_models
.py``, ``tests/test_grid2d_serialize.py``), ``comm_comp_split``,
``trace`` / ``annotate``, and ``dryrun_multichip(4, device="cpu")``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.models.gcn as JGCN
import sparsematrixmultiplicationmpi_tpu.ops.autodiff as JAD
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.models as TM
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.models import (
    conjugate_gradient as j_cg, pagerank as j_pagerank,
)
from sparsematrixmultiplicationmpi_tpu.ops.auto import (
    auto_format as j_auto_format,
)
from sparsematrixmultiplicationmpi_tpu.parallel import (
    BandedRowWise as JBandedRowWise, make_mesh,
)
from sparsematrixmultiplicationmpi_tpu_torch.entry import dryrun_multichip
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import auto_format
from sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff import (
    make_symmetric_spmm,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.ell import spmm_bucketed
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    RowWise, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.utils.profiling import (
    annotate, trace,
)

import _torch_dist_ranks as R

N, F, H, NC, STEPS = 128, 12, 24, 3, 3
F64 = 1e-10


def _close(got, want, rtol=F64):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def jax_gcn():
    """The JAX package's GCN on the same graph in float64: initial
    parameters, first loss and gradients, then three optax Adam steps."""
    jadj, jx, jl, jm = JGCN.synthetic_node_classification(
        N, F, NC, seed=330, dtype=jnp.float64)
    jspmm = JAD.make_symmetric_spmm(j_auto_format(
        JGCN.normalize_adjacency(jadj)))
    params = JGCN.init_gcn(jax.random.PRNGKey(0), F, H, NC,
                           dtype=jnp.float64)
    loss, grads = jax.value_and_grad(JGCN.gcn_loss)(params, jspmm, jx, jl,
                                                    jm)
    opt = optax.adam(1e-2)
    state, p = opt.init(params), params
    step = JGCN.make_train_step(jspmm, opt)
    losses = []
    for _ in range(STEPS):
        p, state, ls = step(p, state, jx, jl, jm)
        losses.append(float(ls))
    return dict(params0=[np.asarray(a) for a in params], loss=float(loss),
                grads=[np.asarray(g) for g in grads], losses=losses,
                params=[np.asarray(a) for a in p])


@pytest.fixture(scope="module")
def ranks(jax_gcn):
    """One group of 4 ranks: the GCN, then the solvers."""
    return (run_ranks(R.gcn_steps, 4, N, F, H, NC, jax_gcn["params0"],
                      STEPS, device="cpu", timeout=600),
            run_ranks(R.solvers, 4, device="cpu", timeout=600))


def test_gcn_loss_and_gradients_equal_one_device_and_jax(ranks, jax_gcn):
    """Every rank's first loss and gradients are the one-device port's
    and ``jax.value_and_grad``'s at the same parameters."""
    adj, x, labels, mask = TM.synthetic_node_classification(
        N, F, NC, seed=330, dtype=np.float64)
    spmm = make_symmetric_spmm(auto_format(TM.normalize_adjacency(adj)).to(
        "cpu"))
    params = TM.gcn_params_from_jax(jax_gcn["params0"], device="cpu")
    data = [torch.from_numpy(a) for a in (x, labels, mask)]
    loss = TM.gcn_loss(params, spmm, *data)
    loss.backward()
    for r in ranks[0]:
        assert float(r["loss"]) == pytest.approx(float(loss.detach()), rel=F64)
        assert float(r["loss"]) == pytest.approx(jax_gcn["loss"], rel=F64)
        for g, one, j in zip(r["grads"], params, jax_gcn["grads"]):
            _close(g, one.grad)
            _close(g, j)


def test_gcn_adam_steps_keep_ranks_identical(ranks, jax_gcn):
    """Three Adam steps: losses and parameters equal to optax's, and the
    parameters identical, bit for bit, on every rank (no gradient
    collective is needed: every rank computes the whole loss)."""
    first = ranks[0][0]
    for r in ranks[0]:
        np.testing.assert_allclose(r["losses"], jax_gcn["losses"],
                                   rtol=F64)
        for a, b, j in zip(r["params"], first["params"], jax_gcn["params"]):
            assert np.array_equal(a, b)
            _close(a, j)


def test_cg_over_the_distributed_band(ranks):
    """CG where every matvec is the halo-exchange band strategy: the
    solution of ``np.linalg.solve`` and of the JAX package's CG over its
    band strategy on 4 devices."""
    d = np.asarray(JG.banded_csr(96, 3, 3, seed=150).to_dense())
    spd = d @ d.T + 8 * np.eye(96)
    b = np.random.default_rng(151).normal(size=(96, 2))
    strat = JBandedRowWise(block_rows=8)
    mesh = make_mesh(4)
    op = strat.prepare(JCSR.from_dense(spd), mesh)
    jres = j_cg(lambda x: strat.spmm(op, x, mesh), jnp.asarray(b),
                tol=1e-12)
    for r in ranks[1]:
        np.testing.assert_allclose(r["cg_x"], np.linalg.solve(spd, b),
                                   atol=1e-6)
        np.testing.assert_allclose(r["cg_x"], np.asarray(jres.x),
                                   atol=1e-9)


def test_lanczos_over_the_distributed_band(ranks):
    d = np.asarray(TG.banded_csr(96, 3, 3, seed=331).to_dense())
    dense_vals = np.linalg.eigvalsh(d + d.T + 6 * np.eye(96))
    top2 = dense_vals[np.argsort(-np.abs(dense_vals))[:2]]
    for r in ranks[1]:
        np.testing.assert_allclose(np.sort(r["eig"]), np.sort(top2),
                                   rtol=1e-7)


def test_pagerank_over_row_wise_and_windowed_halo(ranks):
    """PageRank through ``RowWise`` equals the one-device port's (bucketed
    ELL) and the JAX package's; through the halo-mode windowed strategy
    it equals a dense reference."""
    csr = TG.random_csr(60, 60, 500, seed=152)
    csr = type(csr)(values=np.abs(csr.values), col_indices=csr.col_indices,
                    row_ptr=csr.row_ptr, shape=csr.shape)
    norm = TM.normalize_columns(csr)
    bell = BucketedELL.from_csr(norm).to("cpu")
    ref, _ = TM.pagerank(lambda x: spmm_bucketed(bell, x), 60, tol=1e-10,
                         device="cpu")
    dense = jnp.asarray(norm.to_dense())
    jref, _ = j_pagerank(lambda x: dense @ x, 60, tol=1e-10)
    fem = TM.normalize_columns(TG.fem3d_csr(1500, 30000, seed=244))
    fem_dense = torch.from_numpy(fem.to_dense())
    fem_ref, _ = TM.pagerank(lambda x: fem_dense @ x, 1500, tol=1e-8,
                             device="cpu")
    for r in ranks[1]:
        np.testing.assert_allclose(r["pagerank_row"], ref.numpy(),
                                   atol=1e-8)
        np.testing.assert_allclose(r["pagerank_row"], np.asarray(jref),
                                   atol=1e-8)
        assert r["pagerank_windowed_mode"] == "halo"
        np.testing.assert_allclose(r["pagerank_windowed"],
                                   fem_ref.numpy(), atol=1e-6)


def test_comm_split_and_distributed_run_benchmark(ranks):
    for r in ranks[1]:
        total, comp, comm = r["comm_split"]
        assert total > 0 and comp > 0 and comm >= 0
        assert r["bench"]["correct"] is True
        assert r["bench"]["devices"] == 4 and r["bench"]["gathered"] is False
        assert r["bench"]["comp"] > 0 and r["bench"]["comm"] >= 0
        assert r["bench_amortized_correct"] is True


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    csr = TG.random_csr(64, 64, 400, seed=3)
    row = RowWise()
    op = row.prepare(csr, "cpu")
    v = torch.from_numpy(TG.generate_fat_vector(64, 4, seed=4))
    with trace(str(tmp_path)) as prof:
        with annotate("spmm_phase"):
            row.spmm(op, v)
    assert any(e.key == "spmm_phase" for e in prof.key_averages())
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "spmm_phase" in json.dumps(json.load(f))


def test_dryrun_multichip_on_four_cpu_ranks():
    reports = dryrun_multichip(4, device="cpu")
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert len({r["gcn_loss"] for r in reports}) == 1
    for r in reports:
        assert r["gcn_param_spread"] == 0.0
        assert {"grid2d", "auto", "windowed_row-U16-k8-R128",
                "banded_row-False"} <= set(r["errors"])


def test_dryrun_multichip_defaults_to_the_card():
    """Fewer cards than ranks raises: the dryrun never leaves the card
    unasked (the JAX one falls back to CPU devices)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError):
        dryrun_multichip(have + 1)

"""The port's GNN training path against the JAX package's: the host
builders (``synthetic_node_classification``, ``normalize_adjacency``,
``transpose_csr``), SDDMM, the segment softmax, the custom-gradient SpMM
(``ops/autodiff.py``, a ``torch.autograd.Function``) on bucketed ELL,
COO and windowed operands, the GCN (forward, loss, gradients, three Adam
steps against optax) and the GAT layer, from the same weights carried
across by ``gcn_params_from_jax`` / ``gat_params_from_jax``.

Inputs come from numpy seeds; JAX runs on the CPU with x64 (the test
configuration) and its SpMM on its XLA path. Tolerances: host builders
bit for bit; float64 results within 1e-10 relative to the largest
magnitude compared (both sides sum the same products in other orders),
also for the parameters after three Adam steps (torch and optax apply
the bias corrections in another order; the parameters measured 4e-16
apart); f32 trains to a falling loss.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu.models.gat as JGAT
import sparsematrixmultiplicationmpi_tpu.models.gcn as JGCN
import sparsematrixmultiplicationmpi_tpu.ops.autodiff as JAD
from sparsematrixmultiplicationmpi_tpu.ops.sddmm import sddmm as j_sddmm
from sparsematrixmultiplicationmpi_tpu.formats.matrix import (
    BucketedELL as JBucketedELL,
)
from sparsematrixmultiplicationmpi_tpu.formats.windowed import (
    WindowedPairs as JWindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu.ops.auto import (
    auto_format as j_auto_format,
)
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.models.gat as TGAT
import sparsematrixmultiplicationmpi_tpu_torch.models.gcn as TGCN
import sparsematrixmultiplicationmpi_tpu_torch.ops.autodiff as TAD
from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
    gcn_task, mesh_gcn_task,
)
from sparsematrixmultiplicationmpi_tpu_torch.entry import entry
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    COO, BucketedELL,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    WindowedPairs,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.auto import (
    auto_format, spmm_any,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.library import (
    spmm_library, to_torch_sparse,
)
from sparsematrixmultiplicationmpi_tpu_torch.ops.oracle import spmm_host_f64
from sparsematrixmultiplicationmpi_tpu_torch.ops.sddmm import sddmm, sddmm_coo

CPU = torch.device("cpu")
F64_RTOL = 1e-10


def _close(got, want, rtol=F64_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _same_csr(j, t):
    assert j.shape == t.shape
    for f in ("values", "col_indices", "row_ptr"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---- host builders, bit for bit ----------------------------------------

@pytest.mark.parametrize("n,f,c,deg,seed", [
    (40, 8, 3, 8, 230), (300, 12, 4, 16, 1), (2000, 16, 5, 6, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_node_classification_matches_jax_bitwise(n, f, c, deg,
                                                           seed, dtype):
    jadj, jx, jl, jm = JGCN.synthetic_node_classification(
        n, f, c, avg_degree=deg, seed=seed, dtype=dtype)
    adj, x, labels, mask = TGCN.synthetic_node_classification(
        n, f, c, avg_degree=deg, seed=seed, dtype=dtype)
    _same_csr(jadj, adj)
    for a, b in ((jx, x), (jl, labels), (jm, mask)):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _with_empty_rows(g):
    csr = g.random_csr(50, 50, 200, seed=9)
    coo = csr.to_coo()
    keep = np.asarray(coo.row_indices) % 7 != 3
    rows = np.asarray(coo.row_indices)[keep]
    cols = np.asarray(coo.col_indices)[keep]
    return type(coo).from_arrays(np.asarray(coo.values)[keep], rows, cols,
                                 (50, 50)).to_csr()


ADJACENCIES = {
    "synthetic": lambda g: g.banded_csr(64, 6, 4, seed=3),
    "signed_dc1": lambda g: g.dc1_like(scale=0.005),
    "empty_rows": _with_empty_rows,
    "fem": lambda g: g.fem3d_csr(256, 4096, seed=0),
}


@pytest.mark.parametrize("name", sorted(ADJACENCIES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("self_loops", [True, False])
def test_normalize_adjacency_matches_jax_bitwise(name, dtype, self_loops):
    jcsr = ADJACENCIES[name](JG).astype(dtype)
    tcsr = ADJACENCIES[name](TG).astype(dtype)
    want = JGCN.normalize_adjacency(jcsr, add_self_loops=self_loops)
    got = TGCN.normalize_adjacency(tcsr, add_self_loops=self_loops)
    assert got.values.dtype == np.dtype(dtype)
    _same_csr(want, got)


@pytest.mark.parametrize("make", [
    lambda g: g.random_csr(12, 20, 80, seed=201),
    lambda g: g.powerlaw_csr(300, 200, 2000, seed=3),
    lambda g: g.dc1_like(scale=0.005),
], ids=["random", "powerlaw", "dc1"])
def test_transpose_csr_matches_jax_bitwise(make):
    want = JAD.transpose_csr(make(JG))
    got = TAD.transpose_csr(make(TG))
    _same_csr(want, got)
    np.testing.assert_array_equal(got.to_dense(), make(TG).to_dense().T)


def test_gcn_task_is_the_benchmark_graph():
    a_hat, x, labels, mask = gcn_task(n=2000, f=16, c=4)
    jadj, jx, jl, jm = JGCN.synthetic_node_classification(
        2000, 16, 4, avg_degree=16, seed=1)
    _same_csr(JGCN.normalize_adjacency(jadj), a_hat)
    np.testing.assert_array_equal(np.asarray(jx), x)
    np.testing.assert_array_equal(np.asarray(jl), labels)
    np.testing.assert_array_equal(np.asarray(jm), mask)


def test_mesh_gcn_task_is_a_normalized_symmetric_mesh():
    a_hat, x, labels, mask = mesh_gcn_task(f=8, c=3, seed=2, scale=0.01)
    m = a_hat.shape[0]
    _same_csr(JGCN.normalize_adjacency(
        JG.cop20k_like(scale=0.01).astype(np.float32)), a_hat)
    dense = a_hat.to_dense()
    np.testing.assert_allclose(dense, dense.T, rtol=1e-6)
    assert x.shape == (m, 8) and x.dtype == np.float32
    assert labels.dtype == np.int32 and set(np.unique(labels)) <= {0, 1, 2}
    assert mask.dtype == bool and 0.5 < mask.mean() < 0.9
    again = mesh_gcn_task(f=8, c=3, seed=2, scale=0.01)
    np.testing.assert_array_equal(again[1], x)


# ---- SDDMM and the segment softmax -------------------------------------

@pytest.mark.parametrize("as_csr", [False, True])
@pytest.mark.parametrize("scale", [False, True])
def test_sddmm_matches_jax(as_csr, scale):
    jp, tp = (JG.random_csr(30, 20, 150, seed=11),
              TG.random_csr(30, 20, 150, seed=11))
    if not as_csr:
        jp, tp = jp.to_coo(), tp.to_coo()
    rng = np.random.default_rng(12)
    a, b = rng.normal(size=(30, 5)), rng.normal(size=(20, 5))
    w = rng.normal(size=tp.nnz)
    want = j_sddmm(jp, jnp.asarray(a), jnp.asarray(b),
                    scale_by_values=scale)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = sddmm(tp, ta, tb, scale_by_values=scale)
    assert isinstance(got, COO)
    np.testing.assert_array_equal(got.row_indices,
                                  np.asarray(want.row_indices))
    _close(got.values, want.values)
    (got.values * torch.from_numpy(w)).sum().backward()
    ga, gb = jax.grad(lambda aa, bb: jnp.sum(jnp.asarray(w) * j_sddmm(
        jp, aa, bb, scale_by_values=scale).values), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    _close(ta.grad, ga)
    _close(tb.grad, gb)


def test_sddmm_checks_shapes():
    p = TG.random_csr(30, 20, 150, seed=11).to_coo()
    with pytest.raises(ValueError, match="shape mismatch"):
        sddmm_coo(p, torch.zeros(30, 5), torch.zeros(21, 5))


@pytest.mark.parametrize("n_seg", [6, 9])
def test_segment_softmax_matches_jax_with_empty_rows(n_seg):
    # segments 1 and 4 are empty; with n_seg = 9 the last three as well
    ids = np.array([0, 0, 0, 2, 3, 3, 3, 3, 5, 5], dtype=np.int32)
    rng = np.random.default_rng(5)
    vals = rng.normal(size=ids.size) * 30.0
    w = rng.normal(size=ids.size)
    want = JGAT.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), n_seg)
    tv = torch.from_numpy(vals).requires_grad_()
    got = TGAT.segment_softmax(tv, torch.from_numpy(ids), n_seg)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    (got * torch.from_numpy(w)).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * JGAT.segment_softmax(
        v, jnp.asarray(ids), n_seg)))(jnp.asarray(vals))
    _close(tv.grad, g)


# ---- the custom gradient ------------------------------------------------

def _fem():
    return JG.fem3d_csr(256, 4096, seed=0), TG.fem3d_csr(256, 4096, seed=0)


def _sym_operands(kind):
    jc, tc = _fem()
    if kind == "bucketed":
        return JBucketedELL.from_csr(jc), BucketedELL.from_csr(tc)
    if kind == "coo":
        return jc.to_coo(), tc.to_coo()
    if kind == "auto":
        return j_auto_format(jc), auto_format(tc)
    U = int(kind.split("U")[1])
    kw = dict(block_rows=16, chunk_cols=128, reorder=None, pairs_per_step=U,
              beat_gather_margin=1e9, max_inflation=1e9)
    return JWindowedPairs.from_csr(jc, **kw), WindowedPairs.from_csr(tc, **kw)


def _grads(jf, tf, n, k, seed, strided=False):
    """(port value, JAX value, port grad, JAX grad, w) of sum(w * f(v))."""
    rng = np.random.default_rng(seed)
    v, w = rng.normal(size=(n, k)), rng.normal(size=(n, k))
    tv = torch.from_numpy(v).requires_grad_()
    out = tf(tv)
    if strided:
        # The gradient arrives as a transposed (non-contiguous) view.
        (out.t() * torch.from_numpy(np.ascontiguousarray(w.T))).sum(
            ).backward()
    else:
        (out * torch.from_numpy(w)).sum().backward()
    g = jax.grad(lambda vv: jnp.sum(jnp.asarray(w) * jf(vv)))(jnp.asarray(v))
    return out, jf(jnp.asarray(v)), tv.grad, g, w


@pytest.mark.parametrize("kind", ["bucketed", "coo", "auto", "U4", "U8",
                                  "U16"])
@pytest.mark.parametrize("strided", [False, True])
def test_symmetric_spmm_gradient_matches_jax(kind, strided):
    jop, op = _sym_operands(kind)
    assert type(op).__name__ == type(jop).__name__
    tf = TAD.make_symmetric_spmm(op.to(CPU))
    jf = JAD.make_symmetric_spmm(jop)
    out, jout, g, jg, w = _grads(jf, tf, 256, 8, seed=206, strided=strided)
    _close(out, jout)
    _close(g, jg)
    _close(g, _fem()[1].to_dense().T @ w)


NON_SYMMETRIC = {
    "random_windowed": (lambda g: g.random_csr(30, 25, 200, seed=202), {}),
    "powerlaw_spill": (lambda g: g.powerlaw_csr(600, 600, 4000, seed=3), {}),
    "random_bucketed": (lambda g: g.random_csr(30, 25, 200, seed=202),
                        dict(k_nominal=128)),
}


@pytest.mark.parametrize("name", sorted(NON_SYMMETRIC))
def test_general_spmm_gradient_matches_jax(name):
    make, kw = NON_SYMMETRIC[name]
    jc, tc = make(JG), make(TG)
    jf = JAD.make_spmm(jc, **kw)
    tf = TAD.make_spmm(tc, device="cpu", **kw)
    m, n = tc.shape
    rng = np.random.default_rng(203)
    v, w = rng.normal(size=(n, 4)), rng.normal(size=(m, 4))
    tv = torch.from_numpy(v).requires_grad_()
    out = tf(tv)
    (out * torch.from_numpy(w)).sum().backward()
    jout = jf(jnp.asarray(v))
    jg = jax.grad(lambda vv: jnp.sum(jnp.asarray(w) * jf(vv)))(
        jnp.asarray(v))
    dense = tc.to_dense()
    _close(out, jout)
    _close(out, dense @ v)
    _close(tv.grad, jg)
    _close(tv.grad, dense.T @ w)


def test_spmm_gradient_composes_and_needs_no_input_gradient():
    # A(A v) through two custom backward passes; and a first-layer SpMM
    # whose input is x @ w with only w requiring grad still runs backward.
    tc = TG.random_csr(16, 16, 60, seed=208)
    f = TAD.make_spmm(tc, device="cpu")
    v = torch.from_numpy(TG.generate_fat_vector(16, 2, seed=209))
    v.requires_grad_()
    (f(f(v)) ** 2).sum().backward()
    d = tc.to_dense()
    _close(v.grad, 2 * d.T @ d.T @ (d @ d @ v.detach().numpy()))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 3)))
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 5)))
    w.requires_grad_()
    f(x @ w).sum().backward()
    _close(w.grad, x.numpy().T @ (d.T @ np.ones((16, 5))))


# ---- the GCN -----------------------------------------------------------

def _gcn_case(kind, n=300, f=12, h=16, c=4):
    jadj, jx, jl, jm = JGCN.synthetic_node_classification(
        n, f, c, avg_degree=16, seed=1, dtype=jnp.float64)
    adj, x, labels, mask = TGCN.synthetic_node_classification(
        n, f, c, avg_degree=16, seed=1, dtype=np.float64)
    ja, ta = JGCN.normalize_adjacency(jadj), TGCN.normalize_adjacency(adj)
    if kind == "bucketed":
        jop, op = JBucketedELL.from_csr(ja), BucketedELL.from_csr(ta)
    elif kind == "coo":
        jop, op = ja.to_coo(), ta.to_coo()
    else:
        jop, op = j_auto_format(ja, k_nominal=128), auto_format(
            ta, k_nominal=128)
    assert type(op).__name__ == type(jop).__name__
    jparams = JGCN.init_gcn(jax.random.PRNGKey(0), f, h, c,
                            dtype=jnp.float64)
    params = TGCN.gcn_params_from_jax(jparams, device="cpu")
    return (JAD.make_symmetric_spmm(jop), jparams, (jx, jl, jm),
            TAD.make_symmetric_spmm(op.to(CPU)), params,
            tuple(torch.from_numpy(a) for a in (x, labels, mask)))


@pytest.mark.parametrize("kind", ["bucketed", "coo", "auto"])
def test_gcn_forward_loss_and_gradients_match_jax(kind):
    jspmm, jparams, jdata, spmm, params, data = _gcn_case(kind)
    _close(TGCN.gcn_forward(params, spmm, data[0]),
           JGCN.gcn_forward(jparams, jspmm, jdata[0]))
    loss = TGCN.gcn_loss(params, spmm, *data)
    jloss, jgrads = jax.value_and_grad(JGCN.gcn_loss)(jparams, jspmm,
                                                      *jdata)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=F64_RTOL)
    loss.backward()
    for name in TGCN.GCNParams._fields:
        _close(getattr(params, name).grad, getattr(jgrads, name))


@pytest.mark.parametrize("kind", ["bucketed", "auto"])
def test_gcn_three_adam_steps_match_optax(kind):
    jspmm, jparams, jdata, spmm, params, data = _gcn_case(kind)
    jopt = optax.adam(1e-2)
    jstate = jopt.init(jparams)
    jstep = JGCN.make_train_step(jspmm, jopt)
    step = TGCN.make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, *jdata)
        loss = step(params, *data)
        assert float(loss) == pytest.approx(float(jloss), rel=F64_RTOL)
    for name in TGCN.GCNParams._fields:
        _close(getattr(params, name), getattr(jparams, name),
               rtol=F64_RTOL)


def test_gcn_training_learns_on_cpu_f32():
    adj, x, labels, mask = TGCN.synthetic_node_classification(
        200, 16, 3, seed=220)
    op = auto_format(TGCN.normalize_adjacency(adj)).astype(
        torch.float32).to(CPU)
    spmm = TAD.make_symmetric_spmm(op)
    params = TGCN.init_gcn(16, 32, 3, generator=torch.Generator(
        ).manual_seed(1), device="cpu")
    step = TGCN.make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))
    data = tuple(torch.from_numpy(a) for a in (x, labels, mask))
    losses = [float(step(params, *data)) for _ in range(30)]
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]
    with torch.no_grad():
        preds = TGCN.gcn_forward(params, spmm, data[0]).argmax(dim=1)
    assert float((preds == data[1])[data[2]].double().mean()) > 0.7


def test_init_gcn_and_init_gat_draw_from_the_generator():
    a = TGCN.init_gcn(8, 16, 3, generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64, device="cpu")
    b = TGCN.init_gcn(8, 16, 3, generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64, device="cpu")
    assert [tuple(p.shape) for p in a] == [(8, 16), (16,), (16, 3), (3,)]
    for p, q in zip(a, b):
        assert p.is_leaf and p.requires_grad and p.dtype == torch.float64
        assert torch.equal(p, q)
    assert not a.b1.any() and not a.b2.any()
    assert float(a.w1.detach().std()) == pytest.approx(np.sqrt(2 / 8), rel=0.3)
    g = TGAT.init_gat(8, 16, generator=torch.Generator().manual_seed(4),
                      device="cpu")
    assert [tuple(p.shape) for p in g] == [(8, 16), (16,), (16,)]
    assert all(p.is_leaf and p.requires_grad for p in g)


# ---- graph attention ---------------------------------------------------

def _gat_graph(empty_rows):
    jadj, jx, _, _ = JGCN.synthetic_node_classification(40, 8, 3, seed=230)
    adj, x, _, _ = TGCN.synthetic_node_classification(40, 8, 3, seed=230)
    jcoo, coo = jadj.to_coo(), adj.to_coo()
    if empty_rows:
        keep = np.asarray(coo.row_indices) % 5 != 2
        jcoo = type(jcoo).from_arrays(
            np.asarray(jcoo.values)[keep], np.asarray(jcoo.row_indices)[keep],
            np.asarray(jcoo.col_indices)[keep], jcoo.shape)
        coo = COO.from_arrays(coo.values[keep], coo.row_indices[keep],
                              coo.col_indices[keep], coo.shape)
    return (jcoo.astype(jnp.float64), np.asarray(jx, np.float64),
            coo.astype(np.float64).to(CPU))


@pytest.mark.parametrize("empty_rows", [False, True])
def test_gat_layer_matches_jax(empty_rows):
    jcoo, x, coo = _gat_graph(empty_rows)
    jparams = JGAT.init_gat(jax.random.PRNGKey(0), 8, 16, dtype=jnp.float64)
    params = TGAT.gat_params_from_jax(jparams, device="cpu")
    tx = torch.from_numpy(x).requires_grad_()
    out = TGAT.gat_layer(params, coo, tx)
    jout = JGAT.gat_layer(jparams, jcoo, jnp.asarray(x))
    assert bool(torch.isfinite(out).all())
    _close(out, jout)
    (out ** 2).sum().backward()
    jg, jgx = jax.grad(lambda p, xx: jnp.sum(JGAT.gat_layer(p, jcoo, xx)
                                             ** 2), argnums=(0, 1))(
        jparams, jnp.asarray(x))
    for name in TGAT.GATParams._fields:
        _close(getattr(params, name).grad, getattr(jg, name))
    _close(tx.grad, jgx)


@pytest.mark.parametrize("concat", [True, False])
def test_multi_head_gat_matches_jax(concat):
    jcoo, x, coo = _gat_graph(False)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jheads = [JGAT.init_gat(k, 8, 6, dtype=jnp.float64) for k in keys]
    heads = [TGAT.gat_params_from_jax(p, device="cpu") for p in jheads]
    out = TGAT.multi_head_gat(heads, coo, torch.from_numpy(x), concat=concat)
    jout = JGAT.multi_head_gat(jheads, jcoo, jnp.asarray(x), concat=concat)
    assert out.shape == (40, 24 if concat else 6)
    _close(out, jout)
    out.sum().backward()
    jg = jax.grad(lambda ps: jnp.sum(JGAT.multi_head_gat(
        ps, jcoo, jnp.asarray(x), concat=concat)))(jheads)
    for p, jp in zip(heads, jg):
        for name in TGAT.GATParams._fields:
            _close(getattr(p, name).grad, getattr(jp, name))


# ---- the library yardstick, the entry point, the defaults ---------------

@pytest.mark.parametrize("as_coo", [False, True])
def test_library_spmm_matches_the_oracle(as_coo):
    csr = TG.powerlaw_csr(300, 200, 2000, seed=3)
    v = TG.generate_fat_vector(200, 6, seed=4)
    a = to_torch_sparse(csr.to_coo() if as_coo else csr, device="cpu")
    assert a.layout == torch.sparse_csr and a.dtype == torch.float64
    _close(spmm_library(a, torch.from_numpy(v)), spmm_host_f64(csr, v))
    _close(spmm_any(a, torch.from_numpy(v)), spmm_host_f64(csr, v))
    with pytest.raises(TypeError, match="CSR or COO"):
        to_torch_sparse(BucketedELL.from_csr(csr), device="cpu")


def test_library_sums_duplicates_and_carries_a_gradient():
    # A duplicated coordinate (the CG system keeps them) is summed.
    coo = COO.from_arrays(np.array([1.0, 2.0, 3.0]), np.array([0, 0, 1]),
                          np.array([1, 1, 0]), (2, 2))
    a = to_torch_sparse(coo, device="cpu")
    np.testing.assert_array_equal(a.to_dense().numpy(), [[0, 3], [3, 0]])
    _, tc = _fem()
    f_lib = TAD.make_symmetric_spmm(to_torch_sparse(tc, device="cpu"))
    f_coo = TAD.make_symmetric_spmm(tc.to_coo().to(CPU))
    v = torch.from_numpy(TG.generate_fat_vector(256, 3, seed=5))
    grads = []
    for f in (f_lib, f_coo):
        tv = v.clone().requires_grad_()
        (f(tv) ** 2).sum().backward()
        grads.append(tv.grad)
    _close(grads[0], grads[1].numpy())


def test_entry_runs_on_cpu():
    forward, (params, operand, x) = entry(device="cpu")
    assert x.shape == (256, 32) and x.dtype == torch.float32
    logits = forward(params, operand, x)
    assert logits.shape == (256, 4) and bool(torch.isfinite(logits).all())
    logits.square().sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in params)


@pytest.mark.parametrize("fn", [
    entry, TGCN.init_gcn, TGAT.init_gat, TGCN.gcn_params_from_jax,
    TGAT.gat_params_from_jax, TAD.make_spmm, to_torch_sparse,
], ids=lambda f: f.__name__)
def test_new_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"

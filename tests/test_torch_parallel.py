"""The port's distributed strategies (``parallel/strategies.py``,
``grid2d.py``) on gloo process groups of p = 1, 2 and 4 spawned CPU
ranks, against the dense float64 oracle and against the JAX package's
strategies on the same number of ``conftest.py``'s virtual devices, on
the same seeded inputs: the cases of ``tests/test_parallel.py`` and
``tests/test_grid2d_serialize.py``. Each p spawns one group, which runs
every case of that p (``_torch_dist_ranks.run_cases``)."""

import numpy as np
import pytest
import torch

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.parallel import Auto as JAuto
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    Auto, ColumnWise, Grid2D, Library, NonZeroElement, RowWise, Sequential,
    get_strategy, make_mesh, make_mesh_2d, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.strategies import (
    HybridRowOperand,
)

import _torch_dist_ranks as R
from _torch_jax_cases import check_case

C = R.case
STRATS = (("row", {}), ("column", {}), ("nnz", {"reduce": "psum"}),
          ("nnz", {"reduce": "scatter"}), ("library", {}))


def _sid(name, kw):
    return f"{name}{'-' + kw['reduce'] if 'reduce' in kw else ''}"


def _cases(p):
    cases = []
    # every strategy on every matrix (p = 4), on two of them (p = 1, 2)
    mats = (list(R.MATRICES)[:6] if p == 4 else ["random", "powerlaw"])
    for mat in mats:
        for name, kw in STRATS:
            cases.append(C(f"{mat}-{_sid(name, kw)}", mat, name, 12,
                           kwargs=kw))
    for name, kw in STRATS:  # the result left sharded
        cases.append(C(f"sharded-{_sid(name, kw)}", "random", name, 8,
                       kwargs=kw, gather=False))
    cases.append(C("sequential", "random", "sequential", 6))
    if p == 1:
        return cases
    cases += [C(f"column-k{k}", "random", "column", k) for k in
              (1, 3, 5, 8, 17)]
    cases += [C(f"rows_odd-k{k}", "rows_odd", "row", k) for k in (1, 7)]
    cases.append(C("nnz_odd", "nnz_odd", "nnz", 4))
    cases += [C(f"skewed-{g}", "skewed", "row", 5, gather=g)
              for g in (True, False)]
    cases += [C(f"bf16-{name}", "bf16_band", name, 4, seed=321,
                dtype="bfloat16") for name in ("row", "nnz")]
    cases += [C(f"auto-{mat}", mat, "auto", 4) for mat in
              ("auto_band", "auto_scattered")]
    if p == 4:
        cases += [C(f"grid-{a}x{b}", "grid_random", "grid2d", 12, seed=142,
                    mesh2d=(a, b)) for a, b in ((4, 1), (2, 2), (1, 4))]
        cases.append(C("grid-sharded", "grid_random", "grid2d", 8, seed=144,
                       mesh2d=(2, 2), gather=False))
        cases.append(C("grid-skewed", "skewed48", "grid2d", 6, seed=302,
                       mesh2d=(2, 2)))
    return cases


CASES = {p: _cases(p) for p in (1, 2, 4)}


@pytest.fixture(scope="module")
def ranks():
    """Each p's group run once: ``{p: [rank 0's results, ...]}``."""
    return {p: run_ranks(R.run_cases, p, CASES[p], device="cpu",
                         timeout=600) for p in CASES}


@pytest.mark.parametrize("p,c", [(p, c) for p in CASES for c in CASES[p]],
                         ids=lambda x: x["id"] if isinstance(x, dict)
                         else f"p{x}")
def test_strategy_matches_oracle_and_jax(p, c, ranks):
    check_case(c, p, ranks[p])


def test_skewed_matrix_engages_the_tail(ranks):
    """One near-dense row spills into the COO tail instead of widening
    the ELL planes (RowWise and Grid2D)."""
    for p in (2, 4):
        for r in ranks[p]:
            assert r["skewed-True"]["tail"] > 0
            assert 0 < r["skewed-True"]["width"] < 64
    assert all(r["grid-skewed"]["tail"] > 0 for r in ranks[4])


def test_auto_routes_as_the_jax_package_on_the_mesh(ranks):
    """``Auto`` on several ranks picks the strategy the JAX package picks:
    the halo band for the band, the hybrid row-wise for the scattered
    matrix."""
    for p in (2, 4):
        assert {r["auto-auto_band"]["operand"] for r in ranks[p]} == {
            "BandedRowOperand"}
        assert {r["auto-auto_scattered"]["operand"] for r in ranks[p]} == {
            "HybridRowOperand"}


@pytest.mark.parametrize("name", ["auto_band", "auto_scattered", "fem1500",
                                  "powerlaw3000", "cop20k_small"])
def test_mesh_route_pick_equals_jax(name):
    csr, jcsr = R.build(name, TG, CSR), R.build(name, JG, JCSR)
    assert type(Auto()._mesh_route(csr)).__name__ == \
        type(JAuto()._mesh_route(jcsr)).__name__


def test_hybrid_partition_equals_the_jax_operand():
    """Every rank's ELL block and tail range are the JAX operand's shards,
    bit for bit (a skewed matrix, so the tail is there)."""
    from sparsematrixmultiplicationmpi_tpu.parallel import (
        RowWise as JRowWise, make_mesh as jmesh,
    )

    csr, jcsr = R.build("skewed", TG, CSR), R.build("skewed", JG, JCSR)
    for p in (1, 2, 4, 8):
        jop = JRowWise().prepare(jcsr, jmesh(p))
        shards = RowWise().partition(csr, p)
        for f in HybridRowOperand._ARRAYS:
            got = np.concatenate([getattr(s, f) for s in shards])
            want = np.asarray(getattr(jop, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert shards[0].m_padded == jop.m_padded


def test_one_device_mesh_from_a_device():
    """A device where a mesh is expected is the one-device mesh: every
    strategy prepares and multiplies with no process group."""
    csr = R.build("random", TG, CSR)
    v = torch.from_numpy(TG.generate_fat_vector(80, 5, seed=1))
    want = csr.to_dense() @ v.numpy()
    for s in (Sequential(), RowWise(), ColumnWise(), NonZeroElement(),
              NonZeroElement("scatter"), Library(), Auto()):
        op = s.prepare(csr, "cpu")
        for g in (True, False):
            out = s.spmm(op, v, gather_result=g)
            out = out if g else s.gather(op, out, 5)
            assert np.abs(out.numpy() - want).max() < 1e-10, s.name


def test_grid2d_rejects_a_1d_mesh():
    with pytest.raises(ValueError):
        Grid2D().prepare(R.build("random", TG, CSR), "cpu")


def test_get_strategy_has_every_jax_name():
    from sparsematrixmultiplicationmpi_tpu.parallel import (
        STRATEGIES as JSTRATEGIES,
    )
    from sparsematrixmultiplicationmpi_tpu_torch.parallel import STRATEGIES

    assert set(STRATEGIES) == set(JSTRATEGIES)
    assert isinstance(get_strategy("row"), RowWise)
    assert isinstance(get_strategy("nnz", reduce="scatter"), NonZeroElement)
    assert isinstance(get_strategy("grid2d"), Grid2D)
    with pytest.raises(ValueError):
        get_strategy("bogus")


def test_meshes_default_to_the_card():
    """``make_mesh`` and ``make_mesh_2d`` run on the card unless asked
    for the CPU: without one they raise, and a CPU mesh needs a process
    group."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(4)
    with pytest.raises(RuntimeError):
        make_mesh_2d(2, 2)
    with pytest.raises(RuntimeError):
        make_mesh(2, device="cpu")

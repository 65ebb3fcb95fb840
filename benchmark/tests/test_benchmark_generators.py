"""The frozen generator copies give the program's stand-ins bit for bit;
the benchmark's own amazon0302 stand-in has the published counts."""

import numpy as np
import pytest

from benchmark.reference import generate as ref

port = pytest.importorskip("sparsematrixmultiplicationmpi_tpu_torch.io.generate")


@pytest.mark.parametrize("name", ["cop20k_like"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_stand_in_matches_the_program(name, seed):
    a = getattr(ref, name)(seed=seed, dtype=np.float64, scale=0.01)
    b = getattr(port, name)(seed=seed, dtype=np.float64, scale=0.01)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.row_ptr, np.asarray(b.row_ptr))
    np.testing.assert_array_equal(a.col_indices, np.asarray(b.col_indices))
    np.testing.assert_array_equal(a.values, np.asarray(b.values))
    assert a.col_indices.dtype == np.int32 and a.row_ptr.dtype == np.int32


def test_amazon_stand_in_has_the_published_counts():
    a = ref.amazon0302_top5(0)
    assert a.shape == (262_111, 262_111) and a.nnz == 1_234_877
    out = np.diff(a.row_ptr)
    assert out.max() == 5 and out.min() >= 1
    rows = np.repeat(np.arange(a.shape[0]), out)
    assert not (rows == a.col_indices).any()
    key = rows.astype(np.int64) * a.shape[0] + a.col_indices
    assert np.unique(key).size == a.nnz
    assert a.col_indices.dtype == np.int32 and a.row_ptr.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_amazon_stand_in_is_drawn_from_its_seed(seed):
    a, b = ref.amazon0302_top5(seed, scale=0.01), ref.amazon0302_top5(
        seed, scale=0.01)
    np.testing.assert_array_equal(a.col_indices, b.col_indices)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    assert a.nnz == int(1_234_877 * 0.01)
    c = ref.amazon0302_top5(seed + 1, scale=0.01)
    assert not np.array_equal(a.col_indices, c.col_indices)


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_fat_vector_matches_the_program(seed):
    np.testing.assert_array_equal(ref.generate_fat_vector(50, 3, seed),
                                  port.generate_fat_vector(50, 3, seed))


def test_operators_are_normalised():
    from benchmark.reference.operators import NORMALISATIONS, as_scipy

    raw = ref.cop20k_like(3, scale=0.01)
    sym = as_scipy(NORMALISATIONS["sym_normalized_abs"](raw))
    assert abs(sym - sym.T).max() < 1e-15
    assert (sym.data >= 0).all()
    # D^-1/2 |A| D^-1/2 has D^1/2 1 as an eigenvector of eigenvalue 1.
    d = np.sqrt(np.asarray(abs(as_scipy(raw)).sum(axis=1)).ravel())
    np.testing.assert_allclose(sym @ d, d, rtol=1e-12)
    col = as_scipy(NORMALISATIONS["column_stochastic_abs"](
        ref.amazon0302_top5(3, scale=0.01)))
    sums = np.asarray(col.sum(axis=0)).ravel()
    np.testing.assert_allclose(sums[sums > 0], 1.0, rtol=1e-12)


@pytest.mark.parametrize("how", ["permutation", "cyclic_shift"])
def test_a_seed_renumbers_one_matrix(how):
    from benchmark.reference.operators import as_scipy, operator

    cfg = {"generator": "amazon0302_top5", "scale": 0.01, "pattern_seed": 0,
           "relabel": how, "operator": "column_stochastic_abs"}
    a, b = as_scipy(operator(cfg, 1)), as_scipy(operator(cfg, 2))
    assert a.nnz == b.nnz and (a != b).nnz > 0
    assert sorted(a.data) == sorted(b.data)
    # The same seed gives the same operator.
    assert (a != as_scipy(operator(cfg, 1))).nnz == 0
    # Row sums of a column-stochastic operator's transpose are 1 or 0,
    # whatever the numbering.
    assert sorted(np.round(np.asarray(a.sum(axis=0)).ravel(), 12)) == \
        sorted(np.round(np.asarray(b.sum(axis=0)).ravel(), 12))

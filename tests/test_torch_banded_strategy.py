"""The port's halo-exchange band strategy (``parallel/banded_strategy.py``)
against the JAX package's: ``partition`` equal to the JAX operand's
shards bit for bit, and the multiplies on gloo groups of p = 1, 2 and 4
spawned CPU ranks against the oracle and the JAX output, on the cases of
``tests/test_banded_strategy.py``."""

import numpy as np
import pytest

import sparsematrixmultiplicationmpi_tpu.io.generate as JG
import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu.formats.matrix import CSR as JCSR
from sparsematrixmultiplicationmpi_tpu.parallel import (
    BandedRowWise as JBandedRowWise, make_mesh,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    BandedRowWise, get_strategy, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.parallel.banded_strategy import (
    BandedRowOperand,
)

import _torch_dist_ranks as R
from _torch_jax_cases import check_case

C = R.case
PARTITIONS = [("pure_band", dict(block_rows=8)),
              ("band_spill", dict(block_rows=8)),
              ("band37", dict(block_rows=8)),
              ("cop20k_small", {}),
              ("band_hlo_spill", dict(block_rows=64))]


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("mat,kw", PARTITIONS,
                         ids=[x[0] for x in PARTITIONS])
def test_partition_equals_the_jax_operand(mat, kw, p):
    jop = JBandedRowWise(**kw).prepare(R.build(mat, JG, JCSR), make_mesh(p))
    shards = BandedRowWise(**kw).partition(R.build(mat, TG, CSR), p)
    for f in BandedRowOperand._ARRAYS:
        j = getattr(jop, f)
        assert all((getattr(s, f) is None) == (j is None) for s in shards), f
        if j is not None:
            got = np.concatenate([getattr(s, f) for s in shards])
            want = np.asarray(j)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert shards[0].block_rows == jop.block_rows
    assert shards[0].nb_padded == jop.band.shape[0]


def test_spill_fixture_has_a_spill_and_the_band_none():
    shards = BandedRowWise(block_rows=8).partition(
        R.build("band_spill", TG, CSR), 2)
    assert shards[0].spill_cols is not None
    shards = BandedRowWise(block_rows=8).partition(
        R.build("pure_band", TG, CSR), 2)
    assert shards[0].spill_cols is None


def test_rejects_non_square():
    with pytest.raises(ValueError):
        BandedRowWise(block_rows=8).partition(
            TG.random_csr(40, 30, 100, seed=108), 2)


def test_registered():
    assert isinstance(get_strategy("banded_row"), BandedRowWise)
    assert isinstance(get_strategy("banded_row_wise"), BandedRowWise)


B8 = dict(block_rows=8)


def _cases(p):
    return [
        C("pure-band", "pure_band", "banded_row", 7, kwargs=B8, seed=101),
        C("band-spill", "band_spill", "banded_row", 5, kwargs=B8, seed=101),
        C("sharded", "band192", "banded_row", 4, kwargs=B8, seed=101,
          gather=False),
        C("spill-sharded", "band_spill", "banded_row", 3, kwargs=B8,
          seed=102, gather=False),
        C("blocks-not-divisible", "band37", "banded_row", 3, kwargs=B8,
          seed=101),
        C("cop20k-small", "cop20k_small", "banded_row", 6, seed=101),
        C("chain", "band192", "banded_row", 2, kwargs=B8, seed=103,
          mode="chain1", gather=False),
    ]


CASES = {p: _cases(p) for p in (1, 2, 4)}


@pytest.fixture(scope="module")
def ranks():
    return {p: run_ranks(R.run_cases, p, CASES[p], device="cpu",
                         timeout=600) for p in CASES}


@pytest.mark.parametrize("p,c", [(p, c) for p in CASES for c in CASES[p]],
                         ids=lambda x: x["id"] if isinstance(x, dict)
                         else f"p{x}")
def test_banded_row_matches_oracle_and_jax(p, c, ranks):
    check_case(c, p, ranks[p])

"""The port's collective counter (``utils/collectives.py``) shows what
``tests/test_hlo_collectives.py`` asserts of the JAX package's compiled
HLO: the band strategy permutes only, its spill adds one all-gather,
``psum`` is an all-reduce, ``scatter`` a reduce-scatter, the gathered
row result an all-gather, an ungathered result moves fewer bytes, and
the windowed halo mode gathers nothing. Run on gloo groups of spawned
CPU ranks; each case's result is also held against the oracle and the
JAX package."""

import pytest
import torch

import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import CSR
from sparsematrixmultiplicationmpi_tpu_torch.parallel import (
    RowWise, WindowedRowWise, run_ranks,
)
from sparsematrixmultiplicationmpi_tpu_torch.utils import collectives as coll

import _torch_dist_ranks as R
from _torch_jax_cases import check_case

C = R.case
CASES = [
    C("band", "band_hlo", "banded_row", 4, kwargs=dict(block_rows=64),
      seed=5, gather=False),
    C("band-spill", "band_hlo_spill", "banded_row", 4,
      kwargs=dict(block_rows=64), seed=5, gather=False),
    C("nnz-psum", "random256", "nnz", 4, kwargs=dict(reduce="psum"),
      seed=5, gather=False),
    C("nnz-scatter", "random256", "nnz", 4, kwargs=dict(reduce="scatter"),
      seed=5, gather=False),
    C("row-gathered", "random256", "row", 4, seed=5),
    C("row512-gathered", "random512", "row", 8, seed=5),
    C("row512-sharded", "random512", "row", 8, seed=5, gather=False),
    C("column-gathered", "random256", "column", 4, seed=5),
    C("windowed-halo", "banded2048", "windowed_row", 4,
      kwargs=dict(block_rows=32, chunk_cols=128, reorder=None), seed=231,
      gather=False, mode="permuted"),
    C("grid-gathered", "random256", "grid2d", 4, seed=5, mesh2d=(2, 2)),
]


@pytest.fixture(scope="module")
def ranks():
    one = [c for c in CASES if c["mesh2d"] is None]
    return {p: run_ranks(R.run_cases, p, cases, device="cpu", timeout=600)
            for p, cases in ((1, one), (4, CASES))}


def _stats(ranks, p, case_id):
    return [r[case_id]["stats"] for r in ranks[p]]


@pytest.mark.parametrize("c", CASES, ids=lambda c: c["id"])
def test_results_match_oracle_and_jax(c, ranks):
    check_case(c, 4, ranks[4])


def test_banded_row_wise_is_ppermute_only(ranks):
    r, k = 64, 4
    for s in _stats(ranks, 4, "band"):
        assert set(s) == {"collective-permute"}, s
        count, nbytes = s["collective-permute"]
        assert 1 <= count <= 2
        assert nbytes <= 2 * r * k * 8  # one (r, k) edge block a side


def test_banded_row_wise_spill_adds_one_all_gather(ranks):
    for s in _stats(ranks, 4, "band-spill"):
        assert "collective-permute" in s
        assert s["all-gather"][0] == 1  # the fat-vector gather
        assert "all-reduce" not in s


def test_nnz_psum_is_an_all_reduce(ranks):
    for s in _stats(ranks, 4, "nnz-psum"):
        assert set(s) == {"all-reduce"}


def test_nnz_scatter_is_a_reduce_scatter(ranks):
    for s in _stats(ranks, 4, "nnz-scatter"):
        assert set(s) == {"reduce-scatter"}


def test_row_wise_gather_is_an_all_gather(ranks):
    for s in _stats(ranks, 4, "row-gathered"):
        assert s["all-gather"][0] == 1


def test_row_wise_ungathered_moves_fewer_bytes(ranks):
    def total(case_id):
        return [sum(b for _, b in s.values())
                for s in _stats(ranks, 4, case_id)]

    for sharded, gathered in zip(total("row512-sharded"),
                                 total("row512-gathered")):
        assert sharded < gathered


def test_column_and_grid_gathers_ride_their_axes(ranks):
    for s in _stats(ranks, 4, "column-gathered"):
        assert set(s) == {"all-gather"} and s["all-gather"][0] == 1
    for s in _stats(ranks, 4, "grid-gathered"):
        assert s["all-gather"][0] == 2  # the k axis, then the rows axis
        assert set(s) <= {"all-gather", "reduce-scatter"}


def test_halo_mode_emits_no_all_gather(ranks):
    """Neighbour permutes only, and per rank no more bytes than its
    halo window: (h_l + h_r) chunks of C rows of k float64."""
    op = WindowedRowWise(block_rows=32, chunk_cols=128,
                         reorder=None).partition(
        R.build("banded2048", TG, CSR), 4)[0]
    assert op.input_mode == "halo"
    bound = (op.halo_left + op.halo_right) * op.chunk_cols * 4 * 8
    for s in _stats(ranks, 4, "windowed-halo"):
        assert set(s) == {"collective-permute"}, s
        assert s["collective-permute"][1] <= bound


def test_one_rank_exchanges_nothing(ranks):
    """On one rank the halo exchanges are skipped; the other collectives
    are issued to the one-rank group and counted."""
    stats = ranks[1][0]
    assert stats["band"]["stats"] == {}
    assert stats["windowed-halo"]["stats"] == {}
    assert stats["row-gathered"]["stats"]["all-gather"][0] == 1


def test_a_mesh_without_a_group_counts_nothing():
    csr = R.build("random256", TG, CSR)
    row = RowWise()
    op = row.prepare(csr, "cpu")
    coll.reset_collective_stats()
    row.spmm(op, torch.from_numpy(TG.generate_fat_vector(256, 4, seed=1)))
    assert coll.collective_stats() == {}

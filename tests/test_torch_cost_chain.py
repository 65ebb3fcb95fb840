"""The card's windowed estimate (``formats/windowed.py::compact_kernel_s``
under a table with the H100's structure): the critical-path term prices
a skewed matrix's long block chain, balanced chains are left alone, and
the picks the H100 table changes are pinned here (ROADMAP C lists them
as divergences by design)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import H100, V5E
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    R_SLICE, WINDOW_ENTRIES, WindowedPairs, compact_kernel_s, tile_windows,
    windowed_cost_estimate,
)

#: The H100 table without its critical-path term.
NO_CHAIN = dataclasses.replace(H100, chain_floor=0.0)


def _ij(csr):
    coo = csr.to_coo()
    return (np.asarray(coo.row_indices).astype(np.int64),
            np.asarray(coo.col_indices).astype(np.int64))


def _powerlaw():
    return TG.powerlaw_csr(20_000, 20_000, 300_000, seed=12).astype(
        np.float32)


def test_tile_windows_split_dense_tiles_by_slice_and_window():
    assert tile_windows([0, 1, WINDOW_ENTRIES], R_SLICE).tolist() == [1, 1, 1]
    assert tile_windows([WINDOW_ENTRIES + 1], R_SLICE).tolist() == [2]
    # Two row slices share a 256-row tile's entries.
    assert tile_windows([2 * WINDOW_ENTRIES], 2 * R_SLICE).tolist() == [1]


def test_the_kernel_is_its_longest_chain_or_its_work_over_the_ctas():
    t = H100
    even = compact_kernel_s([1] * 1000, [500] * 1000, 128, 128, 4, 32, 16, t)
    one = compact_kernel_s([1000] + [0] * 999, [500_000] + [0] * 999, 128,
                           128, 4, 32, 16, t)
    # The same windows and entries: in one block they are one CTA's chain.
    assert one > 50 * even
    assert one == pytest.approx(1000 * (128 * 32 * 4 / t.tile_stream_bw)
                                + 500_000 * t.entry_s)
    assert compact_kernel_s([1000] + [0] * 999, [500_000] + [0] * 999, 128,
                            128, 4, 32, 16, NO_CHAIN) == pytest.approx(
        even, rel=1e-12)


def test_the_chain_prices_a_skewed_candidate_above_its_gather_estimate():
    csr = _powerlaw()
    m, n = csr.shape
    i, j = _ij(csr)
    gather = min(e for e, _ in TA.gather_class_estimates(
        csr, 32, cost_table=H100).values())
    est = windowed_cost_estimate(i, j, m, n, 256, 512, 4, 32, 16,
                                 cost_table=H100)[0]
    flat = windowed_cost_estimate(i, j, m, n, 256, 512, 4, 32, 16,
                                  cost_table=NO_CHAIN)[0]
    assert est > gather > flat
    # So the card's search declines every tiling of it, the summed model
    # would not.
    assert WindowedPairs.from_csr(csr, cost_table=H100,
                                  gather_baseline_s=gather) is None
    assert WindowedPairs.from_csr(csr, cost_table=NO_CHAIN,
                                  gather_baseline_s=gather) is not None


def test_the_chain_leaves_the_cop20k_pick_alone():
    """cop20k's chains are balanced (a few pairs a block): the tiling
    the search picks is the same with the critical-path term and without
    it (no gather price declines it here)."""
    csr = TG.cop20k_like(scale=0.2).astype(np.float32)
    pick = WindowedPairs.from_csr(csr, cost_table=H100, gather_baseline_s=1.0)
    flat = WindowedPairs.from_csr(csr, cost_table=NO_CHAIN,
                                  gather_baseline_s=1.0)
    assert isinstance(pick, WindowedPairs)
    assert (type(pick), pick.block_rows, pick.chunk_cols,
            pick.pairs_per_step, pick.n_pairs) == (
        type(flat), flat.block_rows, flat.chunk_cols, flat.pairs_per_step,
        flat.n_pairs)


def test_v5e_has_no_chain_term():
    csr = _powerlaw()
    m, n = csr.shape
    i, j = _ij(csr)
    a = windowed_cost_estimate(i, j, m, n, 256, 512, 4, 32, 16)
    b = windowed_cost_estimate(i, j, m, n, 256, 512, 4, 32, 16,
                               cost_table=V5E)
    assert a[0] == b[0] and (a[2] == b[2]).all()

"""The picks the H100 table changes, pinned at full size: on each
matrix of the results sweep at k = 1 and 32, the class the reference's
table picks and the class the H100 table picks (ROADMAP C lists the
differences as divergences by design; ``chip_smoke.py`` phase 15 holds
the H100 picks of the main family to the measured fastest class on the
card). The search runs without building tiles: the gather estimates,
the windowed tile search and the band build, in ``auto_format``'s
order."""

from __future__ import annotations

import numpy as np
import pytest

import sparsematrixmultiplicationmpi_tpu_torch.io.generate as TG
import sparsematrixmultiplicationmpi_tpu_torch.ops.auto as TA
from sparsematrixmultiplicationmpi_tpu_torch.formats.banded import (
    BandedBlocks,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.cost import H100, V5E
from sparsematrixmultiplicationmpi_tpu_torch.formats.matrix import (
    coalesce_coo,
)
from sparsematrixmultiplicationmpi_tpu_torch.formats.windowed import (
    WindowedPairs, _search_tilings,
)
from sparsematrixmultiplicationmpi_tpu_torch.scripts.run_results_sweep import (
    BUILDERS,
)


def _pick(csr, k, table, ij=None, one_shot=False) -> str:
    """The class ``auto_format`` picks (``windowed RxC``, ``banded R``,
    ``bucketed_ell`` or ``coo``), without building tiles; ``one_shot``
    as ``auto_format(one_shot=True)`` prices."""
    ests = TA.gather_class_estimates(csr, k, cost_table=table)
    name = min(ests, key=lambda n: ests[n][0])
    cands = [(ests[name][0], name)]
    if ij is None:
        coo = csr.to_coo()
        ij = coalesce_coo(np.asarray(coo.row_indices).astype(np.int64),
                          np.asarray(coo.col_indices).astype(np.int64),
                          np.asarray(coo.values), csr.shape[1])[:2]
    found = _search_tilings(csr, *ij, k_nominal=k,
                            gather_baseline_s=ests[name][0],
                            pairs_per_step=table.production_pairs_per_step,
                            cost_table=table)
    if found is not None:
        extra = table.one_shot_s if one_shot else 0.0
        cands.append((found[0] + extra, f"windowed {found[1]}x{found[2]}"))
    bb = BandedBlocks.from_csr(csr, k_nominal=k, cost_table=table)
    if bb is not None:
        cands.append((bb.est_seconds, f"banded {bb.block_rows}"))
    return min(cands, key=lambda c: c[0])[1]


def _class(op) -> str:
    if isinstance(op, WindowedPairs):
        return f"windowed {op.block_rows}x{op.chunk_cols}"
    if isinstance(op, BandedBlocks):
        return f"banded {op.block_rows}"
    return {"BucketedELL": "bucketed_ell", "COO": "coo"}[type(op).__name__]


@pytest.mark.parametrize("table", [V5E, H100], ids=["v5e", "h100"])
@pytest.mark.parametrize("make", [
    lambda: TG.banded_csr(3000, 40, 9, seed=3),
    lambda: TG.powerlaw_csr(3000, 3000, 40_000, seed=4),
    lambda: TG.cop20k_like(scale=0.05)], ids=["banded", "powerlaw", "fem"])
def test_the_tile_free_pick_is_auto_formats(make, table):
    csr = make().astype(np.float32)
    for k in (1, 32):
        assert _pick(csr, k, table) == _class(
            TA.auto_format(csr, cost_table=table, k_nominal=k))


#: matrix -> {k: (the reference's pick, the H100 table's)}.
PICKS = {
    "cage4_like": {1: ("windowed 8x128", "coo"),
                   32: ("windowed 8x128", "bucketed_ell")},
    "fem_banded_100k": {1: ("banded 256", "coo"),
                        32: ("banded 256", "windowed 128x128")},
    "powerlaw_100k": {1: ("windowed 256x512", "coo"),
                      32: ("windowed 256x512", "coo")},
    "uniform_random_100k": {1: ("bucketed_ell", "coo"),
                            32: ("bucketed_ell", "bucketed_ell")},
    "amazon0302_like": {1: ("windowed 512x512", "coo"),
                        32: ("windowed 512x512", "bucketed_ell")},
    "cop20k_like": {1: ("windowed 128x128", "bucketed_ell"),
                    32: ("windowed 128x128", "windowed 128x128")},
    "roadnet_like": {1: ("windowed 128x128", "coo"),
                     32: ("windowed 128x128", "windowed 128x128")},
    "dc1_like": {1: ("bucketed_ell", "coo"),
                 32: ("bucketed_ell", "coo")},
}


@pytest.mark.parametrize("name", sorted(PICKS))
def test_the_h100_picks_at_full_size(name):
    csr = BUILDERS[name](1.0).astype(np.float32)
    coo = csr.to_coo()
    ij = coalesce_coo(np.asarray(coo.row_indices).astype(np.int64),
                      np.asarray(coo.col_indices).astype(np.int64),
                      np.asarray(coo.values), csr.shape[1])[:2]
    for k, (v5e, h100) in PICKS[name].items():
        assert _pick(csr, k, V5E, ij) == v5e, (name, k)
        assert _pick(csr, k, H100, ij) == h100, (name, k)


@pytest.mark.parametrize("table", [V5E, H100], ids=["v5e", "h100"])
def test_the_tile_free_one_shot_pick_is_auto_formats(table):
    csr = TG.banded_csr(3000, 40, 9, seed=3).astype(np.float32)
    for k in (1, 8, 32):
        assert _pick(csr, k, table, one_shot=True) == _class(
            TA.auto_format(csr, cost_table=table, k_nominal=k,
                           one_shot=True))


#: matrix, k -> the one-shot pick of (the reference's table, the H100
#: table's): ``spmm(csr, v)`` on cop20k at k = 32, and the models
#: benchmark's CG system at its k = 8.
ONE_SHOT_PICKS = {("cop20k_like", 32): ("windowed 128x128", "bucketed_ell"),
                  ("cg_spd121k", 8): ("banded 128", "banded 128")}


@pytest.mark.parametrize("case", sorted(ONE_SHOT_PICKS),
                         ids=lambda c: f"{c[0]}-k{c[1]}")
def test_the_h100_one_shot_picks_at_full_size(case):
    from sparsematrixmultiplicationmpi_tpu_torch.bench.systems import (
        spd_banded_system,
    )

    name, k = case
    csr = (spd_banded_system(121_192) if name == "cg_spd121k"
           else BUILDERS[name](1.0)).astype(np.float32)
    v5e, h100 = ONE_SHOT_PICKS[case]
    assert _pick(csr, k, V5E, one_shot=True) == v5e
    assert _pick(csr, k, H100, one_shot=True) == h100

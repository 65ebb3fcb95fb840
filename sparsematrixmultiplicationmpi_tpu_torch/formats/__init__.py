from .banded import BandedBlocks, band_coverage
from .hub import MAX_HUB_COLS, HubExtracted, split_hub_columns
from .matrix import COO, CSR, ELL, BucketedELL
from .reorder import (
    apply_symmetric_permutation, bandwidth, permute_rows, rcm_ordering,
)
from .windowed import CompactTiles, WindowedPairs

__all__ = [
    "BandedBlocks", "band_coverage", "HubExtracted", "MAX_HUB_COLS",
    "split_hub_columns", "COO", "CSR", "ELL", "BucketedELL",
    "WindowedPairs", "CompactTiles", "apply_symmetric_permutation",
    "bandwidth", "permute_rows", "rcm_ordering",
]

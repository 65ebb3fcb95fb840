from .banded import BandedBlocks, band_coverage
from .hub import MAX_HUB_COLS, HubExtracted, split_hub_columns
from .matrix import COO, CSR, ELL, BucketedELL
from .reorder import (
    apply_symmetric_permutation, bandwidth, permute_rows, rcm_ordering,
)
from .serialize import load_format, save_format
from .windowed import CompactTiles, WindowedPairs

__all__ = [
    "BandedBlocks", "band_coverage", "COO", "CSR", "ELL", "BucketedELL",
    "apply_symmetric_permutation", "bandwidth", "permute_rows",
    "rcm_ordering", "load_format", "save_format",
    "HubExtracted", "MAX_HUB_COLS", "split_hub_columns",
    "WindowedPairs", "CompactTiles",
]

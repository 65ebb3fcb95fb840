from .banded import BandedBlocks, band_coverage
from .matrix import COO, CSR, ELL, BucketedELL
from .reorder import (
    apply_symmetric_permutation, bandwidth, permute_rows, rcm_ordering,
)
from .windowed import WindowedPairs

__all__ = [
    "BandedBlocks", "band_coverage", "COO", "CSR", "ELL", "BucketedELL",
    "WindowedPairs", "apply_symmetric_permutation", "bandwidth",
    "permute_rows", "rcm_ordering",
]

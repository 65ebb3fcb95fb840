"""Band-dense hybrid storage (PyTorch port of
``sparsematrixmultiplicationmpi_tpu/formats/banded.py``).

Row block ``b`` densifies the 3-block window of columns
``[(b-1)R, (b+2)R)`` into ``band[b] (R, 3R)``; off-band entries spill to a
``BucketedELL``. The builder and its cost estimate are host-side numpy,
bit-identical to the JAX package (``auto_format`` compares this
candidate's ``est_seconds`` with the windowed one, so routing parity needs
both). The constants are the JAX package's TPU v5e cost model, carried
verbatim until an H100 cost table exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .matrix import BucketedELL, CSR, array_dtype, cast, to_tensor

__all__ = ["BandedBlocks", "band_coverage"]


def band_coverage(csr: CSR, block_rows: int) -> float:
    """Fraction of nnz that fall inside the 3-block halo window."""
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    b = i // block_rows
    w = j - (b - 1) * block_rows
    in_band = (w >= 0) & (w < 3 * block_rows)
    return float(in_band.mean()) if len(i) else 0.0


@dataclasses.dataclass(frozen=True)
class BandedBlocks:
    """Dense banded row-blocks plus sparse spill: ``band[b, r, w]`` holds
    the entry at ``(b*R + r, (b-1)*R + w)``."""

    band: np.ndarray
    spill: Optional[BucketedELL]
    shape: Tuple[int, int]
    block_rows: int
    #: Cost-model per-SpMM estimate (same metric as
    #: ``WindowedPairs.est_seconds``).
    est_seconds: float = float("inf")

    @property
    def dtype(self) -> torch.dtype:
        return array_dtype(self.band)

    @property
    def n_blocks(self) -> int:
        return int(self.band.shape[0])

    @property
    def dense_bytes(self) -> int:
        return int(np.prod(self.band.shape)) * self.dtype.itemsize

    def astype(self, dtype) -> "BandedBlocks":
        """The band and spill values cast to ``dtype`` (torch or numpy),
        on the host or device where they lie."""
        return dataclasses.replace(
            self, band=cast(self.band, dtype),
            spill=None if self.spill is None else self.spill.astype(dtype))

    def to(self, device) -> "BandedBlocks":
        return dataclasses.replace(
            self, band=to_tensor(self.band, device),
            spill=None if self.spill is None else self.spill.to(device))

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        from ..ops.banded import spmm_banded

        return spmm_banded(self, v)

    def to_dense(self) -> np.ndarray:
        """The matrix as a host array (a bf16 band as float32) of a
        host-side operand."""
        m, n = self.shape
        r = self.block_rows
        band = to_tensor(self.band, "cpu")
        if band.dtype == torch.bfloat16:
            band = band.to(torch.float32)
        band = band.numpy()
        out = np.zeros((m, n), dtype=band.dtype)
        for b in range(self.n_blocks):
            rows_hi = min((b + 1) * r, m)
            for s in range(3):
                cols = (b - 1 + s) * r
                lo, hi = max(cols, 0), min(cols + r, n)
                if lo < hi:
                    out[b * r: rows_hi, lo:hi] += band[
                        b, : rows_hi - b * r,
                        s * r + lo - cols: s * r + hi - cols]
        if self.spill is not None:
            out = out + self.spill.astype(out.dtype).to_dense()
        return out

    @classmethod
    def from_csr(cls, csr: CSR, block_rows: Optional[int] = None, *,
                 candidates=(128, 256, 512), min_coverage: float = 0.5,
                 max_inflation: float = 64.0,
                 hbm_bw: float = 819e9,
                 gather_ns_per_row: float = 1.6,
                 k_nominal: int = 32) -> Optional["BandedBlocks"]:
        """Build band-dense storage, choosing ``block_rows`` by the cost
        model (dense-band streaming at ``hbm_bw`` + spilled rows at the
        per-row gather cost). Returns ``None`` when every candidate loses
        to the pure gather path or violates ``min_coverage`` /
        ``max_inflation``."""
        m, n = csr.shape
        itemsize = np.asarray(csr.values).dtype.itemsize
        nnz = max(csr.nnz, 1)
        if block_rows is None:
            from .windowed import SPILL_RESTORE_S_PER_ROW

            gather_time = nnz * gather_ns_per_row * 1e-9
            best = None
            vb = nnz * itemsize
            for r in candidates:
                if r > max(m, 8):
                    continue
                cov = band_coverage(csr, r)
                nb = -(-m // r)
                dense_bytes = nb * r * 3 * r * itemsize
                spill_nnz = (1.0 - cov) * nnz
                spill_s = spill_nnz * gather_ns_per_row * 1e-9
                if spill_nnz > 0.05 * nnz:
                    from ..ops.auto import _calibrated_gather_seconds

                    spill_s = max(spill_s, _calibrated_gather_seconds(
                        "ell", int(spill_nnz * 1.6), m, k_nominal))
                est = (dense_bytes / hbm_bw
                       + spill_s
                       + (m * SPILL_RESTORE_S_PER_ROW if cov < 1.0
                          else 0.0))
                if (cov >= min_coverage and dense_bytes <= max_inflation * vb
                        and est < gather_time):
                    if best is None or est < best[0]:
                        best = (est, r)
            if best is None:
                return None
            block_rows = best[1]
        r = int(block_rows)
        if r % 8:
            raise ValueError(f"block_rows must be a multiple of 8, got {r}")
        nb = max(-(-m // r), 1)

        coo = csr.to_coo()
        i = np.asarray(coo.row_indices).astype(np.int64)
        j = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        from .matrix import coalesce_coo

        i, j, vals = coalesce_coo(i, j, vals, n)
        b = i // r
        w = j - (b - 1) * r
        in_band = (w >= 0) & (w < 3 * r)

        band = np.zeros((nb, r, 3 * r), dtype=vals.dtype)
        band[b[in_band], i[in_band] % r, w[in_band]] = vals[in_band]

        spill = None
        n_out = int((~in_band).sum())
        if n_out:
            from .matrix import COO

            spill_coo = COO.from_arrays(
                vals[~in_band], i[~in_band], j[~in_band], (m, n))
            spill = BucketedELL.from_csr(
                spill_coo.to_csr(), width_align=4, max_buckets=12)
        from .windowed import (
            GATHER_S_PER_ROW, HBM_BW, SPILL_RESTORE_S_PER_ROW,
        )

        row_bytes = k_nominal * 4
        spill_s = n_out * GATHER_S_PER_ROW
        if n_out > 0.05 * nnz:
            from ..ops.auto import _calibrated_gather_seconds

            spill_s = max(spill_s, _calibrated_gather_seconds(
                "ell", int(n_out * 1.6), m, k_nominal))
        est = (band.nbytes / HBM_BW
               + 4 * m * row_bytes / HBM_BW
               + spill_s
               + (m * SPILL_RESTORE_S_PER_ROW if n_out else 0.0))
        return cls(band=band, spill=spill, shape=(m, n), block_rows=r,
                   est_seconds=float(est))

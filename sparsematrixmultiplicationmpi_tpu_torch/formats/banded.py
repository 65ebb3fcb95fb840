"""Band-dense hybrid storage (PyTorch port of
``sparsematrixmultiplicationmpi_tpu/formats/banded.py``).

Row block ``b`` densifies the 3-block window of columns
``[(b-1)R, (b+2)R)`` into ``band[b] (R, 3R)``; off-band entries spill to a
``BucketedELL``. The builder and its cost estimate are host-side numpy,
bit-identical to the JAX package (``auto_format`` compares this
candidate's ``est_seconds`` with the windowed one, so routing parity needs
both). The estimate is priced by a ``CostTable`` (``formats/cost.py``):
the reference's TPU v5e table by default, the H100 table when
``auto_format`` prices for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .cost import CostTable, cost_table_for
from .matrix import (
    BucketedELL, CSR, array_dtype, cast, host_values, to_tensor,
)

__all__ = ["BandedBlocks", "band_coverage"]


def _band_passes(t: CostTable, r: int, k: int) -> int:
    """Times a width-``k`` multiply reads a ``block_rows = r`` band: once
    per ``band_k_cols`` columns where the band kernel takes it (a CTA
    holds that many columns of the fat vector), else once."""
    if t.band_k_cols and r <= t.max_kernel_block_rows:
        return -(-k // t.band_k_cols)
    return 1


def _band_stream_s(t: CostTable, r: int, k: int, nbytes: int,
                   bw: Optional[float] = None) -> float:
    """Seconds to stream a ``block_rows = r`` band of ``nbytes`` for a
    width-``k`` multiply (``_band_passes`` reads) at ``bw``, else at the
    rate of its route: ``band_bw`` through the band kernel,
    ``band_matmul_bw`` (``band_bw`` where the table has none) through
    the batched matmuls."""
    if bw is None:
        bw = t.band_bw
        if r > t.max_kernel_block_rows and t.band_matmul_bw is not None:
            bw = t.band_matmul_bw
    return nbytes * _band_passes(t, r, k) / bw


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
        """The matrix as a host array, from a host operand or a card copy
        (a bf16 one as float32)."""
        m, n = self.shape
        r = self.block_rows
        band = host_values(self.band)
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
            out = out + self.spill.to_dense()
        return out

    @classmethod
    def from_csr(cls, csr: CSR, block_rows: Optional[int] = None, *,
                 candidates=(128, 256, 512), min_coverage: float = 0.5,
                 max_inflation: float = 64.0,
                 hbm_bw: Optional[float] = None,
                 gather_ns_per_row: Optional[float] = None,
                 k_nominal: int = 32,
                 cost_table: Optional[CostTable] = None,
                 ) -> Optional["BandedBlocks"]:
        """Build band-dense storage, choosing ``block_rows`` by the cost
        model (dense-band streaming at ``hbm_bw``, once per the table's
        ``band_k_cols`` columns of a ``k_nominal``-wide vector where the
        band kernel takes the band, + spilled rows at the per-row gather
        cost and a spilled route's fixed ``band_spill_s``; both rates
        default to ``cost_table``'s, the reference's table by default:
        its rate of the band's route, ``_band_stream_s``). Returns
        ``None`` when every candidate loses to the pure gather path or
        violates ``min_coverage`` / ``max_inflation``."""
        t = cost_table_for(None, cost_table)
        if gather_ns_per_row is None:
            gather_ns_per_row = t.gather_s_per_row * 1e9
        m, n = csr.shape
        itemsize = np.asarray(csr.values).dtype.itemsize
        nnz = max(csr.nnz, 1)
        if block_rows is None:
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
                        "ell", int(spill_nnz * 1.6), m, k_nominal, t))
                est = (_band_stream_s(t, r, k_nominal, dense_bytes, hbm_bw)
                       + spill_s
                       + (m * t.spill_restore_s_per_row + t.band_spill_s
                          if cov < 1.0 else 0.0))
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
        row_bytes = k_nominal * 4
        spill_s = n_out * t.gather_s_per_row
        if n_out > 0.05 * nnz:
            from ..ops.auto import _calibrated_gather_seconds

            spill_s = max(spill_s, _calibrated_gather_seconds(
                "ell", int(n_out * 1.6), m, k_nominal, t))
        est = (_band_stream_s(t, r, k_nominal, band.nbytes)
               + 4 * m * row_bytes / t.hbm_bw
               + spill_s
               + (m * t.spill_restore_s_per_row + t.band_spill_s if n_out
                  else 0.0))
        if t.call_s:
            est += t.call_s
        return cls(band=band, spill=spill, shape=(m, n), block_rows=r,
                   est_seconds=float(est))

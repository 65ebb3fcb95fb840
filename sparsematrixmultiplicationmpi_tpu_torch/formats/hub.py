"""Hub-column extraction: a rank-h dense correction over a sparse rest
(port of ``sparsematrixmultiplicationmpi_tpu/formats/hub.py``).

Circuit matrices (the dc1 family) have a few rail-net COLUMNS touching a
large fraction of all nodes. Their contribution to the product is a
handful of rank-1 terms,

    out += A[:, j] (x) v[j, :]       for each hub column j,

which batch into one dense ``(m, h) @ (h, k)`` product; the remainder
goes to whatever format the auto cost model picks for it.
``split_hub_columns`` is host numpy, bit-identical to the JAX package;
``HubExtracted`` holds host arrays until ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .matrix import COO, CSR, cast, coalesce_coo, host_values, to_tensor

__all__ = ["HubExtracted", "split_hub_columns", "MAX_HUB_COLS"]

#: Dense-correction width cap: bounds the dense plane at m * 64 * 4 B
#: (~30 MB on the dc1 class).
MAX_HUB_COLS = 64


def split_hub_columns(csr: CSR, *, threshold: int,
                      max_cols: int = MAX_HUB_COLS):
    """Split ``csr`` into ``(hub_ids, dense_cols, remainder_csr)``, or
    ``None`` when no column's nonzero count reaches ``threshold``.
    ``dense_cols`` is the host ``(m, h)`` plane of the extracted columns
    (at most ``max_cols``, the densest); ``remainder_csr`` holds every
    other entry."""
    m, n = csr.shape
    if csr.nnz == 0:
        return None
    coo = csr.to_coo()
    i = np.asarray(coo.row_indices).astype(np.int64)
    j = np.asarray(coo.col_indices).astype(np.int64)
    vals = np.asarray(coo.values)
    # The dense-column scatter below assigns: duplicates are summed first.
    i, j, vals = coalesce_coo(i, j, vals, n)
    counts = np.bincount(j, minlength=n)
    hub_ids = np.nonzero(counts >= max(int(threshold), 1))[0]
    if len(hub_ids) == 0:
        return None
    if len(hub_ids) > max_cols:
        order = np.argsort(-counts[hub_ids], kind="stable")
        hub_ids = np.sort(hub_ids[order[:max_cols]])
    sel = np.isin(j, hub_ids)
    dense = np.zeros((m, len(hub_ids)), dtype=vals.dtype)
    col_pos = np.searchsorted(hub_ids, j[sel])
    dense[i[sel], col_pos] = vals[sel]
    rem = COO.from_arrays(vals[~sel], i[~sel], j[~sel], (m, n)).to_csr()
    return hub_ids.astype(np.int32), dense, rem


@dataclasses.dataclass(frozen=True)
class HubExtracted:
    """Dense hub-column correction over any ``spmm_any`` operand:
    ``dense_cols[i, p]`` is the entry at ``(i, hub_ids[p])``, every other
    entry lies in ``remainder``."""

    dense_cols: Any                 # (m, h): numpy, or a tensor after to()
    hub_ids: Any                    # (h,) int32
    remainder: Any
    shape: Tuple[int, int]
    est_seconds: float = float("inf")

    @property
    def n_hubs(self) -> int:
        return int(self.dense_cols.shape[1])

    def astype(self, dtype) -> "HubExtracted":
        """The dense plane and the remainder cast to ``dtype`` (torch or
        numpy) where they lie."""
        return dataclasses.replace(
            self, dense_cols=cast(self.dense_cols, dtype),
            remainder=self.remainder.astype(dtype))

    def to(self, device) -> "HubExtracted":
        return dataclasses.replace(
            self, dense_cols=to_tensor(self.dense_cols, device),
            hub_ids=to_tensor(self.hub_ids, device),
            remainder=self.remainder.to(device))

    def to_dense(self) -> np.ndarray:
        """The matrix as a host array, from a host operand or a card copy
        (a bf16 one as float32): the remainder's dense view with the hub
        columns added."""
        dc = host_values(self.dense_cols)
        base = np.zeros(self.shape, dtype=dc.dtype) + self.remainder.to_dense()
        base[:, host_values(self.hub_ids)] += dc
        return base

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        from ..ops.auto import spmm_any

        return spmm_any(self, v)

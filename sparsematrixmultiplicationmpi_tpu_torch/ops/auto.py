"""Automatic format selection (port of
``sparsematrixmultiplicationmpi_tpu/ops/auto.py``).

``auto_format`` prices the gather formats (bucketed ELL, COO), the
windowed tiles and the band-dense blocks with the JAX package's cost
model and returns the cheapest — host-side numpy, the same pick on the
same matrix. The model's constants and the calibrated gather table are
TPU v5e measurements carried verbatim; an H100 table is later work.
``spmm_any`` dispatches on the operand's format.

Hub-column extraction (``allow_hub=True``, ``HubExtracted``) is not
ported yet and raises.
"""

from __future__ import annotations

import inspect
from typing import Union

import numpy as np
import torch

from ..formats.banded import BandedBlocks
from ..formats.matrix import COO, BucketedELL, CSR
from ..formats.windowed import HBM_BW, WindowedPairs
from .banded import spmm_banded
from .ell import spmm_bucketed

__all__ = ["auto_format", "spmm_any", "gather_class_estimates"]

AutoFormat = Union[WindowedPairs, BandedBlocks, BucketedELL, COO]

#: Best-case per-unit gather costs (the reference's round-2 fit): the
#: floor under the calibrated surface below.
COO_S_PER_NNZ = 11.5e-9
ELL_S_PER_SLOT = 2.5e-9

#: (per-path coefficients, anchor features, residuals), fit on first use.
_CALIB_CACHE: dict = {}


def _calib_model():
    """Log-space power-law fit over the calibration table, cached."""
    if _CALIB_CACHE:
        return _CALIB_CACHE
    from ._gather_calib import GATHER_CALIB_RECORDS

    for path in ("coo", "ell"):
        rows = [r for r in GATHER_CALIB_RECORDS if r[0] == path]
        X = np.array([[1.0, np.log(w), np.log(m), np.log(k)]
                      for _, m, w, k, _ in rows])
        y = np.array([np.log(s) for *_, s in rows])
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        _CALIB_CACHE[path] = (coef, X[:, 1:], y - X @ coef)
    return _CALIB_CACHE


def _calibrated_gather_seconds(path: str, work: int, m: int,
                               k: int) -> float:
    """Table estimate of one gather-path SpMM in seconds: power-law prior
    plus an inverse-distance-weighted residual correction (exact on the
    anchors)."""
    coef, feats, resid = _calib_model()[path]
    x = np.array([1.0, np.log(max(work, 1)), np.log(max(m, 1)),
                  np.log(max(k, 1))])
    dist = np.linalg.norm(feats - x[1:], axis=1)
    w = 1.0 / (dist * dist + 1e-3)
    return float(np.exp(x @ coef + np.sum(w * resid) / np.sum(w)))


def gather_class_estimates(csr: CSR, k_nominal: int = 32):
    """Estimated per-SpMM seconds of the two gather formats:
    ``{"bucketed_ell": (est, BucketedELL), "coo": (est, None)}``. The
    legacy linear model is a floor under the calibrated surface."""
    bell = BucketedELL.from_csr(csr)
    padded_rows = sum(b.m_padded * b.width for b in bell.buckets)
    m = csr.shape[0]
    row_bytes = k_nominal * 4
    out_bytes = m * row_bytes / HBM_BW
    floor_bell = (padded_rows * ELL_S_PER_SLOT
                  + (padded_rows + m) * row_bytes / HBM_BW + out_bytes)
    floor_coo = (csr.nnz * COO_S_PER_NNZ
                 + 2 * csr.nnz * row_bytes / HBM_BW + out_bytes)
    est_bell = max(_calibrated_gather_seconds(
        "ell", padded_rows, m, k_nominal), floor_bell)
    est_coo = max(_calibrated_gather_seconds(
        "coo", csr.nnz, m, k_nominal), floor_coo)
    return {"bucketed_ell": (est_bell, bell),
            "coo": (est_coo, None)}


def auto_format(csr: CSR, *, reorder: str | None = "auto",
                allow_hub: bool = False, **format_kwargs) -> AutoFormat:
    """The cheapest storage for this matrix by estimated per-SpMM cost:
    windowed tiles or band-dense blocks where they beat the cheaper of
    the two gather formats. ``format_kwargs`` go to
    ``WindowedPairs.from_csr`` / ``BandedBlocks.from_csr`` (e.g.
    ``k_nominal``, ``block_rows``). The result is host-side; move it with
    ``.to(device)``."""
    op, _ = _auto_with_est(csr, reorder, format_kwargs, allow_hub=allow_hub)
    return op


def _auto_with_est(csr: CSR, reorder, format_kwargs, allow_hub: bool):
    """(operand, estimated seconds) of the candidate search."""
    if allow_hub:
        raise NotImplementedError(
            "allow_hub=True (HubExtracted, formats/hub.py) is not ported yet")

    def _route(fn):
        sig = inspect.signature(fn).parameters
        return {k: v for k, v in format_kwargs.items() if k in sig}

    k_nominal = format_kwargs.get("k_nominal", 32)
    ests = gather_class_estimates(csr, k_nominal=k_nominal)
    best_gather = min(ests.values(), key=lambda t: t[0])[0]

    def gather_op():
        name = min(ests, key=lambda nm: ests[nm][0])
        if name == "coo":
            return csr.to_coo()
        return ests["bucketed_ell"][1]

    candidates = [(best_gather, gather_op)]
    # Dense-tile candidates carry the same est_seconds metric; the
    # windowed build gate compares against this matrix's real gather
    # estimate.
    wp_kwargs = _route(WindowedPairs.from_csr)
    wp_kwargs.setdefault("gather_baseline_s", best_gather)
    wp = WindowedPairs.from_csr(csr, reorder=reorder, **wp_kwargs)
    bb = BandedBlocks.from_csr(csr, **_route(BandedBlocks.from_csr))
    dense_candidates = [f for f in (wp, bb) if f is not None]
    if dense_candidates:
        best_dense = min(dense_candidates, key=lambda f: f.est_seconds)
        candidates.append((best_dense.est_seconds, lambda: best_dense))

    best_est, builder = min(candidates, key=lambda t: t[0])
    return builder(), best_est


def spmm_any(operand: AutoFormat, v: torch.Tensor) -> torch.Tensor:
    """SpMM on the operand's format; the operand must be on ``v``'s
    device (``operand.to(v.device)``). CPU tensors take the plain paths,
    CUDA tensors the kernels where the reference ran one: for windowed
    tiles B2 then B1 (U>2), B6 (a phase layout) or B3/B4 (U=2), with the
    spill through B7 under ``ops/ell.py::SPILL_DMA_GATHER``; B5 for bands
    of ``block_rows <= 128``."""
    if isinstance(operand, WindowedPairs):
        from .windowed import spmm_windowed

        return spmm_windowed(operand, v)
    if isinstance(operand, BandedBlocks):
        from .cuda_banded import MAX_KERNEL_BLOCK_ROWS, spmm_banded_cuda

        dev = v.device.type
        if dev == "cuda" and operand.block_rows <= MAX_KERNEL_BLOCK_ROWS:
            return spmm_banded_cuda(operand, v)  # kernel B5
        if dev in ("cpu", "cuda"):
            # Wider bands on the card take the batched matmuls: the
            # reference's own measured routing (its einsum beat its band
            # kernel at block_rows >= 256 on v5e), not a fallback. An H100
            # measurement of this gate waits for the H100 cost model.
            return spmm_banded(operand, v)
        raise ValueError(
            f"no band route for a tensor on {v.device}: CPU tensors take "
            "spmm_banded, CUDA tensors kernel B5 or spmm_banded")
    if isinstance(operand, BucketedELL):
        return spmm_bucketed(operand, v)
    if isinstance(operand, COO):
        from .oracle import spmm_coo

        return spmm_coo(operand, v)
    raise TypeError(f"unsupported operand format: {type(operand)}")

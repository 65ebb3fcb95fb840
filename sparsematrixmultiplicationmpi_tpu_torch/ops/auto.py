"""Automatic format selection (port of
``sparsematrixmultiplicationmpi_tpu/ops/auto.py``).

``auto_format`` prices the gather formats (bucketed ELL, COO), the
windowed tiles and the band-dense blocks with a ``CostTable``
(``formats/cost.py``) and returns the cheapest — host-side numpy. With
no ``device`` and no ``cost_table`` it prices with the reference's TPU
v5e table, so the pick is the JAX package's on the same matrix; with a
card's ``device`` it prices with that card's measured table (the
H100's). The card's table prices one body of ``Auto``'s chain;
``one_shot=True`` prices a caller that multiplies one-shot through
``spmm_any`` (a solver, PageRank, a GCN layer), whose windowed operand
pays its encode and decode every call. ``route_candidates`` gives every
class's best candidate with its estimate. ``spmm_any`` dispatches on
the operand's format; its route gates (the band kernel's width, the
spill's gather kernel, the windowed kernels' narrow-k gate) are those of
``formats/cost.py::dispatch_table`` for ``v``'s device.

``allow_hub=True`` adds the hub-column candidate (``HubExtracted``: a
dense rank-h correction plus an auto-formatted remainder, the dc1
circuit class), priced as the JAX package prices it; it is off by
default, as there. ``spmm_any`` also takes a ``torch.sparse_csr_tensor``
(``ops/library.py``, the library yardstick), which the search never
returns. ``spmm`` is the one-shot ``spmm_any(auto_format(csr), v)``.
"""

from __future__ import annotations

import inspect
from typing import Union

import numpy as np
import torch

from ..formats.banded import BandedBlocks
from ..formats.cost import V5E, CostTable, cost_table_for, dispatch_table
from ..formats.hub import HubExtracted, split_hub_columns
from ..formats.matrix import COO, BucketedELL, CSR
from ..formats.windowed import WindowedPairs
from ..utils.profiling import phase
from .banded import spmm_banded
from .ell import spmm_bucketed

__all__ = ["auto_format", "spmm", "spmm_any", "gather_class_estimates",
           "route_candidates", "route_kernels"]

AutoFormat = Union[WindowedPairs, BandedBlocks, BucketedELL, COO,
                   HubExtracted]

#: Best-case per-unit gather costs of the reference's table (its
#: round-2 fit): the floor under the calibrated surface below.
COO_S_PER_NNZ = V5E.coo_s_per_nnz
ELL_S_PER_SLOT = V5E.ell_s_per_slot

#: Per record set and model: {path: (coefficients, anchor features,
#: residuals)}, fit on first use.
_CALIB_CACHE: dict = {}


def _calib_model(table: CostTable) -> dict:
    """The prior and its log residuals on the table's gather records,
    cached per record set: a log-space power-law fit (the reference's),
    or the table's linear model over ``gather_features`` (whose records
    carry their ``width`` sixth)."""
    key = (table.gather_calib_records, table.gather_coefs)
    if key in _CALIB_CACHE:
        return _CALIB_CACHE[key]
    fits = {}
    for path in ("coo", "ell"):
        rows = [r for r in table.gather_calib_records if r[0] == path]
        if table.gather_coefs is not None:
            coef = np.asarray(dict(table.gather_coefs)[path])
            feats = np.array([[np.log(w), np.log(m), np.log(k)]
                              for _, m, w, k, *_ in rows])
            prior = np.array([np.dot(coef, gather_features(
                path, w, m, k, width)) for _, m, w, k, _, width in rows])
            fits[path] = (coef, feats, np.log([r[4] for r in rows])
                          - np.log(prior))
            continue
        X = np.array([[1.0, np.log(w), np.log(m), np.log(k)]
                      for _, m, w, k, _ in rows])
        y = np.array([np.log(s) for *_, s in rows])
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        fits[path] = (coef, X[:, 1:], y - X @ coef)
    _CALIB_CACHE[key] = fits
    return fits


def gather_features(path: str, work: int, m: int, k: int,
                    width: int = 0) -> list:
    """The features of a table's linear gather model (``gather_coefs``).
    COO (``work`` = nnz, ``width`` = the longest row): 1, nnz·k, nnz·k²
    (the scatter-add's cost per entry grows with k), and ``width`` (the
    longest row's atomic adds to one output row run one after another).
    Bucketed ELL through kernel B7 (``work`` = padded slots, ``width`` =
    the widest bucket): 1, slots·⌈k/8⌉ (32-byte sectors gathered), m·k
    (rows written and restored), and the widest row's serial walk:
    ``width``·⌈k/32⌉ on the kernel's 4-wide path (k % 4 == 0),
    ``width``·k on its scalar one."""
    if path == "coo":
        return [1.0, work * k, work * k * k, width]
    v4 = k % 4 == 0
    return [1.0, work * -(-k // 8), m * k,
            width * -(-k // 32) if v4 else 0.0, 0.0 if v4 else width * k]


def _calibrated_gather_seconds(path: str, work: int, m: int, k: int,
                               cost_table: CostTable | None = None,
                               width: int = 0) -> float:
    """Table estimate of one gather-path SpMM in seconds: a prior (the
    table's linear model over ``gather_features`` where it has one, the
    H100's; else a log-space power law, the reference's) times an
    inverse-distance-weighted correction by its residuals on the table's
    records (exact on the anchors; their mean far from them)."""
    table = cost_table_for(None, cost_table)
    coef, feats, resid = _calib_model(table)[path]
    x = np.array([1.0, np.log(max(work, 1)), np.log(max(m, 1)),
                  np.log(max(k, 1))])
    dist = np.linalg.norm(feats - x[1:], axis=1)
    w = 1.0 / (dist * dist + 1e-3)
    corr = np.sum(w * resid) / np.sum(w)
    if table.gather_coefs is not None:
        return float(np.dot(coef, gather_features(path, work, m, k, width))
                     * np.exp(corr))
    return float(np.exp(x @ coef + corr))


def gather_class_estimates(csr: CSR, k_nominal: int = 32,
                           cost_table: CostTable | None = None):
    """Estimated per-SpMM seconds of the two gather formats:
    ``{"bucketed_ell": (est, BucketedELL), "coo": (est, None)}``, priced
    by ``cost_table`` (default: the reference's). The legacy linear
    model is a floor under the calibrated surface."""
    t = cost_table_for(None, cost_table)
    bell = BucketedELL.from_csr(csr)
    padded_rows = sum(b.m_padded * b.width for b in bell.buckets)
    m = csr.shape[0]
    row_bytes = k_nominal * 4
    out_bytes = m * row_bytes / t.hbm_bw
    floor_bell = (padded_rows * t.ell_s_per_slot
                  + (padded_rows + m) * row_bytes / t.hbm_bw + out_bytes)
    floor_coo = (csr.nnz * t.coo_s_per_nnz
                 + 2 * csr.nnz * row_bytes / t.hbm_bw + out_bytes)
    est_bell = max(_calibrated_gather_seconds(
        "ell", padded_rows, m, k_nominal, t,
        max(b.width for b in bell.buckets)), floor_bell)
    est_coo = max(_calibrated_gather_seconds(
        "coo", csr.nnz, m, k_nominal, t,
        int(csr.row_lengths().max(initial=0))), floor_coo)
    return {"bucketed_ell": (est_bell, bell),
            "coo": (est_coo, None)}


def auto_format(csr: CSR, *, reorder: str | None = "auto",
                allow_hub: bool = False, device=None,
                cost_table: CostTable | None = None, one_shot: bool = False,
                **format_kwargs) -> AutoFormat:
    """The cheapest storage for this matrix by estimated per-SpMM cost:
    windowed tiles or band-dense blocks where they beat the cheaper of
    the two gather formats. ``format_kwargs`` go to
    ``WindowedPairs.from_csr`` / ``BandedBlocks.from_csr`` (e.g.
    ``k_nominal``, ``block_rows``). ``allow_hub=True`` opts into
    hub-column extraction (one level: the remainder is searched without
    it).

    The search is priced by ``cost_table``, else by the table of
    ``device`` (``formats/cost.py::cost_table_for``): pass the device
    the operand will run on, since with neither the pick is the
    reference's (the TPU v5e table), which on a card can be many times
    slower. ``one_shot=True`` prices each call as one ``spmm_any`` (the
    table's ``one_shot_s`` added to a windowed candidate) rather than as
    one body of ``Auto``'s chain. The result is host-side; move it with
    ``.to(device)``."""
    table = cost_table_for(device, cost_table)
    op, _ = _auto_with_est(csr, reorder, format_kwargs, allow_hub, table,
                           one_shot)
    return op


def _route(fn, format_kwargs) -> dict:
    sig = inspect.signature(fn).parameters
    return {k: v for k, v in format_kwargs.items() if k in sig}


def route_candidates(csr: CSR, *, reorder: str | None = "auto",
                     device=None, cost_table: CostTable | None = None,
                     one_shot: bool = False, **format_kwargs) -> list:
    """Each format class the search weighs, as ``(name, est_seconds,
    operand)`` in the search's order: ``"bucketed_ell"``, ``"coo"``, the
    best ``"windowed"`` tiling and ``"banded"`` (each None where its
    build declines), priced as ``auto_format`` prices them. The COO
    operand is ``csr.to_coo()``. The builds are phases
    (``utils/profiling.py``): ``format.rivals`` the gather formats, the
    band and the COO, ``format.windowed`` the windowed tiling search."""
    table = cost_table_for(device, cost_table)
    k_nominal = format_kwargs.get("k_nominal", 32)
    with phase("format.rivals"):
        ests = gather_class_estimates(csr, k_nominal=k_nominal,
                                      cost_table=table)
        bb = BandedBlocks.from_csr(
            csr, **{**_route(BandedBlocks.from_csr, format_kwargs),
                    "cost_table": table})
        coo = csr.to_coo()
    best_gather = min(ests.values(), key=lambda t: t[0])[0]
    # The windowed build gate compares against this matrix's real gather
    # estimate.
    wp_kwargs = _route(WindowedPairs.from_csr, format_kwargs)
    wp_kwargs.setdefault("gather_baseline_s", best_gather)
    wp_kwargs["cost_table"] = table
    with phase("format.windowed"):
        wp = WindowedPairs.from_csr(csr, reorder=reorder, **wp_kwargs)
    wp_est = None
    if wp is not None:
        wp_est = wp.est_seconds + (table.one_shot_s if one_shot else 0.0)
    return [("bucketed_ell", ests["bucketed_ell"][0], ests["bucketed_ell"][1]),
            ("coo", ests["coo"][0], coo),
            ("windowed", wp_est, wp),
            ("banded", None if bb is None else bb.est_seconds, bb)]


def _auto_with_est(csr: CSR, reorder, format_kwargs, allow_hub: bool,
                   table: CostTable, one_shot: bool = False):
    """(operand, estimated seconds) of the candidate search: the cheaper
    gather format, unless the cheaper of the windowed and band builds
    (which carry the same ``est_seconds`` metric) beats it."""
    cands = [c for c in route_candidates(csr, reorder=reorder,
                                         cost_table=table, one_shot=one_shot,
                                         **format_kwargs)
             if c[2] is not None]
    best = min(cands, key=lambda c: c[1])
    best_est, best_op = best[1], best[2]

    if allow_hub:
        # A column with c_j nonzeros costs ~c_j gather slots a multiply
        # but only m*4 B of dense streaming as a rank-1 term: break-even
        # at c_j ~ m*4B / hbm_bw / ell_s_per_slot.
        m, _ = csr.shape
        k_nominal = format_kwargs.get("k_nominal", 32)
        threshold = max(int(m * 4 / table.hbm_bw / table.ell_s_per_slot), 32)
        split = split_hub_columns(csr, threshold=threshold)
        if split is not None:
            hub_ids, dense_cols, rem = split
            rem_op, rem_est = _auto_with_est(rem, reorder, format_kwargs,
                                             False, table, one_shot)
            h = len(hub_ids)
            est = rem_est + (m * h + h * k_nominal) * 4 / table.hbm_bw
            if table.hub_s:
                est += table.hub_s
            if est < best_est:
                best_op = HubExtracted(
                    dense_cols=dense_cols, hub_ids=hub_ids,
                    remainder=rem_op, shape=csr.shape, est_seconds=est)
                best_est = est
    return best_op, best_est


def spmm_any(operand: AutoFormat, v: torch.Tensor) -> torch.Tensor:
    """SpMM on the operand's format; the operand must be on ``v``'s
    device (``operand.to(v.device)``). CPU tensors take the plain paths,
    CUDA tensors the kernels where the reference ran one: for windowed
    tiles B2 then B1 (U>2), B6 (a phase layout) or B3/B4 (U=2), with the
    spill through B7 where the device's dispatch table says so
    (``spill_dma_gather``, or ``ops/ell.py::SPILL_DMA_GATHER``); B5 for
    bands of at most its ``max_kernel_block_rows`` rows, at any width. A
    ``HubExtracted`` adds its dense
    correction to its remainder's product; a ``torch.sparse_csr_tensor``
    takes the library call."""
    if isinstance(operand, HubExtracted):
        # One (m, h) @ (h, k) dense product over the hub columns' values,
        # accumulated in the result's dtype, plus the remainder's own
        # route. f32 stays full f32 (the reference's HIGHEST): no TF32.
        base = spmm_any(operand.remainder, v)
        vh = v.index_select(0, operand.hub_ids)
        dc = operand.dense_cols
        if dc.dtype != v.dtype:
            vh = vh.to(dc.dtype)
        acc = torch.promote_types(base.dtype, dc.dtype)
        return base + torch.matmul(dc.to(acc), vh.to(acc)).to(base.dtype)
    if isinstance(operand, WindowedPairs):
        from .windowed import spmm_windowed

        return spmm_windowed(operand, v)
    if isinstance(operand, BandedBlocks):
        dev = v.device.type
        if dev == "cuda" and _band_kernel_takes(operand, v):
            from .cuda_banded import spmm_banded_cuda

            return spmm_banded_cuda(operand, v)  # kernel B5
        if dev in ("cpu", "cuda"):
            # Wider bands take the batched matmuls on the card too: the
            # reference's routing (its einsum beat its band kernel from
            # block_rows 256), and B5's shared window holds 128 rows.
            return spmm_banded(operand, v)
        raise ValueError(
            f"no band route for a tensor on {v.device}: CPU tensors take "
            "spmm_banded, CUDA tensors kernel B5 or spmm_banded")
    if isinstance(operand, BucketedELL):
        return spmm_bucketed(operand, v)
    if isinstance(operand, COO):
        from .oracle import spmm_coo

        return spmm_coo(operand, v)
    if isinstance(operand, torch.Tensor) and operand.layout == \
            torch.sparse_csr:
        from .library import spmm_library

        return spmm_library(operand, v)
    raise TypeError(f"unsupported operand format: {type(operand)}")


def route_kernels(operand: AutoFormat, k: int) -> tuple:
    """The hand-written kernels one width-``k`` ``spmm_any`` on a card
    copy of ``operand`` launches, by the card's dispatch
    (``formats/cost.py::dispatch_table``): B2 then B1 (B6 on a phase
    layout; B3 or B4 at U = 2) for windowed tiles that take the kernels
    (``ops/windowed.py::_takes_kernels``), B5 for a band the kernel
    takes, B7 for bucketed ELL and for a spill, a hub operand's
    remainder's; none for COO, whose route is a gather and an
    ``index_add_`` (the JAX package's is XLA's segment sum: no Pallas
    kernel either)."""
    gates = dispatch_table("cuda")
    b7 = ("B7",) if gates.spill_dma_gather and k <= 128 else ()
    if isinstance(operand, HubExtracted):
        return route_kernels(operand.remainder, k)
    if isinstance(operand, BucketedELL):
        return b7
    spill = b7 if getattr(operand, "spill", None) is not None else ()
    if isinstance(operand, BandedBlocks):
        own = operand.block_rows <= gates.max_kernel_block_rows
        return ("B5",) * own + spill
    if isinstance(operand, WindowedPairs):
        from .windowed import _takes_kernels

        if not _takes_kernels(operand, k, "cuda"):
            return spill
        if operand.pairs_per_step > 2:
            own = "B1" if operand.phases is None else "B6"
        else:
            own = "B3" if operand.split else "B4"
        return ("B2", own) + spill
    return ()


def _band_kernel_takes(operand: BandedBlocks, v: torch.Tensor) -> bool:
    """Whether the band kernel B5 takes this band: at most the dispatch
    table's ``max_kernel_block_rows`` rows."""
    return (operand.block_rows
            <= dispatch_table(v.device).max_kernel_block_rows)


def spmm(csr: CSR, v: torch.Tensor) -> torch.Tensor:
    """One-shot convenience: ``auto_format`` on the host, priced for one
    ``spmm_any`` on ``v``'s device, the operand moved there, then
    ``spmm_any``."""
    return spmm_any(auto_format(csr, device=v.device, one_shot=True).to(
        v.device), v)

"""Custom gradient for SpMM, training-grade autodiff (port of
``sparsematrixmultiplicationmpi_tpu/ops/autodiff.py``).

Differentiating the gather-based SpMM with respect to the fat vector
would give autograd a scatter-add (the transpose of a gather). These
wrappers instead run the backward pass as a *forward* SpMM against the
transposed operand, built once, so the gradient goes through the same
routes and kernels as the forward: on the card, for a windowed operand,
B2 then B1 both ways. For a symmetric matrix (GCN-normalized
adjacencies, SPD systems: ``A^T = A``) the forward operand is reused.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..formats.matrix import CSR
from ..io.mtx import expand_and_build_csr
from .auto import auto_format, spmm_any

__all__ = ["make_spmm", "make_symmetric_spmm", "transpose_csr",
           "make_distributed_symmetric_spmm"]


def transpose_csr(csr: CSR) -> CSR:
    """Host-side transpose (build time)."""
    coo = csr.to_coo()
    return expand_and_build_csr(
        np.asarray(coo.col_indices).astype(np.int64),
        np.asarray(coo.row_indices).astype(np.int64),
        np.asarray(coo.values),
        csr.shape[1], csr.shape[0], symmetric=False,
    )


class _SpMM(torch.autograd.Function):
    """``v -> spmm_any(operand, v)`` with backward ``g ->
    spmm_any(operand_t, g)``. The operands are Python objects kept on
    ``ctx``, not saved tensors."""

    @staticmethod
    def forward(ctx, v, operand, operand_t):
        ctx.operand_t = operand_t
        return spmm_any(operand, v)

    @staticmethod
    def backward(ctx, g):
        # The routes read row-major (n, k); a gradient can arrive strided.
        return spmm_any(ctx.operand_t, g.contiguous()), None, None


def make_symmetric_spmm(operand) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v -> A v`` with backward ``g -> A g`` (valid when ``A^T = A``);
    ``operand`` lies where ``v`` will (``operand.to(device)``)."""

    def spmm(v: torch.Tensor) -> torch.Tensor:
        return _SpMM.apply(v, operand, operand)

    return spmm


class _DistSpMM(torch.autograd.Function):
    """``v -> strategy.spmm(operand, v)`` (gathered on every rank) with
    backward ``g -> strategy.spmm(operand, g)``: the same distributed
    forward on the gradient (``A^T = A``)."""

    @staticmethod
    def forward(ctx, v, strategy, operand):
        ctx.strategy, ctx.operand = strategy, operand
        return strategy.spmm(operand, v, gather_result=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.strategy.spmm(ctx.operand, g.contiguous(),
                                 gather_result=True), None, None


def make_distributed_symmetric_spmm(strategy, operand
                                    ) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """``v -> A v`` over a mesh (``strategy`` and its prepared
    ``operand``, e.g. ``RowWise``), with backward ``g -> A g`` (valid when
    ``A^T = A``, as for a GCN's normalized adjacency). Every rank passes
    the whole ``v`` and gets the whole product, so when every rank
    computes the same loss, every rank's gradients are the one-device
    ones, with no gradient collective."""

    def spmm(v: torch.Tensor) -> torch.Tensor:
        return _DistSpMM.apply(v, strategy, operand)

    return spmm


def make_spmm(csr: CSR, *, device="cuda",
              **format_kwargs) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v -> A v`` with backward ``g -> A^T g`` through a second
    operand, ``auto_format`` of the transpose (general matrices). Both
    operands are built on the host and moved to ``device``."""
    operand = auto_format(csr, **format_kwargs).to(device)
    operand_t = auto_format(transpose_csr(csr), **format_kwargs).to(device)

    def spmm(v: torch.Tensor) -> torch.Tensor:
        return _SpMM.apply(v, operand, operand_t)

    return spmm

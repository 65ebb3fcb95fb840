"""Iterative sparse linear solvers over the port's SpMM (port of
``sparsematrixmultiplicationmpi_tpu/models/solvers.py``).

Conjugate gradient, CGLS and Jacobi. The reference's ``lax.while_loop``
becomes a Python loop that tests the same condition before each body, so
iteration counts match; the test reads one scalar back from the device
per iteration. ``spmm`` is any closure over a prepared operand, e.g.
``lambda x: spmm_any(op, x)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["conjugate_gradient", "jacobi", "cgls", "SolveResult"]

Operator = Callable[[torch.Tensor], torch.Tensor]


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0 (the reference's guard on
    zero denominators)."""
    return torch.where(den > 0, num / torch.where(den == 0, 1, den), 0.0)


def _tol2(tol: float, sq: torch.Tensor) -> torch.Tensor:
    """``tol**2 * max(sq, 1)``, with ``tol`` rounded to ``sq``'s dtype
    first, as the reference does."""
    t = torch.tensor(tol, dtype=sq.dtype, device=sq.device)
    return t ** 2 * torch.clamp(sq, min=1.0)


def conjugate_gradient(spmm: Operator, b: torch.Tensor, *, x0=None,
                       tol: float = 1e-10, max_iter: int = 1000,
                       preconditioner: Operator | None = None
                       ) -> SolveResult:
    """(Preconditioned) CG for SPD systems ``A x = b``.

    ``b`` may be ``(n,)`` or ``(n, k)``: a fat right-hand side runs k
    solves in lockstep, stopping when every column's residual is below
    ``tol * max(||b_j||, 1)`` or after ``max_iter`` iterations.
    ``preconditioner`` applies ``M^-1`` (e.g. ``lambda r: r * inv_diag``);
    identity when omitted.
    """
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    precond = preconditioner or (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0.reshape(b.shape)
    r = b - spmm(x)
    z = precond(r)
    p = z
    rz = (r * z).sum(0)
    tol2 = _tol2(tol, (b * b).sum(0))
    i = 0
    while i < max_iter and bool(((r * r).sum(0) > tol2).any()):
        ap = spmm(p)
        alpha = _safe_div(rz, (p * ap).sum(0))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = (r * z).sum(0)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
        i += 1
    norm = torch.sqrt((r * r).sum())
    return SolveResult(x[:, 0] if squeeze else x, i, norm)


def cgls(spmm: Operator, spmm_t: Operator, b: torch.Tensor, *,
         tol: float = 1e-10, max_iter: int = 1000) -> SolveResult:
    """CGLS: least squares ``min ||A x - b||`` for a general (rectangular)
    sparse ``A``, from the forward operator and its transpose. ``b`` is
    ``(m,)`` or ``(m, k)``."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    s = spmm_t(b)
    x = torch.zeros_like(s)
    r = b
    p = s
    gamma = (s * s).sum(0)
    tol2 = _tol2(tol, gamma)
    i = 0
    while i < max_iter and bool((gamma > tol2).any()):
        q = spmm(p)
        alpha = _safe_div(gamma, (q * q).sum(0))
        x = x + alpha * p
        r = r - alpha * q
        s = spmm_t(r)
        gamma_new = (s * s).sum(0)
        p = s + _safe_div(gamma_new, gamma) * p
        gamma = gamma_new
        i += 1
    norm = torch.sqrt((r * r).sum())
    return SolveResult(x[:, 0] if squeeze else x, i, norm)


def jacobi(spmm: Operator, diag: torch.Tensor, b: torch.Tensor, *,
           tol: float = 1e-10, max_iter: int = 2000) -> SolveResult:
    """Jacobi iteration ``x <- x + D^-1 (b - A x)`` for diagonally dominant
    systems. ``diag`` is the matrix diagonal ``(n,)``."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    inv_d = torch.where(diag != 0, 1.0 / torch.where(diag == 0, 1, diag),
                        0.0)
    x = torch.zeros_like(b)
    tol2 = _tol2(tol, (b * b).sum())
    res2 = torch.tensor(float("inf"), dtype=b.dtype, device=b.device)
    i = 0
    while i < max_iter and bool(res2 > tol2):
        r = b - spmm(x)
        x = x + inv_d[:, None] * r
        res2 = (r * r).sum()
        i += 1
    return SolveResult(x[:, 0] if squeeze else x, i, torch.sqrt(res2))

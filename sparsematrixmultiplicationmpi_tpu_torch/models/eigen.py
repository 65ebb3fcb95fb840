"""Lanczos eigensolver over the port's SpMM (port of
``sparsematrixmultiplicationmpi_tpu/models/eigen.py``).

Top-k eigenpairs of a symmetric sparse matrix by the Lanczos iteration
with full reorthogonalization: each step is one SpMM plus dense vector
work. The start vector comes from a ``torch.Generator`` seeded by
``seed``; its numbers differ from ``jax.random``'s, so two runs agree in
Ritz values, not in basis vectors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["lanczos", "topk_eigsh", "LanczosResult"]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor   # (steps,) tridiagonal diagonal
    betas: torch.Tensor    # (steps,) off-diagonal (betas[0] unused)
    vectors: torch.Tensor  # (steps, n) Lanczos basis


def lanczos(spmm: Callable[[torch.Tensor], torch.Tensor], n: int,
            steps: int, *, seed: int = 0, dtype=torch.float64,
            device="cuda") -> LanczosResult:
    """Run ``steps`` Lanczos iterations with full reorthogonalization.
    ``spmm`` maps ``(n, 1) -> (n, 1)`` (a symmetric operator) on
    ``device``: the card unless the caller passes ``"cpu"``."""
    gen = torch.Generator().manual_seed(seed)
    v0 = torch.randn(n, generator=gen, dtype=dtype).to(device)
    vectors = torch.zeros((steps, n), dtype=dtype, device=device)
    vectors[0] = v0 / torch.linalg.norm(v0)
    alphas = torch.zeros(steps, dtype=dtype, device=device)
    betas = torch.zeros(steps, dtype=dtype, device=device)
    for i in range(steps):
        v = vectors[i]
        w = spmm(v[:, None])[:, 0]
        alpha = torch.dot(v, w)
        w = w - alpha * v
        if i > 0:
            w = w - betas[i] * vectors[i - 1]
        # Full reorthogonalization against the basis so far (rows > i are
        # still zero).
        w = w - (vectors @ w) @ vectors
        beta = torch.linalg.norm(w)
        alphas[i] = alpha
        if i + 1 < steps:
            vectors[i + 1] = torch.where(
                beta > 1e-12, w / torch.where(beta == 0, 1, beta), 0.0)
            betas[i + 1] = beta
    return LanczosResult(alphas, betas, vectors)


def topk_eigsh(spmm: Callable[[torch.Tensor], torch.Tensor], n: int,
               k: int, *, steps: int | None = None, seed: int = 0,
               dtype=torch.float64, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (largest magnitude) eigenpairs of a symmetric operator on
    ``device`` (the card unless the caller passes ``"cpu"``):
    ``(eigenvalues (k,), eigenvectors (n, k))``."""
    if steps is None:
        steps = min(max(4 * k, 32), n)
    res = lanczos(spmm, n, steps, seed=seed, dtype=dtype, device=device)
    t = (torch.diag(res.alphas) + torch.diag(res.betas[1:], 1)
         + torch.diag(res.betas[1:], -1))
    evals, evecs = torch.linalg.eigh(t)
    order = torch.argsort(-evals.abs(), stable=True)[:k]
    vecs = res.vectors.T @ evecs[:, order]
    return evals[order], vecs / torch.linalg.norm(vecs, dim=0, keepdim=True)

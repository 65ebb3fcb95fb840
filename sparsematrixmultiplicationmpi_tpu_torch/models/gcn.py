"""Graph convolutional network, the framework's flagship model (port of
``sparsematrixmultiplicationmpi_tpu/models/gcn.py``).

A two-layer GCN (Kipf & Welling) whose neighbourhood aggregation is the
framework's SpMM: ``H' = act(Â (H W) + b)``, ``Â`` the symmetrically
normalized adjacency. The SpMM is a callable, normally
``ops/autodiff.py::make_symmetric_spmm`` over the operand
``auto_format`` picks, so the backward pass runs the same kernels as the
forward. Parameters are a ``GCNParams`` of leaf tensors, trained with a
``torch.optim`` optimizer (``torch.optim.Adam(lr=1e-2)`` has optax's
``adam(1e-2)`` defaults). The host builders are numpy and bit-identical
to the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.matrix import COO, CSR, cast
from ..io.mtx import expand_and_build_csr

__all__ = [
    "GCNParams", "normalize_adjacency", "init_gcn", "gcn_forward",
    "gcn_loss", "make_train_step", "synthetic_node_classification",
    "gcn_params_from_jax",
]


class GCNParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def normalize_adjacency(csr: CSR, add_self_loops: bool = True) -> CSR:
    """Symmetric GCN normalization ``D^-1/2 (A + I) D^-1/2`` (host-side,
    format-build time), computed in f64 and returned in the input's
    dtype."""
    m, n = csr.shape
    if m != n:
        raise ValueError("adjacency must be square")
    coo = csr.to_coo()
    rows = np.asarray(coo.row_indices)
    cols = np.asarray(coo.col_indices)
    vals = np.abs(np.asarray(coo.values))
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(m)])
        cols = np.concatenate([cols, np.arange(m)])
        vals = np.concatenate([vals, np.ones(m)])
    deg = np.zeros(m)
    np.add.at(deg, rows, vals)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg == 0, 1, deg)), 0.0)
    # Normalize in f64, but keep the input dtype: an f64 result from an
    # f32 adjacency would build formats of another dtype than the caller's.
    in_dtype = np.asarray(coo.values).dtype
    vals = (dinv[rows] * vals * dinv[cols]).astype(in_dtype)
    return COO.from_arrays(vals, rows, cols, (m, m)).to_csr()


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_()


def init_gcn(n_features: int, hidden: int, n_classes: int, *,
             generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> GCNParams:
    """He-normal weights drawn from ``generator`` (on its own device),
    zero biases; leaf tensors on ``device`` that require grad."""

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return w * math.sqrt(2.0 / fan_in)

    w1 = normal((n_features, hidden), n_features)
    w2 = normal((hidden, n_classes), hidden)
    return GCNParams(
        w1=_leaf(w1.to(device)),
        b1=_leaf(torch.zeros(hidden, dtype=dtype, device=device)),
        w2=_leaf(w2.to(device)),
        b2=_leaf(torch.zeros(n_classes, dtype=dtype, device=device)),
    )


def gcn_params_from_jax(params, *, device="cuda") -> GCNParams:
    """The JAX package's ``GCNParams`` (or any ``(w1, b1, w2, b2)`` of
    arrays) as leaf tensors on ``device``, so both packages start from
    the same weights."""
    return GCNParams(*(_leaf(torch.from_numpy(np.array(p)).to(device))
                       for p in params))


def gcn_forward(params: GCNParams,
                spmm: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """Two-layer GCN: ``logits = Â relu(Â X W1 + b1) W2 + b2``. The dense
    projections run first, so the SpMM's fat vector has the small width
    (hidden, then classes)."""
    h = spmm(x @ params.w1)
    h = torch.relu(h + params.b1)
    logits = spmm(h @ params.w2)
    return logits + params.b2


def gcn_loss(params: GCNParams, spmm, x, labels, mask) -> torch.Tensor:
    """Cross-entropy over the nodes in ``mask``: the masked sum over
    ``max(sum(mask), 1)``."""
    logits = gcn_forward(params, spmm, x)
    losses = F.cross_entropy(logits, labels.long(), reduction="none")
    mask = mask.to(losses.dtype)
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


def make_train_step(spmm, optimizer: torch.optim.Optimizer):
    """``step(params, x, labels, mask) -> loss``: the loss at the current
    parameters, then one optimizer update of them in place
    (``optimizer`` was built over ``params``)."""

    def step(params: GCNParams, x, labels, mask) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = gcn_loss(params, spmm, x, labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def synthetic_node_classification(n: int, n_features: int, n_classes: int,
                                  avg_degree: int = 8, seed: int = 0,
                                  dtype=np.float32):
    """Deterministic synthetic graph task: communities with mostly
    intra-class edges and class-correlated features. Returns host arrays
    ``(adjacency CSR, x (n, f) in dtype, labels (n,) int32, train_mask
    (n,) bool)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    # Edges mostly within class (homophily) so the GCN can learn.
    n_edges = n * avg_degree // 2
    src = rng.integers(0, n, size=2 * n_edges)
    dst = rng.integers(0, n, size=2 * n_edges)
    same = labels[src] == labels[dst]
    keep = same | (rng.uniform(size=src.size) < 0.1)
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    vals = np.ones(rows.size)
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    adj = expand_and_build_csr(
        rows[idx], cols[idx], vals[idx], n, n, symmetric=False
    )
    x, mask = draw_class_features(rng, labels, n_features, n_classes)
    return adj, cast(x, dtype), labels.astype(np.int32), mask


def draw_class_features(rng, labels, n_features: int, n_classes: int):
    """Class-correlated features and a train mask for ``labels``, drawn
    from ``rng``: class centres times 2 plus unit noise (float64), and a
    70 % mask."""
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    x = centers[labels] + rng.normal(size=(labels.size, n_features))
    mask = rng.uniform(size=labels.size) < 0.7
    return x, mask

"""Graph attention layer (GAT-style): SDDMM, sparse softmax, SpMM (port
of ``sparsematrixmultiplicationmpi_tpu/models/gat.py``).

Attention scores are computed only at the graph's edges, normalized per
destination row with a segment softmax, then applied as SpMM weights
(``ops/oracle.py::spmm_coo``). Every stage is differentiable in the
attention parameters and the features.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.matrix import COO
from ..ops.oracle import spmm_coo

__all__ = ["GATParams", "init_gat", "gat_layer", "multi_head_gat",
           "segment_softmax", "gat_params_from_jax"]


class GATParams(NamedTuple):
    w: torch.Tensor        # (f_in, f_out) projection
    att_src: torch.Tensor  # (f_out,)
    att_dst: torch.Tensor  # (f_out,)


def init_gat(f_in: int, f_out: int, *, generator: torch.Generator,
             dtype=torch.float32, device="cuda") -> GATParams:
    """He-normal projection and N(0, 0.01) attention vectors drawn from
    ``generator`` (on its own device); leaf tensors on ``device`` that
    require grad."""

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device) * scale
        return x.to(device).requires_grad_()

    return GATParams(w=normal((f_in, f_out), np.sqrt(2.0 / f_in)),
                     att_src=normal((f_out,), 0.1),
                     att_dst=normal((f_out,), 0.1))


def gat_params_from_jax(params, *, device="cuda") -> GATParams:
    """The JAX package's ``GATParams`` (or any ``(w, att_src, att_dst)``
    of arrays) as leaf tensors on ``device``."""
    return GATParams(*(torch.from_numpy(np.array(p)).to(device)
                       .requires_grad_() for p in params))


def segment_softmax(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within row segments. A segment with no
    entries has no finite maximum; it is shifted by 0."""
    ids = segment_ids.long()
    seg_max = values.new_full((num_segments,), float("-inf")).scatter_reduce(
        0, ids, values, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          seg_max.new_zeros(()))
    exp = torch.exp(values - seg_max[ids])
    denom = values.new_zeros((num_segments,)).index_add(0, ids, exp)
    return exp / denom[ids].clamp_min(1e-30)


def gat_layer(params: GATParams, adj: COO, x: torch.Tensor) -> torch.Tensor:
    """One attention head: ``out = softmax_rows(scores) @ (x W)`` with
    additive scores ``leaky_relu(a_dst.h_i + a_src.h_j, 0.2)`` at the
    adjacency's edges (``adj`` on ``x``'s device)."""
    h = x @ params.w
    # Additive attention as an SDDMM with rank-1 factors: two per-node
    # scalars gathered at the edges.
    alpha_dst = h @ params.att_dst           # (m,)
    alpha_src = h @ params.att_src           # (n,)
    scores = (alpha_dst.index_select(0, adj.row_indices)
              + alpha_src.index_select(0, adj.col_indices))
    scores = F.leaky_relu(scores, negative_slope=0.2)
    weights = segment_softmax(scores, adj.row_indices, adj.shape[0])
    return spmm_coo(dataclasses.replace(adj, values=weights), h)


def multi_head_gat(params_list, adj: COO, x: torch.Tensor,
                   concat: bool = True) -> torch.Tensor:
    """Each head's ``gat_layer``, concatenated (or averaged)."""
    outs = [gat_layer(p, adj, x) for p in params_list]
    if concat:
        return torch.cat(outs, dim=1)
    return sum(outs) / len(outs)

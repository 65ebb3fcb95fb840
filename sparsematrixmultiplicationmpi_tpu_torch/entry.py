"""The flagship model's forward step (the analog of the JAX package's
``__graft_entry__.py::entry``): a GCN whose aggregation is the port's
SpMM, through the custom-gradient wrapper.

    from sparsematrixmultiplicationmpi_tpu_torch.entry import entry
    forward, args = entry()          # on the card; entry("cpu") on the CPU
    logits = forward(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gcn import (
    gcn_forward, init_gcn, normalize_adjacency,
    synthetic_node_classification,
)
from .ops.auto import auto_format
from .ops.autodiff import make_symmetric_spmm

__all__ = ["entry"]


def entry(device="cuda"):
    """``(forward, (params, operand, x))`` for a 256-node graph (32
    features, 64 hidden, 4 classes, f32) on ``device``."""
    n, n_features, hidden, n_classes = 256, 32, 64, 4
    adj, x, _, _ = synthetic_node_classification(
        n, n_features, n_classes, seed=0, dtype=np.float32)
    # The cast goes through the format's astype, which re-derives every
    # plane the kernels read; a leaf-by-leaf cast would not.
    operand = auto_format(normalize_adjacency(adj)).astype(
        torch.float32).to(device)
    params = init_gcn(n_features, hidden, n_classes,
                      generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, device=device)

    def forward(params, operand, x):
        return gcn_forward(params, make_symmetric_spmm(operand), x)

    return forward, (params, operand, torch.from_numpy(x).to(device))

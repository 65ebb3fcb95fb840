"""Band-dense SpMM in plain PyTorch (port of
``sparsematrixmultiplicationmpi_tpu/ops/banded.py``).

Three batched matmuls over shifted block views (previous / own / next
block), summed, plus the spill through ``spmm_bucketed``. This is the JAX
package's XLA path; ``ops/auto.py::spmm_any`` keeps the reference's route
to the band kernel B5 for accelerator operands with ``block_rows <= 128``.
"""

from __future__ import annotations

import torch

from ..formats.banded import BandedBlocks
from .ell import spmm_bucketed

__all__ = ["spmm_banded"]


def spmm_banded(bb: BandedBlocks, v: torch.Tensor) -> torch.Tensor:
    """SpMM over band-dense storage (``bb`` on ``v``'s device). ``v`` is
    ``(n, k)``; returns ``(m, k)``."""
    m, n = bb.shape
    r = bb.block_rows
    nb = bb.n_blocks
    k = v.shape[1]
    # A bf16 band multiplies natively and accumulates in the fat
    # vector's dtype; a narrow fat vector takes the band's.
    out_dtype = v.dtype if v.element_size() >= 4 else bb.band.dtype

    # v padded to (nb + 2) blocks: one leading halo block, trailing fill.
    total = (nb + 2) * r
    v_pad = v.new_zeros((total, k))
    rows = min(v.shape[0], total - r)
    v_pad[r: r + rows] = v[:rows]
    v_blocks = v_pad.reshape(nb + 2, r, k)

    band = bb.band.to(out_dtype)
    out = v.new_zeros((nb, r, k), dtype=out_dtype)
    for s in range(3):
        out = out + torch.bmm(band[:, :, s * r: (s + 1) * r],
                              v_blocks[s: s + nb].to(out_dtype))
    out = out.reshape(nb * r, k)[:m]

    if bb.spill is not None:
        out = out + spmm_bucketed(bb.spill, v[:n]).to(out_dtype)
    return out

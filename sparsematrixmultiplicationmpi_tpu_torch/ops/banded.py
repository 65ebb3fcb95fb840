"""Band-dense SpMM in plain PyTorch (port of
``sparsematrixmultiplicationmpi_tpu/ops/banded.py``).

Three batched matmuls over shifted block views (previous / own / next
block), summed — B5's plain version, ``ops/cuda_banded.py::
band_matmul_plain`` — plus the spill through ``spmm_bucketed``. This is
the JAX package's XLA einsum path and the port's plain path: every CPU
operand, and CUDA operands with ``block_rows > 128``, as the reference
routes them (``ops/auto.py::spmm_any``). CUDA operands with
``block_rows <= 128`` run kernel B5 instead
(``ops/cuda_banded.py::spmm_banded_cuda``). Like the einsum, the result
has ``v``'s dtype when ``v`` is 32 or 64 bits; the kernel route returns
the band's dtype, as the reference's does.
"""

from __future__ import annotations

import torch

from ..formats.banded import BandedBlocks
from .cuda_banded import band_matmul_plain
from .ell import spmm_bucketed

__all__ = ["spmm_banded"]


def spmm_banded(bb: BandedBlocks, v: torch.Tensor) -> torch.Tensor:
    """SpMM over band-dense storage (``bb`` on ``v``'s device). ``v`` is
    ``(n, k)``; returns ``(m, k)``."""
    m, n = bb.shape
    # The result takes the fat vector's dtype, or the band's for a 16-bit
    # fat vector; the band is cast to it, and the sums run in f32 or f64.
    out_dtype = v.dtype if v.element_size() >= 4 else bb.band.dtype
    out = band_matmul_plain(bb.band.to(out_dtype), v, m=m)
    if bb.spill is not None:
        out = out + spmm_bucketed(bb.spill, v[:n]).to(out_dtype)
    return out

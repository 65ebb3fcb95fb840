"""The control: the reference put in the program's place, in the
precision one step below what the configurations state.

The configurations state float32 with TF32 off, so the control rounds
both factors of every multiply to TF32 (10 stored mantissa bits, to
nearest even) and multiplies them in float32 (``torch.sparse.mm`` over a
CSR of the operator). A comparison that lets this pass cannot tell a
later change that drops to TF32 from the float32 program.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .generate import Csr

__all__ = ["round_tf32", "tf32_multiply"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (to nearest even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_multiply(a: Csr, device):
    """``x -> A x`` with ``A`` and each ``x`` rounded to TF32, products
    summed in float32, on ``device``; ``x`` is ``(n, k)`` float32."""
    vals = round_tf32(torch.from_numpy(a.values.astype(np.float32)))
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        mat = torch.sparse_csr_tensor(
            torch.from_numpy(a.row_ptr.astype(np.int64)),
            torch.from_numpy(a.col_indices.astype(np.int64)), vals,
            size=a.shape, check_invariants=True).to(device)

    def multiply(x: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(mat, round_tf32(x.float()))

    return multiply

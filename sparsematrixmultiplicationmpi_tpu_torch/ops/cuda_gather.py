"""Hopper ELL gather kernel B7 and its plain PyTorch version (counterpart
of ``sparsematrixmultiplicationmpi_tpu/ops/pallas_gather.py``).

``ell_gather_rows`` computes ``out[r] = sum_w vals[r, w] * v[cols[r, w]]``
over one ELL plane in f32 from ``csrc/gather_kernels.cu`` (``_kernel`` on
the TPU, the explicit-DMA gather). It keeps the reference's ``(Rt, k)``
result and its ``k <= 128`` contract; the TPU kernel's 128-lane padding
of ``v`` and its ``rows_per_step`` multiple were Mosaic rules and are
gone. A CPU tensor takes ``ell_gather_rows_plain``; a CUDA tensor the
kernel, with no fallback from one to the other. Launches are counted in
``ell_gather_rows.launches``.
"""

from __future__ import annotations

import torch

from ._kernel_lib import check_launch, load_library
from .cuda_windowed import _on_kernel_device, _require, _stream

__all__ = ["ell_gather_rows", "ell_gather_rows_plain", "MAX_GATHER_K",
           "launch_counts", "reset_launch_counts"]

#: The widest fat vector the gather kernel takes (the reference's bound).
MAX_GATHER_K = 128


def ell_gather_rows_plain(cols: torch.Tensor, vals: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 on any device: one row gather and an f32 sum
    over the width axis."""
    rows, w = cols.shape
    gathered = v.to(torch.float32).index_select(0, cols.reshape(-1))
    return (vals.to(torch.float32)[:, :, None]
            * gathered.reshape(rows, w, v.shape[1])).sum(dim=1)


def ell_gather_rows(cols: torch.Tensor, vals: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``(Rt, k)`` f32 gather-reduce over one ELL plane. ``cols``: (Rt,
    W) int32 rows of ``v``; ``vals``: (Rt, W); ``v``: (n, k), ``k <=
    128``. On CUDA ``vals`` and ``v`` are contiguous f32."""
    k = v.shape[1]
    _require(k <= MAX_GATHER_K,
             f"DMA gather supports k <= {MAX_GATHER_K}, got {k}")
    if not _on_kernel_device(v):
        return ell_gather_rows_plain(cols, vals, v)
    rows, w = cols.shape
    dev = v.device
    for name, x, dt in (("cols", cols, torch.int32),
                        ("vals", vals, torch.float32),
                        ("v", v, torch.float32)):
        _require(x.device == dev and x.dtype == dt and x.is_contiguous(),
                 f"ell_gather_rows kernel: {name} must be a contiguous {dt} "
                 f"tensor on {dev}, got {x.dtype} on {x.device}")
    _require(vals.shape == cols.shape, "vals shape != cols shape")
    out = torch.empty((rows, k), dtype=torch.float32, device=dev)
    if out.numel():
        err = load_library().ell_gather_launch(
            cols.data_ptr(), vals.data_ptr(), v.data_ptr(), out.data_ptr(),
            rows, w, k, _stream(v))
        check_launch("ell_gather_rows", err)
        ell_gather_rows.launches += 1
    return out


ell_gather_rows.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"B7": ell_gather_rows.launches}


def reset_launch_counts() -> None:
    ell_gather_rows.launches = 0

"""Hopper ELL gather kernel B7 and its plain PyTorch versions (counterpart
of ``sparsematrixmultiplicationmpi_tpu/ops/pallas_gather.py``).

``ell_gather_rows`` computes ``out[r] = sum_w vals[r, w] * v[cols[r, w]]``
over one ELL plane in f32 from ``csrc/gather_kernels.cu`` (``_kernel`` on
the TPU, the explicit-DMA gather). It keeps the reference's ``(Rt, k)``
result and its ``k <= 128`` contract; the TPU kernel's 128-lane padding
of ``v`` and its ``rows_per_step`` multiple were Mosaic rules and are
gone. ``ell_gather_bucketed`` runs the same kernel over every bucket of a
``BucketedELL`` in one launch and returns the stacked per-bucket outputs
and a zero row, which the reference builds with one kernel call per
bucket and a concatenate. A CPU tensor takes the plain version
(``*_plain``); a CUDA tensor the kernel, with no fallback from one to the
other. Launches of either wrapper are counted as ``B7``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..formats.matrix import BucketedELL
from ._kernel_lib import check_launch, load_library
from .cuda_windowed import _on_kernel_device, _require, _stream

__all__ = ["ell_gather_rows", "ell_gather_rows_plain", "ell_gather_bucketed",
           "ell_gather_bucketed_plain", "MAX_GATHER_K", "MAX_GATHER_BUCKETS",
           "launch_counts", "reset_launch_counts"]

#: The widest fat vector the gather kernel takes (the reference's bound).
MAX_GATHER_K = 128
#: The most buckets one ``ell_gather_bucketed`` launch takes (its segment
#: table, passed by value, holds them and the zero row;
#: ``BucketedELL.from_csr`` makes at most 10).
MAX_GATHER_BUCKETS = 16


def ell_gather_rows_plain(cols: torch.Tensor, vals: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 on any device: one row gather and an f32 sum
    over the width axis."""
    rows, w = cols.shape
    gathered = v.to(torch.float32).index_select(0, cols.reshape(-1))
    return (vals.to(torch.float32)[:, :, None]
            * gathered.reshape(rows, w, v.shape[1])).sum(dim=1)


def _check_operands(name: str, dev: torch.device, *operands) -> None:
    """Each ``(arg, tensor, dtype)`` is a contiguous ``dtype`` tensor on
    ``dev``."""
    for arg, x, dt in operands:
        _require(x.device == dev and x.dtype == dt and x.is_contiguous(),
                 f"{name} kernel: {arg} must be a contiguous {dt} tensor on "
                 f"{dev}, got {x.dtype} on {x.device}")


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
    _check_operands("ell_gather_rows", v.device,
                    ("cols", cols, torch.int32),
                    ("vals", vals, torch.float32), ("v", v, torch.float32))
    _require(vals.shape == cols.shape, "vals shape != cols shape")
    rows, w = cols.shape
    out = torch.empty((rows, k), dtype=torch.float32, device=v.device)
    if out.numel():
        err = load_library().ell_gather_launch(
            cols.data_ptr(), vals.data_ptr(), v.data_ptr(), out.data_ptr(),
            rows, w, k, _stream(v))
        check_launch("ell_gather_rows", err)
        ell_gather_rows.launches += 1
    return out


ell_gather_rows.launches = 0


def ell_gather_bucketed_plain(bell: BucketedELL,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version of the bucketed launch on any device: each bucket
    through ``ell_gather_rows_plain``, stacked, then one zero row."""
    parts = [ell_gather_rows_plain(b.cols, b.vals, v) for b in bell.buckets]
    parts.append(torch.zeros((1, v.shape[1]), dtype=torch.float32,
                             device=v.device))
    return torch.cat(parts, dim=0)


def ell_gather_bucketed(bell: BucketedELL, v: torch.Tensor) -> torch.Tensor:
    """``(sum m_padded + 1, k)`` f32: every bucket's gather-reduce
    (``ell_gather_rows``) stacked in bucket order, then one zero row, in
    one B7 launch. ``v``: (n, k), ``k <= 128``, contiguous f32 on CUDA;
    the buckets' ``vals`` are read as f32 (cast when they are not), at
    most ``MAX_GATHER_BUCKETS`` buckets."""
    k = v.shape[1]
    _require(k <= MAX_GATHER_K,
             f"DMA gather supports k <= {MAX_GATHER_K}, got {k}")
    _require(len(bell.buckets) <= MAX_GATHER_BUCKETS,
             f"ell_gather_bucketed takes at most {MAX_GATHER_BUCKETS} "
             f"buckets, got {len(bell.buckets)}")
    if not _on_kernel_device(v):
        return ell_gather_bucketed_plain(bell, v)
    _check_operands("ell_gather_bucketed", v.device, ("v", v, torch.float32))
    table, rows = _segment_table(bell, v.device)
    out = torch.empty((rows + 1, k), dtype=torch.float32, device=v.device)
    err = load_library().ell_gather_bucketed_launch(
        table.ctypes.data, len(table), v.data_ptr(), out.data_ptr(), k,
        _stream(v))
    check_launch("ell_gather_bucketed", err)
    ell_gather_bucketed.launches += 1
    return out


ell_gather_bucketed.launches = 0

#: id(bell) -> (weak reference to bell, its device, its segment table,
#: the stacked row count, the f32 vals the table points at).
_segment_tables: dict = {}


def _segment_table(bell: BucketedELL, device: torch.device):
    """The kernel's segment table of ``bell`` (one int64 row per bucket:
    cols and vals pointers, W, rows, first output row; then the zero row,
    W = 0) and the buckets' stacked row count. The kernel takes the table
    by value, so it stays on the host. It is built and its operands
    checked at the operand's first launch, then reused while ``bell``
    lives (its fields cannot be reassigned): the per-bucket checks cost
    more host time than the launch."""
    hit = _segment_tables.get(id(bell))
    if hit is not None and hit[0]() is bell:
        _require(hit[1] == device, f"ell_gather_bucketed: the buckets are on "
                 f"{hit[1]}, v on {device}")
        return hit[2], hit[3]
    table = np.zeros((len(bell.buckets) + 1, 5), dtype=np.int64)
    keep, first = [], 0
    for i, b in enumerate(bell.buckets):
        vals = b.vals.to(torch.float32).contiguous()
        _check_operands("ell_gather_bucketed", device,
                        ("cols", b.cols, torch.int32),
                        ("vals", vals, torch.float32))
        _require(vals.shape == b.cols.shape, "vals shape != cols shape")
        keep.append(vals)  # a cast copy lives as long as the table
        rows, w = b.cols.shape
        table[i] = (b.cols.data_ptr(), vals.data_ptr(), w, rows, first)
        first += rows
    table[-1] = (0, 0, 0, 1, first)  # the zero row
    _segment_tables[id(bell)] = (weakref.ref(bell), device, table, first,
                                 keep)
    weakref.finalize(bell, _segment_tables.pop, id(bell), None)
    return table, first


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"B7": ell_gather_rows.launches + ell_gather_bucketed.launches}


def reset_launch_counts() -> None:
    ell_gather_rows.launches = 0
    ell_gather_bucketed.launches = 0

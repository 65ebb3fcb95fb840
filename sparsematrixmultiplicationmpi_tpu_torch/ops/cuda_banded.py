"""Hopper band kernel B5 and its plain PyTorch version (counterpart of
``sparsematrixmultiplicationmpi_tpu/ops/pallas_banded.py``).

``band_matmul`` computes ``out[b] = band[b] @ v[(b-1)r : (b+2)r]`` for every
row block ``b`` of ``r`` rows, with rows of ``v`` outside ``[0, n)`` counted
as zero, from ``csrc/banded_kernels.cu`` (``_band_kernel`` on the TPU). It
takes ``v`` in its natural ``(n, k)`` layout and any ``k >= 1``: the TPU
kernel's transposed, padded copy of ``v`` and its ``k % 8`` padding were
Mosaic layout rules. A CPU tensor takes ``band_matmul_plain``; a CUDA
tensor the kernel, with no fallback from one to the other. Launches are
counted in ``band_matmul.launches``.

``spmm_banded_cuda`` is ``spmm_banded_pallas``: B5, then the spill through
``spmm_bucketed``. Like the reference's kernel route it casts ``v`` to the
band's dtype, so the result has the band's dtype.
"""

from __future__ import annotations

import torch

from ..formats.banded import BandedBlocks
from ._kernel_lib import check_launch, load_library
from .cuda_windowed import _on_kernel_device, _require, _stream
from .ell import spmm_bucketed

__all__ = ["band_matmul", "band_matmul_plain", "spmm_banded_cuda",
           "launch_counts", "reset_launch_counts", "MAX_KERNEL_BLOCK_ROWS"]

#: The widest band B5 takes; the reference sends only these to its kernel.
MAX_KERNEL_BLOCK_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def band_matmul_plain(band: torch.Tensor, v: torch.Tensor, *,
                      m: int | None = None) -> torch.Tensor:
    """Plain version of B5 on any device: three batched matmuls over
    shifted block views of ``v`` (one zero block in front, zero fill
    behind), in f32 (f64 for an f64 band), cast to the band's dtype.
    Returns the first ``m`` rows (default all ``nb * r``)."""
    nb, r, _ = band.shape
    k = v.shape[1]
    acc = torch.promote_types(band.dtype, torch.float32)
    total = (nb + 2) * r
    v_pad = v.new_zeros((total, k), dtype=acc)
    rows = min(v.shape[0], total - r)
    v_pad[r: r + rows] = v[:rows]
    v_blocks = v_pad.reshape(nb + 2, r, k)
    b = band.to(acc)
    out = torch.bmm(b[:, :, :r], v_blocks[:nb])
    for s in (1, 2):
        out += torch.bmm(b[:, :, s * r: (s + 1) * r], v_blocks[s: s + nb])
    return out.reshape(nb * r, k)[:m].to(band.dtype)


def band_matmul(band: torch.Tensor, v: torch.Tensor, *,
                m: int | None = None) -> torch.Tensor:
    """``out[b*r + i] = sum_w band[b, i, w] * v[(b-1)*r + w]`` as an ``(m,
    k)`` tensor of the band's dtype. ``band``: ``(nb, r, 3r)``; ``v``:
    ``(n, k)`` of the band's dtype. On CUDA: f32 or bf16, contiguous, a
    16-byte aligned band, ``r % 8 == 0`` and ``r <= 128``."""
    _require(band.dim() == 3 and band.shape[2] == 3 * band.shape[1],
             f"band must be (nb, r, 3r), got {tuple(band.shape)}")
    _require(v.dim() == 2, f"v must be (n, k), got {tuple(v.shape)}")
    nb, r, _ = band.shape
    m = nb * r if m is None else int(m)
    _require(0 <= m <= nb * r, f"m={m} outside [0, nb*r={nb * r}]")
    if not _on_kernel_device(band):
        return band_matmul_plain(band, v, m=m)
    n, k = v.shape
    _require(band.dtype in _DTYPE_CODES,
             f"band_matmul kernel takes float32 or bfloat16, got "
             f"{band.dtype}")
    _require(v.device == band.device and v.dtype == band.dtype,
             f"band_matmul kernel: v must be {band.dtype} on {band.device}, "
             f"got {v.dtype} on {v.device}")
    _require(band.is_contiguous() and v.is_contiguous(),
             "band_matmul kernel needs contiguous band and v")
    _require(r % 8 == 0 and 0 < r <= MAX_KERNEL_BLOCK_ROWS,
             f"band_matmul kernel needs r % 8 == 0 and r <= "
             f"{MAX_KERNEL_BLOCK_ROWS}, got r={r}")
    _require(band.data_ptr() % 16 == 0, "band must be 16-byte aligned")
    _require(max(n, k, nb * -(-k // 8)) < 2 ** 31,
             f"band_matmul kernel: n={n}, k={k}, nb={nb} exceed its 32-bit "
             "sizes")
    out = torch.empty((m, k), dtype=band.dtype, device=band.device)
    if out.numel():
        err = load_library().band_launch(
            band.data_ptr(), v.data_ptr(), out.data_ptr(), nb, r, m, n, k,
            _DTYPE_CODES[band.dtype], _stream(band))
        check_launch("band_matmul", err)
        band_matmul.launches += 1
    return out


band_matmul.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {"B5": band_matmul.launches}


def reset_launch_counts() -> None:
    band_matmul.launches = 0


def spmm_banded_cuda(bb: BandedBlocks, v: torch.Tensor) -> torch.Tensor:
    """SpMM over band-dense storage through B5 (``bb`` on ``v``'s device):
    ``(n, k) -> (m, k)`` in the band's dtype, plus the spill."""
    m, n = bb.shape
    v = v.to(bb.band.dtype).contiguous()
    out = band_matmul(bb.band, v, m=m)
    if bb.spill is not None:
        out = out + spmm_bucketed(bb.spill, v[:n])
    return out

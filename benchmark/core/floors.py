"""The least work a multiply needs, whatever format implements it.

Each input byte is read once and each output byte written once: the
configuration's CSR (float32 values, int32 column indices, int32 row
pointer), the fat vector ``v`` (``n x k`` float32) and the output (``m x
k`` float32). A format's own planes, padding or gathers are the
implementation's, not the work, so a kernel that is replaced is judged
against the same floor. The time floor divides by the card's published
memory bandwidth (``PEAKS``); the card's power limit is printed beside
every share read from it.
"""

from __future__ import annotations

__all__ = ["PEAKS", "multiply_bytes", "floor_seconds"]

#: Published peaks by the name ``torch.cuda.get_device_name`` gives
#: (NVIDIA's data sheet, SXM part, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

VALUE_BYTES = 4
INDEX_BYTES = 4


def multiply_bytes(m: int, n: int, nnz: int, k: int) -> int:
    """Bytes one ``(m x n, nnz) @ (n x k)`` multiply has to move at least."""
    csr = nnz * (VALUE_BYTES + INDEX_BYTES) + (m + 1) * INDEX_BYTES
    return csr + n * k * VALUE_BYTES + m * k * VALUE_BYTES


def floor_seconds(m: int, n: int, nnz: int, k: int, card: str):
    """The byte floor in seconds on ``card``, or None for a card with no
    published peak in ``PEAKS``."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return multiply_bytes(m, n, nnz, k) / peak["hbm_bytes_per_s"]

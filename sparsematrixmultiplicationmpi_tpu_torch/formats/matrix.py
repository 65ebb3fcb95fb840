"""Sparse matrix containers as numpy dataclasses with a device step.

PyTorch counterpart of ``sparsematrixmultiplicationmpi_tpu/formats/
matrix.py``. Construction is host-side numpy and bit-identical to the JAX
package on the same input; ``.to(device)`` returns a copy whose arrays are
``torch`` tensors on that device (the JAX package's ``device_put``).

Array convention shared by every port container: host arrays are numpy,
and a ``uint16`` host array holds bfloat16 bit patterns (numpy has no
bfloat16), which ``to_tensor`` turns into a ``torch.bfloat16`` tensor.

Containers
----------
``CSR``   — ``values[nnz]``, ``col_indices[nnz]`` int32, ``row_ptr[m+1]``
            int32, static ``shape``.
``COO``   — row-sorted triplets.
``ELL``   — row-padded ``(m_padded, width)`` column/value planes.
``BucketedELL`` — rows bucketed by length into a few ELL planes plus a
            row permutation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["CSR", "COO", "ELL", "BucketedELL", "coalesce_coo",
           "split_csr_by_width", "to_tensor", "array_dtype", "cast",
           "as_float64"]


def to_tensor(x, device):
    """numpy (or torch) array -> torch tensor on ``device``; ``uint16``
    numpy arrays are bfloat16 bit patterns; ``None`` passes through."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


def array_dtype(x) -> torch.dtype:
    """The torch dtype of a host (numpy) or device (torch) array; a
    ``uint16`` host array is ``torch.bfloat16``."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    if x.dtype == np.uint16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, x.dtype)).dtype


def cast(x, dtype):
    """``x`` cast to ``dtype`` (a torch or numpy dtype) where it lies: a
    tensor stays a tensor on its device, a host array a numpy array
    (bfloat16 as ``uint16`` bits, rounded to nearest even)."""
    if not isinstance(dtype, torch.dtype):
        dtype = array_dtype(np.zeros(0, dtype))
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    t = to_tensor(x, "cpu").to(dtype)
    if dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def as_float64(x) -> np.ndarray:
    """The values of a host array as float64 numpy, decoding ``uint16``
    bfloat16 bit patterns (a plain ``astype`` would read the bits as
    integers)."""
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return to_tensor(x, "cpu").to(torch.float64).numpy()
    return x.astype(np.float64)


def coalesce_coo(i, j, vals, n: int):
    """Sum duplicate (row, col) coordinates — required before any
    densifying build (windowed tiles, banded blocks), whose scatter is an
    assignment. No-op on canonical inputs."""
    key = i.astype(np.int64) * n + j
    uniq, first, inverse = np.unique(key, return_index=True,
                                     return_inverse=True)
    if len(uniq) == len(key):
        return i, j, vals
    summed = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(summed, inverse, vals.astype(np.float64))
    return (i[first], j[first], summed.astype(vals.dtype))


def _move(obj, device, fields):
    return dataclasses.replace(
        obj, **{f: to_tensor(getattr(obj, f), device) for f in fields})


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with an explicit ``shape=(m, n)``."""

    values: np.ndarray
    col_indices: np.ndarray
    row_ptr: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def astype(self, dtype) -> "CSR":
        """Values cast to ``dtype`` (torch or numpy) through ``cast``:
        bfloat16 becomes ``uint16`` bits, rounded to nearest even."""
        return dataclasses.replace(self, values=cast(self.values, dtype))

    def to(self, device) -> "CSR":
        return _move(self, device, ("values", "col_indices", "row_ptr"))

    @classmethod
    def from_arrays(cls, values, col_indices, row_ptr, shape) -> "CSR":
        return cls(
            values=np.asarray(values),
            col_indices=np.asarray(col_indices, dtype=np.int32),
            row_ptr=np.asarray(row_ptr, dtype=np.int32),
            shape=(int(shape[0]), int(shape[1])),
        )

    @classmethod
    def from_dense(cls, dense) -> "CSR":
        """The nonzeros of a dense host array, row-major."""
        dense = np.asarray(dense)
        m, n = dense.shape
        rows, cols = np.nonzero(dense)
        row_ptr = np.zeros(m + 1, dtype=np.int32)
        np.add.at(row_ptr, rows + 1, 1)
        return cls.from_arrays(dense[rows, cols], cols,
                               np.cumsum(row_ptr, dtype=np.int32), (m, n))

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def to_coo(self) -> "COO":
        m, _ = self.shape
        counts = np.diff(np.asarray(self.row_ptr))
        rows = np.repeat(np.arange(m, dtype=np.int32), counts)
        return COO(values=self.values,
                   row_indices=np.asarray(rows, dtype=np.int32),
                   col_indices=self.col_indices, shape=self.shape)

    def row_lengths(self) -> np.ndarray:
        return np.diff(np.asarray(self.row_ptr))


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix, canonically sorted by (row, col)."""

    values: np.ndarray
    row_indices: np.ndarray
    col_indices: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def astype(self, dtype) -> "COO":
        return dataclasses.replace(self, values=cast(self.values, dtype))

    def to(self, device) -> "COO":
        return _move(self, device, ("values", "row_indices", "col_indices"))

    @classmethod
    def from_arrays(cls, values, row_indices, col_indices, shape) -> "COO":
        return cls(
            values=np.asarray(values),
            row_indices=np.asarray(row_indices, dtype=np.int32),
            col_indices=np.asarray(col_indices, dtype=np.int32),
            shape=(int(shape[0]), int(shape[1])),
        )

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=np.asarray(self.values).dtype)
        np.add.at(out, (np.asarray(self.row_indices),
                        np.asarray(self.col_indices)),
                  np.asarray(self.values))
        return out

    def pad_to(self, nnz_padded: int) -> "COO":
        """Padded with explicit zeros at (0, 0) to ``nnz_padded`` entries
        (a multiple of the shard count, for an even nnz split)."""
        pad = int(nnz_padded) - self.nnz
        if pad < 0:
            raise ValueError(f"nnz_padded={nnz_padded} < nnz={self.nnz}")
        if pad == 0:
            return self
        zi = np.zeros((pad,), dtype=np.int32)
        return COO(
            values=np.concatenate([self.values, np.zeros(
                (pad,), dtype=self.values.dtype)]),
            row_indices=np.concatenate([self.row_indices, zi]),
            col_indices=np.concatenate([self.col_indices, zi]),
            shape=self.shape)

    def to_csr(self) -> CSR:
        m, _ = self.shape
        rows = np.asarray(self.row_indices)
        cols = np.asarray(self.col_indices)
        vals = np.asarray(self.values)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        row_ptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)
        return CSR.from_arrays(vals, cols, row_ptr, self.shape)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: ``cols[m_padded, width]`` (padding points at column 0),
    ``vals[m_padded, width]`` (padding is 0.0); ``shape[0]`` rows are
    real."""

    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def m_padded(self) -> int:
        return int(self.cols.shape[0])

    def to(self, device) -> "ELL":
        return _move(self, device, ("cols", "vals"))

    def astype(self, dtype) -> "ELL":
        return dataclasses.replace(self, vals=cast(self.vals, dtype))

    @classmethod
    def from_csr(cls, csr: CSR, width: int | None = None,
                 row_align: int = 8, width_align: int = 1) -> "ELL":
        m, n = csr.shape
        lengths = csr.row_lengths()
        max_len = int(lengths.max()) if m else 0
        if width is None:
            width = max_len
        if width < max_len:
            raise ValueError(f"width={width} < max row nnz={max_len}")
        width = max(1, -(-width // width_align) * width_align)
        m_padded = max(row_align, -(-m // row_align) * row_align)

        cols = np.zeros((m_padded, width), dtype=np.int32)
        vals = np.zeros((m_padded, width), dtype=np.asarray(csr.values).dtype)
        row_ptr = np.asarray(csr.row_ptr)
        src_cols = np.asarray(csr.col_indices)
        src_vals = np.asarray(csr.values)
        rows = np.repeat(np.arange(m), lengths)
        offsets = np.arange(len(src_cols)) - np.repeat(row_ptr[:-1], lengths)
        cols[rows, offsets] = src_cols
        vals[rows, offsets] = src_vals
        return cls(cols=cols, vals=vals, shape=(m, n))

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((self.m_padded, n), dtype=np.asarray(self.vals).dtype)
        np.add.at(out, (np.arange(self.m_padded)[:, None],
                        np.asarray(self.cols)), np.asarray(self.vals))
        return out[:m]


@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """SELL-style bucketed ELLPACK: rows grouped by length into ELL
    buckets of different widths. ``row_perm`` maps concatenated bucket
    rows to original rows (padding rows map to ``m``); ``inv_row_perm``
    maps each original row to its slot (empty rows point one past the
    concatenated rows, where consumers append a zero row)."""

    buckets: Tuple[ELL, ...]
    row_perm: np.ndarray
    inv_row_perm: np.ndarray
    shape: Tuple[int, int]

    def to(self, device) -> "BucketedELL":
        moved = _move(self, device, ("row_perm", "inv_row_perm"))
        return dataclasses.replace(
            moved, buckets=tuple(b.to(device) for b in self.buckets))

    def astype(self, dtype) -> "BucketedELL":
        return dataclasses.replace(
            self, buckets=tuple(b.astype(dtype) for b in self.buckets))

    @classmethod
    def from_csr(cls, csr: CSR, max_buckets: int = 10, row_align: int = 8,
                 width_align: int = 8) -> "BucketedELL":
        m, n = csr.shape
        lengths = csr.row_lengths()
        if m == 0:
            raise ValueError("empty matrix")
        # Geometric (x2) bucket edges in row length: padding <= 2x per
        # bucket.
        max_len = max(int(lengths.max()), 1)
        edges = []
        w = width_align
        while w < max_len and len(edges) < max_buckets - 1:
            edges.append(w)
            w *= 2
        edges.append(max(-(-max_len // width_align) * width_align,
                         width_align))

        order = np.argsort(lengths, kind="stable")
        sorted_lengths = lengths[order]
        buckets = []
        perms = []
        # Empty rows never enter a bucket (see the class docstring).
        start = int(np.searchsorted(sorted_lengths, 0, side="right"))
        if start >= m:  # all-empty matrix: keep one all-zero bucket
            start = m - 1
        for edge in edges:
            stop = int(np.searchsorted(sorted_lengths, edge, side="right"))
            if stop <= start:
                continue
            rows = order[start:stop]
            start = stop
            ell = ELL.from_csr(_csr_take_rows(csr, rows), width=edge,
                               row_align=row_align, width_align=width_align)
            ell = dataclasses.replace(ell, shape=(len(rows), n))
            pad = ell.m_padded - len(rows)
            perms.append(
                np.concatenate([rows, np.full(pad, m)]).astype(np.int32))
            buckets.append(ell)
        row_perm = np.concatenate(perms)
        inv_row_perm = np.full(m, len(row_perm), dtype=np.int32)
        real = row_perm < m
        inv_row_perm[row_perm[real]] = np.nonzero(real)[0].astype(np.int32)
        return cls(buckets=tuple(buckets), row_perm=row_perm,
                   inv_row_perm=inv_row_perm, shape=(m, n))

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        stacked = np.concatenate([
            np.pad(b.to_dense(), ((0, b.m_padded - b.shape[0]), (0, 0)))
            for b in self.buckets])
        out = np.zeros((m + 1, n), dtype=stacked.dtype)
        np.add.at(out, np.asarray(self.row_perm), stacked)
        return out[:m]


def split_csr_by_width(csr: CSR, max_width: int):
    """Split into (head CSR with <= max_width nnz/row, tail COO of the
    overflow or None) — the HYB decomposition."""
    m, n = csr.shape
    lengths = csr.row_lengths().astype(np.int64)
    if not len(lengths) or lengths.max() <= max_width:
        return csr, None
    row_ptr = np.asarray(csr.row_ptr).astype(np.int64)
    cols = np.asarray(csr.col_indices)
    vals = np.asarray(csr.values)
    pos_in_row = np.arange(csr.nnz) - np.repeat(row_ptr[:-1], lengths)
    head = pos_in_row < max_width
    head_lengths = np.minimum(lengths, max_width)
    head_ptr = np.concatenate([[0], np.cumsum(head_lengths)]).astype(np.int32)
    head_csr = CSR.from_arrays(vals[head], cols[head], head_ptr, (m, n))
    tail_rows = np.repeat(np.arange(m, dtype=np.int64), lengths)[~head]
    tail = COO.from_arrays(vals[~head], tail_rows, cols[~head], (m, n))
    return head_csr, tail


def _csr_take_rows(csr: CSR, rows: np.ndarray) -> CSR:
    """Host-side row-subset CSR (format-build time only)."""
    row_ptr = np.asarray(csr.row_ptr)
    src_cols = np.asarray(csr.col_indices)
    src_vals = np.asarray(csr.values)
    lengths = (row_ptr[1:] - row_ptr[:-1])[rows].astype(np.int64)
    starts = row_ptr[:-1][rows].astype(np.int64)
    total = int(lengths.sum())
    cum = np.concatenate([[0], np.cumsum(lengths)[:-1]]) if len(rows) else []
    within = np.arange(total) - np.repeat(cum, lengths)
    idx = np.repeat(starts, lengths) + within
    new_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return CSR.from_arrays(
        src_vals[idx], src_cols[idx], new_ptr, (len(rows), csr.shape[1]))

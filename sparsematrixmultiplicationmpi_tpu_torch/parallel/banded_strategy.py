"""Row-sharded band-dense SpMM with halo exchange (port of
``sparsematrixmultiplicationmpi_tpu/parallel/banded_strategy.py``).

Band blocks, fat vector and output all live row-sharded: rank ``d`` owns
``nb_padded / p`` consecutive ``r``-row blocks. Per SpMM the only
communication is one ``r x k`` edge block to each neighbour (two
permutes in one ``batch_isend_irecv``; zeros at the mesh edges, and no
exchange at all on one rank), plus, when the matrix has off-band spill,
one ``all_gather`` of the fat vector and, for spill rows past the ELL
width cap, the COO tail's ``psum_scatter``. The band is multiplied as
the JAX package multiplies it, outside any kernel: three batched
matmuls over the ``[prev | own | next]`` windows (no hand-written kernel
runs on this path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.banded import BandedBlocks
from ..formats.matrix import COO, ELL, split_csr_by_width
from ..ops.ell import take_rows
from ..utils import collectives as coll
from .mesh import Mesh, as_mesh
from .strategies import STRATEGIES, Strategy, _ell_width_cap, _placed

__all__ = ["BandedRowWise", "BandedRowOperand"]


@dataclasses.dataclass(frozen=True)
class BandedRowOperand:
    """One rank's band blocks ``(nb_padded / p, r, 3r)``, its rows of the
    row-aligned ELL spill ``(nb_padded / p * r, W)`` and its range of the
    nnz-sharded COO tail (spill rows past the width cap, so one hub row
    cannot inflate the spill planes to ``m x max_row_nnz``); the spill
    and tail fields are None where the matrix has none."""

    band: object
    spill_cols: Optional[object]
    spill_vals: Optional[object]
    tail_values: Optional[object]
    tail_rows: Optional[object]      # global rows
    tail_cols: Optional[object]
    shape: Tuple[int, int]
    block_rows: int
    nb_padded: int
    mesh: Optional[Mesh] = None

    _ARRAYS = ("band", "spill_cols", "spill_vals", "tail_values",
               "tail_rows", "tail_cols")

    def to(self, mesh) -> "BandedRowOperand":
        return _placed(self, as_mesh(mesh), self._ARRAYS)


def _bucketed_to_csr(bell):
    """Host-side: flatten a BucketedELL back to CSR (prepare-time only)."""
    m, n = bell.shape
    rows_l, cols_l, vals_l = [], [], []
    perm = np.asarray(bell.row_perm)
    offset = 0
    for b in bell.buckets:
        rows = perm[offset: offset + b.m_padded]
        offset += b.m_padded
        rr = np.repeat(rows, b.width)
        cc = np.asarray(b.cols).reshape(-1)
        vv = np.asarray(b.vals).reshape(-1)
        keep = (vv != 0) & (rr < m)
        rows_l.append(rr[keep])
        cols_l.append(cc[keep])
        vals_l.append(vv[keep])
    return COO.from_arrays(
        np.concatenate(vals_l), np.concatenate(rows_l),
        np.concatenate(cols_l), (m, n)).to_csr()


class BandedRowWise(Strategy):
    """Row-sharded banded SpMM (halo exchange + optional spill gather)."""

    name = "banded_row_wise"

    def __init__(self, block_rows: Optional[int] = None, **format_kwargs):
        self.block_rows = block_rows
        self.format_kwargs = format_kwargs

    def partition(self, csr, p: int) -> list:
        """Every rank's ``BandedRowOperand``, on the host (the JAX
        package's ``prepare``, sharded)."""
        m, n = csr.shape
        if m != n:
            raise ValueError(
                "banded_row_wise needs a square matrix (band structure is "
                "defined relative to the diagonal)")
        kwargs = dict(self.format_kwargs)
        if self.block_rows is not None:
            kwargs.setdefault("block_rows", self.block_rows)
        else:
            # This strategy IS the band path: always build a band; the
            # cost-model rejection is for the Auto chooser.
            kwargs.setdefault("min_coverage", 0.0)
        bb = BandedBlocks.from_csr(csr, **kwargs)
        if bb is None:
            bb = BandedBlocks.from_csr(csr, block_rows=128)
        r, nb = bb.block_rows, bb.n_blocks
        nb_padded = -(-nb // p) * p
        band = np.asarray(bb.band)
        if nb_padded != nb:
            band = np.concatenate(
                [band, np.zeros((nb_padded - nb, r, 3 * r), band.dtype)])

        spill_cols = spill_vals = None
        tail = None
        if bb.spill is not None:
            # One row-aligned ELL (no row permutation), width-capped, so
            # it row-shards as the band does; overflow rides the tail.
            spill_csr = _bucketed_to_csr(bb.spill)
            head, tail = split_csr_by_width(
                spill_csr, _ell_width_cap(spill_csr, 8))
            ell = ELL.from_csr(head, row_align=nb_padded * r)
            spill_cols, spill_vals = ell.cols, ell.vals
            if tail is not None:
                tail = tail.pad_to(-(-tail.nnz // p) * p)
        nb_loc, rows = nb_padded // p, nb_padded // p * r

        def part(x, d, n_loc):
            return None if x is None else x[d * n_loc:(d + 1) * n_loc]

        t_loc = 0 if tail is None else tail.nnz // p
        return [BandedRowOperand(
            band=band[d * nb_loc:(d + 1) * nb_loc],
            spill_cols=part(spill_cols, d, rows),
            spill_vals=part(spill_vals, d, rows),
            tail_values=None if tail is None else part(
                tail.values, d, t_loc),
            tail_rows=None if tail is None else part(
                tail.row_indices, d, t_loc),
            tail_cols=None if tail is None else part(
                tail.col_indices, d, t_loc),
            shape=(m, n), block_rows=r, nb_padded=nb_padded)
            for d in range(p)]

    def prepare(self, csr, mesh) -> BandedRowOperand:
        mesh = as_mesh(mesh)
        return self.partition(csr, mesh.size)[mesh.rank].to(mesh)

    def spmm(self, operand: BandedRowOperand, v, mesh=None, *,
             gather_result=True):
        op = operand
        mesh = op.mesh
        p, d = mesh.size, mesh.rank
        m = op.shape[0]
        r = op.block_rows
        nb_loc = op.band.shape[0]
        v = v.to(mesh.device)
        k = v.shape[1]
        # Row-shard the fat vector, padded to the band's row extent.
        v_pad = v.new_zeros((op.nb_padded * r, k))
        v_pad[: v.shape[0]] = v[: op.nb_padded * r]
        v_blk = v_pad[d * nb_loc * r:(d + 1) * nb_loc * r]
        v_blocks = v_blk.reshape(nb_loc, r, k)

        # Halo: the left neighbour's last block and the right
        # neighbour's first block; zeros at the mesh edges (the band's
        # windows past the matrix edge are zero-padded by construction).
        left = d - 1 if d > 0 else None
        right = d + 1 if d + 1 < p else None
        prev_blk, next_blk = (
            coll.ppermute(mesh, [(v_blocks[-1], right, v_blocks[0], left),
                                 (v_blocks[0], left, v_blocks[0], right)])
            if p > 1 else (None, None))
        zero = v_blocks.new_zeros((r, k))
        v_ext = torch.cat([(zero if prev_blk is None else prev_blk)[None],
                           v_blocks,
                           (zero if next_blk is None else next_blk)[None]])

        acc = torch.promote_types(op.band.dtype, v.dtype)
        out = torch.zeros((nb_loc, r, k), dtype=acc, device=v.device)
        for s in range(3):
            out += torch.bmm(op.band[:, :, s * r:(s + 1) * r].to(acc),
                             v_ext[s:s + nb_loc].to(acc))
        out = out.to(v.dtype).reshape(nb_loc * r, k)

        if op.spill_cols is not None:
            # Off-band entries may reference any fat-vector row: gather
            # the whole vector once, then the local ELL rows against it.
            v_full = coll.all_gather(v_blk, mesh)
            gathered = take_rows(v_full, op.spill_cols).reshape(
                *op.spill_cols.shape, k)
            out = out + (op.spill_vals[:, :, None].to(v.dtype)
                         * gathered).sum(dim=1)
            if op.tail_values is not None:
                prods = op.tail_values[:, None].to(v.dtype) * take_rows(
                    v_full, op.tail_cols)
                partial = v.new_zeros((op.nb_padded * r, k)).index_add_(
                    0, op.tail_rows, prods)
                out = out + coll.psum_scatter(partial, mesh)
        if gather_result:
            return coll.all_gather(out, mesh)[:m]
        return out

    def gather(self, operand, out, k):
        return coll.all_gather(out, operand.mesh)[: operand.shape[0]]


STRATEGIES["banded_row"] = BandedRowWise
STRATEGIES["banded_row_wise"] = BandedRowWise

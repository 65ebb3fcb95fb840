"""Row-sharded windowed tile-pair SpMM, the flagship format on a mesh
(port of ``sparsematrixmultiplicationmpi_tpu/parallel/windowed_strategy.
py``).

Row blocks are range-partitioned over the ranks: rank ``d`` owns rows
``[d * s_loc, (d + 1) * s_loc)`` of the padded permuted space and the
dense tiles of its blocks, and runs the one-device windowed contraction
on them (``local_windowed``: on the card B2 then B1 at U > 2, B2 then
B3 (f32) or B4 (bf16) at U = 2). The output lands row-sharded
(``gather_result=False``) or is ``all_gather``-ed.

Two input modes, chosen by ``partition`` from the operand's real column
footprint:

* ``halo``: the fat vector is chunk-sharded like the output, and each
  rank receives only the halo chunks its tiles, spill and tail reference
  beyond its own range, by point-to-point permutes (one
  ``batch_isend_irecv`` per multiply); O((h_l + h_r) * C * k) bytes per
  link whatever the matrix size;
* ``replicate``: the whole fat vector on every rank (hub-heavy matrices,
  whose windows span most chunks, and rectangular ones).

Kernel contract: every rank's pair list is padded as
``WindowedPairs.from_csr`` pads the one-device one (even per-block runs
for U = 2, a multiple of U pairs in all; every local block present,
empty ones with a zero tile of an owned chunk), so each rank's
``WindowedPairs`` (``WindowedRowOperand.pairs``) takes the one-device
kernels as they are, and its card copy (``to``) holds the compact plane
those kernels read. ``partition`` is host numpy and bit for bit the JAX
package's ``prepare``; ``prepare(csr, mesh)`` is ``partition(csr,
p)[rank].to(mesh)``. The JAX package's ``force_pallas`` /
``SPMM_FORCE_PALLAS`` switch (Mosaic interpret mode) has no counterpart:
the route follows the tensor's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.cost import CostTable, cost_table_for
from ..formats.matrix import COO, ELL, coalesce_coo, split_csr_by_width, \
    to_tensor
from ..formats.windowed import (
    WindowedPairs, _split_planes, _tiles_t,
    build_dense_pairs, windowed_cost_estimate,
)
from ..ops.ell import take_rows
from ..ops.windowed import spmm_windowed_core
from ..utils import collectives as coll
from .mesh import Mesh, as_mesh
from .strategies import STRATEGIES, Strategy, _ell_width_cap

__all__ = ["WindowedRowWise", "WindowedRowOperand", "local_windowed",
           "rank_rows", "rank_window"]


@dataclasses.dataclass(frozen=True)
class WindowedRowOperand:
    """One rank's share of the row-sharded windowed operand.

    ``pairs`` is the rank's pair list as a ``WindowedPairs`` of shape
    ``(s_loc, window rows)`` with no spill and no permutation:
    ``pair_block`` holds local block ids, ``pair_chunk`` chunk ids in the
    rank's fat-vector window (global ids in ``replicate`` mode; ids in
    its ``[h_l + ch_loc + h_r]``-chunk window in ``halo`` mode), and the
    tile planes its kernels read (``tiles_split`` at U = 2 for f32,
    ``tiles_t`` at U > 2). ``spill_cols`` / ``spill_vals`` are its
    ``s_loc`` rows of the width-capped ELL spill (window-local columns
    in halo mode); the COO tail is its nnz range (replicate: global
    rows, reduce-scattered) or the entries of the rows it owns (halo:
    local rows). ``perm`` / ``inv_perm`` are the whole RCM permutation.
    """

    pairs: WindowedPairs
    spill_cols: Optional[object]
    spill_vals: Optional[object]
    tail_values: Optional[object]
    tail_rows: Optional[object]
    tail_cols: Optional[object]
    perm: Optional[object]
    inv_perm: Optional[object]
    shape: Tuple[int, int]
    block_rows: int
    chunk_cols: int
    pairs_per_step: int
    input_mode: str
    halo_left: int      # chunks
    halo_right: int     # chunks
    s_loc: int          # padded rows per rank
    mesh: Optional[Mesh] = None

    _ARRAYS = ("spill_cols", "spill_vals", "tail_values", "tail_rows",
               "tail_cols", "perm", "inv_perm")

    def to(self, mesh) -> "WindowedRowOperand":
        """The rank's copy on its mesh's device: ``pairs.to`` (on the card
        the compact plane its kernels read, built here once, and the
        two-pair contract audited) and the other arrays as tensors."""
        mesh = as_mesh(mesh)
        return dataclasses.replace(
            self, mesh=mesh, pairs=self.pairs.to(mesh.device),
            **{f: to_tensor(getattr(self, f), mesh.device)
               for f in self._ARRAYS})

    def encode(self, v: torch.Tensor) -> torch.Tensor:
        if self.perm is not None:
            v = v.index_select(0, self.perm)
        return v

    def decode(self, out_p: torch.Tensor) -> torch.Tensor:
        out_p = out_p[: self.shape[0]]
        if self.inv_perm is None:
            return out_p
        return out_p.index_select(0, self.inv_perm)


def _tile_planes(tiles, U: int):
    """The kernel tile planes of the JAX operand's ``tiles_split``:
    lane-packed split planes at U <= 2 (f32 only), transposed planes at
    U > 2 (split for f32, plain for bf16)."""
    sp = _split_planes(tiles)
    if U <= 2:
        return sp
    return _tiles_t(tiles, sp)


def _pad_device_pairs(tl, pcd, pbd, nb_loc: int, P_max: int, U: int,
                      pad_chunk: int = 0):
    """Pad one rank's (tiles, chunks, local blocks) to the kernels' pad
    contract at ``P_max`` pairs (``WindowedPairs.from_csr``'s padding):
    odd runs evened at U == 2, then tail pairs on the last local block.
    ``pbd`` must cover every local block and ``P_max`` be a multiple of
    ``U``. Pad pairs reference ``pad_chunk`` (an owned chunk in halo
    mode, so the pad never widens the halo). Returns block-sorted arrays
    of length ``P_max``."""
    R, C = tl.shape[1], tl.shape[2]
    if U == 2:
        counts = np.bincount(pbd, minlength=nb_loc)
        odd = np.nonzero(counts % 2)[0].astype(pbd.dtype)
        if len(odd):
            pbd = np.concatenate([pbd, odd])
            pcd = np.concatenate(
                [pcd, np.full(len(odd), pad_chunk, pcd.dtype)])
            tl = np.concatenate(
                [tl, np.zeros((len(odd), R, C), tl.dtype)])
    tail = P_max - len(pbd)
    if tail < 0:
        raise ValueError(
            f"P_max {P_max} below padded device count {len(pbd)}")
    if tail:
        # On the last local block: keeps the order ascending and, at
        # U == 2, that block's run even (both counts are even).
        pbd = np.concatenate([pbd, np.full(tail, nb_loc - 1, pbd.dtype)])
        pcd = np.concatenate([pcd, np.full(tail, pad_chunk, pcd.dtype)])
        tl = np.concatenate([tl, np.zeros((tail, R, C), tl.dtype)])
    order = np.argsort(pbd, kind="stable")
    return tl[order], pcd[order], pbd[order]


def _assemble_pairs(per_dev, nb_loc, U, p, R, C, rebase):
    """Every rank's pair list under the kernels' pad contract, stacked
    (``p * P_max`` pairs, rank-major). ``rebase=(ch_loc, h_l, h_r)`` maps
    global chunk ids into each rank's halo window."""
    if U == 2:
        raw_max = max(
            len(pbd) + int((np.bincount(pbd, minlength=nb_loc) % 2).sum())
            for _, _, pbd, _, _ in per_dev)
    else:
        raw_max = max(len(pbd) for _, _, pbd, _, _ in per_dev)
    P_max = max(-(-raw_max // U) * U, U)
    tiles = np.zeros((p * P_max, R, C), dtype=per_dev[0][0].dtype)
    pair_chunk = np.zeros(p * P_max, dtype=np.int32)
    pair_pos = np.zeros(p * P_max, dtype=np.int32)
    block_ptr = np.zeros((p, nb_loc + 1), dtype=np.int32)
    for d, (tl, pcd, pbd, own_chunk, _) in enumerate(per_dev):
        if rebase is not None:
            ch_loc, h_l, h_r = rebase
            hi_bound = h_l + ch_loc + h_r - 1
            # Real pairs rebase in-window by construction of the halo;
            # dummy and pad pairs (zero tiles) are clipped into it.
            pcd = np.clip(pcd - d * ch_loc + h_l, 0, hi_bound).astype(
                np.int32)
            own_chunk = int(np.clip(own_chunk - d * ch_loc + h_l, 0,
                                    hi_bound))
        tl, pcd, pbd = _pad_device_pairs(
            tl, pcd, pbd, nb_loc, P_max, U, pad_chunk=own_chunk)
        sl = slice(d * P_max, (d + 1) * P_max)
        tiles[sl] = tl
        pair_chunk[sl] = pcd
        pair_pos[sl] = pbd
        block_ptr[d] = np.searchsorted(pbd, np.arange(nb_loc + 1))
    return tiles, pair_chunk, pair_pos, block_ptr, P_max


def _shard_tail_by_owner(tv, tr, tc, p: int, s_loc: int, safe_col: int):
    """Halo mode's COO tail: each entry on the rank that owns its output
    row, with local row ids and window-local column ids; ranks padded to
    a common count with zero entries pointing at an owned slot."""
    dev = (tr // s_loc).astype(np.int64)
    t_loc = max(int(np.bincount(dev, minlength=p).max()), 1)
    out_v = np.zeros(p * t_loc, dtype=tv.dtype)
    out_r = np.zeros(p * t_loc, dtype=np.int32)
    out_c = np.full(p * t_loc, safe_col, dtype=np.int32)
    for d in range(p):
        sel = dev == d
        cnt = int(sel.sum())
        base = d * t_loc
        out_v[base: base + cnt] = tv[sel]
        out_r[base: base + cnt] = (tr[sel] - d * s_loc).astype(np.int32)
        out_c[base: base + cnt] = (
            tc[sel] - d * s_loc + safe_col).astype(np.int32)
    return out_v, out_r, out_c


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x``, zero rows past its end."""
    part = x[lo:hi]
    if part.shape[0] < hi - lo:
        part = torch.cat([part, part.new_zeros(
            (hi - lo - part.shape[0], x.shape[1]))])
    return part


def _halo_window(v_blk: torch.Tensor, mesh: Mesh, h_l_rows: int,
                 h_r_rows: int) -> torch.Tensor:
    """The rank's fat-vector window ``[left halo | own | right halo]``:
    for each hop ``t`` one permute of only the rows needed from rank
    ``d - t`` (left) or ``d + t`` (right), all in one
    ``batch_isend_irecv``; positions past the mesh edges are zeros (no
    real entry references them)."""
    s_loc = v_blk.shape[0]
    p, d = mesh.size, mesh.rank
    if not (h_l_rows or h_r_rows):
        return v_blk
    transfers, left, right = [], [], []
    if h_l_rows:
        T = -(-h_l_rows // s_loc)
        for t in range(T, 0, -1):  # farthest block first
            need = h_l_rows - (t - 1) * s_loc if t == T else s_loc
            send = v_blk[s_loc - need:]
            transfers.append((send, d + t if d + t < p else None, send,
                              d - t if d >= t else None))
            left.append(send)
    if h_r_rows:
        T = -(-h_r_rows // s_loc)
        for t in range(1, T + 1):  # nearest block first
            need = h_r_rows - (t - 1) * s_loc if t == T else s_loc
            send = v_blk[:need]
            transfers.append((send, d - t if d >= t else None, send,
                              d + t if d + t < p else None))
            right.append(send)
    received = coll.ppermute(mesh, transfers) if p > 1 else \
        [None] * len(transfers)
    parts = [torch.zeros_like(s) if r is None else r
             for s, r in zip(left + right, received)]
    return torch.cat(parts[:len(left)] + [v_blk] + parts[len(left):])


def rank_window(operand: WindowedRowOperand, v_pad: torch.Tensor,
                rank: int) -> torch.Tensor:
    """Rank ``rank``'s halo-mode fat-vector window cut from the whole
    padded permuted vector ``v_pad`` (``p * s_loc`` rows), as
    ``_halo_window`` assembles it from the ranks' blocks: its rows with
    ``h_l`` chunks before and ``h_r`` after, zeros past either end (to
    run one rank's multiply in a process that holds the whole vector)."""
    C, s = operand.chunk_cols, operand.s_loc
    lo = rank * s - operand.halo_left * C
    hi = (rank + 1) * s + operand.halo_right * C
    out = v_pad.new_zeros((hi - lo, v_pad.shape[1]))
    a, b = max(lo, 0), min(hi, v_pad.shape[0])
    out[a - lo:b - lo] = v_pad[a:b]
    return out


def local_windowed(operand: WindowedRowOperand,
                   v_window: torch.Tensor) -> torch.Tensor:
    """One rank's ``(s_loc, k)`` windowed contraction on its fat-vector
    window (no collective): ``spmm_windowed_core`` on the rank's pair
    list, so a CPU tensor takes the plain path and a CUDA tensor the
    one-device kernels behind the same gates (U > 2 with ``R % 128 ==
    0``: B2 then B1; U = 2: B2 then B3 for f32, B4 for bf16; every
    unaligned ``k`` zero-padded to a multiple of 8 around them, as
    ``ops/windowed.py::_takes_kernels`` decides)."""
    return spmm_windowed_core(operand.pairs, v_window)[: operand.s_loc]


def rank_rows(operand: WindowedRowOperand,
              v_window: torch.Tensor) -> torch.Tensor:
    """Everything of one rank's ``(s_loc, k)`` rows that its fat-vector
    window gives without a collective: ``local_windowed``, its spill
    rows, and in halo mode its row-owned tail (in replicate mode the
    tail's partial is reduce-scattered by the caller)."""
    op = operand
    k = v_window.shape[1]
    out = local_windowed(op, v_window).to(v_window.dtype)
    if op.spill_cols is not None:
        gathered = take_rows(v_window, op.spill_cols).reshape(
            *op.spill_cols.shape, k)
        out = out + (op.spill_vals[:, :, None].to(v_window.dtype)
                     * gathered).sum(dim=1)
    if op.tail_values is not None and op.input_mode == "halo":
        # Row-owned tail (local ids): a local segment-sum.
        prods = op.tail_values[:, None].to(v_window.dtype) * take_rows(
            v_window, op.tail_cols)
        out = out.index_add(0, op.tail_rows, prods)
    return out


class WindowedRowWise(Strategy):
    """Row-sharded windowed tiles over a 1-D mesh."""

    name = "windowed_row_wise"

    def __init__(self, block_rows: Optional[int] = None,
                 chunk_cols: Optional[int] = None,
                 reorder: str | None = "auto",
                 pairs_per_step: Optional[int] = None,
                 input_mode: str = "auto",
                 cost_table: Optional[CostTable] = None):
        self.block_rows = block_rows
        self.chunk_cols = chunk_cols
        self.reorder = reorder
        self.cost_table = cost_table
        if pairs_per_step is not None and (
                not isinstance(pairs_per_step, int) or pairs_per_step < 2):
            raise ValueError(
                f"pairs_per_step must be an int >= 2, got {pairs_per_step}")
        self.pairs_per_step = pairs_per_step
        if input_mode not in ("auto", "halo", "replicate"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.input_mode = input_mode

    def partition(self, csr, p: int, device=None) -> list:
        """Every rank's ``WindowedRowOperand``, on the host: the JAX
        package's ``prepare`` (RCM, tile shape, dense pairs, per-rank pad
        contract, spill, tail and input mode), bit for bit under the
        reference's cost table. The tile shape, the dense/spill split and
        the default U are priced by the table of ``device`` (this
        strategy's ``cost_table`` when given)."""
        m, n = csr.shape
        table = cost_table_for(device, self.cost_table)
        U = self.pairs_per_step or table.production_pairs_per_step
        itemsize = np.asarray(csr.values).dtype.itemsize

        coo = csr.to_coo()
        i = np.asarray(coo.row_indices).astype(np.int64)
        j = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        # The densifying scatter assigns: sum duplicates first.
        i, j, vals = coalesce_coo(i, j, vals, n)

        perm = inv_perm = None
        if self.reorder == "auto" and m == n:
            from ..formats.reorder import rcm_ordering

            perm = rcm_ordering(csr).astype(np.int32)
            inv = np.empty(m, dtype=np.int64)
            inv[perm] = np.arange(m)
            i, j = inv[i], inv[j]
            inv_perm = inv.astype(np.int32)

        if self.block_rows is not None:
            R, C = int(self.block_rows), int(self.chunk_cols or 128)
        else:
            shapes = [(64, 256), (128, 256), (256, 256), (128, 512),
                      (256, 512), (8, 128), (32, 128), (128, 128)]
            if U > 2:
                # B1 needs R % 128 == 0 (the reference's compiled flush).
                eligible = [s for s in shapes
                            if s[0] % 128 == 0 and s[0] <= max(m, 8)]
                shapes = eligible or shapes
            best = None
            for R_c, C_c in shapes:
                if R_c % 8 or R_c > max(m, 8):
                    continue
                est, _, _, _, _ = windowed_cost_estimate(
                    i, j, m, n, R_c, C_c, itemsize, pairs_per_step=U,
                    cost_table=table)
                if best is None or est < best[0]:
                    best = (est, R_c, C_c)
            _, R, C = best

        pb, pc, tiles_raw, spill_idx = build_dense_pairs(
            i, j, vals, m, n, R, C, itemsize, pairs_per_step=U,
            cost_table=table)

        # One per-rank row extent, a multiple of both R and C, so the
        # block grid (outputs) and the chunk grid (inputs) shard alike.
        L = math.lcm(R, C)
        s_loc = max(-(-m // (p * L)), 1) * L
        nb_loc = s_loc // R
        ch_loc = s_loc // C
        S = p * s_loc
        n_chunks_global = -(-n // C)

        # Every local block holds a pair (the kernels write only blocks
        # they visit): uncovered ones, the phantom blocks past m
        # included, get a zero tile of an owned chunk.
        dev_of_pair = pb // nb_loc
        counts = np.bincount(dev_of_pair, minlength=p)
        dev_starts = np.concatenate([[0], np.cumsum(counts)])
        per_dev = []
        for d in range(p):
            lo, hi = dev_starts[d], dev_starts[d + 1]
            local_pb = (pb[lo:hi] - d * nb_loc).astype(np.int32)
            present = np.zeros(nb_loc, dtype=bool)
            present[local_pb] = True
            missing = np.nonzero(~present)[0].astype(np.int32)
            cnt = hi - lo
            own_chunk = min(d * ch_loc, n_chunks_global - 1)
            tl = np.zeros((cnt + len(missing), R, C), dtype=vals.dtype)
            tl[:cnt] = tiles_raw[lo:hi]
            pcd = np.concatenate(
                [pc[lo:hi].astype(np.int32),
                 np.full(len(missing), own_chunk, np.int32)])
            pbd = np.concatenate([local_pb, missing])
            per_dev.append((tl, pcd, pbd, own_chunk, int(cnt)))

        # Spill in global index space first: the halo window must
        # account for its columns before any rebasing.
        spill_cols = spill_vals = None
        tail_values = tail_rows = tail_cols = None
        if len(spill_idx):
            spill_csr = COO.from_arrays(
                vals[spill_idx], i[spill_idx], j[spill_idx], (m, n)
            ).to_csr()
            head, tail = split_csr_by_width(
                spill_csr, _ell_width_cap(spill_csr, 8))
            ell = ELL.from_csr(head, row_align=S)
            spill_cols = np.asarray(ell.cols)
            spill_vals = np.asarray(ell.vals)
            if tail is not None:
                tail_values = np.asarray(tail.values)
                tail_rows = np.asarray(tail.row_indices)
                tail_cols = np.asarray(tail.col_indices)

        # Input mode: halo windows from every rank's real column
        # footprint (tiles + spill + tail).
        h_l = h_r = 0
        use_halo = self.input_mode in ("auto", "halo") and m == n
        if use_halo:
            need_l = need_r = 0
            for d in range(p):
                _, pcd, _, _, n_real = per_dev[d]
                # Only real pairs shape the window: dummy and pad pairs
                # are zero tiles, clipped into it at rebase.
                real = pcd[:n_real]
                lo_chunks = [int(real.min())] if n_real else []
                hi_chunks = [int(real.max())] if n_real else []
                if spill_cols is not None:
                    sc = spill_cols[d * s_loc:(d + 1) * s_loc]
                    sv = spill_vals[d * s_loc:(d + 1) * s_loc]
                    nz = sv != 0
                    if nz.any():
                        lo_chunks.append(int(sc[nz].min()) // C)
                        hi_chunks.append(int(sc[nz].max()) // C)
                if tail_values is not None:
                    owned = (tail_rows >= d * s_loc) & \
                        (tail_rows < (d + 1) * s_loc)
                    if owned.any():
                        lo_chunks.append(int(tail_cols[owned].min()) // C)
                        hi_chunks.append(int(tail_cols[owned].max()) // C)
                if lo_chunks:
                    need_l = max(need_l, d * ch_loc - min(lo_chunks))
                    need_r = max(need_r,
                                 max(hi_chunks) - ((d + 1) * ch_loc - 1))
            h_l, h_r = max(need_l, 0), max(need_r, 0)
            if self.input_mode == "auto":
                # Halo only where it beats replication.
                use_halo = (h_l + h_r) < (p - 1) * ch_loc
            if p == 1:
                h_l = h_r = 0

        if use_halo:
            tiles, pair_chunk, pair_pos, block_ptr, P_max = _assemble_pairs(
                per_dev, nb_loc, U, p, R, C, rebase=(ch_loc, h_l, h_r))
            if spill_cols is not None:
                dev_row = np.arange(S) // s_loc
                off = (dev_row * s_loc - h_l * C)[:, None]
                spill_cols = np.where(
                    spill_vals != 0, spill_cols - off, h_l * C
                ).astype(np.int32)
            if tail_values is not None:
                tail_values, tail_rows, tail_cols = _shard_tail_by_owner(
                    tail_values, tail_rows, tail_cols, p, s_loc, h_l * C)
            window = (h_l + ch_loc + h_r) * C
        else:
            h_l = h_r = 0
            tiles, pair_chunk, pair_pos, block_ptr, P_max = _assemble_pairs(
                per_dev, nb_loc, U, p, R, C, rebase=None)
            if tail_values is not None:
                tail_coo = COO.from_arrays(
                    tail_values, tail_rows, tail_cols, (m, n)
                ).pad_to(-(-len(tail_values) // p) * p)
                tail_values = np.asarray(tail_coo.values)
                tail_rows = np.asarray(tail_coo.row_indices)
                tail_cols = np.asarray(tail_coo.col_indices)
            window = n_chunks_global * C

        planes = _tile_planes(tiles, U)
        t_loc = 0 if tail_values is None else len(tail_values) // p

        def part(x, d, n_loc):
            return None if x is None else x[d * n_loc:(d + 1) * n_loc]

        out = []
        for d in range(p):
            ptiles = part(tiles, d, P_max)
            pairs = WindowedPairs(
                tiles=ptiles, pair_chunk=part(pair_chunk, d, P_max),
                pair_block=part(pair_pos, d, P_max),
                block_ptr=block_ptr[d],
                tiles_split=part(planes, d, P_max) if U <= 2 else None,
                spill=None, perm=None, inv_perm=None,
                shape=(s_loc, window), block_rows=R, chunk_cols=C,
                est_seconds=float("nan"), pairs_per_step=U,
                tiles_t=part(planes, d, P_max) if U > 2 else None)
            out.append(WindowedRowOperand(
                pairs=pairs, spill_cols=part(spill_cols, d, s_loc),
                spill_vals=part(spill_vals, d, s_loc),
                tail_values=part(tail_values, d, t_loc),
                tail_rows=part(tail_rows, d, t_loc),
                tail_cols=part(tail_cols, d, t_loc),
                perm=perm, inv_perm=inv_perm, shape=(m, n),
                block_rows=R, chunk_cols=C, pairs_per_step=U,
                input_mode="halo" if use_halo else "replicate",
                halo_left=int(h_l), halo_right=int(h_r), s_loc=int(s_loc)))
        return out

    def prepare(self, csr, mesh) -> WindowedRowOperand:
        mesh = as_mesh(mesh)
        return self.partition(csr, mesh.size, mesh.device)[
            mesh.rank].to(mesh)

    def spmm(self, operand, v, mesh=None, *, gather_result=True):
        """Full-semantics SpMM: encode, sharded multiply, decode. With
        ``gather_result=False`` the result stays this rank's ``s_loc``
        rows of the permuted, padded space (``gather`` decodes it)."""
        out_p = self.spmm_permuted(operand, operand.encode(
            v.to(operand.mesh.device)), gather_result=gather_result)
        return operand.decode(out_p) if gather_result else out_p

    def gather(self, operand, out, k):
        return operand.decode(
            coll.all_gather(out, operand.mesh)[: operand.shape[0]])

    def spmm_permuted(self, operand, v_p, mesh=None, *,
                      gather_result=True, sharded_input=False):
        """Permuted-space SpMM. ``v_p`` is the whole permuted fat vector,
        or with ``sharded_input`` this rank's ``s_loc`` rows of it (a
        chain's state: in halo mode the row-sharded output IS the next
        input, with no relayout; in replicate mode it is gathered
        first)."""
        op = operand
        mesh = op.mesh
        p, d = mesh.size, mesh.rank
        m, n = op.shape
        C, s_loc = op.chunk_cols, op.s_loc
        S = p * s_loc
        halo = op.input_mode == "halo"
        if sharded_input and not halo:
            v_p = coll.all_gather(v_p, mesh)
        # Rows past the vector are zeros; rows past the chunk grid (a
        # chained output padded to the block grid) structural zeros.
        if halo:
            v_blk = v_p if sharded_input else _rows(
                v_p, d * s_loc, (d + 1) * s_loc)
            v_full = _halo_window(v_blk, mesh, op.halo_left * C,
                                  op.halo_right * C)
        else:
            v_full = _rows(v_p, 0, -(-n // C) * C)
        out = rank_rows(op, v_full)
        if op.tail_values is not None and not halo:
            prods = op.tail_values[:, None].to(v_full.dtype) * take_rows(
                v_full, op.tail_cols)
            partial = v_full.new_zeros((S, v_full.shape[1])).index_add_(
                0, op.tail_rows, prods)
            out = out + coll.psum_scatter(partial, mesh)
        if gather_result:
            return coll.all_gather(out, mesh)[:m]
        return out

    def chain_parts(self, operand, mesh=None, *, gather_result=True):
        """(encode, body, decode) in permuted space. With
        ``gather_result=False`` the state is this rank's ``s_loc`` rows
        (square matrices only): ``encode`` keeps them, each body leaves
        its output row-sharded and ``decode`` gathers once."""
        m, n = operand.shape
        if not gather_result and m != n:
            raise ValueError("a sharded chain needs a square matrix")

        def enc(v, op):
            v_p = op.encode(v.to(op.mesh.device))
            if gather_result:
                return v_p
            d, s_loc = op.mesh.rank, op.s_loc
            return _rows(v_p, d * s_loc, (d + 1) * s_loc)

        def body(x, op):
            return self.spmm_permuted(op, x, gather_result=gather_result,
                                      sharded_input=not gather_result)

        def dec(x, op):
            if not gather_result:
                x = coll.all_gather(x, op.mesh)[:m]
            return op.decode(x)

        return enc, body, dec


STRATEGIES["windowed_row"] = WindowedRowWise
STRATEGIES["windowed_row_wise"] = WindowedRowWise

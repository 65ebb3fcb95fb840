"""Windowed tile-pair storage (PyTorch port of
``sparsematrixmultiplicationmpi_tpu/formats/windowed.py``).

The matrix is cut into ``R x C`` tiles; every tile that holds enough
nonzeros to beat the gather path is stored dense in a flat,
block-ascending pair list (``tiles[p]``, ``pair_block[p]``,
``pair_chunk[p]``), the rest spills to bucketed ELL. SpMM is then
``out[pair_block[p]] += tiles[p] @ v[pair_chunk[p]*C:][:C]``.

Everything here is host-side numpy and bit-identical to the JAX package
on the same input: the cost-model tile search, the RCM ordering choice,
the padded pair layout, the bf16 ``hi|lo`` split planes, the transposed
planes ``tiles_t`` and the phase-major layout (``phase_layout=True``,
``build_phase_layout``). On the card the Hopper kernels B1
(``ops/cuda_windowed.py::windowed_matmul_tmulti``) and B6 read
``tiles_t``'s nonzeros only, as a ``CompactTiles`` plane that
``WindowedPairs.to`` builds once per operand. The tile search is
priced by a ``CostTable`` (``formats/cost.py``): by default the
reference's TPU v5e table, so a host build routes exactly as the JAX
package's; ``ops/auto.py::auto_format`` passes the H100 table when it
prices for a card. bf16 host arrays are ``uint16`` bit patterns
(``formats/matrix.py::to_tensor``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.profiling import phase
from .cost import V5E, CostTable, cost_table_for
from .matrix import (
    BucketedELL, CSR, ELL, array_dtype, cast, host_values, to_tensor,
)

__all__ = ["WindowedPairs", "CompactTiles", "windowed_cost_estimate",
           "windowed_wins",
           "build_dense_pairs", "build_phase_layout", "DEFAULT_CANDIDATES"]

#: Default (R, C) tile-shape candidates for the build-time cost search.
DEFAULT_CANDIDATES = ((64, 256), (128, 256), (256, 256),
                      (128, 512), (256, 512), (512, 512),
                      (64, 128), (128, 128), (256, 128),
                      (8, 128), (16, 128), (32, 128))

#: The reference's TPU v5e routing constants, as module names for parity
#: with the JAX package. Every pricing function here reads them from a
#: ``CostTable`` (``formats/cost.py``): these are ``V5E``'s values, and
#: the card's are ``H100``'s.
HBM_BW = V5E.hbm_bw
GATHER_S_PER_ROW = V5E.gather_s_per_row
TILE_OVERHEAD_S = V5E.tile_overhead_s
TILE_STREAM_BW = V5E.tile_stream_bw
PRODUCTION_PAIRS_PER_STEP = V5E.production_pairs_per_step
TMULTI_STEP_S = V5E.tmulti_step_s
TMULTI_PAIR_S = V5E.tmulti_pair_s
SPILL_RESTORE_S_PER_ROW = V5E.spill_restore_s_per_row
SPILL_FRAC_REFUSE = V5E.spill_frac_refuse
KPAD_MIN_K = V5E.kpad_min_k
DENSE_BYTES_ALLOWANCE = V5E.dense_bytes_allowance
DENSE_BYTES_HARD_CAP = V5E.dense_bytes_hard_cap
RESIDENT_SLAB_VMEM_BYTES = V5E.resident_slab_vmem_bytes


def _split_planes(tiles: np.ndarray) -> Optional[np.ndarray]:
    """Lane-packed bf16 ``hi|lo`` split of an f32 tile array — (P, R, 2C)
    ``uint16`` bf16 bits with ``hi`` in columns [:C] and ``lo`` in [C:] —
    or None for other dtypes. Both roundings are torch's
    round-to-nearest-even f32 -> bf16. Torch's cast writes one bit
    pattern for every NaN, so a NaN half (a NaN value, or the ``lo`` of
    ±Inf) is rewritten to ``0x7fc0`` with the sign of the f32 it came
    from: ml_dtypes' bits, which the JAX package's split gives on every
    input (its native split keeps a NaN's payload too, so the two differ
    on payload NaNs alone)."""
    if tiles.dtype != np.float32:
        return None
    tiles = np.ascontiguousarray(tiles)
    t = torch.from_numpy(tiles)
    hi = _nan_bits(t.to(torch.bfloat16).view(torch.int16), t)
    # The rest is numpy's subtraction from the rewritten hi, as the JAX
    # split's: torch's propagates another NaN operand (a non-finite
    # value's rest), and the two agree bit for bit on finite values.
    hi32 = (hi.to(torch.int32) << 16).view(torch.float32)
    with np.errstate(invalid="ignore"):
        rest = torch.from_numpy(tiles - hi32.numpy())
    lo = _nan_bits(rest.to(torch.bfloat16).view(torch.int16), rest)
    return torch.cat([hi, lo], dim=-1).numpy().view(np.uint16)


def _nan_bits(bits: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """bf16 ``bits`` (int16) of f32 ``src`` with each NaN written as
    ml_dtypes writes it: ``0x7fc0`` carrying the sign of ``src``."""
    sign = ((src.view(torch.int32) >> 16) & -0x8000).to(torch.int16)
    return torch.where(torch.isnan(src), sign | 0x7fc0, bits)


def _tiles_t(tiles: np.ndarray, tiles_split: Optional[np.ndarray]):
    """Transposed tile operand for kernel B1: (P, 2C, R) sublane-packed
    hi/lo bf16 bits for f32 data (hi planes on rows [:C], lo on [C:]), or
    (P, C, R) plain transposed tiles otherwise."""
    src = tiles_split if tiles_split is not None else tiles
    return np.ascontiguousarray(src.swapaxes(1, 2))


def build_phase_layout(pb, pc, nb: int, n_chunks: int, cpp: int, U: int):
    """Phase-major reordering of a (padded, block-major) pair list for
    the phased kernel B6 (``ops/cuda_windowed.py::
    windowed_matmul_tmulti_phased``).

    Pairs are grouped by fat-vector chunk window ("phase" ``pc // cpp``
    — ``cpp`` chunks per phase sized so one phase's slabs fit the VMEM
    budget), block-ascending within each phase. Per phase, row blocks
    inside its touched block range with no pair get a dummy zero pair
    (the kernel only flushes blocks it visits, and the phase's partial
    output buffer covers the whole range), and the phase's pair count
    is padded to a ``U`` multiple. Deterministic pure function of
    ``(pb, pc)`` — ``astype`` re-derives the same layout to re-gather
    the transposed planes.

    Returns ``(pb_ph, pc_ph, src, phases)``: phase-LOCAL block and
    chunk ids (int32), ``src`` mapping each phase-major slot to its
    input pair index (-1 for dummies, int64), and a static tuple of
    per-phase ``(pair_offset, n_pairs, chunk_lo, block_lo, nb_ph)``
    records. Empty phases (chunk windows no pair touches) are skipped —
    the combine leaves their blocks' contribution zero.
    """
    pb = np.asarray(pb, dtype=np.int64)
    pc = np.asarray(pc, dtype=np.int64)
    ph = pc // cpp
    order = np.lexsort((pc, pb, ph))
    ph_sorted = ph[order]
    nph_max = int(ph_sorted[-1]) + 1
    bounds = np.searchsorted(ph_sorted, np.arange(nph_max + 1))
    pb_out, pc_out, src_out, phases = [], [], [], []
    offset = 0
    for p in range(nph_max):
        s, e = bounds[p], bounds[p + 1]
        if s == e:
            continue
        sel = order[s:e]
        lpb = pb[sel]
        lpc = pc[sel] - p * cpp
        blo, bhi = int(lpb.min()), int(lpb.max())
        present = np.zeros(bhi - blo + 1, dtype=bool)
        present[lpb - blo] = True
        holes = np.nonzero(~present)[0] + blo
        gb = np.concatenate([lpb, holes])
        gc = np.concatenate([lpc, np.zeros(len(holes), np.int64)])
        gs = np.concatenate([sel, np.full(len(holes), -1, np.int64)])
        o2 = np.argsort(gb, kind="stable")
        gb, gc, gs = gb[o2], gc[o2], gs[o2]
        pad = (-len(gb)) % U
        if pad:
            gb = np.concatenate([gb, np.full(pad, bhi, np.int64)])
            gc = np.concatenate([gc, np.zeros(pad, np.int64)])
            gs = np.concatenate([gs, np.full(pad, -1, np.int64)])
        phases.append((offset, len(gb), p * cpp, blo, bhi - blo + 1))
        offset += len(gb)
        pb_out.append(gb - blo)
        pc_out.append(gc)
        src_out.append(gs)
    return (np.concatenate(pb_out).astype(np.int32),
            np.concatenate(pc_out).astype(np.int32),
            np.concatenate(src_out),
            tuple(phases))


def _chunks_per_phase(C: int, itemsize: int, k_nominal: int,
                      cost_table: Optional[CostTable] = None) -> int:
    """Chunks per resident phase for the table's slab budget: one chunk's
    slab is ``k8 x slab_w`` bf16 (lane-packed hi|lo for f32 data, single
    plane for bf16)."""
    budget = cost_table_for(None, cost_table).resident_slab_vmem_bytes
    k8 = -(-max(k_nominal, 8) // 8) * 8
    slab_w = 2 * C if itemsize == 4 else C
    return max(int(budget // (k8 * slab_w * 2)), 1)


def _phase_fields(tiles, tiles_split, pair_block, pair_chunk, nb: int,
                  n_chunks: int, cpp: int, U: int):
    """(tiles_t phase-major, pb_ph, pc_ph, phases) for a U>2 format:
    the transposed bf16 planes gathered into the phase-major order
    (dummies zero). Host-side numpy."""
    pb_ph, pc_ph, src, phases = build_phase_layout(
        np.asarray(pair_block), np.asarray(pair_chunk), nb, n_chunks,
        cpp, U)
    base = tiles_split if tiles_split is not None else tiles
    base = np.asarray(base)
    g = base[np.where(src >= 0, src, 0)]
    g[src < 0] = 0
    tiles_t = np.ascontiguousarray(g.swapaxes(1, 2))
    return tiles_t, pb_ph, pc_ph, phases


def _phase_block_ptr(pb_ph, phases) -> Optional[np.ndarray]:
    """The phased kernels' work list: for each phase, the bounds of its
    ``nb_ph`` local block runs as pair indices relative to the phase's
    first pair (``nb_ph + 1`` entries), concatenated in phase order.
    None without a phase layout."""
    if phases is None:
        return None
    pb_ph = np.asarray(pb_ph)
    return np.concatenate([
        np.searchsorted(pb_ph[off:off + n], np.arange(nb_ph + 1))
        for off, n, _, _, nb_ph in phases]).astype(np.int32)


def _bf16_bits(x):
    """A numpy array from the JAX package's bf16 planes (ml_dtypes
    ``bfloat16``) as ``uint16`` bits; other arrays pass through."""
    if x is None:
        return None
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iuf":
        return x.view(np.uint16)
    return x


def _host_bucketed(spill) -> Optional[BucketedELL]:
    """Any object with BucketedELL's fields (e.g. the JAX package's) as
    this package's host-side ``BucketedELL``."""
    if spill is None or isinstance(spill, BucketedELL):
        return spill
    return BucketedELL(
        buckets=tuple(ELL(cols=np.asarray(b.cols), vals=_bf16_bits(b.vals),
                          shape=tuple(b.shape)) for b in spill.buckets),
        row_perm=np.asarray(spill.row_perm),
        inv_row_perm=np.asarray(spill.inv_row_perm),
        shape=tuple(spill.shape))


def _host_bits(x) -> np.ndarray:
    """A dense plane as a host numpy array, bf16 as ``uint16`` bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return _bf16_bits(x)


def _as_torch(x, unsigned16: bool = False) -> torch.Tensor:
    """A compact-plane array as a tensor where it lies: host numpy arrays
    become CPU tensors (``uint16`` as ``int16`` bits when ``unsigned16``,
    as ``torch.bfloat16`` otherwise)."""
    if isinstance(x, torch.Tensor):
        return x
    if unsigned16 and x.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
    return to_tensor(x, "cpu")


def _dtype_is(x, np_dtype, torch_dtype) -> bool:
    """Whether a host array has ``np_dtype``, or a tensor ``torch_dtype``."""
    if isinstance(x, torch.Tensor):
        return x.dtype == torch_dtype
    return x.dtype == np.dtype(np_dtype)


def _signed16(x: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an integer tensor as ``int16`` (two's complement)."""
    x = x & 0xFFFF
    return (x - ((x & 0x8000) << 1)).to(torch.int16)


@dataclasses.dataclass(frozen=True)
class CompactTiles:
    """The nonzeros of a tile plane: the tile operand the compact kernels
    read on the card, where a ``WindowedPairs`` copy keeps it in place of
    the dense plane (``WindowedPairs.to``). Two orientations of one
    layout:

    * a ``tiles_t``-shaped plane ``(P, planes * C, R)`` (B1, B6);
    * with ``natural``, a natural plane ``(P, R, planes * C)``, the
      ``tiles_split`` or ``tiles`` of a U=2 operand (B3, B4 bf16). A
      natural tile is the transpose of a ``tiles_t`` tile, so its arrays
      are exactly those of ``from_dense`` of the transposed plane.

    Entries are stored per tile by output index: pair, then ``r``, then
    the contraction index ``c``, all ascending. An entry is any ``(c, r)``
    at which some plane's bit pattern is non-zero, so ``to_dense`` gives
    the plane back bit for bit.

    * ``pair_nz_ptr`` (P + 1) int32: the global offset of each pair's
      first entry, so a run of pairs ``[a, b)`` is ``self[a:b]``, a slice
      of this and of ``col_ptr`` over the same entries;
    * ``col_ptr`` (P, R + 1): each output index's entries within its
      pair, ``uint16`` while ``C * R <= 65535``, else int32;
    * ``rows`` (nnz,): ``c``, ``uint8`` for ``C <= 256``, else int16;
    * ``vals`` (nnz,): with ``split`` the bf16 hi and lo bits packed into
      one int32 (``hi | lo << 16``), so one 32-bit load brings both;
      otherwise the plane's own values.

    A host copy holds numpy arrays (bf16 values as ``uint16`` bits);
    ``to(device)`` gives torch tensors (``uint16`` column offsets as
    ``int16`` bits, bf16 values as ``torch.bfloat16``).
    """

    pair_nz_ptr: object
    col_ptr: object
    rows: object
    vals: object
    chunk_cols: int
    split: bool
    natural: bool = False

    @classmethod
    def from_natural(cls, tiles, split: bool) -> "CompactTiles":
        """The compact plane of a dense natural plane ``(P, R, planes *
        C)`` (numpy, bf16 as ``uint16`` bits, or a tensor), built on the
        host from a transposed view of it, without a transposed copy."""
        ct = cls.from_dense(_host_bits(tiles).swapaxes(1, 2), split)
        return dataclasses.replace(ct, natural=True)

    @classmethod
    def from_dense(cls, tiles_t, split: bool) -> "CompactTiles":
        """The compact plane of a dense ``tiles_t`` (numpy, bf16 as
        ``uint16`` bits, or a tensor), built on the host."""
        t = _host_bits(tiles_t)
        P, CW, R = t.shape
        C = CW // 2 if split else CW
        if split and t.dtype != np.uint16:
            raise ValueError(f"split planes are bf16 bits, got {t.dtype}")
        bits = t.view(np.dtype(f"u{t.dtype.itemsize}"))
        nz = (bits[:, :C] != 0) | (bits[:, C:] != 0) if split else bits != 0
        flat = np.flatnonzero(nz.transpose(0, 2, 1))  # (p, r, c) ascending
        if flat.size >= 2 ** 31:
            raise ValueError(f"{flat.size} entries overflow int32 offsets")
        pr, c = np.divmod(flat, C)
        p, r = np.divmod(pr, R)
        col_ptr = np.zeros((P, R + 1), np.int64)
        col_ptr[:, 1:] = np.cumsum(
            np.bincount(pr, minlength=P * R).reshape(P, R), axis=1)
        pair_nz_ptr = np.zeros(P + 1, np.int32)
        pair_nz_ptr[1:] = np.cumsum(col_ptr[:, -1])
        if split:
            vals = (bits[p, c, r].astype(np.uint32)
                    | bits[p, C + c, r].astype(np.uint32) << 16).view(
                        np.int32)
        else:
            vals = t[p, c, r]
        return cls(
            pair_nz_ptr=pair_nz_ptr,
            col_ptr=col_ptr.astype(np.uint16 if C * R <= 65535 else np.int32),
            rows=c.astype(np.uint8 if C <= 256 else np.int16),
            vals=vals, chunk_cols=C, split=split)

    @property
    def shape(self) -> Tuple[int, int, int]:
        """The dense plane's shape: ``(P, planes * C, R)``, or ``(P, R,
        planes * C)`` when ``natural``."""
        P, R1 = self.col_ptr.shape
        CW = (2 if self.split else 1) * self.chunk_cols
        return (P, R1 - 1, CW) if self.natural else (P, CW, R1 - 1)

    @property
    def dtype(self) -> torch.dtype:
        """The dense plane's dtype (bf16 for split planes)."""
        return torch.bfloat16 if self.split else array_dtype(self.vals)

    @property
    def device(self) -> torch.device:
        if isinstance(self.vals, torch.Tensor):
            return self.vals.device
        return torch.device("cpu")

    @property
    def nnz(self) -> int:
        return int(self.pair_nz_ptr[-1]) - int(self.pair_nz_ptr[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the four arrays (the whole entry arrays, also for a
        slice of pairs)."""
        return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                   else x.nbytes for x in (self.pair_nz_ptr, self.col_ptr,
                                           self.rows, self.vals))

    @property
    def wide(self) -> int:
        """The kernels' index widths: bit 0 int32 ``col_ptr``, bit 1
        int16 ``rows``."""
        return (int(_dtype_is(self.col_ptr, np.int32, torch.int32))
                | int(_dtype_is(self.rows, np.int16, torch.int16)) << 1)

    def __getitem__(self, pairs: slice) -> "CompactTiles":
        """Pairs ``[a, b)`` over the same entry arrays."""
        a, b, step = pairs.indices(self.shape[0])
        if step != 1:
            raise ValueError("a compact plane slices only unit-step runs")
        return dataclasses.replace(self, pair_nz_ptr=self.pair_nz_ptr[a:b + 1],
                                   col_ptr=self.col_ptr[a:b])

    def to(self, device) -> "CompactTiles":
        device = torch.device(device)
        return dataclasses.replace(
            self, pair_nz_ptr=_as_torch(self.pair_nz_ptr).to(device),
            col_ptr=_as_torch(self.col_ptr, unsigned16=True).to(device),
            rows=_as_torch(self.rows).to(device),
            vals=_as_torch(self.vals).to(device))

    def to_dense(self):
        """The dense plane of ``shape``, where the arrays lie: a tensor on
        their device, numpy (bf16 as ``uint16`` bits) on the host."""
        host = not isinstance(self.vals, torch.Tensor)
        ptr = _as_torch(self.pair_nz_ptr).long()
        cp = _as_torch(self.col_ptr, unsigned16=True).long()
        if _dtype_is(self.col_ptr, np.uint16, torch.int16):
            cp = cp & 0xFFFF
        P, R = cp.shape[0], cp.shape[1] - 1
        C, dev = self.chunk_cols, ptr.device
        lo, hi = int(ptr[0]), int(ptr[-1])
        pr = torch.repeat_interleave(
            torch.arange(P * R, device=dev), (cp[:, 1:] - cp[:, :-1]).reshape(-1))
        p, r = pr // R, pr % R
        c = _as_torch(self.rows)[lo:hi].long()

        def at(c):  # the dense index of (p, c, r)
            return (p, r, c) if self.natural else (p, c, r)

        vals = _as_torch(self.vals)[lo:hi]
        if self.split:
            v = vals.long()
            out = torch.zeros(self.shape, dtype=torch.int16, device=dev)
            out[at(c)] = _signed16(v)
            out[at(C + c)] = _signed16(v >> 16)
            out = out.view(torch.bfloat16)
        else:
            out = torch.zeros(self.shape, dtype=vals.dtype, device=dev)
            out[at(c)] = vals
        return _host_bits(out) if host else out


#: Widest chunk the compact kernels (B1, B3, B4 bf16, B6) stage
#: (``kCMax`` in ``csrc/windowed_kernels.cu``). A U=2 card copy of a wider
#: chunk keeps its dense natural planes, which the dense kernel reads.
COMPACT_MAX_C = 512


def dense_plane(x):
    """A tile plane as the plain versions read it: a ``CompactTiles``
    densified (``to_dense``), a dense plane as it is."""
    return x.to_dense() if isinstance(x, CompactTiles) else x


def _plane_dtype(x) -> torch.dtype:
    return x.dtype if isinstance(x, CompactTiles) else array_dtype(x)


def _padded_k(k_nominal: int, t: CostTable) -> int:
    """The width the windowed kernels stream for ``k_nominal``: an
    unaligned k of at least ``kpad_min_k`` padded to a multiple of 8."""
    if k_nominal % 8 and k_nominal >= t.kpad_min_k:
        return -(-k_nominal // 8) * 8
    return k_nominal


def _pair_cost_s(R: int, C: int, itemsize: int, k_nominal: int,
                 pairs_per_step: int = 2,
                 cost_table: Optional[CostTable] = None) -> float:
    """Cost of one dense tile: fixed overheads plus tile and
    fat-vector-slab bytes at the measured kernel streaming rate (a table
    that prices dense tiles: the reference's).

    U <= 2 (two-pair kernel, probe14 fit): per-step fixed cost
    ``2*TILE_OVERHEAD_S`` split across the step's two pairs. U > 2
    (transposed kernel, probe17 fit): per-step ``TMULTI_STEP_S`` divided
    by U plus a per-pair issue cost ``TMULTI_PAIR_S`` (scalar-core work
    per dynamic slab fetch + dots — the binding constant for fine
    tiles).

    Sub-sublane ``k_nominal`` >= ``kpad_min_k`` is priced at the padded
    width the kernel actually streams (the k-pad route)."""
    t = cost_table_for(None, cost_table)
    k_eff = _padded_k(k_nominal, t)
    # Tile bytes: R*C*itemsize (f32 ships as two bf16 planes = same
    # bytes; bf16 ships one). Slab bytes scale the same way: bf16 hi|lo
    # lane-packed for f32 data (k*2C*2 = k*C*itemsize), single bf16
    # plane for bf16 data.
    stream = (R * C + C * k_eff) * itemsize / t.tile_stream_bw
    if pairs_per_step > 2:
        return (t.tmulti_step_s / pairs_per_step + t.tmulti_pair_s
                + stream)
    return t.tile_overhead_s * 2 / pairs_per_step + stream


#: How the card's compact kernels (``csrc/windowed_kernels.cu``: B1, B6
#: and B3 / B4 bf16 on their compact planes) split the work: a CTA takes
#: ``K_SLICE`` columns of the padded fat vector (``kCKS``) and ``R_SLICE``
#: output rows (``kCRS``) of one block, walks the block's pairs in turn,
#: and stages a pair's entries in windows of up to ``WINDOW_ENTRIES``
#: (``kCap``), each window with the pair's slab.
K_SLICE, R_SLICE, WINDOW_ENTRIES = 32, 128, 1024


def tile_windows(counts, R: int) -> np.ndarray:
    """The windows a CTA stages for tiles of ``counts`` entries (their
    entries spread over the ``R_SLICE`` row slices of an R-row block)."""
    per_cta = -(-np.asarray(counts, dtype=np.int64)
                // (-(-R // R_SLICE) * WINDOW_ENTRIES))
    return np.maximum(per_cta, 1)


def _compact_shape(R: int, C: int, itemsize: int, k_nominal: int,
                   pairs_per_step: int, t: CostTable):
    """(CTAs a block, row slices, seconds a window, seconds an entry) of
    the card's compact kernel for one tiling and width."""
    k8 = -(-max(_padded_k(k_nominal, t), 1) // 8) * 8
    rs = -(-R // R_SLICE)
    fixed = t.tmulti_pair_s if pairs_per_step > 2 else t.tile_overhead_s
    window = fixed + C * min(k8, K_SLICE) * itemsize / t.tile_stream_bw
    return -(-k8 // K_SLICE) * rs, rs, window, t.entry_s


def compact_kernel_s(block_windows, block_entries, R: int, C: int,
                     itemsize: int, k_nominal: int, pairs_per_step: int,
                     cost_table: CostTable) -> float:
    """Seconds of one launch of the card's compact windowed kernel over
    blocks of ``block_windows`` windows and ``block_entries`` entries: a
    block's CTA costs its windows' staging and its share of the entries;
    the launch takes the larger of all CTAs' work over the ``ctas`` that
    run at once and ``chain_floor`` times the costliest CTA."""
    t = cost_table
    ctas, rs, window, entry = _compact_shape(R, C, itemsize, k_nominal,
                                             pairs_per_step, t)
    cta = (np.asarray(block_windows, dtype=np.float64) * window
           + np.asarray(block_entries, dtype=np.float64) / rs * entry)
    return max(ctas * float(cta.sum()) / t.ctas,
               t.chain_floor * float(cta.max(initial=0.0)))


def _pair_counts(i, j, R: int, C: int, n_chunks: int):
    """Unique (row-block, column-chunk) pairs with nnz counts."""
    key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
    uniq, inverse, counts = np.unique(
        key, return_inverse=True, return_counts=True
    )
    return key, uniq, inverse, counts


def windowed_cost_estimate(i, j, m: int, n: int, R: int, C: int,
                           itemsize: int, k_nominal: int = 32,
                           pairs_per_step: int = 2,
                           allow_spill: bool = True,
                           cost_table: Optional[CostTable] = None):
    """Estimated per-SpMM seconds for tile size (R, C) with the GLOBAL
    optimal dense/spill split, plus the count threshold and tile stats.
    ``allow_spill=False`` forces every nonempty tile dense (spill-free
    builds — e.g. formats that must stay transposed-chain eligible).

    Tiles are sorted by nnz count; the exact total-cost curve over "top
    t tiles dense, rest spills" is minimized:

        total(t) = t * pair_stream_cost + spill_nnz(t) * gather_cost
                   + [spill_nnz(t) > 0] * m * restore_cost + output write

    The fixed m-row spill-restore term means the optimum sometimes lands
    at zero spill (every nonempty tile dense) — a per-tile marginal rule
    can never choose that. Pure host-side numpy (build-time only).

    A table with ``compact_tiles`` (the card) prices the card's compact
    kernels instead (``compact_kernel_s``): summed work over the CTAs
    that run at once, or the costliest block's chain of windows where
    that is longer; the split is chosen on the summed work. The estimate
    is then that of one body of the operand's chain: the kernel alone
    where ``Auto`` chains it in transposed state (U > 2, R = C, a
    multiple of ``R_SLICE``, square, no spill), else plus ``call_s``, the
    chain body's other work (B2, the relayouts, the spill's ops).
    """
    t = cost_table_for(None, cost_table)
    n_chunks = -(-n // C)
    _, uniq, _, counts = _pair_counts(i, j, R, C, n_chunks)
    order = np.argsort(-counts, kind="stable")
    cs = counts[order]
    spill_after = np.concatenate([cs[::-1].cumsum()[::-1], [0]])
    t_axis = np.arange(len(cs) + 1)
    if t.compact_tiles:
        ctas, rs, window, entry = _compact_shape(
            R, C, itemsize, k_nominal, pairs_per_step, t)
        per_tile = tile_windows(cs, R) * window + cs / rs * entry
        work = ctas * np.concatenate([[0], per_tile.cumsum()]) / t.ctas
    else:
        work = t_axis * _pair_cost_s(R, C, itemsize, k_nominal,
                                     pairs_per_step, t)
    totals = (work
              + spill_after * t.gather_s_per_row
              + (spill_after > 0) * m * t.spill_restore_s_per_row)
    best_t = int(np.argmin(totals)) if allow_spill else len(cs)
    est = float(totals[best_t]) + m * k_nominal * 4 / t.hbm_bw
    dense = np.zeros(len(counts), dtype=bool)
    dense[order[:best_t]] = True
    if t.compact_tiles:
        blocks = uniq[dense] // n_chunks
        kernel = compact_kernel_s(
            np.bincount(blocks, weights=tile_windows(counts[dense], R)),
            np.bincount(blocks, weights=counts[dense]), R, C, itemsize,
            k_nominal, pairs_per_step, t)
        est += kernel - float(work[best_t])
        t_chain = (pairs_per_step > 2 and R == C and R % R_SLICE == 0
                   and m == n and best_t == len(cs))
        if not t_chain:
            est += t.call_s
    threshold = float(cs[best_t - 1]) if best_t else np.inf
    return est, threshold, dense, uniq, counts


def build_dense_pairs(i, j, vals, m: int, n: int, R: int, C: int,
                      itemsize: int, k_nominal: int = 32,
                      pairs_per_step: int = 2,
                      cost_table: Optional[CostTable] = None):
    """Identify above-threshold (row-block, column-chunk) tiles and
    materialize them, block-sorted.

    Returns ``(pb_raw, pc_raw, tiles_raw, spill_idx)`` where ``pb_raw``/
    ``pc_raw``/``tiles_raw`` are the P_raw dense tiles in ascending
    (block, chunk) order and ``spill_idx`` indexes the entries of
    ``(i, j, vals)`` that fall below the dense threshold. Shared by
    ``WindowedPairs.from_csr`` (block-run pointers on top) and the
    row-sharded distributed strategy (device-range splitting on top).

    ``(i, j)`` must be duplicate-free (``coalesce_coo``): the dense-tile
    scatter assigns, so a duplicate coordinate would overwrite instead
    of accumulate.
    """
    n_chunks = -(-n // C)
    _, _, dense, uniq, counts = windowed_cost_estimate(
        i, j, m, n, R, C, itemsize, k_nominal, pairs_per_step,
        cost_table=cost_table)

    key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
    pair_of_entry = np.searchsorted(uniq, key)
    dense_ids = np.nonzero(dense)[0]
    remap = np.full(len(uniq), -1, dtype=np.int64)
    remap[dense_ids] = np.arange(len(dense_ids))
    p_entry = remap[pair_of_entry]
    in_dense = p_entry >= 0

    P_raw = len(dense_ids)
    tiles_raw = np.zeros((P_raw, R, C), dtype=vals.dtype)
    tiles_raw[p_entry[in_dense], i[in_dense] % R, j[in_dense] % C] = \
        vals[in_dense]
    pb_raw = (uniq[dense_ids] // n_chunks).astype(np.int64)
    pc_raw = (uniq[dense_ids] % n_chunks).astype(np.int64)
    return pb_raw, pc_raw, tiles_raw, np.nonzero(~in_dense)[0]


def _search_tilings(csr: "CSR", i0, j0, *, block_rows=None,
                    chunk_cols=None, reorder="auto",
                    candidates=DEFAULT_CANDIDATES, k_nominal: int = 32,
                    max_inflation: Optional[float] = None,
                    beat_gather_margin: Optional[float] = None,
                    pairs_per_step: int = 2,
                    gather_baseline_s: Optional[float] = None,
                    allow_spill: bool = True,
                    cost_table: Optional[CostTable] = None):
    """Cost-model search over tile shapes x orderings (host-side numpy),
    priced by ``cost_table`` (default: the reference's).

    Returns the winning ``(est, R, C, perm, i, j, dense, uniq, counts)``
    tuple, or ``None`` when no configuration beats the gather-path
    baseline by ``beat_gather_margin`` (default: the table's), or no
    tile clears the dense threshold — the caller then falls back to a
    gather format.

    ``gather_baseline_s`` is the seconds-per-SpMM the caller's actual
    gather alternative would cost (``ops/auto.py::
    gather_class_estimates``); default is the legacy optimistic
    ``nnz * gather_s_per_row``. The distinction matters on diffuse
    high-m matrices (roadnet class): the legacy baseline is ~4-10x
    rosier than any real gather path there, so the gate refused tilings
    that beat every real alternative by 8x (round-4 TPU sweep: windowed
    9.9 ms vs the COO fallback's 80 ms).
    """
    t = cost_table_for(None, cost_table)
    m, n = csr.shape
    itemsize = np.asarray(csr.values).dtype.itemsize
    # None = default ratio with the small-matrix byte allowance; an
    # explicit caller value is a strict memory bound.
    ratio_cap = 96.0 if max_inflation is None else float(max_inflation)
    allowance = t.dense_bytes_allowance if max_inflation is None else 0

    tile_shapes = []
    for cand in candidates:
        r_c = (cand, 128) if isinstance(cand, int) else tuple(cand)
        r_cand, c_cand = r_c
        if block_rows is not None:
            r_cand = int(block_rows)
        if chunk_cols is not None:
            c_cand = int(chunk_cols)
        if c_cand % 128:
            raise ValueError(
                f"chunk_cols must be a multiple of 128, got {c_cand}")
        if r_cand % 8 or r_cand > max(m, 8):
            continue
        if (r_cand, c_cand) not in tile_shapes:
            tile_shapes.append((r_cand, c_cand))
    if pairs_per_step > 2 and block_rows is None:
        # U>2 formats run the transposed kernel, whose compiled flush
        # DMA needs R % 128 == 0; an auto-searched sub-128 R would
        # silently fall back to the XLA path on hardware. Prefer
        # kernel-eligible shapes, but keep the caller's list when none
        # qualify (tiny matrices / explicit candidate sets — the
        # dispatch falls back correctly). A table that prices the card's
        # compact kernels prices only the tilings they run.
        eligible = [(r, c) for r, c in tile_shapes if r % 128 == 0]
        if eligible or t.compact_tiles:
            tile_shapes = eligible
    if not tile_shapes and block_rows is not None:
        tile_shapes = [(int(block_rows), int(chunk_cols or 128))]

    # Candidate orderings: as-given, plus RCM for square matrices.
    orderings = [(None, i0, j0)]
    if reorder == "auto" and m == n:
        from .reorder import rcm_ordering

        perm = rcm_ordering(csr)
        inv = np.empty(m, dtype=np.int64)
        inv[perm] = np.arange(m)
        orderings.append((perm, inv[i0], inv[j0]))

    gather_est = (gather_baseline_s if gather_baseline_s is not None
                  else csr.nnz * t.gather_s_per_row)
    best = None
    for perm, i, j in orderings:
        for R, C_cand in tile_shapes:
            est, _, dense, uniq, counts = windowed_cost_estimate(
                i, j, m, n, R, C_cand, itemsize, k_nominal,
                pairs_per_step, allow_spill=allow_spill, cost_table=t,
            )
            # Re-price a NONTRIVIAL spill with the calibrated gather
            # surface: the linear 1.6 ns/entry inside the split is a
            # best-case constant, and on mixed band+scatter structure
            # it underestimates the spill's bucketed-ELL cost several-
            # fold (round-5 hardware ladder, results/
            # auto_threshold_tpu.json: windowed measured 8.7 ms where
            # the linear est said 1.9 at band coverage 0.26). The split
            # itself stays linear (its optimum is insensitive at small
            # spill); only the accept/route estimate pays the measured
            # price. 1.6x is the scattered-spill slot inflation under
            # width_align=2 (between uniform 1.37x and dc1 1.84x,
            # results/gather_calib3.json records).
            spill_nnz = int(counts[~dense].sum())
            if spill_nnz > 0.05 * max(csr.nnz, 1):
                from ..ops.auto import _calibrated_gather_seconds

                est += (_calibrated_gather_seconds(
                    "ell", int(spill_nnz * 1.6), m, k_nominal, t)
                    - spill_nnz * t.gather_s_per_row)
            # Spill-majority guard (``spill_frac_refuse``): when the
            # optimal split spills most of the matrix, windowed is the
            # wrong CLASS and the linear spill term misses several-fold.
            # Auto-search only — a caller pinning block_rows (spill-path
            # tests, probes) builds what it asks.
            if (block_rows is None
                    and spill_nnz > t.spill_frac_refuse * max(csr.nnz, 1)):
                continue
            tile_bytes = int(dense.sum()) * R * C_cand * itemsize
            if tile_bytes > t.dense_bytes_hard_cap:
                continue
            if (tile_bytes > ratio_cap * csr.nnz * itemsize
                    and tile_bytes > allowance):
                continue
            if best is None or est < best[0]:
                best = (est, R, C_cand, perm, i, j, dense, uniq, counts)
    if best is None:
        return None
    if beat_gather_margin is None:
        beat_gather_margin = t.beat_gather_margin
    if best[0] > beat_gather_margin * gather_est or not best[6].any():
        return None
    return best


def windowed_wins(csr: "CSR", **search_kwargs) -> bool:
    """Cheap build-time probe: would ``WindowedPairs.from_csr`` return a
    format (i.e. some tiling beats the pure gather path)? Used by the
    Auto strategy's mesh routing to decide windowed vs gather sharding
    without materializing tiles."""
    m, _ = csr.shape
    if m == 0 or csr.nnz == 0:
        return False
    coo = csr.to_coo()
    i0 = np.asarray(coo.row_indices).astype(np.int64)
    j0 = np.asarray(coo.col_indices).astype(np.int64)
    return _search_tilings(csr, i0, j0, **search_kwargs) is not None



@dataclasses.dataclass(frozen=True)
class WindowedPairs:
    """Flat block-ascending list of dense (R, C) tiles plus bucketed-ELL
    spill.

    ``tiles[p, r, c]`` holds the entry at permuted coordinates
    ``(pair_block[p]*R + r, pair_chunk[p]*C + c)``; each row block's
    tiles are one contiguous run ``[block_ptr[b], block_ptr[b+1])``
    (the build inserts a dummy zero tile into empty blocks, and the U>2
    global tail pad belongs to the last block's run). ``perm[k]`` is the
    original index at permuted position ``k``.

    The iterate protocol works in padded permuted space: ``encode``
    maps ``(n, k) -> (pad_rows, k)``, ``iterate`` is
    ``(pad_rows, k) -> (pad_rows, k)`` and ``decode`` slices the tail and
    undoes the permutation.
    """

    #: (P, R, C); None in some card copies, its natural ``CompactTiles``
    #: in a card copy of a bf16 U=2 operand (``to``).
    tiles: Optional[Union[np.ndarray, CompactTiles]]
    pair_chunk: np.ndarray          # (P,) int32
    pair_block: np.ndarray          # (P,) int32, ascending
    block_ptr: np.ndarray           # (nb + 1,) int32 pair run bounds
    #: Lane-packed bf16 hi|lo split of f32 tiles, (P, R, 2C); None for
    #: other dtypes. A card copy of a U=2 operand holds its natural
    #: ``CompactTiles`` instead (``to``).
    tiles_split: Optional[Union[np.ndarray, CompactTiles]]
    spill: Optional[BucketedELL]
    perm: Optional[np.ndarray]      # (m,) int32 or None
    inv_perm: Optional[np.ndarray]  # (m,) int32 or None
    shape: Tuple[int, int]
    block_rows: int
    chunk_cols: int
    est_seconds: float              # cost-model estimate (k=32)
    #: Pairs per step the build padded for: 2 = even per-block runs,
    #: >2 = global tail pad only (the transposed U-pair kernel B1).
    pairs_per_step: int = 2
    #: Transposed planes for B1, built for ``pairs_per_step > 2``:
    #: (P, 2C, R) bf16 hi/lo for f32 data, (P, C, R) otherwise; a card
    #: copy whose kernels read them holds their ``CompactTiles`` instead.
    #: PHASE-major order when ``phases`` is set (``build_phase_layout``):
    #: consumed by B6 with the ``_ph`` id arrays, never with
    #: ``pair_block``/``pair_chunk``.
    tiles_t: Optional[Union[np.ndarray, CompactTiles]] = None
    #: Phase-major layout (``phase_layout=True``, R % 128 == 0 U>2
    #: builds): phase-LOCAL block and chunk ids in ``tiles_t``'s order,
    #: the static per-phase ``(pair_offset, n_pairs, chunk_lo, block_lo,
    #: nb_ph)`` records and the chunk window one phase covers (sized for
    #: ``k_nominal``; a wider runtime k takes the streamed route).
    pair_block_ph: Optional[np.ndarray] = None
    pair_chunk_ph: Optional[np.ndarray] = None
    phases: Optional[tuple] = None
    chunks_per_phase: int = 0
    #: The phased kernels' work list, derived on the host from
    #: ``pair_block_ph`` (``_phase_block_ptr``).
    block_ptr_ph: Optional[np.ndarray] = None

    _ARRAYS = ("tiles", "pair_chunk", "pair_block", "block_ptr",
               "tiles_split", "perm", "inv_perm", "tiles_t",
               "pair_block_ph", "pair_chunk_ph", "block_ptr_ph")

    @property
    def dtype(self) -> torch.dtype:
        """The tiles' dtype (f32 for split planes), from whichever plane
        the copy holds."""
        if self.tiles is not None:
            return _plane_dtype(self.tiles)
        if self.split:
            return torch.float32
        return _plane_dtype(self.tiles_t)

    @property
    def natural_plane(self):
        """The natural plane the two-pair kernels (B3, B4) read:
        ``tiles_split`` of split f32 operands, else ``tiles``; dense, or
        its natural ``CompactTiles`` in a card copy (``to``)."""
        return self.tiles_split if self.split else self.tiles

    @property
    def n_pairs(self) -> int:
        return int(self.pair_block.shape[0])

    @property
    def dense_bytes(self) -> int:
        """Bytes of the dense tile array ``(P, R, C)`` in the operand's
        dtype, as the JAX package counts them, whichever planes this copy
        holds."""
        return (self.n_pairs * self.block_rows * self.chunk_cols
                * self.dtype.itemsize)

    def plain_pairs(self):
        """``(tiles (P, R, C), pair_block, pair_chunk)`` of a copy whose
        arrays are tensors (``to``), where they lie: the operand's own
        block-major pairs, or, in a card copy that holds only the
        kernels' planes, tiles rebuilt from them: exact for one plane;
        hi + lo for split planes, the kernels' precision (within 2**-17
        relative of the f32 tile); a ``CompactTiles`` plane densified
        first. A phase-major ``tiles_t`` comes with its pairs' global
        block and chunk ids; its dummy tiles are zero. The plain path
        multiplies these."""
        C = self.chunk_cols
        if self.tiles is not None:
            return (dense_plane(self.tiles), self.pair_block,
                    self.pair_chunk)
        if self.tiles_t is None:  # U=2 f32: the natural split planes
            t = dense_plane(self.tiles_split)
            return (t[..., :C].to(torch.float32)
                    + t[..., C:].to(torch.float32),
                    self.pair_block, self.pair_chunk)
        t = dense_plane(self.tiles_t)
        if self.split:
            t = t[:, :C].to(torch.float32) + t[:, C:].to(torch.float32)
        t = t.transpose(1, 2)
        if self.phases is None:
            return t, self.pair_block, self.pair_chunk
        counts = torch.tensor([ph[1] for ph in self.phases], device=t.device)
        chunk_lo = torch.tensor([ph[2] for ph in self.phases],
                                device=t.device)
        block_lo = torch.tensor([ph[3] for ph in self.phases],
                                device=t.device)
        return (t, self.pair_block_ph + block_lo.repeat_interleave(counts),
                self.pair_chunk_ph + chunk_lo.repeat_interleave(counts))

    def to_dense(self) -> np.ndarray:
        """The original-order matrix as a host array (test/debug only),
        from a host build or a card copy, read through the host: each
        tile at its (block, chunk), the spill added, the permutation
        undone. The tiles are those of ``plain_pairs``: a copy that holds
        only split planes gives hi + lo; a bf16 operand gives float32
        holding its bf16 values exactly."""
        m, n = self.shape
        R, C = self.block_rows, self.chunk_cols
        tiles, pb, pc = self.to("cpu").plain_pairs()
        if tiles.dtype == torch.bfloat16:
            tiles = tiles.to(torch.float32)
        out = tiles.new_zeros((self.n_blocks, self.n_chunks, R, C))
        out.index_put_((pb.long(), pc.long()), tiles, accumulate=True)
        out = out.transpose(1, 2).reshape(self.n_blocks * R,
                                          self.n_chunks * C)[:m, :n].numpy()
        if self.spill is not None:
            out = out + self.spill.to_dense()
        if self.inv_perm is not None:
            inv = host_values(self.inv_perm)
            out = out[np.ix_(inv, inv)]
        return out

    @property
    def split(self) -> bool:
        """Whether f32 values ride as bf16 hi|lo planes; read from
        ``tiles_t`` where built, since a device copy may drop the natural
        planes (``to``)."""
        if self.tiles_t is not None:
            return self.tiles_t.shape[1] == 2 * self.chunk_cols
        return self.tiles_split is not None

    @property
    def n_blocks(self) -> int:
        return -(-self.shape[0] // self.block_rows)

    @property
    def n_chunks(self) -> int:
        return -(-self.shape[1] // self.chunk_cols)

    @property
    def pad_rows(self) -> int:
        """Row count of the padded permuted space: covers the chunk grid
        (inputs) and the block grid (outputs), a chunk multiple."""
        C = self.chunk_cols
        raw = max(self.n_chunks * C, self.n_blocks * self.block_rows)
        return -(-raw // C) * C

    @property
    def device(self) -> torch.device:
        """Where the arrays live: a torch device after ``to``, the CPU
        while they are host numpy."""
        if isinstance(self.pair_block, torch.Tensor):
            return self.pair_block.device
        return torch.device("cpu")

    def astype(self, dtype) -> "WindowedPairs":
        """The tiles cast to ``dtype`` (torch or numpy) on the host, with
        the planes the kernels read re-derived from them: the bf16 split,
        ``tiles_t``, and the phase layout (a pure function of the
        block-major ids; ``chunks_per_phase`` is kept from the build, and
        a window the new width overflows takes the streamed route)."""
        tiles = cast(self.tiles, dtype)
        split = _split_planes(tiles)
        tiles_t = pb_ph = pc_ph = phases = None
        if self.pairs_per_step > 2:
            if self.phases is not None:
                tiles_t, pb_ph, pc_ph, phases = _phase_fields(
                    tiles, split, self.pair_block, self.pair_chunk,
                    self.n_blocks, self.n_chunks, self.chunks_per_phase,
                    self.pairs_per_step)
            else:
                tiles_t = _tiles_t(tiles, split)
        return dataclasses.replace(
            self, tiles=tiles, tiles_split=split, tiles_t=tiles_t,
            pair_block_ph=pb_ph, pair_chunk_ph=pc_ph, phases=phases,
            block_ptr_ph=_phase_block_ptr(pb_ph, phases),
            spill=None if self.spill is None else self.spill.astype(dtype))

    def card_planes(self) -> "WindowedPairs":
        """This operand with the planes a CUDA copy holds (``to``), still
        on the host: the planes no kernel of its route reads left behind
        as ``None``, the plane its kernels read as its ``CompactTiles``:

        * U>2 with ``R % 128 == 0``: ``tiles_t``'s plane, for B1 and B6;
          ``tiles`` and ``tiles_split`` dropped;
        * U=2 f32: ``tiles_split``'s natural plane, for B3; ``tiles``
          dropped;
        * U=2 bf16: ``tiles``' natural plane, for B4.

        The U=2 planes are compacted only while ``chunk_cols <=
        COMPACT_MAX_C``, the widest chunk the compact kernels stage; a
        wider chunk keeps the dense natural planes, which the dense
        natural kernel reads. A U=2 one-plane f32 operand keeps its dense
        ``tiles`` (B4 f32). The plain path, and ``to_dense``, rebuild the
        tiles from the planes kept (``plain_pairs``)."""
        dropped, compact = (), {}  # compact: field -> natural orientation
        narrow = self.chunk_cols <= COMPACT_MAX_C
        if (self.pairs_per_step > 2 and self.tiles_t is not None
                and self.block_rows % 128 == 0):
            dropped, compact = ("tiles", "tiles_split"), {"tiles_t": False}
        elif self.pairs_per_step <= 2 and self.tiles_split is not None:
            dropped = ("tiles",)
            if narrow:
                compact = {"tiles_split": True}
        elif (self.pairs_per_step <= 2 and narrow
              and self.dtype == torch.bfloat16):
            compact = {"tiles": True}
        fields = dict.fromkeys(dropped)
        for f, natural in compact.items():
            x = getattr(self, f)
            if not isinstance(x, CompactTiles):
                x = (CompactTiles.from_natural if natural
                     else CompactTiles.from_dense)(x, self.split)
            fields[f] = x
        return dataclasses.replace(self, **fields)

    def to(self, device) -> "WindowedPairs":
        """A copy whose arrays are torch tensors on ``device`` (bf16
        planes as ``torch.bfloat16``). A CUDA copy holds ``card_planes``
        (its ``CompactTiles`` built here on the host, once per operand, in
        the phase ``format.card_planes`` of ``utils/profiling.py``).
        The host arrays are left as they are.

        Moving a U=2 operand to a CUDA device audits, on the host arrays,
        the two-pair kernels' contract (pairs ``2s`` and ``2s+1`` share a
        row block), as the reference's dispatch does, and raises when it
        is violated."""
        device = torch.device(device)
        src = self
        if device.type == "cuda":
            pb = self.pair_block
            if self.pairs_per_step <= 2 and isinstance(pb, np.ndarray) and (
                    len(pb) % 2 or np.any(pb[0::2] != pb[1::2])):
                raise ValueError(
                    "two-pair kernel contract violated: per-block pair "
                    "runs must be padded to even length "
                    "(WindowedPairs.from_csr pairs_per_step=2 branch)")
            with phase("format.card_planes"):
                src = self.card_planes()
        fields = {}
        for f in self._ARRAYS:
            x = getattr(src, f)
            fields[f] = (x.to(device) if isinstance(x, CompactTiles)
                         else to_tensor(x, device))
        return dataclasses.replace(
            src,
            spill=None if self.spill is None else self.spill.to(device),
            **fields)

    # ---- padded-permuted-space iteration protocol --------------------
    def encode(self, v: torch.Tensor) -> torch.Tensor:
        """``(n, k) -> (pad_rows, k)`` in the permuted column space, zero
        tail."""
        if self.perm is not None:
            v = v.index_select(0, self.perm)
        pad = self.pad_rows - v.shape[0]
        if pad > 0:
            v = torch.cat([v, v.new_zeros((pad, v.shape[1]))], dim=0)
        return v

    def decode(self, out_p: torch.Tensor) -> torch.Tensor:
        """Slice the pad tail and undo the permutation."""
        out_p = out_p[: self.shape[0]]
        if self.inv_perm is None:
            return out_p
        return out_p.index_select(0, self.inv_perm)

    def iterate(self, v_p: torch.Tensor) -> torch.Tensor:
        """Permuted-space SpMM (the chainable hot body)."""
        from ..ops.windowed import spmm_windowed_core

        return spmm_windowed_core(self, v_p)

    @property
    def supports_transposed_chain(self) -> bool:
        """Whether ``ops/windowed.py::windowed_t_chain`` applies: U-pair
        transposed planes built, square block/chunk grids, no spill."""
        return (self.pairs_per_step > 2
                and self.tiles_t is not None
                and self.spill is None
                and self.block_rows == self.chunk_cols
                and self.n_blocks == self.n_chunks)

    # ---- construction -------------------------------------------------
    @classmethod
    def from_arrays(cls, *, tiles, pair_chunk, pair_block, block_ptr,
                    tiles_split, spill, perm, inv_perm, shape, block_rows,
                    chunk_cols, est_seconds, pairs_per_step=2, tiles_t=None,
                    phases=None, pair_block_ph=None, pair_chunk_ph=None,
                    chunks_per_phase=0) -> "WindowedPairs":
        """An operand from its fields as numpy arrays — e.g. the fields
        of an operand the JAX package built, so both packages run the
        identical operand. bf16 planes may arrive as ml_dtypes
        ``bfloat16`` or as ``uint16`` bits."""
        def opt(x, dtype=None):
            return None if x is None else np.asarray(x, dtype=dtype)

        pb_ph = opt(pair_block_ph, np.int32)
        phases = None if phases is None else tuple(
            tuple(int(x) for x in ph) for ph in phases)
        return cls(
            tiles=_bf16_bits(tiles),
            pair_chunk=np.asarray(pair_chunk, dtype=np.int32),
            pair_block=np.asarray(pair_block, dtype=np.int32),
            block_ptr=np.asarray(block_ptr, dtype=np.int32),
            tiles_split=_bf16_bits(tiles_split),
            spill=_host_bucketed(spill),
            perm=opt(perm), inv_perm=opt(inv_perm),
            shape=(int(shape[0]), int(shape[1])),
            block_rows=int(block_rows), chunk_cols=int(chunk_cols),
            est_seconds=float(est_seconds),
            pairs_per_step=int(pairs_per_step),
            tiles_t=_bf16_bits(tiles_t),
            pair_block_ph=pb_ph,
            pair_chunk_ph=opt(pair_chunk_ph, np.int32),
            phases=phases, chunks_per_phase=int(chunks_per_phase),
            block_ptr_ph=_phase_block_ptr(pb_ph, phases),
        )

    @classmethod
    def from_csr(cls, csr: CSR, *, block_rows: Optional[int] = None,
                 chunk_cols: Optional[int] = None,
                 reorder: str | None = "auto",
                 candidates=DEFAULT_CANDIDATES,
                 k_nominal: int = 32,
                 max_inflation: Optional[float] = None,
                 beat_gather_margin: Optional[float] = None,
                 pairs_per_step: Optional[int] = None,
                 gather_baseline_s: Optional[float] = None,
                 allow_spill: bool = True,
                 phase_layout: bool = False,
                 cost_table: Optional[CostTable] = None,
                 ) -> Optional["WindowedPairs"]:
        """Build windowed storage (the JAX package's builder, same
        arguments, same arrays); returns ``None`` when no tiling beats the
        gather path by ``beat_gather_margin`` (default: the table's).
        ``phase_layout=True`` opts
        a kernel-eligible U>2 build (``R % 128 == 0``) into the
        phase-major layout of kernel B6; off by default, as in the
        reference (measured slower than the block-major kernel on the
        v5e). ``cost_table`` prices the search (default: the reference's
        table; ``ops/auto.py::auto_format`` passes its device's) and
        gives the default ``pairs_per_step``."""
        table = cost_table_for(None, cost_table)
        if pairs_per_step is None:
            pairs_per_step = table.production_pairs_per_step
        if not isinstance(pairs_per_step, int) or pairs_per_step < 2:
            # A value < 2 would skip BOTH padding branches yet still
            # dispatch to the two-pair kernel — the odd-run silent-
            # corruption class.
            raise ValueError(
                f"pairs_per_step must be an int >= 2, got "
                f"{pairs_per_step!r}")
        m, n = csr.shape
        if m == 0 or csr.nnz == 0:
            return None
        itemsize = np.asarray(csr.values).dtype.itemsize

        coo = csr.to_coo()
        i0 = np.asarray(coo.row_indices).astype(np.int64)
        j0 = np.asarray(coo.col_indices).astype(np.int64)
        vals = np.asarray(coo.values)
        from .matrix import coalesce_coo

        i0, j0, vals = coalesce_coo(i0, j0, vals, n)

        best = _search_tilings(
            csr, i0, j0, block_rows=block_rows, chunk_cols=chunk_cols,
            reorder=reorder, candidates=candidates, k_nominal=k_nominal,
            max_inflation=max_inflation,
            beat_gather_margin=beat_gather_margin,
            pairs_per_step=pairs_per_step,
            gather_baseline_s=gather_baseline_s,
            allow_spill=allow_spill, cost_table=table,
        )
        if best is None:
            return None
        est, R, C, perm, i, j, dense, uniq, counts = best

        n_chunks = -(-n // C)
        key = (i // R).astype(np.int64) * n_chunks + (j // C).astype(np.int64)
        # Map each nnz to its pair id (position in the sorted unique keys).
        pair_of_entry = np.searchsorted(uniq, key)
        dense_ids = np.nonzero(dense)[0]
        remap = np.full(len(uniq), -1, dtype=np.int64)
        remap[dense_ids] = np.arange(len(dense_ids))
        p_entry = remap[pair_of_entry]
        in_dense = p_entry >= 0

        # Pairs ascending by (block, chunk) — uniq is sorted.
        pb_raw = (uniq[dense_ids] // n_chunks).astype(np.int64)
        pc_raw = (uniq[dense_ids] % n_chunks).astype(np.int64)
        nb = max(-(-m // R), 1)

        # Final padded layout computed UP FRONT so the (potentially
        # multi-GB) tile array is allocated once and scattered into once
        # — the append-and-resort assembly it replaces made four full
        # copies and dominated build time (cop20k: 23.8 s -> see
        # git history for the measurement). Per block b the final run
        # length f_b adds: a dummy zero tile when the block is empty
        # (coverage guarantee — the Pallas kernels only write blocks
        # they visit), an even-run pad at pairs_per_step == 2 (the
        # two-pair kernel's output BlockSpec forbids a step spanning
        # blocks — measured 22 % faster at +11 % zero-tile pad,
        # probe15), and at pairs_per_step > 2 only a global tail pad on
        # the last block (the U-pair scratch-accumulator kernel lets
        # steps span blocks).
        c_b = np.bincount(pb_raw, minlength=nb)
        f_b = np.where(c_b == 0, 1, c_b)
        if pairs_per_step == 2:
            f_b = f_b + f_b % 2
        tail_pad = int((-f_b.sum()) % pairs_per_step) \
            if pairs_per_step > 2 else 0
        P_final = int(f_b.sum()) + tail_pad
        O_b = np.concatenate([[0], np.cumsum(c_b)[:-1]])
        F_b = np.concatenate([[0], np.cumsum(f_b)[:-1]])
        # Real pair at sorted position q (block b, k-th in block) lands
        # at F_b + k; pads fill [F_b + c_b, F_b + f_b) with zero tiles
        # referencing chunk 0.
        final_of_pair = np.arange(len(pb_raw)) + (F_b - O_b)[pb_raw]
        pair_block = np.repeat(np.arange(nb, dtype=np.int32),
                               f_b.astype(np.int64))
        if tail_pad:
            pair_block = np.concatenate(
                [pair_block, np.full(tail_pad, nb - 1, np.int32)])
        pair_chunk = np.zeros(P_final, dtype=np.int32)
        pair_chunk[final_of_pair] = pc_raw
        tiles = np.zeros((P_final, R, C), dtype=vals.dtype)
        tiles[final_of_pair[p_entry[in_dense]], i[in_dense] % R,
              j[in_dense] % C] = vals[in_dense]

        block_ptr = np.searchsorted(
            pair_block, np.arange(nb + 1)).astype(np.int32)

        spill = None
        if (~in_dense).any():
            from .matrix import COO

            spill_coo = COO.from_arrays(
                vals[~in_dense], i[~in_dense], j[~in_dense], (m, n)
            )
            # Off-tile stragglers are short rows: fine-grained bucket
            # widths cut padded gather rows (gather is per-row-bound;
            # width_align=2 measured 0.14 ms faster than 4 on the cop20k
            # spill, scripts/exp_kernel_probe11.py).
            spill = BucketedELL.from_csr(
                spill_coo.to_csr(), width_align=2, max_buckets=16
            )

        inv_perm = None
        if perm is not None:
            inv_perm = np.empty(m, dtype=np.int32)
            inv_perm[perm] = np.arange(m, dtype=np.int32)
            perm = perm.astype(np.int32)
        split = _split_planes(tiles)
        tiles_t = pb_ph = pc_ph = phases = None
        cpp = 0
        if pairs_per_step > 2:
            if phase_layout and R % 128 == 0:
                cpp = _chunks_per_phase(C, itemsize, k_nominal, table)
                tiles_t, pb_ph, pc_ph, phases = _phase_fields(
                    tiles, split, pair_block, pair_chunk, nb, n_chunks,
                    cpp, pairs_per_step)
            else:
                tiles_t = _tiles_t(tiles, split)
        return cls(
            tiles=tiles, pair_chunk=pair_chunk, pair_block=pair_block,
            block_ptr=block_ptr, tiles_split=split, tiles_t=tiles_t,
            pair_block_ph=pb_ph, pair_chunk_ph=pc_ph, phases=phases,
            chunks_per_phase=cpp,
            block_ptr_ph=_phase_block_ptr(pb_ph, phases),
            spill=spill, perm=perm, inv_perm=inv_perm,
            shape=(m, n), block_rows=R, chunk_cols=C,
            est_seconds=float(est), pairs_per_step=pairs_per_step,
        )

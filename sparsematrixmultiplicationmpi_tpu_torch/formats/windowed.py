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
``WindowedPairs.to`` builds once per operand. The cost constants below are the JAX package's TPU v5e
measurements, carried verbatim so the port routes exactly as the
reference does; an H100 cost table is later work. bf16 host arrays are
``uint16`` bit patterns (``formats/matrix.py::to_tensor``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .matrix import BucketedELL, CSR, ELL, array_dtype, cast, to_tensor

__all__ = ["WindowedPairs", "CompactTiles", "windowed_cost_estimate",
           "windowed_wins",
           "build_dense_pairs", "build_phase_layout", "DEFAULT_CANDIDATES"]

#: Default (R, C) tile-shape candidates for the build-time cost search.
DEFAULT_CANDIDATES = ((64, 256), (128, 256), (256, 256),
                      (128, 512), (256, 512), (512, 512),
                      (64, 128), (128, 128), (256, 128),
                      (8, 128), (16, 128), (32, 128))

#: Measured TPU v5e constants driving the dense/spill split (round-2
#: kernel measurements,
#: scripts/exp_kernel_probe10.py, probe13): XLA row gather ~4.8 ns/row
#: regardless of width; raw elementwise streaming ~819 GB/s. The
#: auto-pipelined Pallas kernel is MXU/overhead-bound, modeled per-pair
#: as a fixed step cost plus tile+slab bytes at an effective rate.
#: Production lane-packed split-bf16 3-pass f32 kernel, fit over the
#: probe14 shape sweep (580.5/926.2 ns at (256,256)/(512,256)):
#: ~191 ns fixed + ~758 GB/s marginal. (Separate hi/lo streams fit
#: 190 ns + 615 GB/s, probe13; the retired 6-pass HIGHEST kernel
#: 114 ns + 455 GB/s, probe10.) ADDITIVE, so small tiles are
#: overhead-bound and the cost model sizes tiles to balance coverage
#: against the fixed cost.
HBM_BW = 819e9
#: Re-measured 2026-08-19 on the round-4 chip/runtime: 1.53-1.57 ns/row
#: in two independent runs (scripts/check_cost_constants.py,
#: results/cost_constants_check.json) vs the round-1 4.8. The cop20k
#: dense/spill split is insensitive to the change (zero spill either
#: way — the fixed m-row restore dominates marginal decisions).
GATHER_S_PER_ROW = 1.6e-9
TILE_OVERHEAD_S = 191e-9
TILE_STREAM_BW = 758e9
#: Kernel generation new builds target: 2 = two-pair kernel with even
#: per-block runs; >2 = transposed U-pair kernel
#: (``ops/pallas_windowed.py::windowed_matmul_tmulti``), global tail pad
#: only. FLIPPED to 16 from real-v5e probe17 (2026-08-19,
#: results/probe17_tmulti.json): (128,128) U=16 measured 1.458 ms on the
#: cop20k stand-in vs 2.754 ms for the shipped U=2 split3 — 1.89x.
#: U=32 regresses (2.18 ms: 32 double-buffered slab streams blow the
#: VMEM budget).
PRODUCTION_PAIRS_PER_STEP = 16
#: tmulti cost-model constants, fit on probe17's U=8/16 points at
#: (128,128) with the streamed-bytes term held at TILE_STREAM_BW
#: (reproduces both measured per-pair costs to 0.1 ns; U=4 is
#: overestimated — harmless, production is 16):
#:   cost/pair = TMULTI_STEP_S/U + TMULTI_PAIR_S + bytes/TILE_STREAM_BW
TMULTI_STEP_S = 77e-9
#: Deliberately NOT refit after the round-5 acc2 adoption: the shipped
#: two-accumulator kernel's marginal pair cost at (128,128) measured
#: ~5-13 ns (probe23 1.292 ms / probe24 1.144 ms, ~11 % chip spread),
#: but this constant is shape-blind and is precisely what keeps the
#: search off fine tiles, whose measured per-pair cost is 185-200 ns
#: (probe18: compute does NOT hide behind the thinner DMA streams
#: there). Lowering it to the (128,128)-only value would re-admit
#: shapes measured 1.4-1.8x slower; the ~10 % absolute overestimate at
#: the production shape is the price of a safe relative ordering.
TMULTI_PAIR_S = 29e-9
#: Per-output-row cost of a nonzero spill: the bucketed-ELL restore take
#: over m rows plus the full-size add (419 us measured at m=121k, k=32 —
#: scripts/exp_kernel_probe13.py ``scat`` — i.e. ~3.5 ns/row; a 23k-row
#: scatter-add alternative measured slower at 573 us).
SPILL_RESTORE_S_PER_ROW = 3.5e-9
#: Auto-search refuses tilings whose optimal split spills more than this
#: fraction of nnz. Measured bracket (round-5 threshold ladder,
#: results/auto_threshold_tpu.json): a 54 %-spill build WINS vs gather
#: (1.47 vs 2.17 ms, rung 0.55) while a 74 %-spill build LOSES 2.1x
#: (8.74 vs 4.08 ms, rung 0.75); every family windowed wins in the
#: round-4 sweep keeps spill <= 22 %. The boundary is placed between
#: the two measured rungs. Callers pinning ``block_rows`` bypass the
#: guard (explicit spill-path tests/probes).
SPILL_FRAC_REFUSE = 0.65
#: Sub-sublane fat vectors (k % 8 != 0) at least this wide are zero-
#: padded to the next sublane multiple and run through the Pallas kernel
#: (Mosaic cannot lower unaligned dots); narrower k takes the XLA path.
#: Consumed by ``ops/windowed.py::spmm_windowed_core`` and the
#: distributed ``_local_windowed`` dispatch; the cost model below prices
#: the padded slab traffic accordingly. Re-tune against
#: scripts/exp_kpad_windowed.py when hardware numbers land.
KPAD_MIN_K = 12
#: Densification memory guards (v5e HBM = 16 GB; U>2 f32 builds hold
#: tiles + tiles_split + tiles_t, so the true host footprint is ~3x
#: the tile array — 2x for bf16/U<=2). Below ``DENSE_BYTES_ALLOWANCE``
#: the DEFAULT ``max_inflation`` RATIO is not enforced — the cost model
#: already prices the streamed bytes, and on tiny-nnz diffuse matrices
#: (roadnet class: 6 MB of nnz) a 197x ratio is a harmless 1.2 GB that
#: measured 8x faster than every gather path. A caller-SUPPLIED
#: ``max_inflation`` is strict (an explicit memory bound must bound
#: memory). ``DENSE_BYTES_HARD_CAP`` always binds (a
#: ratio-passing 100M-nnz build could otherwise OOM).
DENSE_BYTES_ALLOWANCE = 2_000_000_000
DENSE_BYTES_HARD_CAP = 6_000_000_000
#: VMEM budget for one phase's resident fat-vector slab window
#: (``ops/pallas_windowed.py::_kernel_tmulti_resident``). probe18's
#: envelope: a 7 MB window + the double-buffered U=16 tile stream
#: compiled and ran under a 14 MB limit on v5e — the constant-index
#: window block is single-buffered. A v5e budget, kept verbatim so the
#: phase layout and the phased kernel's resident/streamed gate match the
#: reference; on the H100 a window this size stays in the 50 MB L2.
RESIDENT_SLAB_VMEM_BYTES = 7 * 1024 * 1024


def _split_planes(tiles: np.ndarray) -> Optional[np.ndarray]:
    """Lane-packed bf16 ``hi|lo`` split of an f32 tile array — (P, R, 2C)
    ``uint16`` bf16 bits with ``hi`` in columns [:C] and ``lo`` in [C:] —
    or None for other dtypes. Both roundings are torch's
    round-to-nearest-even f32 -> bf16, the same bits as the JAX package's
    native / ml_dtypes split."""
    if tiles.dtype != np.float32:
        return None
    t = torch.from_numpy(np.ascontiguousarray(tiles))
    hi = t.to(torch.bfloat16)
    lo = (t - hi.to(torch.float32)).to(torch.bfloat16)
    out = torch.cat([hi, lo], dim=-1)
    return out.view(torch.int16).numpy().view(np.uint16)


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


def _chunks_per_phase(C: int, itemsize: int, k_nominal: int) -> int:
    """Chunks per resident phase for the VMEM budget: one chunk's slab
    is ``k8 x slab_w`` bf16 (lane-packed hi|lo for f32 data, single
    plane for bf16)."""
    k8 = -(-max(k_nominal, 8) // 8) * 8
    slab_w = 2 * C if itemsize == 4 else C
    return max(int(RESIDENT_SLAB_VMEM_BYTES // (k8 * slab_w * 2)), 1)


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


def _pair_cost_s(R: int, C: int, itemsize: int, k_nominal: int,
                 pairs_per_step: int = 2) -> float:
    """Cost of one dense tile: fixed overheads plus tile and
    fat-vector-slab bytes at the measured kernel streaming rate.

    U <= 2 (two-pair kernel, probe14 fit): per-step fixed cost
    ``2*TILE_OVERHEAD_S`` split across the step's two pairs. U > 2
    (transposed kernel, probe17 fit): per-step ``TMULTI_STEP_S`` divided
    by U plus a per-pair issue cost ``TMULTI_PAIR_S`` (scalar-core work
    per dynamic slab fetch + dots — the binding constant for fine
    tiles).

    Sub-sublane ``k_nominal`` >= ``KPAD_MIN_K`` is priced at the padded
    width the kernel actually streams (the k-pad route)."""
    k_eff = k_nominal
    if k_nominal % 8 and k_nominal >= KPAD_MIN_K:
        k_eff = -(-k_nominal // 8) * 8
    # Tile bytes: R*C*itemsize (f32 ships as two bf16 planes = same
    # bytes; bf16 ships one). Slab bytes scale the same way: bf16 hi|lo
    # lane-packed for f32 data (k*2C*2 = k*C*itemsize), single bf16
    # plane for bf16 data.
    stream = (R * C + C * k_eff) * itemsize / TILE_STREAM_BW
    if pairs_per_step > 2:
        return (TMULTI_STEP_S / pairs_per_step + TMULTI_PAIR_S
                + stream)
    return TILE_OVERHEAD_S * 2 / pairs_per_step + stream


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
                           allow_spill: bool = True):
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
    """
    n_chunks = -(-n // C)
    _, uniq, _, counts = _pair_counts(i, j, R, C, n_chunks)
    pair_cost = _pair_cost_s(R, C, itemsize, k_nominal, pairs_per_step)
    order = np.argsort(-counts, kind="stable")
    cs = counts[order]
    spill_after = np.concatenate([cs[::-1].cumsum()[::-1], [0]])
    t_axis = np.arange(len(cs) + 1)
    totals = (t_axis * pair_cost
              + spill_after * GATHER_S_PER_ROW
              + (spill_after > 0) * m * SPILL_RESTORE_S_PER_ROW)
    best_t = int(np.argmin(totals)) if allow_spill else len(cs)
    est = float(totals[best_t]) + m * k_nominal * 4 / HBM_BW
    dense = np.zeros(len(counts), dtype=bool)
    dense[order[:best_t]] = True
    threshold = float(cs[best_t - 1]) if best_t else np.inf
    return est, threshold, dense, uniq, counts


def build_dense_pairs(i, j, vals, m: int, n: int, R: int, C: int,
                      itemsize: int, k_nominal: int = 32,
                      pairs_per_step: int = 2):
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
        i, j, m, n, R, C, itemsize, k_nominal, pairs_per_step)

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
                    beat_gather_margin: float = 0.8,
                    pairs_per_step: int = 2,
                    gather_baseline_s: Optional[float] = None,
                    allow_spill: bool = True):
    """Cost-model search over tile shapes x orderings (host-side numpy).

    Returns the winning ``(est, R, C, perm, i, j, dense, uniq, counts)``
    tuple, or ``None`` when no configuration beats the gather-path
    baseline by ``beat_gather_margin`` (or no tile clears the dense
    threshold) — the caller then falls back to a gather format.

    ``gather_baseline_s`` is the seconds-per-SpMM the caller's actual
    gather alternative would cost (``ops/auto.py::
    gather_class_estimates``); default is the legacy optimistic
    ``nnz * GATHER_S_PER_ROW``. The distinction matters on diffuse
    high-m matrices (roadnet class): the legacy baseline is ~4-10x
    rosier than any real gather path there, so the gate refused tilings
    that beat every real alternative by 8x (round-4 TPU sweep: windowed
    9.9 ms vs the COO fallback's 80 ms).
    """
    m, n = csr.shape
    itemsize = np.asarray(csr.values).dtype.itemsize
    # None = default ratio with the small-matrix byte allowance; an
    # explicit caller value is a strict memory bound.
    ratio_cap = 96.0 if max_inflation is None else float(max_inflation)
    allowance = DENSE_BYTES_ALLOWANCE if max_inflation is None else 0

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
        # dispatch falls back correctly).
        eligible = [(r, c) for r, c in tile_shapes if r % 128 == 0]
        if eligible:
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
                  else csr.nnz * GATHER_S_PER_ROW)
    best = None
    for perm, i, j in orderings:
        for R, C_cand in tile_shapes:
            est, _, dense, uniq, counts = windowed_cost_estimate(
                i, j, m, n, R, C_cand, itemsize, k_nominal,
                pairs_per_step, allow_spill=allow_spill,
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
                    "ell", int(spill_nnz * 1.6), m, k_nominal)
                    - spill_nnz * GATHER_S_PER_ROW)
            # Spill-majority guard (see SPILL_FRAC_REFUSE): when the
            # optimal split spills most of the matrix, windowed is the
            # wrong CLASS and the linear spill term misses several-fold.
            # Auto-search only — a caller pinning block_rows (spill-path
            # tests, probes) builds what it asks.
            if (block_rows is None
                    and spill_nnz > SPILL_FRAC_REFUSE * max(csr.nnz, 1)):
                continue
            tile_bytes = int(dense.sum()) * R * C_cand * itemsize
            if tile_bytes > DENSE_BYTES_HARD_CAP:
                continue
            if (tile_bytes > ratio_cap * csr.nnz * itemsize
                    and tile_bytes > allowance):
                continue
            if best is None or est < best[0]:
                best = (est, R, C_cand, perm, i, j, dense, uniq, counts)
    if best is None:
        return None
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

    def to(self, device) -> "WindowedPairs":
        """A copy whose arrays are torch tensors on ``device`` (bf16
        planes as ``torch.bfloat16``). A CUDA copy leaves behind, as
        ``None``, the planes no kernel of its route reads, and holds the
        plane its kernels read as its ``CompactTiles`` (built here on the
        host, once per operand):

        * U>2 with ``R % 128 == 0``: ``tiles_t``'s plane, for B1 and B6;
          ``tiles`` and ``tiles_split`` dropped;
        * U=2 f32: ``tiles_split``'s natural plane, for B3; ``tiles``
          dropped;
        * U=2 bf16: ``tiles``' natural plane, for B4.

        The U=2 planes are compacted only while ``chunk_cols <=
        COMPACT_MAX_C``, the widest chunk the compact kernels stage; a
        wider chunk keeps the dense natural planes, which the dense
        natural kernel reads. A U=2 one-plane f32 operand keeps its dense
        ``tiles`` (B4 f32). The plain path rebuilds its tiles from the
        planes kept. The host arrays are left as they are.

        Moving a U=2 operand to a CUDA device audits, on the host arrays,
        the two-pair kernels' contract (pairs ``2s`` and ``2s+1`` share a
        row block), as the reference's dispatch does, and raises when it
        is violated."""
        device = torch.device(device)
        cuda = device.type == "cuda"
        two_pair = cuda and self.pairs_per_step <= 2
        if two_pair:
            pb = self.pair_block
            if isinstance(pb, np.ndarray) and (
                    len(pb) % 2 or np.any(pb[0::2] != pb[1::2])):
                raise ValueError(
                    "two-pair kernel contract violated: per-block pair "
                    "runs must be padded to even length "
                    "(WindowedPairs.from_csr pairs_per_step=2 branch)")
        dropped, compact = (), {}  # compact: field -> natural orientation
        narrow = self.chunk_cols <= COMPACT_MAX_C
        if (cuda and self.pairs_per_step > 2 and self.tiles_t is not None
                and self.block_rows % 128 == 0):
            dropped, compact = ("tiles", "tiles_split"), {"tiles_t": False}
        elif two_pair and self.tiles_split is not None:
            dropped = ("tiles",)
            if narrow:
                compact = {"tiles_split": True}
        elif two_pair and narrow and self.dtype == torch.bfloat16:
            compact = {"tiles": True}
        fields = {}
        for f in self._ARRAYS:
            x = getattr(self, f)
            if f in dropped:
                x = None
            elif f in compact and not isinstance(x, CompactTiles):
                x = (CompactTiles.from_natural if compact[f]
                     else CompactTiles.from_dense)(x, self.split)
            fields[f] = (x.to(device) if isinstance(x, CompactTiles)
                         else to_tensor(x, device))
        return dataclasses.replace(
            self,
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
                 beat_gather_margin: float = 0.8,
                 pairs_per_step: Optional[int] = None,
                 gather_baseline_s: Optional[float] = None,
                 allow_spill: bool = True,
                 phase_layout: bool = False,
                 ) -> Optional["WindowedPairs"]:
        """Build windowed storage (the JAX package's builder, same
        arguments, same arrays); returns ``None`` when no tiling beats the
        gather path by ``beat_gather_margin``. ``phase_layout=True`` opts
        a kernel-eligible U>2 build (``R % 128 == 0``) into the
        phase-major layout of kernel B6; off by default, as in the
        reference (measured slower than the block-major kernel on the
        v5e)."""
        if pairs_per_step is None:
            pairs_per_step = PRODUCTION_PAIRS_PER_STEP
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
            allow_spill=allow_spill,
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
                cpp = _chunks_per_phase(C, itemsize, k_nominal)
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

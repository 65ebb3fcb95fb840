"""Windowed tile-pair storage (PyTorch port of
``sparsematrixmultiplicationmpi_tpu/formats/windowed.py``).

The matrix is cut into ``R x C`` tiles; every tile that holds enough
nonzeros to beat the gather path is stored dense in a flat,
block-ascending pair list (``tiles[p]``, ``pair_block[p]``,
``pair_chunk[p]``), the rest spills to bucketed ELL. SpMM is then
``out[pair_block[p]] += tiles[p] @ v[pair_chunk[p]*C:][:C]``.

Everything here is host-side numpy and bit-identical to the JAX package
on the same input: the cost-model tile search, the RCM ordering choice,
the padded pair layout, the bf16 ``hi|lo`` split planes and the
transposed planes ``tiles_t`` that the Hopper kernel B1
(``ops/cuda_windowed.py::windowed_matmul_tmulti``) streams. The cost
constants below are the JAX package's TPU v5e measurements, carried
verbatim so the port routes exactly as the reference does; an H100 cost
table is later work. bf16 host arrays are ``uint16`` bit patterns
(``formats/matrix.py::to_tensor``).

The phase-major resident layout (``phase_layout=True``, kernel B6) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .matrix import BucketedELL, CSR, ELL, to_tensor

__all__ = ["WindowedPairs", "windowed_cost_estimate", "windowed_wins",
           "build_dense_pairs", "DEFAULT_CANDIDATES"]

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
#: window block is single-buffered.
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
        buckets=tuple(ELL(cols=np.asarray(b.cols), vals=np.asarray(b.vals),
                          shape=tuple(b.shape)) for b in spill.buckets),
        row_perm=np.asarray(spill.row_perm),
        inv_row_perm=np.asarray(spill.inv_row_perm),
        shape=tuple(spill.shape))


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

    tiles: Optional[np.ndarray]     # (P, R, C); None in a card copy (to)
    pair_chunk: np.ndarray          # (P,) int32
    pair_block: np.ndarray          # (P,) int32, ascending
    block_ptr: np.ndarray           # (nb + 1,) int32 pair run bounds
    #: Lane-packed bf16 hi|lo split of f32 tiles, (P, R, 2C); None for
    #: other dtypes.
    tiles_split: Optional[np.ndarray]
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
    #: (P, 2C, R) bf16 hi/lo for f32 data, (P, C, R) otherwise.
    tiles_t: Optional[np.ndarray] = None

    _ARRAYS = ("tiles", "pair_chunk", "pair_block", "block_ptr",
               "tiles_split", "perm", "inv_perm", "tiles_t")

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

    def to(self, device) -> "WindowedPairs":
        """A copy whose arrays are torch tensors on ``device`` (bf16
        planes as ``torch.bfloat16``). On a CUDA device, where the kernels
        read only ``tiles_t`` (U>2, ``R % 128 == 0``), the natural planes
        ``tiles``/``tiles_split`` stay behind as ``None``: the plain path
        rebuilds its tiles from ``tiles_t`` when a route needs them."""
        device = torch.device(device)
        kernel_only = (device.type == "cuda" and self.pairs_per_step > 2
                       and self.tiles_t is not None
                       and self.block_rows % 128 == 0)
        dropped = ("tiles", "tiles_split") if kernel_only else ()
        return dataclasses.replace(
            self,
            spill=None if self.spill is None else self.spill.to(device),
            **{f: None if f in dropped else to_tensor(getattr(self, f),
                                                      device)
               for f in self._ARRAYS})

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
        ``bfloat16`` or as ``uint16`` bits. The phase-major layout
        (``phases``) needs kernel B6, which is not ported."""
        if phases is not None:
            raise NotImplementedError(
                "phase-major windowed layout needs kernel B6 "
                "(_kernel_tmulti_resident), not ported yet")
        def opt(x):
            return None if x is None else np.asarray(x)

        return cls(
            tiles=np.asarray(tiles),
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
        gather path by ``beat_gather_margin``. ``phase_layout=True``
        raises: its kernel (B6) is not ported."""
        if phase_layout:
            raise NotImplementedError(
                "phase_layout=True needs kernel B6 "
                "(_kernel_tmulti_resident), not ported yet")
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
        tiles_t = _tiles_t(tiles, split) if pairs_per_step > 2 else None
        return cls(
            tiles=tiles, pair_chunk=pair_chunk, pair_block=pair_block,
            block_ptr=block_ptr, tiles_split=split, tiles_t=tiles_t,
            spill=spill, perm=perm, inv_perm=inv_perm,
            shape=(m, n), block_rows=R, chunk_cols=C,
            est_seconds=float(est), pairs_per_step=pairs_per_step,
        )

"""The routing cost tables: one ``CostTable`` per device class.

Every constant that decides a format pick or a dispatch route lives in a
``CostTable``: the tile search (``formats/windowed.py``), the band build
(``formats/banded.py``), the gather-class and hub prices and the band
gate (``ops/auto.py``), the spill route (``ops/ell.py``) and the
narrow-k gate (``ops/windowed.py::_takes_kernels``).

* ``V5E`` holds the JAX package's TPU v5e values verbatim. It prices on
  the CPU, so every CPU pick and ``est_seconds`` is the reference's bit
  for bit. Its ``chain_floor`` is zero and its ``ctas`` one: the TPU
  grid runs serially on one core, so per-pair costs add up.
* ``H100`` holds the values measured on an NVIDIA H100 80GB HBM3 by the
  port's probes (``sparsematrixmultiplicationmpi_tpu_torch/scripts/``,
  each writing ``results/h100/<probe>.json``). The card's compact
  kernels read only a tile's stored entries (``compact_tiles``), and run
  one CTA per output block, so a windowed estimate there is the larger
  of the summed work over the CTAs that run at once and the longest
  block chain (``chain_floor``).

Two lookups, for two jobs:

* ``cost_table_for(device, cost_table)`` prices a build: ``cost_table``
  when given, else ``V5E`` for the CPU (or no device), ``H100`` for a
  card whose name says H100, and an error for any other card.
* ``dispatch_table(device)`` holds the gates a multiply reads when it
  runs (``spill_dma_gather``, ``max_kernel_block_rows``, ``kpad_min_k``,
  ``resident_slab_vmem_bytes``): ``V5E`` on a CPU tensor, ``H100`` on a
  CUDA one (or any other off the CPU), whatever table priced the
  operand. They are the limits of
  the port's kernels, which are built for ``sm_90a`` only, so they do
  not change with the card's name or the operand's build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ._gather_calib import GATHER_CALIB_RECORDS
from ._gather_calib_h100 import GATHER_CALIB_RECORDS_H100, GATHER_COEFS_H100

__all__ = ["CostTable", "V5E", "H100", "cost_table_for", "dispatch_table"]


@dataclasses.dataclass(frozen=True)
class CostTable:
    """The constants of one device's cost model (seconds, bytes/s)."""

    name: str
    #: Streaming rate of plain elementwise traffic (output write, band).
    hbm_bw: float
    #: Per spilled entry of a windowed or banded spill.
    gather_s_per_row: float
    #: U <= 2 windowed kernel: fixed cost of one step of two pairs.
    tile_overhead_s: float
    #: Streamed tile and slab bytes of a windowed pair.
    tile_stream_bw: float
    #: Pairs per step new windowed builds target (U).
    production_pairs_per_step: int
    #: U > 2 windowed kernel: fixed cost per step of U pairs.
    tmulti_step_s: float
    #: U > 2 windowed kernel: fixed cost per pair.
    tmulti_pair_s: float
    #: Per output row of a nonzero spill's restore.
    spill_restore_s_per_row: float
    #: The tile search refuses tilings that spill more than this of nnz.
    spill_frac_refuse: float
    #: A windowed build is offered only where its estimate is at most
    #: this times the best gather format's.
    beat_gather_margin: float
    #: Unaligned k at least this wide is padded to a multiple of 8 and
    #: runs the windowed kernels; narrower k takes the plain route.
    kpad_min_k: int
    dense_bytes_allowance: int
    dense_bytes_hard_cap: int
    #: Budget of one phase's resident slab window (phase layout, B6).
    resident_slab_vmem_bytes: int
    #: Linear floors under the calibrated gather surface.
    coo_s_per_nnz: float
    ell_s_per_slot: float
    #: ``(path, m, work, k, seconds)`` gather-route measurements.
    gather_calib_records: tuple
    #: Whether a spill or bucketed operand gathers through kernel B7.
    spill_dma_gather: bool
    #: The widest band the band kernel B5 takes; wider ones take
    #: ``spmm_banded``.
    max_kernel_block_rows: int
    #: The band's streaming rate in the band estimate (through the band
    #: kernel, where ``band_matmul_bw`` is set).
    band_bw: float
    #: The band kernel reads its band once per this many columns of the
    #: fat vector (a CTA's share; 0: once whatever the width).
    band_k_cols: int = 0
    #: The band's rate through the batched matmuls (``spmm_banded``, the
    #: route of a band wider than ``max_kernel_block_rows``); None: as
    #: ``band_bw``.
    band_matmul_bw: Optional[float] = None
    #: ``(("coo", coefs), ("ell", coefs))``: a linear model of the gather
    #: routes over the operand's structure (``ops/auto.py::
    #: gather_features``) in place of the records' surface (None).
    gather_coefs: Optional[tuple] = None
    #: Whether windowed tiles are priced as the card's compact kernels
    #: run them (``formats/windowed.py::compact_kernel_s``: per CTA, its
    #: windows' slab staging at ``tile_stream_bw`` plus ``tmulti_pair_s``
    #: (``tile_overhead_s`` at U = 2) a window, and ``entry_s`` a stored
    #: entry) instead of by their dense bytes (the TPU's serial grid).
    compact_tiles: bool = False
    entry_s: float = 0.0
    #: CTAs of the compact kernels that run at once.
    ctas: float = 1.0
    #: Weight of the costliest CTA's chain: a compact kernel takes at
    #: least ``chain_floor`` times it (zero where the grid is serial).
    chain_floor: float = 0.0
    #: Fixed seconds of one chain body beyond its kernel, on a windowed
    #: route not chained in transposed state and on a band route.
    call_s: float = 0.0
    #: Fixed seconds the hub route adds to its remainder's.
    hub_s: float = 0.0
    #: Fixed seconds a spilled band's route (the band kernel, then the
    #: spill's gather and restore) adds beyond its priced terms.
    band_spill_s: float = 0.0
    #: Fixed seconds a one-shot windowed multiply (``spmm_any``: encode,
    #: body, decode) adds to one body of a chain; priced only for a
    #: caller that multiplies one-shot (``auto_format(one_shot=True)``).
    one_shot_s: float = 0.0


#: The JAX package's TPU v5e model, verbatim (its ``formats/windowed.py``,
#: ``ops/auto.py``, ``ops/_gather_calib.py``, ``ops/ell.py`` and the band
#: gate of its ``spmm_any``), with the reference's provenance.
V5E = CostTable(
    name="v5e",
    # Raw elementwise streaming (probe10, probe13).
    hbm_bw=819e9,
    # XLA row gather, re-measured 1.53-1.57 ns/row (its
    # check_cost_constants.py; round 1 said 4.8).
    gather_s_per_row=1.6e-9,
    # The lane-packed split-bf16 two-pair kernel over probe14's shapes:
    # ~191 ns fixed a step + ~758 GB/s marginal, additive, so small
    # tiles are overhead-bound.
    tile_overhead_s=191e-9,
    tile_stream_bw=758e9,
    # probe17: (128, 128) U = 16 1.458 ms on cop20k against 2.754 ms at
    # U = 2; U = 32 regresses (VMEM).
    production_pairs_per_step=16,
    # probe17's U = 8 / 16 points at (128, 128); the pair cost is kept
    # high on purpose, to keep the search off fine tiles (probe18).
    tmulti_step_s=77e-9,
    tmulti_pair_s=29e-9,
    # The bucketed-ELL restore over m rows plus the add (probe13: 419 us
    # at m = 121k, k = 32).
    spill_restore_s_per_row=3.5e-9,
    # Between a 54 %-spill build that won and a 74 % one that lost 2.1x
    # (its auto_threshold_tpu.json ladder).
    spill_frac_refuse=0.65,
    # A build must beat the gather path by 20 %.
    beat_gather_margin=0.8,
    # Mosaic cannot lower unaligned dots: below 12, the XLA route.
    kpad_min_k=12,
    # Densification guards (host footprint ~3x the tile array).
    dense_bytes_allowance=2_000_000_000,
    dense_bytes_hard_cap=6_000_000_000,
    # probe18: a 7 MB resident window ran under a 14 MB VMEM limit.
    resident_slab_vmem_bytes=7 * 1024 * 1024,
    # The round-2 per-unit gather fit: a floor under the records.
    coo_s_per_nnz=11.5e-9,
    ell_s_per_slot=2.5e-9,
    # Its exp_gather_calib3.py (gather_calib3.json).
    gather_calib_records=GATHER_CALIB_RECORDS,
    # Its DMA gather measured slower than XLA's take (16.0 vs 4.7 ns/row).
    spill_dma_gather=False,
    # Its einsum beat its band kernel from block_rows 256 up.
    max_kernel_block_rows=128,
    # Its band estimate streams the band at hbm_bw.
    band_bw=819e9,
)

#: NVIDIA H100 80GB HBM3 at 700 W. Each value names the probe
#: (``python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.<probe>``)
#: and the file under ``results/h100/`` it came from.
H100 = CostTable(
    name="h100",
    # check_cost_constants: a 1 GiB device copy, bytes read and written
    # over its time (cost_constants_check.json; 90 % of the published
    # 3.35 TB/s).
    hbm_bw=3022036947666.2656,
    # exp_spill_gather: B7's time per spilled entry, the median over the
    # cop20k U = 2 and powerlaw_100k spills at k = 1, 32
    # (spill_gather.json).
    gather_s_per_row=1.9318097329479992e-10,
    # fit_probe17: B3's fixed cost a window; the fit's lower bound
    # (probe17_fit.json).
    tile_overhead_s=0.0,
    # fit_probe17: a window's slab staging, C * min(k8, 32) * 4 bytes at
    # this rate in one CTA (probe17_fit.json).
    tile_stream_bw=8079465228.150127,
    # fit_probe17: the fastest chain body at (128, 128) among U = 4..32;
    # B1's time moves by at most 1.3 % with U (probe17_fit.json).
    production_pairs_per_step=16,
    # fit_probe17: no cost a step or a pair beyond the window's: the
    # card's kernel has no U-pair step (probe17_fit.json, u_spread).
    tmulti_step_s=0.0,
    tmulti_pair_s=0.0,
    # exp_spill_gather: the m-row restore (index_select and add) per
    # output row, the median over the spills (spill_gather.json).
    spill_restore_s_per_row=4.5392338989447727e-10,
    # Not re-measured on the card: the reference's bracket.
    spill_frac_refuse=0.65,
    # No margin: each estimate is a measured chain body, and phase 15 of
    # chip_smoke.py holds the pick to the fastest class measured.
    beat_gather_margin=1.0,
    # exp_kpad_windowed: the padded kernels beat the plain route at every
    # k from 1 (kpad_windowed.json).
    kpad_min_k=1,
    # Host memory guards, the reference's.
    dense_bytes_allowance=2_000_000_000,
    dense_bytes_hard_cap=6_000_000_000,
    # The phase layout's slab budget, the reference's (B6 keeps it).
    resident_slab_vmem_bytes=7 * 1024 * 1024,
    # exp_gather_calib3 --render: the least seconds per nnz of the COO
    # records and per slot of the B7 ones (gather_calib3.json, floors).
    coo_s_per_nnz=3.088879841370328e-11,
    ell_s_per_slot=8.001584956283421e-12,
    # exp_gather_calib3: COO and B7-route bucketed ELL over the results
    # sweep's matrices (gather_calib3.json, formats/_gather_calib_h100.py),
    # and the linear model fit to them that prices the gather routes
    # (exp_gather_calib3 --render).
    gather_calib_records=GATHER_CALIB_RECORDS_H100,
    gather_coefs=GATHER_COEFS_H100,
    # exp_spill_gather: B7 beats the take route on every spill
    # (spill_gather.json).
    spill_dma_gather=True,
    # exp_auto_threshold: the widest block_rows at which B5 beats
    # spmm_banded at k = 1 (auto_threshold.json); B5 takes every width,
    # and beats spmm_banded at each one probed (1 to 128).
    max_kernel_block_rows=128,
    # B5's design: a CTA holds BAND_K_CHUNK = 128 columns of the fat
    # vector and streams its band block once, so a width-k multiply reads
    # the band ceil(k/128) times (ops/cuda_banded.py, passed to
    # csrc/banded_kernels.cu as kc).
    band_k_cols=128,
    # fit_probe17: the compact kernels' CTA model (probe17_fit.json).
    compact_tiles=True,
    entry_s=3.35146343692722e-08,
    ctas=918.706261763201,
    chain_floor=1.0,
    call_s=3.145738202656533e-05,
    # exp_auto_threshold: the rates at which the band estimate gives the
    # measured times of spill-free bands: B5's chain bodies on the CG
    # system at k = 1, 8, 32 (the band read once; beside call_s, so above
    # the copy rate), and spmm_banded's past the gate
    # (auto_threshold.json).
    band_bw=4212681375857.8315,
    band_matmul_bw=1777546465451.2437,
    # exp_hub_dc1: what the hub route adds to its remainder beyond the
    # priced bytes (hub_dc1.json).
    hub_s=2.1645098359274878e-05,
    # exp_auto_threshold: what a spilled band through B5 measures beyond
    # its estimate's other terms, the median over the gate's spilled
    # bands (auto_threshold.json).
    band_spill_s=2.3087655787391544e-05,
    # exp_auto_threshold: a one-shot windowed multiply less its chain
    # body, the median over the CG system and cop20k at k = 1, 8, 32
    # (auto_threshold.json).
    one_shot_s=0.00015074400901794434,
)

def cost_table_for(device=None, cost_table: Optional[CostTable] = None
                   ) -> CostTable:
    """The table that prices a build for ``device``: ``cost_table`` when
    given, else ``V5E`` for the CPU (or no device: a host build priced as
    the reference prices it) and ``H100`` for a CUDA device whose name
    says H100. Any other card raises, naming it."""
    if cost_table is not None:
        return cost_table
    if device is None:
        return V5E
    device = torch.device(device)
    if device.type == "cpu":
        return V5E
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if "H100" in name:
            return H100
        raise ValueError(
            f"no cost table for {name!r}: the port has measured tables for "
            "the NVIDIA H100 only; pass cost_table= (e.g. formats.cost.H100 "
            "or V5E) to price work on this card")
    raise ValueError(f"no cost table for a {device.type} device")


def dispatch_table(device) -> CostTable:
    """The table whose gates route a multiply on ``device``: ``V5E`` on
    the CPU (the reference's routing), ``H100`` off it (the port's
    kernels' limits). Reads the device's type only."""
    return V5E if torch.device(device).type == "cpu" else H100

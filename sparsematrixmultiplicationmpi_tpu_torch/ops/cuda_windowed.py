"""Hopper kernels of the windowed SpMM and their plain PyTorch versions
(counterpart of ``sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py``).

Five kernels from ``csrc/windowed_kernels.cu``:

* **B1** ``windowed_matmul_tmulti`` — the transposed-state U-pair
  contraction (``_kernel_tmulti`` on the TPU): slabs in, ``(nb, k8, R)``
  f32 out, or the next chain state ``(nb, k8, 2R)`` bf16 ``[hi | lo]``
  with ``fuse_resplit``. The kernel reads the tiles' nonzeros only, a
  ``CompactTiles`` plane (``formats/windowed.py``).
* **B2** ``chunk_slabs`` — the per-iterate relayout ``(pad_rows, k) ->
  (n_chunks, k, C)``, with ``split`` the bf16 ``[hi | lo]`` planes
  ``(n_chunks, k, 2C)``.
* **B3** ``windowed_matmul_split3`` — the natural-layout split3
  contraction of U=2 f32 formats (``_kernel_split3``): ``(nb, R, k8)``.
* **B4** ``windowed_matmul_single`` — the same contraction on one plane,
  bf16 or f32 at full precision (``_kernel_plain``, wrapper
  ``windowed_matmul_pallas``).
* **B6** ``windowed_matmul_tmulti_phased`` — B1's contraction over a
  phase-major pair list (``_kernel_tmulti_resident``), per-phase partials
  added in phase order; B1 on each phase's slices when the window
  overflows the reference's budget (the streamed route). Same compact
  tile operand as B1.

Each wrapper takes its plain version (``*_plain``, same module) for a
tensor on the CPU and launches its kernel for a CUDA tensor — there is no
fallback from one to the other — and counts its kernel launches in
``<wrapper>.launches``. The plain versions mirror the JAX package on
dense tiles (a ``CompactTiles`` operand on the CPU is densified first).
On the card B1 and B6 take only the compact plane of ``tiles_t``; B3 and
B4 bf16 dispatch on their plane's type: a natural ``CompactTiles`` goes
to the compact kernel (``C <= COMPACT_MAX_C``, 512, the widest chunk it
stages), a dense plane to the dense natural kernel, which takes only a
wider chunk (``WindowedPairs.to`` keeps such chunks dense); a dense plane
of a narrower chunk raises. B4 f32 reads dense f32 tiles.
``spmm_windowed_cuda`` is the JAX package's ``spmm_windowed_pallas``:
one-shot SpMM through B2 then B1, B6, B3 or B4.
"""

from __future__ import annotations

import functools
import itertools

import torch

from ..formats.cost import dispatch_table
from ..formats.windowed import (
    COMPACT_MAX_C, CompactTiles, WindowedPairs, dense_plane,
)
from ._kernel_lib import check_launch, load_library

__all__ = ["chunk_slabs", "chunk_slabs_plain", "windowed_matmul_tmulti",
           "windowed_matmul_tmulti_plain", "resplit_slabs",
           "windowed_matmul_split3", "windowed_matmul_split3_plain",
           "windowed_matmul_single", "windowed_matmul_single_plain",
           "windowed_matmul_tmulti_phased",
           "windowed_matmul_tmulti_phased_plain",
           "spmm_windowed_cuda", "launch_counts", "reset_launch_counts"]


def _on_kernel_device(x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor
    (kernel); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"no kernel for a tensor on {x.device}: CPU tensors take the "
            "plain version, CUDA tensors the kernel")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---- B2: chunk_slabs --------------------------------------------------

def resplit_slabs(x32: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 ``[hi | lo]`` along the last axis, ``hi = rn(x)`` and
    ``lo = rn(x - hi)`` (round-to-nearest-even both times): the next
    chain state from a ``(nb, k8, R)`` B1 output (what ``fuse_resplit``
    writes directly), and B2's split."""
    hi = x32.to(torch.bfloat16)
    lo = (x32 - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=-1)


def chunk_slabs_plain(v_pad: torch.Tensor, *, C: int,
                      split: bool) -> torch.Tensor:
    """Plain version of B2 on any device."""
    n_chunks = v_pad.shape[0] // C
    t = v_pad.reshape(n_chunks, C, v_pad.shape[1]).transpose(1, 2)
    if split:
        return resplit_slabs(t.to(torch.float32))
    return t.contiguous()


def chunk_slabs(v_pad: torch.Tensor, *, C: int,
                split: bool) -> torch.Tensor:
    """Per-iterate fat-vector relayout ``(pad_rows, k) -> (n_chunks, k,
    C)``; with ``split`` (f32 input) one bf16 ``[hi | lo]`` array
    ``(n_chunks, k, 2C)``, otherwise ``v_pad``'s dtype."""
    if not _on_kernel_device(v_pad):
        return chunk_slabs_plain(v_pad, C=C, split=split)
    pad_rows, k = v_pad.shape
    _require(v_pad.is_contiguous(), "chunk_slabs needs a contiguous input")
    _require(pad_rows % C == 0 and C % 128 == 0,
             f"chunk_slabs: pad_rows {pad_rows} must be a multiple of C "
             f"{C}, and C a multiple of 128")
    if split:
        _require(v_pad.dtype == torch.float32,
                 f"chunk_slabs split=True needs float32, got {v_pad.dtype}")
        mode, out_dtype, w = 0, torch.bfloat16, 2 * C
    else:
        _require(v_pad.dtype in (torch.float32, torch.bfloat16),
                 f"chunk_slabs kernel takes float32 or bfloat16, got "
                 f"{v_pad.dtype}")
        mode = 1 if v_pad.dtype == torch.float32 else 2
        out_dtype, w = v_pad.dtype, C
    n_chunks = pad_rows // C
    out = torch.empty((n_chunks, k, w), dtype=out_dtype, device=v_pad.device)
    if out.numel():
        err = load_library().chunk_slabs_launch(
            v_pad.data_ptr(), out.data_ptr(), n_chunks, C, k, mode,
            _stream(v_pad))
        check_launch("chunk_slabs", err)
        chunk_slabs.launches += 1
    return out


chunk_slabs.launches = 0


# ---- B1: windowed_matmul_tmulti -------------------------------------

def _tmulti_checks(pair_block, tiles_t, slabs, *, pairs_per_step, split,
                   fuse_resplit):
    """The JAX wrapper's contract checks; returns (C, R, k8)."""
    U = pairs_per_step
    P, C2, R = tiles_t.shape
    C = C2 // 2 if split else C2
    k8 = slabs.shape[1]
    _require(P % U == 0,
             f"pair count {P} not a multiple of pairs_per_step {U}")
    _require(split or tiles_t.dtype != torch.float32,
             "tmulti split=False requires bf16 operands; f32 tiles must use "
             "the sublane-packed hi/lo split planes (split=True)")
    _require(k8 % 8 == 0, f"slab row dim {k8} must be a sublane multiple")
    slab_w = 2 * C if split else C
    _require(slabs.shape[2] == slab_w,
             f"slab width {slabs.shape[2]} != expected {slab_w} "
             f"(split={split})")
    _require(not fuse_resplit or k8 % 16 == 0,
             f"fuse_resplit requires k8 % 16 == 0, got k8={k8}")
    _require(pair_block.shape[0] == P, "pair_block length != tile count")
    return C, R, k8


def windowed_matmul_tmulti_plain(pair_block, pair_chunk, tiles_t, slabs, *,
                                 nb: int, split: bool = True,
                                 fuse_resplit: bool = False):
    """Plain version of B1 on any device: gather each pair's slab, three
    batched matmuls (split3) or one in f32 (f64 for f64 planes), then a
    segment-sum over the block-sorted pairs."""
    P, C2, R = tiles_t.shape
    C = C2 // 2 if split else C2
    acc = torch.promote_types(torch.float32, tiles_t.dtype)
    sl = slabs.index_select(0, pair_chunk).to(acc)
    t = tiles_t.to(acc)
    if split:
        prods = (torch.bmm(sl[..., :C], t[:, :C])
                 + torch.bmm(sl[..., :C], t[:, C:])
                 + torch.bmm(sl[..., C:], t[:, :C]))
    else:
        prods = torch.bmm(sl, t)
    out = prods.new_zeros((nb, slabs.shape[1], R))
    out.index_add_(0, pair_block, prods)
    if fuse_resplit:
        return resplit_slabs(out) if split else out.to(torch.bfloat16)
    return out


def _compact_operand(name, tiles_t, slabs, *, C, R, k8, split,
                     natural=False) -> tuple:
    """A compact kernel's tile operand as its launch arguments (the four
    arrays' data pointers and the index widths), checked: a
    ``CompactTiles`` on the slabs' CUDA device, in the kernel's
    orientation (``natural`` for B3 / B4 bf16, else B1 / B6's
    ``tiles_t``), bf16. A dense plane there raises: the kernels read the
    compact plane, which ``WindowedPairs.to`` builds once per operand, and
    nothing compacts per call. The plane's arrays are checked once, when
    a plane first reaches a kernel; the arguments are kept on it."""
    if not isinstance(tiles_t, CompactTiles):
        what, how = (("natural plane", "from_natural") if natural
                     else ("tiles_t", "from_dense"))
        raise ValueError(
            f"no kernel for a dense {what} on {slabs.device}: {name} reads "
            f"the compact plane (CompactTiles.{how}, which "
            "WindowedPairs.to builds once per operand)")
    _on_kernel_device(slabs)
    cached = tiles_t.__dict__.get("_kernel_args")  # frozen: no setattr
    if cached is None or cached[0] != slabs.device:
        arrays = (tiles_t.pair_nz_ptr, tiles_t.col_ptr, tiles_t.rows,
                  tiles_t.vals)
        _require(all(x.device == slabs.device and x.is_contiguous()
                     for x in arrays),
                 f"{name} kernel: the compact plane must lie on "
                 f"{slabs.device}, contiguous")
        cached = (slabs.device, *(x.data_ptr() for x in arrays),
                  tiles_t.wide)
        tiles_t.__dict__["_kernel_args"] = cached
    _require(tiles_t.split == split and tiles_t.natural == natural
             and tiles_t.dtype == torch.bfloat16,
             f"{name} kernel: a compact plane with split={tiles_t.split}, "
             f"natural={tiles_t.natural}, {tiles_t.dtype} given split="
             f"{split}; the kernel reads a bf16 plane with natural="
             f"{natural}")
    _require(slabs.dtype == torch.bfloat16 and slabs.is_contiguous()
             and slabs.data_ptr() % 16 == 0,
             f"{name} kernel: slabs must be a contiguous, 16-byte aligned "
             f"bf16 tensor, got {slabs.dtype}")
    _require(C % 128 == 0 and C <= COMPACT_MAX_C and R % 8 == 0
             and k8 % 8 == 0,
             f"{name} kernel needs C % 128 == 0, C <= {COMPACT_MAX_C}, "
             f"R % 8 == 0 and k8 % 8 == 0, got C={C}, R={R}, k8={k8}")
    return cached[1:]


def _int32_on(name, dev, **arrays) -> None:
    for arg, x in arrays.items():
        _require(x.device == dev and x.dtype == torch.int32
                 and x.is_contiguous(),
                 f"{name} kernel: {arg} must be a contiguous int32 tensor on "
                 f"{dev}, got {x.dtype} on {x.device}")


def windowed_matmul_tmulti(pair_block, pair_chunk, block_ptr, tiles_t,
                           slabs, *, nb: int, pairs_per_step: int = 8,
                           split: bool = True, fuse_resplit: bool = False):
    """Fused contraction in transposed state: slabs in, ``(nb, k8, R)``
    f32 out — or, with ``fuse_resplit``, the next chain state
    ``(nb, k8, 2R)`` bf16 ``[hi | lo]`` (``(nb, k8, R)`` bf16 when not
    split).

    ``tiles_t``: (P, 2C, R) bf16 hi/lo planes with ``split``, else
    (P, C, R), dense (plain version, CPU) or as its ``CompactTiles``
    (the kernel on CUDA; densified on the CPU). Pairs block-ascending,
    every block present, ``P % pairs_per_step == 0``; ``block_ptr``
    (nb + 1) bounds each block's pair run (the kernel's work list).
    ``slabs``: (n_chunks, k8, 2C) bf16 from ``chunk_slabs(split=True)``,
    or (n_chunks, k8, C)."""
    C, R, k8 = _tmulti_checks(pair_block, tiles_t, slabs,
                              pairs_per_step=pairs_per_step, split=split,
                              fuse_resplit=fuse_resplit)
    if slabs.device.type == "cpu":
        return windowed_matmul_tmulti_plain(
            pair_block, pair_chunk, dense_plane(tiles_t), slabs, nb=nb,
            split=split, fuse_resplit=fuse_resplit)
    plane = _compact_operand("windowed_matmul_tmulti", tiles_t, slabs, C=C,
                             R=R, k8=k8, split=split)
    dev = slabs.device
    _int32_on("windowed_matmul_tmulti", dev, pair_chunk=pair_chunk,
              block_ptr=block_ptr)
    _require(block_ptr.shape[0] == nb + 1, "block_ptr length != nb + 1")
    if fuse_resplit and not split:
        # The one-plane chain state is a bf16 cast of the f32 result (the
        # kernel's fused epilogue writes the split [hi | lo] state).
        return windowed_matmul_tmulti(
            pair_block, pair_chunk, block_ptr, tiles_t, slabs, nb=nb,
            pairs_per_step=pairs_per_step, split=False).to(torch.bfloat16)
    if fuse_resplit:
        out = torch.empty((nb, k8, 2 * R), dtype=torch.bfloat16, device=dev)
    else:
        out = torch.empty((nb, k8, R), dtype=torch.float32, device=dev)
    if out.numel():
        err = load_library().tmulti_launch(
            block_ptr.data_ptr(), pair_chunk.data_ptr(), *plane,
            slabs.data_ptr(), out.data_ptr(), nb, C, R, k8, int(split),
            int(fuse_resplit), _stream(slabs))
        check_launch("windowed_matmul_tmulti", err)
        windowed_matmul_tmulti.launches += 1
    return out


windowed_matmul_tmulti.launches = 0


# ---- B6: windowed_matmul_tmulti_phased ----------------------------------

def _combine_phases(parts, phases, nb: int) -> torch.Tensor:
    """``(nb, k8, R)``: each phase's ``(nb_ph, k8, R)`` partial added at
    its ``block_lo``, in phase order (the reference's pad-and-add, same
    order); blocks no phase touches stay zero."""
    out = parts[0].new_zeros((nb,) + tuple(parts[0].shape[1:]))
    for part, (_, _, _, block_lo, nb_ph) in zip(parts, phases):
        out[block_lo:block_lo + nb_ph] += part
    return out


def windowed_matmul_tmulti_phased_plain(pair_block_ph, pair_chunk_ph,
                                        tiles_t, slabs, *, nb: int,
                                        phases, split: bool = True):
    """Plain version of B6 on any device: B1's plain version on each
    phase's slices (its pairs, its chunk window of ``slabs``), the
    partials added in phase order."""
    parts = []
    for off, n, chunk_lo, _, nb_ph in phases:
        parts.append(windowed_matmul_tmulti_plain(
            pair_block_ph[off:off + n], pair_chunk_ph[off:off + n],
            tiles_t[off:off + n], slabs[chunk_lo:], nb=nb_ph, split=split))
    return _combine_phases(parts, phases, nb)


@functools.lru_cache(maxsize=64)
def _phase_table(phases: tuple, device: torch.device) -> torch.Tensor:
    """B6's per-phase rows ``(pair_off, chunk_lo, first partial, offset
    of the run bounds in block_ptr_ph)``, int32 on ``device``; built once
    per layout and device."""
    rows, first, bp_off = [], 0, 0
    for off, _, chunk_lo, _, nb_ph in phases:
        rows.append((off, chunk_lo, first, bp_off))
        first += nb_ph
        bp_off += nb_ph + 1
    return torch.tensor(rows, dtype=torch.int32, device=device)


def windowed_matmul_tmulti_phased(pair_block_ph, pair_chunk_ph, block_ptr_ph,
                                  tiles_t, slabs, *, nb: int, phases,
                                  chunks_per_phase: int,
                                  pairs_per_step: int = 16,
                                  split: bool = True,
                                  force_streamed: bool = False):
    """Phased transposed contraction: slabs in, ``(nb, k8, R)`` f32 out.

    The pair list is phase-major (``formats/windowed.py::
    build_phase_layout``): per phase ``(pair_off, n_pairs, chunk_lo,
    block_lo, nb_ph)``, phase-local block and chunk ids
    (``pair_block_ph``, ``pair_chunk_ph``), run bounds ``block_ptr_ph``
    (``nb_ph + 1`` per phase, relative to ``pair_off``). ``tiles_t`` is
    dense (plain version, CPU) or its ``CompactTiles`` (the kernels).
    Resident route: one B6 launch writes every phase's block-range
    partial, in phase order; streamed route (``force_streamed``, or a
    chunk window past the dispatch table's ``resident_slab_vmem_bytes`` at
    this ``k8``, the gate the reference computes): one B1 launch per
    phase on its slices. The partials are added in phase order either
    way."""
    _, C2, R = tiles_t.shape
    C = C2 // 2 if split else C2
    k8 = slabs.shape[1]
    _require(k8 % 8 == 0, f"slab row dim {k8} must be a sublane multiple")
    _require(split or tiles_t.dtype != torch.float32,
             "phased tmulti split=False requires bf16 operands")
    slab_w = 2 * C if split else C
    _require(slabs.shape[2] == slab_w,
             f"slab width {slabs.shape[2]} != expected {slab_w} "
             f"(split={split})")
    if slabs.device.type == "cpu":
        return windowed_matmul_tmulti_phased_plain(
            pair_block_ph, pair_chunk_ph, dense_plane(tiles_t), slabs, nb=nb,
            phases=phases, split=split)
    plane = _compact_operand("windowed_matmul_tmulti_phased", tiles_t,
                             slabs, C=C, R=R, k8=k8, split=split)
    window_bytes = (min(chunks_per_phase, slabs.shape[0]) * k8 * slab_w
                    * slabs.element_size())
    budget = dispatch_table(slabs.device).resident_slab_vmem_bytes
    if force_streamed or window_bytes > budget:
        parts, bp_off = [], 0
        for off, n, chunk_lo, _, nb_ph in phases:
            parts.append(windowed_matmul_tmulti(
                pair_block_ph[off:off + n], pair_chunk_ph[off:off + n],
                block_ptr_ph[bp_off:bp_off + nb_ph + 1], tiles_t[off:off + n],
                slabs[chunk_lo:], nb=nb_ph, pairs_per_step=pairs_per_step,
                split=split))
            bp_off += nb_ph + 1
        return _combine_phases(parts, phases, nb)
    dev = slabs.device
    _int32_on("windowed_matmul_tmulti_phased", dev,
              pair_chunk_ph=pair_chunk_ph, block_ptr_ph=block_ptr_ph)
    _require(block_ptr_ph.shape[0] == sum(ph[4] + 1 for ph in phases),
             "block_ptr_ph length != sum of nb_ph + 1 over the phases")
    table = _phase_table(tuple(phases), dev)
    n_partials = sum(ph[4] for ph in phases)
    partials = torch.empty((n_partials, k8, R), dtype=torch.float32,
                           device=dev)
    if partials.numel():
        err = load_library().tmulti_phased_launch(
            table.data_ptr(), len(phases), block_ptr_ph.data_ptr(),
            pair_chunk_ph.data_ptr(), *plane, slabs.data_ptr(),
            partials.data_ptr(), n_partials, C, R, k8, int(split),
            _stream(slabs))
        check_launch("windowed_matmul_tmulti_phased", err)
        windowed_matmul_tmulti_phased.launches += 1
    firsts = [0, *itertools.accumulate(ph[4] for ph in phases)]
    return _combine_phases(
        [partials[a:b] for a, b in zip(firsts, firsts[1:])], phases, nb)


windowed_matmul_tmulti_phased.launches = 0


# ---- B3 / B4: natural-layout two-pair contractions ----------------------

def _natural_checks(name, pair_block, tiles, slabs, *, planes: int):
    """The JAX wrappers' contract checks; returns (R, C, k8). ``tiles``
    dense or its natural ``CompactTiles``."""
    P, R, CW = tiles.shape
    C = CW // planes
    _require(P % 2 == 0,
             f"{name} requires an even pair count, got {P}; pad per-block "
             "runs to even length (WindowedPairs.from_csr pairs_per_step=2 "
             "branch)")
    _require(pair_block.shape[0] == P, "pair_block length != tile count")
    _require(slabs.shape[2] == CW,
             f"slab width {slabs.shape[2]} != tile width {CW}")
    return R, C, slabs.shape[1]


def _natural_compact(wrapper, pair_chunk, block_ptr, tiles, slabs, *, nb, R,
                     C, k8, split: bool) -> torch.Tensor:
    """B3 / B4 bf16 on the card, on the natural compact plane ``tiles``,
    counted in ``wrapper.launches``."""
    name = wrapper.__name__
    plane = _compact_operand(name, tiles, slabs, C=C, R=R, k8=k8,
                             split=split, natural=True)
    dev = slabs.device
    _int32_on(name, dev, pair_chunk=pair_chunk, block_ptr=block_ptr)
    _require(block_ptr.shape[0] == nb + 1, "block_ptr length != nb + 1")
    out = torch.empty((nb, R, k8), dtype=torch.float32, device=dev)
    if out.numel():
        err = load_library().natural_compact_launch(
            block_ptr.data_ptr(), pair_chunk.data_ptr(), *plane,
            slabs.data_ptr(), out.data_ptr(), nb, C, R, k8, int(split),
            _stream(slabs))
        check_launch(name, err)
        wrapper.launches += 1
    return out


def _natural_launch(wrapper, pair_chunk, block_ptr, tiles, slabs, *, nb, R,
                    C, k8, mode: int, dtype: torch.dtype) -> torch.Tensor:
    """The dense natural kernels on the card for ``wrapper`` (B3 / B4
    bf16 past ``COMPACT_MAX_C``, B4 f32), counted in its ``launches``."""
    name = wrapper.__name__
    dev = slabs.device
    _require(mode == 2 or C > COMPACT_MAX_C,
             f"no kernel for a dense natural plane with C={C} on {dev}: "
             f"{name} reads the compact plane (CompactTiles.from_natural, "
             f"which WindowedPairs.to builds once per operand) while C <= "
             f"{COMPACT_MAX_C}")
    for arg, x, dt in (("tiles", tiles, dtype), ("slabs", slabs, dtype),
                       ("pair_chunk", pair_chunk, torch.int32),
                       ("block_ptr", block_ptr, torch.int32)):
        _require(x.device == dev and x.dtype == dt and x.is_contiguous(),
                 f"{name} kernel: {arg} must be a contiguous {dt} tensor on "
                 f"{dev}, got {x.dtype} on {x.device}")
    _require(block_ptr.shape[0] == nb + 1, "block_ptr length != nb + 1")
    _require(C % 128 == 0 and R % 8 == 0 and k8 % 8 == 0,
             f"{name} kernel needs C % 128 == 0, R % 8 == 0 and k8 % 8 == 0, "
             f"got C={C}, R={R}, k8={k8}")
    _require(tiles.data_ptr() % 16 == 0 and slabs.data_ptr() % 16 == 0,
             "tiles and slabs must be 16-byte aligned")
    out = torch.empty((nb, R, k8), dtype=torch.float32, device=dev)
    if out.numel():
        err = load_library().natural_launch(
            block_ptr.data_ptr(), pair_chunk.data_ptr(), tiles.data_ptr(),
            slabs.data_ptr(), out.data_ptr(), nb, C, R, k8, mode,
            _stream(slabs))
        check_launch(name, err)
        wrapper.launches += 1
    return out


def windowed_matmul_split3_plain(pair_block, pair_chunk, tiles_split, slabs,
                                 *, nb: int) -> torch.Tensor:
    """Plain version of B3 on any device: gather each pair's slab, three
    batched f32 matmuls ``th.sh + tl.sh + th.sl``, block segment-sum."""
    C = tiles_split.shape[2] // 2
    sl = slabs.index_select(0, pair_chunk).to(torch.float32).transpose(1, 2)
    t = tiles_split.to(torch.float32)
    prods = (torch.bmm(t[..., :C], sl[:, :C]) + torch.bmm(t[..., C:], sl[:, :C])
             + torch.bmm(t[..., :C], sl[:, C:]))
    out = prods.new_zeros((nb,) + tuple(prods.shape[1:]))
    return out.index_add_(0, pair_block, prods)


def windowed_matmul_split3(pair_block, pair_chunk, block_ptr, tiles_split,
                           slabs, *, nb: int) -> torch.Tensor:
    """Natural-layout split3 contraction, ``(nb, R, k8)`` f32 (the JAX
    package's ``windowed_matmul_split3``, which runs ``chunk_slabs``
    itself; here the caller passes its ``split=True`` slabs).

    ``tiles_split``: (P, R, 2C) bf16 ``[hi | lo]``, block-sorted with
    even per-block runs (``P`` even, checked): on the card its natural
    ``CompactTiles`` (the compact kernel, ``C <= COMPACT_MAX_C``) or,
    for a wider chunk, dense (the dense kernel); dense or compact on the
    CPU (densified). ``block_ptr`` (nb + 1) bounds each block's run (the
    kernel's work list); ``slabs``: (n_chunks, k8, 2C) bf16 from
    ``chunk_slabs(split=True)``."""
    R, C, k8 = _natural_checks("windowed_matmul_split3", pair_block,
                               tiles_split, slabs, planes=2)
    if not _on_kernel_device(slabs):
        return windowed_matmul_split3_plain(
            pair_block, pair_chunk, dense_plane(tiles_split), slabs, nb=nb)
    if isinstance(tiles_split, CompactTiles):
        return _natural_compact(windowed_matmul_split3, pair_chunk,
                                block_ptr, tiles_split, slabs, nb=nb, R=R,
                                C=C, k8=k8, split=True)
    return _natural_launch(windowed_matmul_split3, pair_chunk, block_ptr,
                           tiles_split, slabs, nb=nb, R=R, C=C, k8=k8,
                           mode=0, dtype=torch.bfloat16)


windowed_matmul_split3.launches = 0


def windowed_matmul_single_plain(pair_block, pair_chunk, tiles, slabs, *,
                                 nb: int) -> torch.Tensor:
    """Plain version of B4 on any device: slabs cast to the tiles' dtype,
    one batched matmul in f32 (f64 for f64 tiles), block segment-sum."""
    acc = torch.promote_types(torch.float32, tiles.dtype)
    sl = slabs.to(tiles.dtype).index_select(0, pair_chunk).to(acc)
    prods = torch.bmm(tiles.to(acc), sl.transpose(1, 2))
    out = prods.new_zeros((nb,) + tuple(prods.shape[1:]))
    return out.index_add_(0, pair_block, prods)


def windowed_matmul_single(pair_block, pair_chunk, block_ptr, tiles, slabs,
                           *, nb: int) -> torch.Tensor:
    """Natural-layout one-plane contraction, ``(nb, R, k8)`` f32: the JAX
    package's ``windowed_matmul_pallas`` (kernel ``_kernel_plain``), with
    the caller's ``chunk_slabs(split=False)`` slabs. f32 tiles run at
    full f32 precision, bf16 tiles with f32 accumulation; the slabs are
    cast to the tiles' dtype first, as the reference does (the kernel
    takes them already cast). ``tiles``: (P, R, C), even per-block runs
    (``P`` even, checked); on the card bf16 tiles are their natural
    ``CompactTiles`` (the compact kernel, ``C <= COMPACT_MAX_C``) or,
    for a wider chunk, dense (the dense kernel), f32 tiles dense;
    ``slabs``: (n_chunks, k8, C)."""
    R, C, k8 = _natural_checks("windowed_matmul_single", pair_block, tiles,
                               slabs, planes=1)
    if not _on_kernel_device(slabs):
        return windowed_matmul_single_plain(
            pair_block, pair_chunk, dense_plane(tiles), slabs, nb=nb)
    if isinstance(tiles, CompactTiles):
        return _natural_compact(windowed_matmul_single, pair_chunk,
                                block_ptr, tiles, slabs, nb=nb, R=R, C=C,
                                k8=k8, split=False)
    _require(tiles.dtype in (torch.float32, torch.bfloat16),
             f"windowed_matmul_single kernel takes float32 or bfloat16 "
             f"tiles, got {tiles.dtype}")
    return _natural_launch(windowed_matmul_single, pair_chunk, block_ptr,
                           tiles, slabs, nb=nb, R=R, C=C, k8=k8,
                           mode=2 if tiles.dtype == torch.float32 else 1,
                           dtype=tiles.dtype)


windowed_matmul_single.launches = 0

_COUNTED = {"B1": windowed_matmul_tmulti, "B2": chunk_slabs,
            "B3": windowed_matmul_split3, "B4": windowed_matmul_single,
            "B6": windowed_matmul_tmulti_phased}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


# ---- one-shot SpMM (spmm_windowed_pallas) ---------------------------

def spmm_windowed_cuda(wp: WindowedPairs,
                       v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM through the kernels: ``(pad_rows, k) ->
    (pad_rows, k)``, ``k % 8 == 0``. U>2 formats (routed here with
    transposed planes and ``R % 128 == 0``, the reference's gates): B2
    then B1, or B6 on a phase layout. U=2 formats: B2 then B3 for split
    f32 planes, else B2 then B4 on ``v`` cast to the tiles' dtype. The
    spill, if any, is restored by ``_finish``."""
    from .windowed import _finish

    R, C = wp.block_rows, wp.chunk_cols
    nb = wp.n_blocks
    k = v_p.shape[1]
    split = wp.split
    if wp.pairs_per_step <= 2:
        tiles = wp.natural_plane
        if split:
            slabs = chunk_slabs(v_p.to(torch.float32).contiguous(), C=C,
                                split=True)
            computed = windowed_matmul_split3(
                wp.pair_block, wp.pair_chunk, wp.block_ptr, tiles, slabs,
                nb=nb)
        else:
            slabs = chunk_slabs(v_p.to(tiles.dtype).contiguous(), C=C,
                                split=False)
            computed = windowed_matmul_single(
                wp.pair_block, wp.pair_chunk, wp.block_ptr, tiles, slabs,
                nb=nb)
        return _finish(wp, computed.reshape(nb * R, k), v_p)
    slab_dtype = torch.float32 if split else wp.tiles_t.dtype
    slabs = chunk_slabs(v_p.to(slab_dtype).contiguous(), C=C, split=split)
    if wp.phases is not None:
        out_t = windowed_matmul_tmulti_phased(
            wp.pair_block_ph, wp.pair_chunk_ph, wp.block_ptr_ph, wp.tiles_t,
            slabs, nb=nb, phases=wp.phases,
            chunks_per_phase=wp.chunks_per_phase,
            pairs_per_step=wp.pairs_per_step, split=split)
    else:
        out_t = windowed_matmul_tmulti(
            wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
            nb=nb, pairs_per_step=wp.pairs_per_step, split=split)
    computed = out_t.transpose(1, 2).reshape(nb * R, k)
    return _finish(wp, computed, v_p)

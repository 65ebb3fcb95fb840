"""Hopper kernels of the windowed SpMM and their plain PyTorch versions
(counterpart of ``sparsematrixmultiplicationmpi_tpu/ops/pallas_windowed.py``).

Two kernels from ``csrc/windowed_kernels.cu`` carry the main path:

* **B1** ``windowed_matmul_tmulti`` — the transposed-state U-pair
  contraction (``_kernel_tmulti`` on the TPU): slabs in, ``(nb, k8, R)``
  f32 out, or the next chain state ``(nb, k8, 2R)`` bf16 ``[hi | lo]``
  with ``fuse_resplit``.
* **B2** ``chunk_slabs`` — the per-iterate relayout ``(pad_rows, k) ->
  (n_chunks, k, C)``, with ``split`` the bf16 ``[hi | lo]`` planes
  ``(n_chunks, k, 2C)``.

Each wrapper takes its plain version (``*_plain``, same module) for a
tensor on the CPU and launches its kernel for a CUDA tensor — there is no
fallback from one to the other — and counts its kernel launches in
``<wrapper>.launches``. ``spmm_windowed_cuda`` is the U>2 branch of the
JAX package's ``spmm_windowed_pallas``: one-shot SpMM through B2 then B1.
"""

from __future__ import annotations

import torch

from ..formats.windowed import WindowedPairs
from ._kernel_lib import check_launch, load_library

__all__ = ["chunk_slabs", "chunk_slabs_plain", "windowed_matmul_tmulti",
           "windowed_matmul_tmulti_plain", "resplit_slabs",
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


def windowed_matmul_tmulti(pair_block, pair_chunk, block_ptr, tiles_t,
                           slabs, *, nb: int, pairs_per_step: int = 8,
                           split: bool = True, fuse_resplit: bool = False):
    """Fused contraction in transposed state: slabs in, ``(nb, k8, R)``
    f32 out — or, with ``fuse_resplit``, the next chain state
    ``(nb, k8, 2R)`` bf16 ``[hi | lo]`` (``(nb, k8, R)`` bf16 when not
    split).

    ``tiles_t``: (P, 2C, R) bf16 hi/lo planes with ``split``, else
    (P, C, R). Pairs block-ascending, every block present,
    ``P % pairs_per_step == 0``; ``block_ptr`` (nb + 1) bounds each
    block's pair run (the kernel's work list). ``slabs``: (n_chunks, k8,
    2C) bf16 from ``chunk_slabs(split=True)``, or (n_chunks, k8, C)."""
    C, R, k8 = _tmulti_checks(pair_block, tiles_t, slabs,
                              pairs_per_step=pairs_per_step, split=split,
                              fuse_resplit=fuse_resplit)
    if not _on_kernel_device(slabs):
        return windowed_matmul_tmulti_plain(
            pair_block, pair_chunk, tiles_t, slabs, nb=nb, split=split,
            fuse_resplit=fuse_resplit)
    dev = slabs.device
    for name, x, dt in (("tiles_t", tiles_t, torch.bfloat16),
                        ("slabs", slabs, torch.bfloat16),
                        ("pair_chunk", pair_chunk, torch.int32),
                        ("block_ptr", block_ptr, torch.int32)):
        _require(x.device == dev and x.dtype == dt and x.is_contiguous(),
                 f"windowed_matmul_tmulti kernel: {name} must be a "
                 f"contiguous {dt} tensor on {dev}, got {x.dtype} on "
                 f"{x.device}")
    _require(block_ptr.shape[0] == nb + 1, "block_ptr length != nb + 1")
    _require(C % 128 == 0 and R % 8 == 0,
             f"windowed_matmul_tmulti kernel needs C % 128 == 0 and "
             f"R % 8 == 0, got C={C}, R={R}")
    _require(tiles_t.data_ptr() % 16 == 0, "tiles_t must be 16-byte aligned")
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
            block_ptr.data_ptr(), pair_chunk.data_ptr(), tiles_t.data_ptr(),
            slabs.data_ptr(), out.data_ptr(), nb, C, R, k8, int(split),
            int(fuse_resplit), _stream(slabs))
        check_launch("windowed_matmul_tmulti", err)
        windowed_matmul_tmulti.launches += 1
    return out


windowed_matmul_tmulti.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {"B1": windowed_matmul_tmulti.launches,
            "B2": chunk_slabs.launches}


def reset_launch_counts() -> None:
    windowed_matmul_tmulti.launches = 0
    chunk_slabs.launches = 0


# ---- one-shot SpMM (U>2 branch of spmm_windowed_pallas) -------------

def spmm_windowed_cuda(wp: WindowedPairs,
                       v_p: torch.Tensor) -> torch.Tensor:
    """Padded-permuted-space SpMM through B2 then B1: ``(pad_rows, k) ->
    (pad_rows, k)``, ``k % 8 == 0``. The caller routes here only for U>2
    formats with transposed planes and ``R % 128 == 0`` (the reference's
    kernel gates); the spill, if any, is restored by ``_finish``."""
    from .windowed import _finish

    R = wp.block_rows
    nb = wp.n_blocks
    k = v_p.shape[1]
    split = wp.split
    slab_dtype = torch.float32 if split else wp.tiles_t.dtype
    slabs = chunk_slabs(v_p.to(slab_dtype).contiguous(), C=wp.chunk_cols,
                        split=split)
    out_t = windowed_matmul_tmulti(
        wp.pair_block, wp.pair_chunk, wp.block_ptr, wp.tiles_t, slabs,
        nb=nb, pairs_per_step=wp.pairs_per_step, split=split)
    computed = out_t.transpose(1, 2).reshape(nb * R, k)
    return _finish(wp, computed, v_p)

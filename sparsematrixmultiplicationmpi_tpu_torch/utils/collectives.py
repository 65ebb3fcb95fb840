"""Counted collectives (counterpart of
``sparsematrixmultiplicationmpi_tpu/utils/collectives.py``).

The JAX package audits the collectives XLA inserts by reading compiled
HLO (``collective_stats``). Here the strategies issue every collective
themselves, through the wrappers below, which are the only place they
touch ``torch.distributed``; each wrapper counts what it issued. The
counter has the shape of the JAX audit: ``{kind: (count, bytes)}`` with
the HLO op names as kinds and, as bytes, the size of what the collective
delivers to this rank (its per-shard output):

* ``all_gather`` (tiled along an axis) -> ``"all-gather"``;
* ``psum`` (``all_reduce``) -> ``"all-reduce"``;
* ``psum_scatter`` (``reduce_scatter_tensor``, tiled on rows) ->
  ``"reduce-scatter"``;
* ``ppermute`` (one ``batch_isend_irecv`` for several permutes) ->
  ``"collective-permute"``, one per permute this rank sends or receives
  in.

On a mesh without a process group (one device) the wrappers return their
input and count nothing: nothing was issued. No gradient flows through
them: the distributed SpMM's backward is itself a distributed forward
(``ops/autodiff.py::make_distributed_symmetric_spmm``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_gather", "psum", "psum_scatter", "ppermute",
           "collective_stats", "reset_collective_stats", "COLLECTIVE_OPS"]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "collective-permute")

_STATS: Dict[str, List[int]] = {}

# The tiled collectives under their newer names where this torch has them
# (the older ones warn there), else under the older.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def collective_stats() -> Dict[str, Tuple[int, int]]:
    """``{kind: (count, bytes)}`` issued by this rank since the last
    reset."""
    return {kind: (c, b) for kind, (c, b) in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def _count(kind: str, nbytes: int) -> None:
    c = _STATS.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _group(mesh, axis: Optional[str]):
    """(group, size) of ``axis`` (None: the 1-D mesh's one axis)."""
    if axis is None:
        if len(mesh.shape) != 1:
            raise ValueError(f"name the axis of a {len(mesh.shape)}-D mesh")
        return mesh.group, mesh.size
    k = mesh.axis_names.index(axis)
    return mesh.axis_groups[k], mesh.shape[k]


def all_gather(x: torch.Tensor, mesh, *, axis: int = 0,
               mesh_axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``axis`` in
    rank order (``jax.lax.all_gather(..., tiled=True)``)."""
    group, size = _group(mesh, mesh_axis)
    if group is None:
        return x
    x = x.movedim(axis, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    _count("all-gather", _nbytes(out))
    if axis == 0:
        return out
    # rank r's block, (n_axis, ...) with the gathered axis first, moved
    # back in place and concatenated along it
    parts = out.reshape((size,) + tuple(x.shape)).movedim(1, axis + 1)
    return torch.cat(list(parts), dim=axis)


def psum(x: torch.Tensor, mesh, *,
         mesh_axis: Optional[str] = None) -> torch.Tensor:
    """Sum of every rank's ``x`` on every rank (``jax.lax.psum``)."""
    group, _ = _group(mesh, mesh_axis)
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    _count("all-reduce", _nbytes(out))
    return out


def psum_scatter(x: torch.Tensor, mesh, *,
                 mesh_axis: Optional[str] = None) -> torch.Tensor:
    """Sum over ranks, rows split evenly: rank ``r`` gets rows ``[r * n /
    p, (r + 1) * n / p)`` (``jax.lax.psum_scatter(..., tiled=True)``)."""
    group, size = _group(mesh, mesh_axis)
    if group is None:
        return x
    if x.shape[0] % size:
        raise ValueError(f"psum_scatter of {x.shape[0]} rows over {size} "
                         "ranks: pad the rows to a multiple first")
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x.contiguous(), group=group)
    _count("reduce-scatter", _nbytes(out))
    return out


def ppermute(mesh, transfers: Sequence[tuple]) -> list:
    """Several point-to-point permutes in one ``batch_isend_irecv``.

    Each transfer is ``(send, dst, recv_like, src)``: this rank sends
    ``send`` to rank ``dst`` and receives a tensor shaped like
    ``recv_like`` from rank ``src``; a ``dst`` or ``src`` of None skips
    that side (a mesh edge). Returns the received tensors (None where
    nothing was received). Transfers are tagged by position, so two
    permutes between the same pair of ranks (the two neighbours of a
    2-rank mesh) cannot cross."""
    ops, received = [], []
    group = mesh.group
    for tag, (send, dst, recv_like, src) in enumerate(transfers):
        buf = None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), dst,
                                  group=group, tag=tag))
        if src is not None:
            buf = torch.empty_like(recv_like,
                                   memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, buf, src, group=group,
                                  tag=tag))
        if dst is not None or src is not None:
            _count("collective-permute", 0 if buf is None else _nbytes(buf))
        received.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received

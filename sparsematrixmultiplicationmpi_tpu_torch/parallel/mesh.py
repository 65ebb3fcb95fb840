"""Process-group meshes, the framework's "communicator" (port of
``sparsematrixmultiplicationmpi_tpu/parallel/mesh.py``).

The reference's process model is an MPI communicator sized by ``mpirun
-np``; the JAX package's is a ``jax.sharding.Mesh`` of devices. Here it
is a ``torch.distributed`` process group, one process per rank: NCCL
with rank ``r`` on ``cuda:<local rank>`` on the card, gloo when the
caller asks for the CPU. ``initialize_distributed`` is the
``MPI_Init`` analog; ``make_mesh`` wraps the initialized group.

Every strategy takes a ``Mesh``. A ``torch.device`` (or ``"cpu"`` /
``"cuda"``) passed in its place is the one-device mesh with no process
group (``as_mesh``): its collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "initialize_distributed",
           "as_mesh", "AXIS"]

#: Canonical 1-D partitioning axis name (kept for parity with the JAX
#: package's strategies, which name their mesh axis).
AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D or 2-D mesh of processes.

    ``group`` spans every rank (None on the one-device mesh); ``shape``
    is ``(p,)`` or ``(p_rows, p_cols)`` with this rank at ``coords``
    (row-major: rank ``i * p_cols + j``). A 2-D mesh also holds, for
    this rank, ``axis_groups``: the group along the rows axis (the ranks
    of its mesh column, which a collective over ``"rows"`` spans) and
    the group along the columns axis (the ranks of its mesh row)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    shape: Tuple[int, ...] = (1,)
    coords: Tuple[int, ...] = (0,)
    axis_groups: Tuple[Optional[object], ...] = (None,)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (AXIS,) if len(self.shape) == 1 else ("rows", "cols")


def as_mesh(mesh_or_device) -> Mesh:
    """A ``Mesh`` as it is; a device (or ``"cpu"`` / ``"cuda"``) as the
    one-device mesh with no process group."""
    if isinstance(mesh_or_device, Mesh):
        return mesh_or_device
    return Mesh(group=None, rank=0, size=1,
                device=torch.device(mesh_or_device))


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for {device}")


def _local_device(device, rank: int) -> torch.device:
    """The rank's device: ``cuda:<local rank>`` on the card (raising when
    there are fewer cards than the local rank needs), the CPU when
    asked."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs CUDA, and "
                           "torch.cuda.is_available() is False")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise ValueError(f"rank {rank} needs cuda:{local}, have "
                         f"{torch.cuda.device_count()} devices")
    return torch.device("cuda", local)


def initialize_distributed(*, rank: int, world_size: int,
                           init_method: str, device="cuda") -> None:
    """Join the process group (``MPI_Init`` analog): NCCL for
    ``device="cuda"`` (this rank's card made current), gloo for
    ``"cpu"``. ``init_method`` is a ``tcp://host:port`` or
    ``file://path`` rendezvous. No-op when already initialized."""
    if dist.is_initialized():
        return
    dev = _local_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend_for(dev), init_method=init_method,
                            rank=rank, world_size=world_size)


def _check_group(n: int, device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs CUDA, and "
                           "torch.cuda.is_available() is False")
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"requested {n} devices, have "
                         f"{torch.cuda.device_count()}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "in each rank first")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"requested {n} ranks, the process group has "
                         f"{world}")
    want = _backend_for(device)
    if dist.get_backend() != want:
        raise ValueError(f"a mesh on {device.type} needs the {want} "
                         f"backend, the process group runs "
                         f"{dist.get_backend()}")
    return _local_device(device, dist.get_rank())


def make_mesh(n_devices: Optional[int] = None, *, device="cuda") -> Mesh:
    """1-D mesh over the initialized process group (``n_devices`` ranks,
    default all): rank ``r`` on ``cuda:<local rank>``, or on the CPU
    when ``device="cpu"`` (gloo). More ranks than cards raises."""
    n = dist.get_world_size() if (
        n_devices is None and dist.is_initialized()) else (n_devices or 1)
    dev = _check_group(n, device)
    rank = dist.get_rank()
    return Mesh(group=dist.group.WORLD, rank=rank, size=n, device=dev,
                shape=(n,), coords=(rank,),
                axis_groups=(dist.group.WORLD,))


def make_mesh_2d(n_row: int, n_col: int, *, device="cuda") -> Mesh:
    """2-D ``n_row x n_col`` mesh for the rows x k decomposition
    (``Grid2D``), its axis groups built with ``dist.new_group`` (every
    rank creates every group, in one order)."""
    dev = _check_group(n_row * n_col, device)
    rank = dist.get_rank()
    i, j = divmod(rank, n_col)
    rows_axis = cols_axis = None
    for c in range(n_col):  # the ranks of mesh column c
        g = dist.new_group([r * n_col + c for r in range(n_row)])
        if c == j:
            rows_axis = g
    for r in range(n_row):  # the ranks of mesh row r
        g = dist.new_group([r * n_col + c for c in range(n_col)])
        if r == i:
            cols_axis = g
    return Mesh(group=dist.group.WORLD, rank=rank, size=n_row * n_col,
                device=dev, shape=(n_row, n_col), coords=(i, j),
                axis_groups=(rows_axis, cols_axis))

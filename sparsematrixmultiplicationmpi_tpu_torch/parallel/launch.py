"""Run a function on every rank of a fresh process group (the ``mpirun
-np`` analog; the JAX package runs its meshes in one process).

``run_ranks(fn, n, *args, device=...)`` spawns ``n`` processes (start
method ``spawn``: a forked child could inherit a parent's runtime
threads, JAX's included), joins each to a group through a ``file://``
rendezvous in a private temporary directory (no port to collide on),
builds its 1-D mesh and returns the ranks' ``fn(mesh, *args)`` in rank
order. ``fn`` must be importable by name from the child (a module-level
function). Tensors in a result come back as numpy arrays. A rank that
raises fails the call with its traceback, and every rank still running
is stopped.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch

__all__ = ["run_ranks"]


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world_size, init_method, device, fn, args, results):
    import torch.distributed as dist

    from .mesh import initialize_distributed, make_mesh

    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize_distributed(rank=rank, world_size=world_size,
                               init_method=init_method, device=device)
        mesh = make_mesh(world_size, device=device)
        results.put((rank, True, _to_host(fn(mesh, *args))))
    except Exception:  # reported: the parent raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device="cuda",
              timeout: float = 600.0) -> list:
    """``[fn(mesh_r, *args) for r in range(world_size)]``, each on its
    own spawned rank of a ``world_size`` group (NCCL for ``"cuda"``,
    gloo for ``"cpu"``)."""
    ctx = mp.get_context("spawn")
    out = [None] * world_size
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, init, str(device), fn, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            reported = set()
            while len(reported) < world_size:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in reported and p.exitcode is not None]
                    if dead:  # died before reporting (e.g. at start-up)
                        raise RuntimeError(
                            f"rank {dead[0]} of {world_size} exited with "
                            f"code {procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{fn.__name__} on {world_size} ranks did not "
                            f"finish in {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{val}")
                out[rank] = val
                reported.add(rank)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return out

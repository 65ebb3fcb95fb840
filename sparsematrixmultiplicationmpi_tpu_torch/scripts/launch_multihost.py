"""Multi-process launcher for ``spmm-torch`` (port of the JAX package's
``scripts/launch_multihost.py``): the ``mpirun`` analog.

One process per card, each joined to one process group. Under
``torchrun`` the process identity comes from its environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``):

    torchrun --nproc-per-node 4 -m \
        sparsematrixmultiplicationmpi_tpu_torch.scripts.launch_multihost \
        -- run synthetic:cop20k --k 32 --strategy windowed_row

and by hand, one command per process, the flags override it:

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.launch_multihost \
        --coordinator 10.0.0.2:29500 --num-processes 4 --process-id $ID \
        -- run synthetic:cop20k --k 32

The process joins with ``parallel/mesh.py::initialize_distributed``
(NCCL on the card, ``LOCAL_RANK``'s card made current; gloo with
``--device cpu``), prints ``[launch] process i/n``, and runs the command
line after ``--`` through ``cli.main``, whose mesh then spans every
process; ``run`` and ``sweep`` get the launcher's ``--device`` unless
they name one.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from . import _common

__all__ = ["main"]


def _forwarded(cli_args, device: str) -> list:
    args = list(cli_args)
    if args and args[0] == "--":
        args = args[1:]
    if args and args[0] in ("run", "sweep") and "--device" not in args:
        args += ["--device", device]
    return args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="launch_multihost", description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: MASTER_ADDR and "
                         "MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="default: WORLD_SIZE")
    ap.add_argument("--process-id", type=int, default=None,
                    help="default: RANK")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="NCCL on the card (default) or gloo on the CPU")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="arguments for the spmm-torch command line "
                         "(after --)")
    args = ap.parse_args(argv)
    err = _common.device_error(args.device)
    if err:
        return _common.refuse("launch_multihost", err)
    env = os.environ
    coordinator = args.coordinator or (
        f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if "MASTER_ADDR" in env and "MASTER_PORT" in env else None)
    if coordinator is None:
        return _common.refuse(
            "launch_multihost", "no coordinator: pass --coordinator "
            "host:port or set MASTER_ADDR and MASTER_PORT (torchrun does)")
    world = (args.num_processes if args.num_processes is not None
             else int(env.get("WORLD_SIZE", 1)))
    rank = (args.process_id if args.process_id is not None
            else int(env.get("RANK", 0)))

    import torch.distributed as dist

    from ..cli import main as cli_main
    from ..parallel.mesh import initialize_distributed

    initialize_distributed(rank=rank, world_size=world,
                           init_method=f"tcp://{coordinator}",
                           device=args.device)
    try:
        local = torch.cuda.device_count() if args.device == "cuda" else 1
        print(f"[launch] process {rank}/{world}: {local} local / {world} "
              f"global devices (backend {dist.get_backend()})", flush=True)
        return cli_main(_forwarded(args.cli_args, args.device))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

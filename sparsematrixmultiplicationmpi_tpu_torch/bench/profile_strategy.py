"""Where a distributed strategy's multiply spends its time on one card,
by ``torch.profiler``.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.profile_strategy \
        [--strategy windowed|banded|column|row] [--sharded]

Joins a one-rank NCCL group (``initialize_distributed`` on a free local
port), prepares the strategy's operand through it (``windowed``:
``WindowedRowWise()`` on the cop20k_A stand-in at k = 32; ``column`` and
``row`` the same matrix; ``banded``: ``BandedRowWise(k_nominal=8)`` on
the CG system at k = 8), then runs 50 back-to-back multiplies, result
gathered (``--sharded``: left sharded), three times, as
``profile_chain.py`` runs chain bodies: on the host clock (ms per
multiply, waiting for the device), on the host clock without waiting
(the host's own issue time per multiply), and under ``torch.profiler``
(each kernel's device time, NCCL's included, and the share of the
profiled window in which the device was busy). Prints the profiler's
table, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ..bench.systems import spd_banded_system
from ..io.generate import cop20k_like, generate_fat_vector
from ..parallel import (
    BandedRowWise, ColumnWise, RowWise, WindowedRowWise,
    initialize_distributed, make_mesh,
)

N = 50
STRATEGIES = {"windowed": (WindowedRowWise, {}, 32),
              "column": (ColumnWise, {}, 32),
              "row": (RowWise, {}, 32),
              "banded": (BandedRowWise, {"k_nominal": 8}, 8)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategy", choices=sorted(STRATEGIES),
                    default="windowed")
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_strategy: no CUDA device", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(rank=0, world_size=1, device="cuda",
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh()
        cls, kwargs, k = STRATEGIES[args.strategy]
        csr = (spd_banded_system(121_192) if args.strategy == "banded"
               else cop20k_like(dtype=np.float32))
        strategy = cls(**kwargs)
        op = strategy.prepare(csr, mesh)
        v = torch.from_numpy(generate_fat_vector(csr.shape[1], k).astype(
            np.float32)).to(mesh.device)
        gather = not args.sharded

        def one():
            strategy.spmm(op, v, gather_result=gather)

        def run():
            for _ in range(N):
                one()
            torch.cuda.synchronize()

        run()  # warm-up
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) / N * 1e3
        t0 = time.perf_counter()
        for _ in range(N):
            one()
        enqueue_ms = (time.perf_counter() - t0) / N * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=12))
    kernels = {e.key: {"count": e.count,
                       "us_per_launch": e.self_device_time_total / e.count}
               for e in averages if e.self_device_time_total > 0
               and not e.key.startswith(("aten::", "cuda", "c10d::",
                                         "nccl:", "record_param"))}
    busy_ms = sum(x["count"] * x["us_per_launch"]
                  for x in kernels.values()) / 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({
        "device": smi.stdout.strip(), "strategy": args.strategy,
        "gather_result": gather, "n": N, "k": k,
        "host_ms_per_multiply": host_ms,
        "host_enqueue_ms_per_multiply": enqueue_ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a GCN training step's time goes, by ``torch.profiler``.

    python -m sparsematrixmultiplicationmpi_tpu_torch.bench.profile_gcn \
        [--graph mesh|100k] [--library]

Builds the GCN task on the first CUDA device (``mesh``: ``mesh_gcn_task``,
the cop20k mesh through ``WindowedPairs``, so every SpMM is B2 + B1;
``100k``: ``gcn_task``, the model benchmark's graph through
``BucketedELL``), f 64, h 128, c 16, f32, with ``--library`` the SpMM
through ``torch.sparse.mm`` instead. Runs 20 Adam steps three times: on
the host clock (milliseconds per step, waiting for the device), on the
host clock without waiting (the host's own issue time per step), and
under ``torch.profiler`` (each kernel's device time and the device's
busy share of the window; host-side rows and annotated ranges, which
repeat their kernels' time, are left out). Prints the profiler's table, then
one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.gcn import init_gcn, make_train_step
from ..ops.auto import auto_format
from ..ops.autodiff import make_symmetric_spmm
from ..ops.library import to_torch_sparse
from .systems import gcn_task, mesh_gcn_task

N = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", choices=("mesh", "100k"), default="mesh")
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gcn: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    a_hat, x, labels, mask = (mesh_gcn_task() if args.graph == "mesh"
                              else gcn_task())
    if args.library:
        operand = to_torch_sparse(a_hat.astype(np.float32), device=dev)
    else:
        operand = auto_format(a_hat, k_nominal=128).astype(
            torch.float32).to(dev)
    spmm = make_symmetric_spmm(operand)
    x, labels, mask = (torch.from_numpy(a).to(dev) for a in (x, labels,
                                                               mask))
    params = init_gcn(x.shape[1], 128, 16,
                      generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(spmm, torch.optim.Adam(params, lr=1e-2))

    def run():
        for _ in range(N):
            step(params, x, labels, mask)
        torch.cuda.synchronize(dev)

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) / N * 1e3
    t0 = time.perf_counter()
    for _ in range(N):
        step(params, x, labels, mask)
    enqueue_ms = (time.perf_counter() - t0) / N * 1e3
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=15))
    # Kernels only: a host-side row (an aten op, the autograd Function
    # around the ctypes kernels) or an annotated range (the optimizer
    # step) repeats the device time of the kernels inside it.
    kernels = {e.key: {"count": e.count,
                       "us_per_step": e.self_device_time_total / N}
               for e in averages if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation}
    busy_ms = sum(k["us_per_step"] for k in kernels.values()) * N / 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(json.dumps({
        "device": smi.stdout.strip() or torch.cuda.get_device_name(dev),
        "graph": args.graph, "operand": type(operand).__name__
        if not args.library else "torch.sparse_csr", "n": N,
        "host_ms_per_step": host_ms, "host_enqueue_ms_per_step": enqueue_ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "kernels": dict(sorted(
            kernels.items(), key=lambda kv: -kv[1]["us_per_step"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
